"""Folder data-path throughput probe (port of tools/loader_bench.py): the
host side of the folder trainer, which launches no kernel.

Measures images/sec of the FolderDataset trainHook pipeline (decode +
aspect resize + random crop + hflip + normalize, donkey_folder.lua:33-70)
three ways:

  sample        single-thread FolderDataset.sample (the per-donkey cost)
  prefetch      PrefetchLoader with N worker threads (the data:getBatch path)
  canvas        single-thread sample_canvas (the --device-augment mode: the
                host keeps only decode + resize + long-dim crop)

Synthesizes an on-disk image tree in a temporary directory when --data-root
is not given, so the number is reproducible anywhere.  Prints one JSON line
per mode.

  python -m dcgan_sr_tpu_torch.loader_bench [--data-root DIR] [--images 200]
      [--batches 20] [--batch-size 32] [--threads 4] [--jpeg]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from .data import FolderDataset, PrefetchLoader
from .image.io import save_image


def synthesize_tree(root, n_images, jpeg=False):
    rng = np.random.RandomState(0)
    sub = os.path.join(root, "class0")
    os.makedirs(sub, exist_ok=True)
    ext = "jpg" if jpeg else "png"
    for i in range(n_images):
        # CelebA-like aspect: 218x178, decoded then short-side-96 resized
        save_image(os.path.join(sub, f"{i:06d}.{ext}"),
                   rng.rand(3, 218, 178).astype(np.float32))
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--images", type=int, default=200)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--jpeg", action="store_true",
                    help="synthesize JPEGs instead of PNGs")
    args = ap.parse_args(argv)

    tmp = None
    root = args.data_root
    if root is None:
        tmp = tempfile.TemporaryDirectory(prefix="loader_bench_")
        root = synthesize_tree(tmp.name, args.images, jpeg=args.jpeg)

    with tempfile.TemporaryDirectory(prefix="loader_cache_") as cache:
        ds = FolderDataset(root, cache_dir=cache)
        b, nb = args.batch_size, args.batches
        results = []

        rng = np.random.RandomState(1)
        ds.sample(b, rng)  # warm any OS page cache
        t0 = time.perf_counter()
        for _ in range(nb):
            ds.sample(b, rng)
        results.append(("folder_sample_images_per_sec",
                        nb * b / (time.perf_counter() - t0)))

        with PrefetchLoader(lambda r: ds.sample(b, r),
                            n_threads=args.threads) as loader:
            loader.get_batch()  # pipeline warm
            t0 = time.perf_counter()
            for _ in range(nb):
                loader.get_batch()
            results.append((f"folder_prefetch{args.threads}_images_per_sec",
                            nb * b / (time.perf_counter() - t0)))

        rng = np.random.RandomState(2)
        ds.sample_canvas(b, rng)
        t0 = time.perf_counter()
        for _ in range(nb):
            ds.sample_canvas(b, rng)
        results.append(("folder_canvas_images_per_sec",
                        nb * b / (time.perf_counter() - t0)))

    for metric, ips in results:
        print(json.dumps({"metric": metric, "value": round(ips, 1),
                          "unit": "images/sec"}), flush=True)
    if tmp is not None:
        tmp.cleanup()
    return dict(results)


if __name__ == "__main__":
    main()
