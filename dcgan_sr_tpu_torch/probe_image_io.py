"""Image round-trip convention probes, the reference's two manual test
scripts reproduced (test_image_to_tensor.lua:1-30,
test_tensor_to_image.lua:1-42): the port of tools/probe_image_io.py, on the
host alone.

Probe 1 (tensor -> image): saves constant 64x64 tensors (0, 0.5, 1, -1,
-0.5) through the min-max display normalizer and prints their stats,
showing that toDisplayTensor maps any constant image to black and that
values are round(x*255) bytes.

Probe 2 (image -> tensor): writes known PNGs (black, white, #333333,
4-value) and loads them back as byte tensors, showing the decode convention
(CHW, 0-255 bytes / [0,1] floats).

  python -m dcgan_sr_tpu_torch.probe_image_io [outdir]

The default outdir is probe_image_io under the temporary directory.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from .image.io import load_image, save_display, save_image
from .utils.stats import print_tensor_stats


def probe_tensor_to_image(outdir):
    for label, val in [("image_all_0", 0.0), ("image_all_05", 0.5),
                       ("image_all_1", 1.0), ("image_all__1", -1.0),
                       ("image_all__05", -0.5)]:
        t = np.full((64, 64), val, np.float32)
        save_display(os.path.join(outdir, f"{label}.png"), t)
        print_tensor_stats(label, t)
        back = load_image(os.path.join(outdir, f"{label}.png"), nc=1,
                          dtype="byte")
        print(f"  saved-byte value: {int(back.max())} (constant input -> black)")


def probe_image_to_tensor(outdir):
    fixtures = {
        "image_black": np.zeros((3, 4, 4), np.float32),
        "image_white": np.ones((3, 4, 4), np.float32),
        "image_333333": np.full((3, 4, 4), 0x33 / 255.0, np.float32),
        "image_all4": np.stack([np.full((4, 4), v / 255.0, np.float32)
                                for v in (0, 85, 170, 255)])[:3],
    }
    for name, arr in fixtures.items():
        path = os.path.join(outdir, f"{name}.png")
        save_image(path, arr)
        byte = load_image(path, nc=3, dtype="byte")
        print(name)
        print(f"  shape: {byte.shape} dtype: {byte.dtype} "
              f"unique: {sorted(set(byte.ravel().tolist()))}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else os.path.join(tempfile.gettempdir(),
                                            "probe_image_io")
    os.makedirs(out, exist_ok=True)
    print("== tensor -> image (display-normalized save) ==")
    probe_tensor_to_image(out)
    print("== image -> tensor (byte decode) ==")
    probe_image_to_tensor(out)
    return out


if __name__ == "__main__":
    main()
