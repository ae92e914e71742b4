"""Persistent batched SR serving on the card (port of tools/serve.py).

One process holds the generator on its device and serves HTTP requests with
micro-batching: concurrent requests within a short window coalesce into one
batched pipeline call.  Every variant serves: patch configs (gray-patch*,
…-overlap) run the overlap-tile pipeline (infer/tiled.py
make_overlap_sr_fn, seam-stitched output); full-image configs (gray-3, and
the other non-patch variants) feed the whole image to their
fully-convolutional net-2x generator (make_full_sr_fn).  pm1 variants'
[-1,1] range conversion happens inside the service, so HTTP is [0,1] image
bytes end to end.  The default compute path is true-2x input with
running-stats BN (bn_eval) and, for patch configs, the flat (N*T)-tile
generator call; `--parity-bn` normalizes each image (each image's tiles)
with its own statistics, the reference's math.  The generators' fusable
convT+BN+ReLU+conv pair (gray-3 and the patch variants' layers 3-4) runs
through the fused bulge kernel (ops/bulge.py).

  python -m dcgan_sr_tpu_torch.serve --config gray-3 \
      --ckpt fixtures/gray3_textured_net_G.npz --port 8000 --warmup
  python -m dcgan_sr_tpu_torch.serve \
      --ckpt fixtures/overlap_textured_net_G.npz --port 8000 --warmup --bf16
  curl --data-binary @face.png http://localhost:8000/upscale > face_sr.png

Endpoints:
  POST /upscale      image bytes (PNG/JPEG) -> PNG. Default: true-2x
                     (HxW low-res in, 2Hx2W out). `?mode=restore` runs the
                     reference eval protocol instead (degrade internally,
                     same-size output).
  GET  /healthz      JSON: ready, LR buckets, request/batch/error counters,
                     batch latency percentiles, kernel launch counts.

`--config` defaults to gray-patch-batch-overlap, as the JAX server's does.

Each input dimension is edge-padded to a small ladder of pipeline-legal
bucket extents, and batches to power-of-two sizes, exactly as the JAX server
does.  Eager PyTorch compiles nothing per shape, but the ladder is kept
because it is part of the result: under per-image batch-statistics BN
(--parity-bn) the padding enters each image's statistics, and the overlap
tiling needs legal extents anyway, so the same ladder gives the same
answers as the JAX server.  Nothing compiles per shape, but the fused pair's
kernel library is built from csrc/bulge.cu at its first launch (seconds of
nvcc after a fresh checkout), and cuDNN picks its algorithms at each shape's
first call: `--warmup` builds the kernel and runs every square bucket in
both modes, at batch 1 and at --max-batch, before the server listens, so
that no request waits for either.  `--warmup-rect` runs every (bh, bw) pair
of the ladder instead (buckets^2 x 2 modes), so that a non-square first
request is warm too.

`--bf16` computes in bf16 (the precision bench_infer measures): the
generator's layers and the fused pair's bf16 kernel.  With --u8-io the
byte<->range maps stay fp32 around the generator, which casts at entry and
hands fp32 back, as the JAX server's do.

`--t7 net_G.t7` serves a reference Torch checkpoint instead of `--ckpt`
(compat/, imported over the random init as the JAX server does).  A
--compact-params checkpoint serves as its unpacked weights
(train/checkpoint.py load_generator).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import sys
import threading
import time

import numpy as np
import torch

from .infer.tiled import lr_pad_dim, make_full_sr_fn, make_overlap_sr_fn
from .ops import bulge as bulge_ops


MODES = ("2x", "restore")


class SRService:
    """Owns the generator: per-bucket pipelines + a dispatcher thread that
    coalesces queued requests into batched device calls.

    `submit(img_hw, mode)` is thread-safe and blocks until the result is
    ready; all device work happens on the single dispatcher thread."""

    def __init__(self, cfg, net, *, max_size=256, max_batch=8,
                 window_ms=5.0, bn_eval=True, self_ensemble=1,
                 compute_dtype=None, u8_io=False):
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.net = net
        self.device = net.device
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self.bn_eval = bool(bn_eval)
        self.self_ensemble = int(self_ensemble)
        # uint8 device I/O: the [0,1]<->byte conversion (and the pm1 range
        # map) runs on the device, so host<->device copies carry 1 byte/px
        # instead of 4; responses are identical to quantizing the float path
        self.u8_io = bool(u8_io)
        # patch variants serve through the overlap-tile pipeline (their G maps
        # 4x4 tiles); full-image variants feed the whole image to their G
        self.tiled = cfg.patch_based
        self.pm1 = cfg.data_range == "pm1"
        if self.tiled:
            p, ov = cfg.patchSize, cfg.overlap
            snap = lambda d: lr_pad_dim(d, p, ov)  # noqa: E731
        else:
            snap = lambda d: d + (d % 2)           # noqa: E731  even extents
        # LR-extent ladder: ~1.5x steps snapped to pipeline-legal extents,
        # from the training grid (fineSize/2) up to max_size
        buckets, d = [], cfg.fineSize // 2
        while d < max_size:
            b = snap(d)
            if not buckets or b > buckets[-1]:
                buckets.append(b)
            d = int(d * 1.5)
        self.buckets = buckets + [snap(max_size)]
        self._fns = {}            # (bh, bw, mode) -> pipeline
        self.shapes_run = set()   # (bh, bw, mode, batch) the device has run
        self._q = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "errors": 0}
        self._stats_lock = threading.Lock()  # handler threads + dispatcher
        self._lat_ms = []         # last N batch latencies (host wall)
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()

    # -- shape discipline ---------------------------------------------------

    def bucket_for(self, h, w):
        """Smallest ladder pair (bh, bw) covering (h, w), per DIMENSION."""
        def snap1(d):
            for b in self.buckets:
                if b >= d:
                    return b
            raise ValueError(f"image {h}x{w} exceeds max bucket "
                             f"{self.buckets[-1]} (raise --max-size)")
        return snap1(h), snap1(w)

    @staticmethod
    def _lr_extent(h, w, mode):
        """LR extents a (h, w) request occupies (restore inputs arrive at
        OUTPUT, i.e. 2x, scale)."""
        return (h, w) if mode == "2x" else ((h + 1) // 2, (w + 1) // 2)

    def _validate(self, img, mode):
        """Reject malformed requests in the CALLER's thread, before they can
        reach the queue and poison a coalesced batch."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {sorted(MODES)}")
        nc = self.cfg.nc
        ok = img.ndim == 2 if nc == 1 else (img.ndim == 3
                                            and img.shape[0] == nc)
        if not ok:
            raise ValueError(
                f"config {self.cfg.variant} expects "
                f"{'(H, W)' if nc == 1 else f'({nc}, H, W)'} images, "
                f"got shape {tuple(img.shape)}")
        h, w = img.shape[-2:]
        try:
            self.bucket_for(*self._lr_extent(h, w, mode))
        except ValueError:
            raise ValueError(
                f"image {h}x{w} (LR {'x'.join(map(str, self._lr_extent(h, w, mode)))}) "
                f"exceeds max bucket {self.buckets[-1]} (raise --max-size)"
            ) from None

    def _fn(self, bh, bw, mode):
        """(bh, bw, mode) -> pipeline(batch) -> SR batch.

        Tiled: (N, H, W) in / (N, ·, ·) seam-stitched out, one pipeline per
        bucket pair (its index tables belong to the geometry).  Full-image:
        (N, nc, H, W) in / out, one pipeline per mode.  Range is the
        generator's own (see _run_batch)."""
        key = (bh, bw, mode) if self.tiled else (None, None, mode)
        if key not in self._fns:
            lr_input = mode != "restore"        # restore = eval protocol
            if self.tiled:
                fn = make_overlap_sr_fn(
                    self.cfg, self.net, fine=(2 * bh, 2 * bw),
                    lr_input=lr_input, bn_eval=self.bn_eval,
                    self_ensemble=self.self_ensemble,
                    compute_dtype=self.compute_dtype)
                self._fns[key] = lambda x, _fn=fn: _fn(x)["seam"]
            else:
                self._fns[key] = make_full_sr_fn(
                    self.net, lr_input=lr_input, bn_eval=self.bn_eval,
                    self_ensemble=self.self_ensemble,
                    compute_dtype=self.compute_dtype)
        return self._fns[key]

    def warmup(self, batch_sizes=None, rect=False):
        """Build the fused pair's kernel (on a card) and run every SQUARE
        (bucket, mode) pipeline once at each of `batch_sizes` (default: 1
        and max_batch), through the dispatcher queue like any request, so
        that neither the kernel's build nor a shape's first cuDNN call lands
        on a user's request (JAX tools/serve.py warmup).  rect=True runs
        every (bh, bw) pair of the ladder instead (buckets^2 pairs, in both
        modes), so that a non-square first request finds its shape warm
        too.  main() runs it before it listens."""
        if self.device.type == "cuda" and self.net.pairs:
            bulge_ops.build()
        if batch_sizes is None:
            batch_sizes = sorted({1, self.max_batch})
        shape = (self.cfg.nc,) if self.cfg.nc != 1 else ()
        pairs = ([(bh, bw) for bh in self.buckets for bw in self.buckets]
                 if rect else [(b, b) for b in self.buckets])
        for bh, bw in pairs:
            for mode in MODES:
                sh, sw = (bh, bw) if mode == "2x" else (2 * bh, 2 * bw)
                img = np.zeros(shape + (sh, sw), np.float32)
                for n in batch_sizes:
                    self.submit_many([img] * n, mode)

    def _count(self, key, n=1):
        with self._stats_lock:
            self.stats[key] += n

    # -- request path ---------------------------------------------------------

    def submit(self, img_hw, mode="2x"):
        """SR one (H, W) [0,1] image; blocks until the batched dispatch that
        includes it completes.  Returns the cropped output array."""
        return self.submit_many([img_hw], mode)[0]

    def submit_many(self, imgs, mode="2x"):
        try:
            for im in imgs:
                self._validate(im, mode)
        except ValueError:
            self._count("errors")        # rejected requests stay visible
            raise
        # An oversized request goes in max_batch-sized chunks (one bigger
        # batch would pad to the next power of two).  All chunks are queued
        # before the first wait, so they dispatch back to back and the last,
        # partial chunk can coalesce with other requests in its window.
        items = []
        for i in range(0, len(imgs), self.max_batch):
            item = {"imgs": imgs[i:i + self.max_batch], "mode": mode,
                    "done": threading.Event()}
            self._q.put(item)
            items.append(item)
        out = []
        for item in items:
            item["done"].wait()
            if "error" in item:
                raise item["error"]
            out.extend(item["results"])
        return out

    # -- dispatcher (the only thread that touches the device) ----------------

    def _dispatch_loop(self):
        while True:
            items = [self._q.get()]
            if items[0] is None:
                return
            # micro-batch: coalesce whatever lands within the window, up to
            # max_batch images, same mode only
            deadline = time.monotonic() + self.window_s
            requeue = []
            saw_none = False
            count = len(items[0]["imgs"])
            while count < self.max_batch:
                tmo = deadline - time.monotonic()
                if tmo <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=tmo)
                except queue.Empty:
                    break
                if nxt is None:
                    saw_none = True     # re-put AFTER the requeued items
                    break
                if (nxt["mode"] == items[0]["mode"]
                        and count + len(nxt["imgs"]) <= self.max_batch):
                    items.append(nxt)
                    count += len(nxt["imgs"])
                else:
                    requeue.append(nxt)
            # requeue BEFORE any shutdown sentinel, or the requeued
            # submitters would wait forever
            for r in requeue:
                self._q.put(r)
            if saw_none:
                self._q.put(None)
            try:
                self._run_batch(items)
            except Exception as e:  # fail the requests, not the server
                self._count("errors", len(items))
                for it in items:
                    it["error"] = e
                    it["done"].set()

    def _run_batch(self, items):
        mode = items[0]["mode"]
        flat = [im for it in items for im in it["imgs"]]
        mh = max(im.shape[-2] for im in flat)
        mw = max(im.shape[-1] for im in flat)
        bh, bw = self.bucket_for(*self._lr_extent(mh, mw, mode))
        side_h, side_w = (bh, bw) if mode == "2x" else (2 * bh, 2 * bw)
        batch = np.stack([
            np.pad(im, [(0, 0)] * (im.ndim - 2)
                   + [(0, side_h - im.shape[-2]), (0, side_w - im.shape[-1])],
                   mode="edge") for im in flat])
        n = len(batch)
        # power-of-two batch bucket; per-image results do not depend on the
        # padding images in either BN mode (running stats, or per-image
        # statistics: each image's tiles for patch configs, each image for
        # full-image configs)
        n2 = 1 << (n - 1).bit_length()
        if n2 > n:
            batch = np.concatenate([batch, batch[:1].repeat(n2 - n, axis=0)])
        if not self.tiled and batch.ndim == 3:   # full pipeline wants NCHW
            batch = batch[:, None]
        t0 = time.monotonic()
        if self.u8_io:
            x8 = np.clip(np.round(batch * 255.0), 0, 255).astype(np.uint8)
            x = torch.from_numpy(x8).to(self.device).float() / 255.0
        else:
            x = torch.from_numpy(np.ascontiguousarray(batch, np.float32)
                                 ).to(self.device)
        if self.pm1:                # HTTP is [0,1]; the G trains on [-1,1]
            x = x * 2.0 - 1.0
        y = self._fn(bh, bw, mode)(x)
        self.shapes_run.add((bh, bw, mode, n2))
        if self.pm1:
            y = (y + 1.0) * 0.5
        if self.u8_io:
            y8 = torch.clamp(torch.round(y * 255.0), 0, 255).to(torch.uint8)
            sr = y8.cpu().numpy()[:n].astype(np.float32) / 255.0
        else:
            sr = y.cpu().numpy()[:n]          # host copy closes the dispatch
        self._lat_ms.append((time.monotonic() - t0) * 1e3)
        del self._lat_ms[:-256]               # ring of recent batch latencies
        if not self.tiled and self.cfg.nc == 1:
            sr = sr[:, 0]
        self._count("requests", n)
        self._count("batches")
        k = 0
        for it in items:
            res = []
            for im in it["imgs"]:
                h, w = im.shape[-2:]
                oh, ow = (2 * h, 2 * w) if mode == "2x" else (h, w)
                res.append(sr[k][..., :oh, :ow])
                k += 1
            it["results"] = res
            it["done"].set()

    def health(self):
        """The /healthz body."""
        lat = sorted(self._lat_ms)
        pct = (lambda q: round(lat[int(q * (len(lat) - 1))], 3)) \
            if lat else (lambda q: None)
        with self._stats_lock:
            counters = dict(self.stats)
        return {
            "ready": True,
            "config": self.cfg.variant,
            "device": str(self.device),
            "bn_eval": self.bn_eval,
            "dtype": "bf16" if self.compute_dtype == torch.bfloat16 else "fp32",
            "tiled": self.tiled,
            "buckets_lr": self.buckets,
            **counters,
            "batch_ms_p50": pct(0.5), "batch_ms_p95": pct(0.95),
            "recent_batch_ms": [round(v, 3) for v in self._lat_ms[-16:]],
            "kernel_launches": dict(bulge_ops.launches),
            "bulge_impl_launches": dict(bulge_ops.impl_launches),
        }

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)


def make_http_server(service, port=8000, host="127.0.0.1"):
    """ThreadingHTTPServer over an SRService: handler threads only
    decode/encode and enqueue; the service's dispatcher owns the device."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from PIL import Image

    from .image.io import load_image

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # stdout stays for the service's own logs
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] != "/healthz":
                return self._json(404, {"error": "unknown path"})
            self._json(200, service.health())

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/upscale":
                return self._json(404, {"error": "unknown path"})
            mode = "restore" if "mode=restore" in query else "2x"
            try:
                length = int(self.headers.get("Content-Length", 0))
                nc = service.cfg.nc
                img = load_image(io.BytesIO(self.rfile.read(length)), nc=nc)
            except Exception as e:      # undecodable bytes: count + reject
                service._count("errors")
                return self._json(400, {"error": str(e)})
            try:                        # submit counts its own rejections
                sr = service.submit(img[0] if nc == 1 else img, mode)
            except ValueError as e:     # rejected input (size/channels)
                return self._json(400, {"error": str(e)})
            except Exception as e:      # internal dispatch failure
                return self._json(500, {"error": str(e)})
            out8 = (np.clip(np.round(np.asarray(sr) * 255.0), 0, 255)
                    .astype(np.uint8))
            if out8.ndim == 3:                    # CHW -> HWC color PNG
                out8 = np.moveaxis(out8, 0, -1)
            buf = io.BytesIO()
            Image.fromarray(out8).save(buf, format="PNG")
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    class Server(ThreadingHTTPServer):
        # the default listen backlog of 5 drops SYNs under a concurrent
        # connect burst, stalling those clients a full 1 s TCP retransmit
        request_queue_size = 128

    # PIL loads its format plugins at the first encode, which took the
    # first request of a warmed server to 175 ms against a median of 16 ms
    # (H100 host): encode and decode one PNG now
    buf = io.BytesIO()
    Image.fromarray(np.zeros((2, 2), np.uint8)).save(buf, format="PNG")
    load_image(io.BytesIO(buf.getvalue()), nc=service.cfg.nc)
    return Server((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="gray-patch-batch-overlap")
    ap.add_argument("--ckpt", help="framework checkpoint (…_net_G.npz)")
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-size", type=int, default=256,
                    help="largest LR input extent served")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=5.0,
                    help="micro-batch aggregation window")
    ap.add_argument("--parity-bn", action="store_true",
                    help="per-image train-mode BN (the reference's math) "
                         "instead of the default running-stats quality mode")
    ap.add_argument("--self-ensemble", type=int, default=1,
                    choices=(1, 2, 4, 8))
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernel and run every square (bucket, "
                         "mode) pipeline at batch 1 and --max-batch before "
                         "serving")
    ap.add_argument("--warmup-rect", action="store_true",
                    help="warm every RECTANGULAR (bh, bw) ladder pair too "
                         "(buckets^2 pairs x 2 modes), so that a non-square "
                         "first request finds its shape warm; implies "
                         "--warmup")
    ap.add_argument("--t7", help="reference Torch checkpoint (net_G.t7); "
                    "takes the place of --ckpt")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (the precision bench_infer measures)")
    ap.add_argument("--u8-io", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="uint8 device I/O (default ON): byte<->[0,1] (and "
                         "pm1) range maps run on the device, so host<->device "
                         "copies carry 1 byte/px instead of 4; --no-u8-io "
                         "keeps float32 copies")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    from .core import get_config
    from .train.checkpoint import load_generator
    from .utils.device import pick_device

    device = pick_device(args.cpu)
    cfg = get_config(args.config)
    try:
        net, msg = load_generator(cfg, args.ckpt, t7=args.t7, ema=args.ema,
                                  need_state=not args.parity_bn,
                                  device=device)
    except ValueError as e:
        sys.exit(str(e))
    print(msg)
    service = SRService(cfg, net, max_size=args.max_size,
                        max_batch=args.max_batch, window_ms=args.window_ms,
                        bn_eval=not args.parity_bn,
                        self_ensemble=args.self_ensemble,
                        compute_dtype=torch.bfloat16 if args.bf16 else None,
                        u8_io=args.u8_io)
    if args.warmup or args.warmup_rect:
        t0 = time.perf_counter()
        service.warmup(rect=args.warmup_rect)
        print(f"warmup: {len(service.shapes_run)} shapes, "
              f"{len(service._fns)} pipelines, kernels "
              f"{dict(bulge_ops.launches)}, in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    srv = make_http_server(service, args.port, args.host)
    print(f"serving {cfg.variant} on http://{args.host}:{args.port} "
          f"({device}, LR buckets {service.buckets}, max_batch "
          f"{args.max_batch}, {'parity' if args.parity_bn else 'running-stats'}"
          f" BN, {'bf16' if args.bf16 else 'fp32'})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        service.close()


if __name__ == "__main__":
    main()
