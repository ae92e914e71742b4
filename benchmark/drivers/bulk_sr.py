"""Bulk SR: the upscale tool's pipeline on a batch of images a call, calls
queued back to back (bench_infer's method: the host never waits for a call
before queueing the next, at most two are in flight).

traffic_params:
  pipeline     "overlap" (infer/tiled.py make_overlap_sr_fn: tiles, the
               2x2 degrade, the generator with each image's statistics,
               the naive and seam stitches) or "full_lr"
               (make_full_sr_fn(lr_input=True): true 2x of LR images, each
               image's own statistics)
  images       images a call
  side         the input images' side (HR for "overlap", LR for "full_lr")
  pool         distinct input batches made from the seed, cycled
  check_calls  calls of the window, drawn from the seed, whose outputs are
               compared with the reference once the window has closed,
               with the window's last call
  trace_calls  calls in the traced stretch (with --trace 1)

The check: "overlap" compares each sampled call's tiles with the
reference's (tiles_gap: the worst image's mean absolute gap; tiles_max_gap:
the largest), and both stitches with the reference's stitches of the
program's own tiles, pixel for pixel (stitch_mismatch: a seam follows
differences of tiles, so it can only be judged exactly from the tiles it
was cut from).  "full_lr" compares each image (image_gap, image_max_gap).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import flops as F
from .. import peaks
from ..common import queued_calls, sync
from ..reference import sr as R
from ..spec import fused_pairs
from ..stats import rate
from ..weights import draw, generator_for


def pair_shape(g_spec, lr_hw, items):
    """(batch, ci, cm, co, h, w) of x at the generator's first fused pair,
    for `items` inputs of side lr_hw."""
    i = fused_pairs(g_spec)[0]
    hw, ch = lr_hw, g_spec[1]["cin"]
    for layer in g_spec[:i]:
        if layer["kind"] == "upsample":
            hw *= layer["factor"]
        else:
            hw = 2 * hw if layer["kind"] == "convT" else hw // 2
            ch = layer["cout"]
    return items, ch, g_spec[i]["cout"], g_spec[i + 1]["cout"], hw, hw


class Driver:
    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        self.pipeline = t["pipeline"]
        self.n, self.side, self.pool = t["images"], t["side"], t["pool"]
        self.check_calls, self.trace_calls = t["check_calls"], t["trace_calls"]
        c = cell.config
        if self.pipeline == "overlap":
            p, ov = c["patchSize"], c["overlap"]
            lines = (self.side - ov) // (p - ov)
            self.items, self.lr_hw = self.n * lines * lines, p // 2
            self.out_mp = self.n * self.side * self.side / 1e6
        elif self.pipeline == "full_lr":
            self.items, self.lr_hw = self.n, self.side
            self.out_mp = self.n * (2 * self.side) ** 2 / 1e6
        else:
            raise ValueError(f"unknown pipeline {self.pipeline!r}")
        self.flops_per_call = F.conv_flops(cell.g_spec, self.lr_hw) \
            * self.items
        elem = 2 if cell.workload["dtype"] == "bf16" else 4
        b, ci, cm, co, h, w = pair_shape(cell.g_spec, self.lr_hw, self.items)
        self.pair_ops, self.pair_bytes = F.pair_work(b, ci, cm, co, h, w,
                                                     elem)

    def setup(self):
        from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn, \
            make_overlap_sr_fn

        cell, dev = self.cell, self.cell.device
        cfg = cell.port_config()
        self.params = draw(cell.g_spec, generator_for(cell.seed, dev, 0), dev)
        net = cell.port_network(cfg, self.params)
        if self.pipeline == "overlap":
            self.run = make_overlap_sr_fn(cfg, net,
                                          compute_dtype=cell.compute_dtype)
            shape = (self.n, self.side, self.side)
        else:
            self.run = make_full_sr_fn(net, compute_dtype=cell.compute_dtype,
                                       lr_input=True)
            shape = (self.n, cell.config["nc"], self.side, self.side)
        gen = generator_for(cell.seed, dev, 1)
        self.inputs = [torch.rand(shape, generator=gen, device=dev)
                       for _ in range(self.pool)]
        self.net = net
        for x in self.inputs[:2]:          # every shape the window uses
            self.run(x)
        sync(dev)
        t0 = time.perf_counter()
        self.run(self.inputs[0])
        sync(dev)
        t_call = time.perf_counter() - t0
        n_min = max(self.check_calls,
                    int(cell.seconds / (2 * max(t_call, 1e-6))))
        rng = np.random.default_rng(cell.seed)
        self.sample = set(int(i) for i in rng.choice(
            n_min, size=min(self.check_calls, n_min), replace=False))
        self.kept = {}

    def window(self):
        cell = self.cell
        failed = [0]

        def call(i):
            try:
                out = self.run(self.inputs[i % self.pool])
            except RuntimeError:
                failed[0] += 1
                return
            if i in self.sample:
                self.kept[i] = out
            self.last = (i, out)

        self.last = None
        n, secs = queued_calls(call, cell.seconds, cell.device, cell.tracer,
                               trace_start=2, trace_calls=self.trace_calls)
        if self.last is not None:
            self.kept.setdefault(*self.last)
        self.last = None
        return {
            "metrics": {"sr_mp_per_s": rate(n * self.out_mp, secs)},
            "attempted": n, "failed": failed[0],
            "work": {"flops": self.trace_calls * self.flops_per_call,
                     "pair_bound_s": self.trace_calls * max(
                         self.pair_ops / peaks.BF16_FLOPS,
                         self.pair_bytes / peaks.HBM_BYTES_PER_S),
                     "pair_calls": self.trace_calls},
            "notes": {"calls": n, "window_s": secs, "sampled": sorted(
                self.kept), "flops_per_call": self.flops_per_call,
                "pair_ops": self.pair_ops, "pair_bytes": self.pair_bytes},
        }

    def release(self):
        del self.run, self.net

    # -- the check ---------------------------------------------------------

    def _reference(self, x, precision="fp32"):
        c = self.cell
        if self.pipeline == "overlap":
            return R.overlap_sr(c.g_spec, self.params, x, c.config, precision)
        return R.full_sr(c.g_spec, self.params, x, precision)

    def _outputs(self, kind):
        """{call: (input, the side's output)} of the sampled calls."""
        if not self.kept:
            raise RuntimeError("no sampled call finished in the window")
        out = {}
        for i, got in sorted(self.kept.items()):
            x = self.inputs[i % self.pool]
            if kind == "control":
                got = self._reference(x, "fp8")
            elif kind.startswith("fault_"):
                got = _plant(got, kind)
            out[i] = (x, got)
        return out

    def readings(self, kind="program"):
        worst_mean, worst_max, mismatch = 0.0, 0.0, 0
        for i, (x, got) in self._outputs(kind).items():
            ref = self._reference(x)
            if self.pipeline == "overlap":
                a, b = got["tiles"].float(), ref["tiles"]
                naive, seam = R.stitches(a, tuple(x.shape[-2:]),
                                         self.cell.config)
                mismatch += int((got["naive"] != naive).sum()) \
                    + int((got["seam"] != seam).sum())
            else:
                a, b = got.float(), ref
            d = (a - b).abs().reshape(a.shape[0], -1)
            worst_mean = max(worst_mean, float(d.mean(1).max()))
            worst_max = max(worst_max, float(d.max()))
            if not math.isfinite(float(a.sum())):
                worst_mean = worst_max = math.inf
        if self.pipeline == "overlap":
            return {"tiles_gap": worst_mean, "tiles_max_gap": worst_max,
                    "stitch_mismatch": mismatch}
        return {"image_gap": worst_mean, "image_max_gap": worst_max}


def _plant(out, kind):
    """A fault in a call's outputs, as if made where they are produced:
    "fault_swap" gives the first image the second image's answer;
    "fault_half" computes half the images and repeats them for the rest."""
    def fix(t):
        t = t.clone()
        if kind == "fault_swap":
            t[0] = t[1]
        elif kind == "fault_half":
            h = t.shape[0] // 2
            t[h:2 * h] = t[:h]
        else:
            raise ValueError(f"unknown fault {kind!r}")
        return t
    if isinstance(out, dict):
        return {k: fix(v) for k, v in out.items()}
    return fix(out)
