"""Bulk SR with SRGAN's generator: `upscale --config srgan-x4 --bf16`'s
pipeline (infer/tiled.py make_full_sr_fn(lr_input=True, bn_eval=True)) on
a batch of LR RGB images a call, calls queued back to back (at most two in
flight, common.queued_calls).

The network is built from the benchmark's reference's spec
(reference/srgan.py `spec`), which set-up first holds equal to the
program's own (models/specs.py generator_spec of the port's model table),
and the configuration file's sizes equal to the port's.  Weights come from
the seed (reference/srgan.py `draw`); the running statistics are made as
weights.calibrate_running makes them: the pooled statistics of a
seed-drawn LR batch through the reference in float32, each variance scaled
by a factor in [0.8, 1.25) and each mean moved by a tenth of a standard
deviation, so that no BN layer is the identity.

traffic_params:
  images       LR images a call
  side         their side (the output's is scale x side)
  pool         distinct input batches made from the seed, cycled
  check_calls  calls of the window, drawn from the seed, whose outputs are
               compared with the reference once the window has closed,
               with the window's last call
  trace_calls  calls in the traced stretch (with --trace 1)
  check_block  images the reference takes at a time in the check
  calib_images LR images whose pooled statistics set the running ones

The check compares each image of the sampled calls with the float32
reference: image_gap, the worst image's mean absolute gap, and
image_max_gap, the largest.  `counters` (and `notes`) carry what ran in
the window: residual sums, shuffles and PReLUs (utils/profiling.py
counters), each BN kernel's launches and the CUDA BN calls sent to the
plain code (ops/bn.py).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..common import queued_calls, sync
from ..reference import srgan as R
from ..stats import rate
from ..weights import generator_for
from .bulk_sr import _plant

SIZE_KEYS = ("nc", "channels", "blocks", "up_channels", "scale", "head_k",
             "body_k")


def calibrate_running(config, params, state, x, gen):
    """Running statistics for every BN layer from x's pooled statistics
    (module docstring), drawn from `gen`; sets them in `state`.  The
    program's CPU tests (tests/test_torch_srgan.py) make theirs with it."""
    stats = []
    R.forward(params, state, x, bn="pooled", stats=stats)
    it = iter(stats)

    def walk(t):
        if isinstance(t, list):
            for v in t:
                walk(v)
        elif "body" in t:
            walk(t["body"])
        elif "bn" in t:
            mean, var = next(it)
            u = torch.rand(2, mean.shape[0], generator=gen,
                           device=mean.device)
            t["bn"]["var"] = var * (0.8 + 0.45 * u[0])
            t["bn"]["mean"] = mean + 0.1 * (u[1] - 0.5) * var.sqrt()

    walk(state)
    return state


def _counters():
    """Residual sums, shuffles, PReLUs and BN's launches and plain CUDA
    calls, in this process so far ({} of a program without them)."""
    out = {}
    try:
        from dcgan_sr_tpu_torch.utils.profiling import counters
        out.update(counters)
    except ImportError:
        pass
    try:
        from dcgan_sr_tpu_torch.ops import bn
        out.update({f"bn.{k}": v for k, v in bn.launches.items()})
        out["bn.plain_cuda_calls"] = bn.plain_cuda_calls
    except ImportError:
        pass
    return out


class Driver:
    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        self.n, self.side, self.pool = t["images"], t["side"], t["pool"]
        self.check_calls, self.trace_calls = t["check_calls"], t["trace_calls"]
        self.block, self.calib = t["check_block"], t["calib_images"]
        c = cell.config
        self.out_mp = self.n * (c["scale"] * self.side) ** 2 / 1e6
        self.flops_per_call = R.conv_flops(c, self.side) * self.n

    def setup(self):
        from dcgan_sr_tpu_torch.core import MODELS
        from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn
        from dcgan_sr_tpu_torch.models import Network, generator_spec

        cell, dev, c = self.cell, self.cell.device, self.cell.config
        model = MODELS[c["variant"]]
        m = dataclasses.asdict(model)
        for k in SIZE_KEYS:
            if m[k] != c[k]:
                raise ValueError(f"the program's model has {k}={m[k]!r}, "
                                 f"the file {c[k]!r}")
        spec = R.spec(c)
        if tuple(generator_spec(model)) != spec:
            raise ValueError("the program's network is not the reference's")
        self.params, self.state = R.draw(c, generator_for(cell.seed, dev, 0),
                                         dev)
        gen = generator_for(cell.seed, dev, 2)
        x = torch.rand((self.calib, c["nc"], self.side, self.side),
                       generator=gen, device=dev)
        calibrate_running(c, self.params, self.state, x, gen)
        net = Network(spec, self.params, self.state, device=dev)
        self.run = make_full_sr_fn(net, compute_dtype=cell.compute_dtype,
                                   lr_input=True, bn_eval=True)
        gen = generator_for(cell.seed, dev, 1)
        shape = (self.n, c["nc"], self.side, self.side)
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
        before = _counters()
        n, secs = queued_calls(call, cell.seconds, cell.device, cell.tracer,
                               trace_start=2, trace_calls=self.trace_calls)
        after = _counters()
        counters = {k: v - before.get(k, 0) for k, v in after.items()}
        if self.last is not None:
            self.kept.setdefault(*self.last)
        self.last = None
        return {
            "metrics": {"sr_mp_per_s": rate(n * self.out_mp, secs)},
            "attempted": n, "failed": failed[0],
            "work": {"flops": self.trace_calls * self.flops_per_call},
            "counters": counters,
            "notes": {"calls": n, "window_s": secs, "sampled": sorted(
                self.kept), "flops_per_call": self.flops_per_call,
                "counters": counters},
        }

    def release(self):
        del self.run, self.net

    # -- the check ---------------------------------------------------------

    def _reference(self, x, precision="fp32"):
        return torch.cat([
            R.forward(self.params, self.state, x[j:j + self.block],
                      precision=precision)
            for j in range(0, x.shape[0], self.block)])

    def readings(self, kind="program"):
        """image_gap and image_max_gap of the program ("program"), of the
        control (the reference in float8 in the program's place,
        "control"), or of a fault planted in the program's outputs
        ("fault_swap", "fault_half": bulk_sr's)."""
        if not self.kept:
            raise RuntimeError("no sampled call finished in the window")
        worst_mean, worst_max = 0.0, 0.0
        for i, got in sorted(self.kept.items()):
            x = self.inputs[i % self.pool]
            if kind == "control":
                got = self._reference(x, "fp8")
            elif kind.startswith("fault_"):
                got = _plant(got, kind)
            elif kind != "program":
                raise ValueError(f"unknown reading kind {kind!r}")
            a = got.float()
            d = (a - self._reference(x)).abs().reshape(a.shape[0], -1)
            worst_mean = max(worst_mean, float(d.mean(1).max()))
            worst_max = max(worst_max, float(d.max()))
            if not torch.isfinite(a).all():
                worst_mean = worst_max = float("inf")
        return {"image_gap": worst_mean, "image_max_gap": worst_max}
