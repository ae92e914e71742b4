"""Where one training step's time goes, for any variant: the port of
tools/attr_variant.py.

  python -m dcgan_sr_tpu_torch.attr_variant --config rgb-full [--batch 100]
         [--steps 20] [--reps 3] [--fp32] [--ngf N] [--ndf N]
         [--no-layers] [--cpu]

Measures, each as ms per pass over K = --steps passes a call (one warm
call, then --reps timed calls, utils/measure.timed_scan):

  step           the full train step: the trainer's K-step chunk
                 (train/multi_step.py; on the card one CUDA graph replay)
  g_fwd          generator forward alone
  g_fwd_bwd      generator forward + backward (every gradient consumed)
  d_fwd          discriminator forward alone
  d_fwd_bwd      discriminator forward + backward
  layer table    G forward + backward of every spec prefix; successive
                 differences attribute each layer's (+BN/activation) cost

The networks are built as the trainer runs them: trainable, with G's layers
3-4 unfused (the fused pair has no backward), train-mode BN over the batch
given, bf16 compute unless --fp32.  `scan_apply` queues the K passes and
folds each pass's mean output (and, with gradients, the sum of every
gradient leaf) into one device scalar, so the fence waits for every pass.
It prints the JAX tool's lines, and last its JSON keys.  It runs on the
first CUDA device unless --cpu is given (CPU times are not the card's).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .core import get_config
from .models import Network, discriminator_spec, generator_spec, init_network
from .train.multi_step import build_multi_step, counted, launches_run
from .train.step import init_train_state
from .utils.device import pick_device
from .utils.measure import timed_scan


def scan_apply(net, xs, grad, compute_dtype=None):
    """K passes of `net` over xs (K, B, ...), train-mode BN: the sum over
    passes of the output's mean and, with `grad`, of every gradient leaf's
    sum (tools/attr_variant.py:41-61), as one device scalar."""
    params = [p for p in net.parameters() if p.requires_grad]
    acc = torch.zeros((), device=xs.device)
    for x in xs:
        with torch.set_grad_enabled(grad and bool(params)):
            v = net(x, compute_dtype=compute_dtype).float().mean()
        if grad and params:
            gsum = sum(g.float().sum() for g in torch.autograd.grad(v, params))
            acc = acc + v.detach() + gsum
        else:
            acc = acc + v
    return acc


def trainable(spec, generator, device):
    """`spec` with a fresh init from `generator`, as the trainer builds it."""
    return Network(spec, *init_network(spec, generator), device=device,
                   fuse=False, trainable=True)


def layer_desc(layer):
    """The JAX tool's row label of one spec entry."""
    return layer["kind"] + (f" {layer.get('cin')}->{layer.get('cout')}"
                            if "cin" in layer else "")


def main(argv=None, launches=None):
    """The tool; `launches`, where given, is filled with {kernel: launches
    the card ran} in the full step's chunks (train/multi_step.py
    launches_run: the capture not counted, every replay counted)."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="rgb-full")
    ap.add_argument("--batch", type=int, default=None,
                    help="images per step (patch variants: patches derive)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--ngf", type=int, default=None,
                    help="width override (CPU smoke runs)")
    ap.add_argument("--ndf", type=int, default=None)
    ap.add_argument("--layers", action="store_true", default=True)
    ap.add_argument("--no-layers", dest="layers", action="store_false")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    device = pick_device(args.cpu)
    dtype_s = "float32" if args.fp32 else "bfloat16"
    overrides = dict(compute_dtype=dtype_s)
    for key, v in (("batchSize", args.batch), ("ngf", args.ngf),
                   ("ndf", args.ndf)):
        if v is not None:
            overrides[key] = v
    cfg = get_config(args.config, env_override=False, **overrides)
    cdt = None if args.fp32 else torch.bfloat16
    k, reps = args.steps, args.reps
    b = cfg.step_batch                   # patches for patch variants
    hw = cfg.train_size                  # 8 for patch variants, 64 otherwise
    rng = np.random.RandomState(0)
    out = {"config": cfg.variant, "dtype": dtype_s, "step_batch": b}

    def on_device(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)

    # full step
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device=device)
    before = counted()
    multi = build_multi_step(cfg)
    sb = on_device(k, b, cfg.nc, hw, hw)
    dt = timed_scan(lambda: multi(state, sb)[1]["errG"][-1], (), reps, k)
    if launches is not None:
        launches.update(launches_run(
            {key: n - before[key] for key, n in counted().items()}, multi))
    out["step_ms"] = round(dt * 1e3, 3)
    print(f"{'full step':24s} {dt*1e3:7.3f} ms  ({b/dt:,.0f} img-eq/s)",
          flush=True)
    del state, multi, sb

    g_spec = generator_spec(cfg)
    d_spec = discriminator_spec(cfg)
    lr_hw = hw // 2
    g_in = on_device(k, b, cfg.nc, lr_hw, lr_hw)
    d_in = on_device(k, b, cfg.nc, hw, hw)

    for name, spec, xs in (("g", g_spec, g_in), ("d", d_spec, d_in)):
        net = trainable(spec, torch.Generator().manual_seed(1), device)
        for grad in (False, True):
            dt = timed_scan(lambda: scan_apply(net, xs, grad, cdt), (),
                            reps, k)
            tag = f"{name}_fwd" + ("_bwd" if grad else "")
            out[tag + "_ms"] = round(dt * 1e3, 3)
            print(f"{tag:24s} {dt*1e3:7.3f} ms", flush=True)

    if args.layers:
        print("-- G prefix ablation (fwd+bwd; diff = that layer's cost) --",
              flush=True)
        prev = 0.0
        rows = []
        for n in range(1, len(g_spec) + 1):
            net = trainable(g_spec[:n], torch.Generator().manual_seed(1),
                            device)
            dt = timed_scan(lambda: scan_apply(net, g_in, True, cdt), (),
                            reps, k) * 1e3
            desc = layer_desc(g_spec[n - 1])
            rows.append({"layer": desc, "prefix_ms": round(dt, 3),
                         "delta_ms": round(dt - prev, 3)})
            print(f"  {desc:28s} prefix {dt:7.3f} ms   +{dt - prev:6.3f} ms",
                  flush=True)
            prev = dt
        out["g_layers"] = rows

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
