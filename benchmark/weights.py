"""Weights, running statistics and inputs made from the seed, on the device.

Every network's tensors come from one torch.Generator on the run's device
in one draw a network (the reference's init: convolution weights
N(0, 0.02), BN scale N(1, 0.02), bias 0); the harness hands the same
tensors to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

from . import spec as S


def generator_for(seed, device, stream=0):
    """A generator on `device` for sub-stream `stream` of `seed`: the
    seed's draws for different purposes never overlap."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * stream) % (2 ** 63))
    return g


def draw(spec_, gen, device):
    """Per-layer parameter dicts of `spec_` from one normal draw."""
    sizes = []
    for layer in spec_:
        if layer["kind"] in ("conv", "convT"):
            sizes.append(math.prod(S.weight_shape(layer)))
            if layer["bn"]:
                sizes.append(layer["cout"])
    flat = torch.randn(sum(sizes), generator=gen, device=device) * 0.02
    params, at = [], 0
    for layer in spec_:
        p = {}
        if layer["kind"] in ("conv", "convT"):
            n = math.prod(S.weight_shape(layer))
            p["w"] = flat[at:at + n].view(S.weight_shape(layer))
            at += n
            if layer["bn"]:
                c = layer["cout"]
                p["bn_scale"] = 1.0 + flat[at:at + c]
                at += c
                p["bn_bias"] = torch.zeros(c, device=device)
                p["bn_mean"] = torch.zeros(c, device=device)
                p["bn_var"] = torch.ones(c, device=device)
        params.append(p)
    return params


def port_trees(params):
    """The program's (params, state) lists: {"w", "bn_scale", "bn_bias"}
    and {"bn": {"mean", "var"}} a layer (models/network.py's structure)."""
    ps, st = [], []
    for p in params:
        ps.append({k: p[k] for k in ("w", "bn_scale", "bn_bias") if k in p})
        st.append({"bn": {"mean": p["bn_mean"], "var": p["bn_var"]}}
                  if "bn_mean" in p else {})
    return ps, st


def calibrate_running(spec_, params, x, gen):
    """Give every BN layer running statistics that are not its initial
    ones: the pooled statistics of `x` through the network (float32, the
    reference), each variance scaled by a factor in [0.8, 1.25) and each
    mean moved by a tenth of a standard deviation, both drawn from `gen`."""
    from .reference import nets
    from .reference.precision import exact_fp32

    stats = []
    with torch.no_grad(), exact_fp32():
        nets.forward(spec_, params, x, "pooled", stats=stats)
    bn = [p for p in params if "bn_mean" in p]
    for p, (mean, var) in zip(bn, stats):
        c = mean.shape[-1]
        u = torch.rand(2, c, generator=gen, device=mean.device)
        p["bn_var"] = var[0] * (0.8 + 0.45 * u[0])
        p["bn_mean"] = mean[0] + 0.1 * (u[1] - 0.5) * var[0].sqrt()
    return params
