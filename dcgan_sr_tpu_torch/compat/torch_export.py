"""Export a generator/discriminator as a Torch7 nn.Sequential `.t7` (port of
dcgan_sr_tpu/compat/torch_export.py).

The inverse of torch_import: a user of the reference can load the port's
weights with `torch.load('..._net_G.t7')` and run them under the original Lua
scripts.  The module chain mirrors the reference definitions (e.g.
train-gray-3.lua:52-73): SpatialUpSamplingNearest / SpatialFullConvolution /
SpatialConvolution / SpatialBatchNormalization / ReLU / LeakyReLU / Sigmoid /
Tanh / View.  `params`/`state` are per-layer dicts of numpy arrays or torch
tensors (Network.trees()); the file's bytes equal the JAX package's export of
the same values.
"""

from __future__ import annotations

import numpy as np

from .t7 import T7Object, save_t7

_ACT_MODULES = {
    "relu": lambda: T7Object("nn.ReLU", {"inplace": True, "train": True}),
    "lrelu": lambda: T7Object("nn.LeakyReLU",
                              {"negval": 0.2, "inplace": True, "train": True}),
    "sigmoid": lambda: T7Object("nn.Sigmoid", {"train": True}),
    "tanh": lambda: T7Object("nn.Tanh", {"train": True}),
}


def _f32(a):
    if hasattr(a, "detach"):            # a torch tensor, on any device
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def export_torch_sequential(spec, params, state=None):
    """Build an nn.Sequential T7Object from a layer spec + params list."""
    mods = {}
    idx = 1

    def add(m):
        nonlocal idx
        mods[idx] = m
        idx += 1

    for li, layer in enumerate(spec):
        kind = layer["kind"]
        p = params[li]
        if kind == "upsample":
            add(T7Object("nn.SpatialUpSamplingNearest",
                         {"scale_factor": layer["factor"], "train": True}))
            continue
        if kind == "flatten":
            add(T7Object("nn.View",
                         {"numElements": 1, "numInputDims": 3, "train": True}))
            continue
        common = {"weight": _f32(p["w"]), "train": True,
                  "kW": layer["k"], "kH": layer["k"],
                  "dW": layer["s"], "dH": layer["s"],
                  "padW": layer["p"], "padH": layer["p"]}
        if kind == "conv":
            add(T7Object("nn.SpatialConvolution",
                         dict(common, nInputPlane=layer["cin"],
                              nOutputPlane=layer["cout"])))
        else:
            add(T7Object("nn.SpatialFullConvolution",
                         dict(common, nInputPlane=layer["cin"],
                              nOutputPlane=layer["cout"],
                              adjW=0, adjH=0)))
        if layer.get("bn"):
            bn_state = (state[li].get("bn") if state is not None and state[li]
                        else None)
            running_mean = (_f32(bn_state["mean"]) if bn_state
                            else np.zeros(layer["cout"], np.float32))
            running_var = (_f32(bn_state["var"]) if bn_state
                           else np.ones(layer["cout"], np.float32))
            add(T7Object("nn.SpatialBatchNormalization", {
                "weight": _f32(p["bn_scale"]),
                "bias": _f32(p["bn_bias"]),
                "running_mean": running_mean,
                "running_var": running_var,
                "eps": 1e-5, "momentum": 0.1, "affine": True,
                "nDim": 4, "train": True,
            }))
        if layer.get("act"):
            add(_ACT_MODULES[layer["act"]]())
    return T7Object("nn.Sequential", {"modules": mods, "train": True})


def export_torch_generator(path, spec, params, state=None):
    save_t7(path, export_torch_sequential(spec, params, state))
    return path
