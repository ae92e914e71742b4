"""Import a reference Torch checkpoint (nn.Sequential netG) into the port's
(params, state) lists (port of dcgan_sr_tpu/compat/torch_import.py).

Maps the serialized module chain of a `.t7` generator/discriminator (e.g.
`checkpoints/<name>_<epoch>_net_G.t7`, train.lua:298) onto the matching
layer spec's per-layer dicts:
  nn.SpatialConvolution        weight (nOut, nIn, kH, kW)  -> conv "w"
  nn.SpatialFullConvolution    weight (nIn, nOut, kH, kW)  -> convT "w"
  nn.SpatialBatchNormalization weight/bias/running_*       -> bn_scale/bn_bias
  nn.SpatialUpSamplingNearest / nn.ReLU / nn.LeakyReLU / nn.Sigmoid /
  nn.Tanh / nn.View            parameter-free, consumed positionally

Weight layouts are the port's own (ops/nn.py uses torch layouts), so the
import is a reshape-free copy.  The result holds float32 numpy arrays in the
JAX package's structure, which models.Network takes as they are.
"""

from __future__ import annotations

import numpy as np

from .t7 import T7Object, load_t7

_PARAM_FREE = {
    "nn.SpatialUpSamplingNearest", "nn.ReLU", "nn.LeakyReLU", "nn.Sigmoid",
    "nn.Tanh", "nn.View", "nn.Reshape", "cudnn.ReLU", "cudnn.Sigmoid",
    "cudnn.Tanh",
}
_CONV = {"nn.SpatialConvolution", "cudnn.SpatialConvolution"}
_CONVT = {"nn.SpatialFullConvolution", "cudnn.SpatialFullConvolution"}
_BN = {"nn.SpatialBatchNormalization", "cudnn.SpatialBatchNormalization"}


def _modules(seq: T7Object):
    mods = seq["modules"]
    # lua arrays serialize as {1: m1, 2: m2, ...}
    return [mods[k] for k in sorted(mods)]


def _f32(a):
    if hasattr(a, "detach"):            # a torch tensor, on any device
        a = a.detach().cpu()
    return np.array(a, dtype=np.float32)


def _copy(tree):
    """A per-layer dict (or a list of them) with float32 numpy leaves."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return _f32(tree)


def import_torch_sequential(obj: T7Object, spec, params, state=None):
    """Copy weights from a deserialized nn.Sequential into `params` (a new
    list).

    `spec`/`params` as models.init_network gives them.  Consumes the torch
    module list positionally: each spec conv/convT layer takes one conv
    module and, if bn=True, the following BatchNormalization module.

    If a `state` list is given, BN running statistics (running_mean /
    running_var) are copied into a new state list returned as the second
    element, for running-statistics inference (bn_eval).
    """
    if obj.torch_type != "nn.Sequential":
        raise ValueError(f"expected nn.Sequential, got {obj.torch_type}")
    mods = _modules(obj)
    out = [_copy(p) for p in params]
    out_state = None if state is None else [_copy(s) for s in state]
    mi = 0

    def next_module():
        nonlocal mi
        while mi < len(mods) and mods[mi].torch_type in _PARAM_FREE:
            mi += 1
        if mi >= len(mods):
            raise ValueError("ran out of torch modules while mapping spec")
        m = mods[mi]
        mi += 1
        return m

    for li, layer in enumerate(spec):
        kind = layer["kind"]
        if kind not in ("conv", "convT"):
            continue
        m = next_module()
        want = _CONV if kind == "conv" else _CONVT
        if m.torch_type not in want:
            raise ValueError(
                f"layer {li}: expected {sorted(want)}, got {m.torch_type}")
        w = _f32(m["weight"])
        if w.shape != out[li]["w"].shape:
            raise ValueError(f"layer {li}: weight shape {w.shape} != "
                             f"{out[li]['w'].shape}")
        out[li]["w"] = w
        if layer.get("bn"):
            bn = next_module()
            if bn.torch_type not in _BN:
                raise ValueError(f"layer {li}: expected BatchNormalization, "
                                 f"got {bn.torch_type}")
            out[li]["bn_scale"] = _f32(bn["weight"])
            out[li]["bn_bias"] = _f32(bn["bias"])
            if out_state is not None and "running_mean" in bn:
                out_state[li]["bn"] = {"mean": _f32(bn["running_mean"]),
                                       "var": _f32(bn["running_var"])}
    if state is not None:
        return out, out_state
    return out


def import_torch_generator(path, spec, params, state=None):
    """Load a reference netG/netD `.t7` file into matching params.

    With `state`, also returns the BN running statistics (see
    import_torch_sequential)."""
    return import_torch_sequential(load_t7(path), spec, params, state)
