"""Spec-driven network as an nn.Module (port of dcgan_sr_tpu/models/network.py).

A network is a tuple of layer dicts (models/specs.py).  The module keeps one
child per spec entry, so layer i's tensors are `layers.<i>.w`,
`layers.<i>.bn_scale`, `layers.<i>.bn_bias` (parameters) and
`layers.<i>.bn_mean`, `layers.<i>.bn_var` (buffers): the same list order as
the JAX package's (params, state) pytrees, whose npz keys are
`_params_/_<i>_/_w_` and `_state_/_<i>_/_bn_/_mean_` (train/checkpoint.py).

Wherever the spec has convT(k4s2p1, bn, relu) followed by conv(k4s2p1) — the
gray-3 generator's layers 3-4 — the pair runs through ops/bulge.py (the
fused kernel on a card, its plain version on the CPU); the second conv's own
BN and activation follow as usual.  `fuse=False` runs every layer unfused,
the plain composition the fused pair is checked against.

bf16 compute (`compute_dtype=torch.bfloat16` of forward, JAX
apply_network(compute_dtype=)): the input is cast at entry, every layer
computes in bf16 from the fp32 master parameters (ops/nn.py), BN statistics
stay fp32, and the output goes back to fp32 for the losses, labels and
metrics.  The fused pair takes the bf16 tensor as it is (ops/bulge.py).

Spans (utils/profiling.py, on while a profiler runs): `cast` around the
entry and exit casts, `upsample` around each nearest upsampling, `conv`
around each convolution (its weight cast and layout changes included),
`bn` around each BN, `act` around each activation, in G and D alike; the
fused pair is ops/bulge.py's `bulge`.  A layer with BN hands its
activation to ops/nn.py batch_norm, so its `bn` span holds the activation:
the plain path opens the `act` span inside it, and where BN runs on
ops/bn.py's kernels (a bf16 map on the card, no gradient carried) a ReLU or
leaky ReLU is folded into the second kernel and no `act` span opens.

BN statistics (`bn_stats` of forward):
  "pooled"     train mode over the batch given (apply_network train=True);
               with `groups=G`, over each of G equal runs of consecutive
               images (the overlap pipeline's vmap over images, each one a
               pooled batch of its own tiles);
  "per_image"  train mode over each image alone (make_full_sr_fn's vmap);
  "running"    eval mode with the running statistics (bn_eval).

Serving builds the module with its defaults: frozen parameters, the fused
pair, and a forward that never touches the running statistics.  Training
(train/step.py) builds it with `trainable=True` (parameters require grad)
and `fuse=False` (the fused kernel has no backward, so layers 3-4 run
unfused under autograd), and calls forward with `track_stats=True`: each BN
layer then also moves its running statistics, in place, by the batch it has
just seen (momentum 0.1, unbiased variance) — the JAX package's threaded
`new_state`, so two forwards in a row (D on real, then on fake) update in
that order.  `logits=True` leaves out a Sigmoid head, for the BCE variants
whose sigmoid is folded into the loss.

`axis_name` of forward (a parallel.Mesh; the data-parallel step,
train/step.py) makes every train-mode BN cross-replica (ops/nn.py
batch_norm), as JAX apply_network(axis_name=) does.  It goes with pooled
statistics and an unfused network only: inference BN is per image, per
group or running, and the fused pair's statistics stay in its kernel.

A port-only model's layers (SRGAN's generator, models/specs.py) are modules
of their own, so the seven variants' `Layer` runs as before: `SRLayer` (a
conv with a bias, BN when the spec has it, then a PReLU or nothing; no
fused pair, no `--fast-ops` rewrite), `Residual` (its body's layers, then
the sum with its input in a `residual` span) and `Shuffle` (PixelShuffle in
a `shuffle` span, then its PReLU).  A PReLU runs in an `act` span; a BN
layer before it passes no activation to ops/nn.py batch_norm, so on the
card its apply kernel runs without one.  utils/profiling.py `counters`
counts the sums, shuffles and PReLUs.  Their (params, state) trees nest: a
residual layer's entry is {"body": [one entry a body layer]}, an SR conv's
params add "b" (bias) and "prelu" (slopes), a shuffle's params hold its
"prelu".

`fast=True` of forward (the trainer's `--fast-ops`, JAX apply_network(fast=))
rewrites every unfused k4s2p1 conv and convT whose input has an even H and
W into its k3s1p1 form (ops/fast.py); the fused pair is never rewritten.
A conv weight may be the 2-D master of ops/compact.py (`--compact-params`):
the layer views it as 4-D (`Layer.weight`) wherever a convolution reads it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import fast as FAST
from ..ops import nn as N
from ..ops.bulge import STATS_MODES, bulge
from ..ops.compact import _w_shape
from ..ops.init import init_bn, init_conv, init_prelu
from ..utils.profiling import counters, span

BN_STATS = STATS_MODES   # the three ways the fused pair takes its statistics


def init_network(spec, generator, dtype=torch.float32):
    """Random (params, state) lists in the JAX package's structure: one dict
    per layer, {"w", "bn_scale", "bn_bias"} and {"bn": {"mean", "var"}}
    (a port-only model's layers as the module docstring says)."""
    params, state = [], []
    for layer in spec:
        p, s = _init_layer(layer, generator, dtype)
        params.append(p)
        state.append(s)
    return params, state


def _init_layer(layer, generator, dtype):
    kind = layer["kind"]
    if kind in ("conv", "convT"):
        if kind == "conv":
            wshape = (layer["cout"], layer["cin"], layer["k"], layer["k"])
        else:
            wshape = (layer["cin"], layer["cout"], layer["k"], layer["k"])
        p = {"w": init_conv(wshape, generator, dtype)}
        s = {}
        if layer.get("bn"):
            scale, bias, bn_state = init_bn(layer["cout"], generator, dtype)
            p["bn_scale"], p["bn_bias"] = scale, bias
            s["bn"] = bn_state
        if layer.get("bias"):
            p["b"] = torch.zeros((layer["cout"],), dtype=dtype)
        if layer.get("act") == "prelu":
            p["prelu"] = init_prelu(layer["cout"], dtype)
        return p, s
    if kind == "residual":
        body = [_init_layer(sub, generator, dtype) for sub in layer["body"]]
        return ({"body": [p for p, _ in body]},
                {"body": [s for _, s in body]})
    if kind == "pixel_shuffle" and layer.get("act") == "prelu":
        return {"prelu": init_prelu(layer["cout"], dtype)}, {}
    return {}, {}


def _as_t(a, device):
    """Always a copy, float32, on `device`."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.detach().to(device=device, dtype=torch.float32, copy=True)


def _is_k4s2p1(layer, kind):
    return (layer["kind"] == kind and layer["k"] == 4 and layer["s"] == 2
            and layer["p"] == 1)


def bulge_pairs(spec):
    """Start indices i of the fusable (convT+BN+ReLU, conv) pairs, scanned
    left to right without overlap."""
    out, i = [], 0
    while i + 1 < len(spec):
        a, b = spec[i], spec[i + 1]
        if (_is_k4s2p1(a, "convT") and a.get("bn") and a.get("act") == "relu"
                and _is_k4s2p1(b, "conv")):
            out.append(i)
            i += 2
        else:
            i += 1
    return out


class Layer(nn.Module):
    """One spec entry; conv layers own `w` and, with BN, its scale/bias
    parameters and running-stat buffers."""

    def __init__(self, layer, p, s, device, trainable=False):
        super().__init__()
        self.spec = layer
        self.foldable = (layer["kind"] in ("conv", "convT")
                         and _is_k4s2p1(layer, layer["kind"]))

        if layer["kind"] in ("conv", "convT"):
            self.w = nn.Parameter(_as_t(p["w"], device),
                                  requires_grad=trainable)
            if layer.get("bn"):
                self.bn_scale = nn.Parameter(_as_t(p["bn_scale"], device),
                                             requires_grad=trainable)
                self.bn_bias = nn.Parameter(_as_t(p["bn_bias"], device),
                                            requires_grad=trainable)
                self.register_buffer("bn_mean",
                                     _as_t(s["bn"]["mean"], device))
                self.register_buffer("bn_var", _as_t(s["bn"]["var"], device))

    @property
    def weight(self):
        """`w` as the 4-D conv weight: a view of a 2-D compact master."""
        w = self.w
        return w if w.dim() == 4 else w.view(_w_shape(self.spec))

    def conv(self, x, compute_dtype=None, fast=False):
        sp, w = self.spec, self.weight
        with span("conv"):
            # JAX's fast_ok: k4s2p1 and an even input, conv and convT alike
            if (fast and self.foldable and x.shape[-1] % 2 == 0
                    and x.shape[-2] % 2 == 0):
                fn = (FAST.conv2d_s2d if sp["kind"] == "conv"
                      else FAST.conv_transpose2d_subpixel)
                return fn(x, w, compute_dtype=compute_dtype)
            if sp["kind"] == "conv":
                return N.conv2d(x, w, sp["s"], sp["p"],
                                compute_dtype=compute_dtype)
            return N.conv_transpose2d(x, w, sp["s"], sp["p"],
                                      compute_dtype=compute_dtype)

    def post(self, x, bn_stats, track_stats=False, logits=False, groups=None,
             axis_name=None):
        """BN (if any) and the activation that follow this layer's conv;
        with BN, ops/nn.py batch_norm applies the activation too."""
        act = self.spec.get("act")
        if logits and act == "sigmoid":
            act = None
        if not self.spec.get("bn"):
            return N.activate(x, act)
        return self._bn(x, act, bn_stats, track_stats, groups, axis_name)

    def _bn(self, x, act, bn_stats, track_stats, groups, axis_name):
        """This layer's BN, with `act` handed to ops/nn.py batch_norm."""
        with span("bn"):
            x, new = N.batch_norm(
                x, self.bn_scale, self.bn_bias,
                state={"mean": self.bn_mean, "var": self.bn_var},
                train=bn_stats != "running",
                per_image=bn_stats == "per_image", groups=groups,
                axis_name=axis_name, act=act)
            if track_stats and bn_stats == "pooled":
                # in place: no backward reads the running statistics
                self.bn_mean.copy_(new["mean"].detach())
                self.bn_var.copy_(new["var"].detach())
        return x

    def forward(self, x, bn_stats, track_stats=False, logits=False,
                groups=None, compute_dtype=None, fast=False, axis_name=None):
        kind = self.spec["kind"]
        if kind == "upsample":
            with span("upsample"):
                return N.upsample_nearest(x, self.spec["factor"])
        if kind == "flatten":
            return x.reshape(x.shape[0], -1)[:, 0]
        if kind in ("conv", "convT"):
            return self.post(self.conv(x, compute_dtype, fast), bn_stats,
                             track_stats, logits, groups, axis_name)
        raise ValueError(f"unknown layer kind {kind!r}")


def _prelu(x, slope):
    with span("act"):
        counters["prelu"] += 1
        return N.prelu(x, slope)


class SRLayer(Layer):
    """A conv layer of a port-only model: stride 1, a bias, BN when the
    spec has it (no activation handed to it), then a channel-wise PReLU
    (`act` "prelu", its slopes the parameter `prelu`) or nothing."""

    def __init__(self, layer, p, s, device, trainable=False):
        super().__init__(layer, p, s, device, trainable)
        self.b = nn.Parameter(_as_t(p["b"], device), requires_grad=trainable)
        if layer["act"] == "prelu":
            self.prelu = nn.Parameter(_as_t(p["prelu"], device),
                                      requires_grad=trainable)

    def conv(self, x, compute_dtype=None, fast=False):
        sp = self.spec
        with span("conv"):
            return N.conv2d(x, self.w, sp["s"], sp["p"],
                            compute_dtype=compute_dtype, bias=self.b)

    def post(self, x, bn_stats, track_stats=False, logits=False, groups=None,
             axis_name=None):
        if self.spec["bn"]:
            x = self._bn(x, None, bn_stats, track_stats, groups, axis_name)
        if self.spec["act"] == "prelu":
            return _prelu(x, self.prelu)
        return x


class Residual(nn.Module):
    """A residual layer: its body's layers, then body(x) + x."""

    def __init__(self, layer, p, s, device, trainable=False):
        super().__init__()
        self.spec = layer
        self.body = nn.ModuleList(
            _module(sub, p["body"][i], s["body"][i] if s else {}, device,
                    trainable)
            for i, sub in enumerate(layer["body"]))

    def forward(self, x, *args):
        y = x
        for layer in self.body:
            y = layer(y, *args)
        with span("residual"):
            counters["residual"] += 1
            return x + y


class Shuffle(nn.Module):
    """PixelShuffle by the spec's factor, then its PReLU (if any)."""

    def __init__(self, layer, p, s, device, trainable=False):
        super().__init__()
        self.spec = layer
        if layer.get("act") == "prelu":
            self.prelu = nn.Parameter(_as_t(p["prelu"], device),
                                      requires_grad=trainable)

    def forward(self, x, *args):
        with span("shuffle"):
            counters["shuffle"] += 1
            x = N.pixel_shuffle(x, self.spec["factor"])
        if self.spec.get("act") == "prelu":
            return _prelu(x, self.prelu)
        return x


def _module(layer, p, s, device, trainable):
    """The module of one spec entry."""
    kind = layer["kind"]
    if kind == "residual":
        return Residual(layer, p, s, device, trainable)
    if kind == "pixel_shuffle":
        return Shuffle(layer, p, s, device, trainable)
    if layer.get("bias"):
        return SRLayer(layer, p, s, device, trainable)
    return Layer(layer, p, s, device, trainable)


def _layer_trees(layer):
    """(params, state) of one module, nested for a residual layer."""
    if isinstance(layer, Residual):
        body = [_layer_trees(sub) for sub in layer.body]
        return {"body": [p for p, _ in body]}, {"body": [s for _, s in body]}
    b = dict(layer.named_buffers(recurse=False))
    return (dict(layer.named_parameters(recurse=False)),
            {"bn": {"mean": b["bn_mean"], "var": b["bn_var"]}} if b else {})


class Network(nn.Module):
    """Generator (or discriminator) built from a spec, with the JAX
    package's (params, state) lists carried across as its parameters and
    buffers — from a checkpoint (train/checkpoint.py load_branch), from
    `init_network`, or from numpy arrays a test hands over."""

    def __init__(self, spec, params, state, *, device="cuda", fuse=True,
                 trainable=False, bulge_impl=None):
        super().__init__()
        self.spec = tuple(spec)
        # which implementation of the fused pair to ask for by name (a
        # measurement's business); None leaves it to ops.bulge.choose_impl
        self.bulge_impl = bulge_impl
        self.layers = nn.ModuleList(
            _module(layer, params[i], state[i] if state is not None else {},
                    device, trainable)
            for i, layer in enumerate(self.spec))
        self.pairs = frozenset(bulge_pairs(self.spec)) if fuse else frozenset()

    @property
    def device(self):
        return next(self.parameters()).device

    def trees(self):
        """(params, state) of this network in the JAX package's structure:
        per layer {"w", "bn_scale", "bn_bias"} and {"bn": {"mean", "var"}},
        holding the module's own tensors (not copies)."""
        params, state = [], []
        for layer in self.layers:
            p, s = _layer_trees(layer)
            params.append(p)
            state.append(s)
        return params, state

    def forward(self, x, bn_stats="pooled", *, track_stats=False,
                logits=False, groups=None, compute_dtype=None, fast=False,
                axis_name=None):
        if bn_stats not in BN_STATS:
            raise ValueError(f"bn_stats must be one of {BN_STATS}")
        if groups is not None and (bn_stats != "pooled" or track_stats):
            raise ValueError("groups goes with bn_stats='pooled' and no "
                             "track_stats")
        if track_stats and self.pairs:
            raise ValueError("track_stats needs fuse=False: the fused pair "
                             "does not move its BN layer's running statistics")
        if axis_name is not None and (bn_stats != "pooled" or groups
                                      is not None or self.pairs):
            raise ValueError(
                "axis_name (cross-replica BN statistics) goes with "
                "bn_stats='pooled', no groups and fuse=False: the fused "
                "pair's in-kernel statistics are never cross-replica")
        if compute_dtype is not None:
            with span("cast"):
                x = x.to(compute_dtype)
        i = 0
        while i < len(self.layers):
            layer = self.layers[i]
            if i in self.pairs:
                nxt = self.layers[i + 1]
                x, _ = bulge(
                    x, layer.weight, layer.bn_scale, layer.bn_bias, nxt.weight,
                    stats=bn_stats, groups=groups, impl=self.bulge_impl,
                    running=((layer.bn_mean, layer.bn_var)
                             if bn_stats == "running" else None))
                x = nxt.post(x, bn_stats, track_stats, logits, groups)
                i += 2
            else:
                x = layer(x, bn_stats, track_stats, logits, groups,
                          compute_dtype, fast, axis_name)
                i += 1
        if compute_dtype is None:
            return x
        with span("cast"):
            return x.float()
