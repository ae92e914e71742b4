"""Core NN ops with Torch7-`nn` semantics in PyTorch, differentiable.

Port of dcgan_sr_tpu/ops/nn.py.  Layouts are the reference's: activations
NCHW, conv weight OIHW, conv-transpose weight IOHW, no biases in the seven
variants (`m:noBias()`, train.lua:46).  SRGAN's generator (a port-only
model) adds a conv bias (`conv2d(bias=)`, cast to the compute dtype with
the weight), a channel-wise PReLU (`prelu`) and `pixel_shuffle`.  The JAX
package's custom VJPs work around XLA's transpose rules and have no
counterpart here: autograd differentiates these ops.

fp32 parity: the JAX package runs fp32 convolutions at Precision.HIGHEST.
cuDNN runs fp32 convolutions in TF32 by default on Hopper (about three
decimal digits), forward and backward alike, and autograd runs the backward
convolutions later, wherever the caller asks for gradients.  So `conv2d` and
`conv_transpose2d` are one autograd function (`_Conv`) that turns TF32 off
(`fp32_convs()`) around its forward call and again around its own backward
call: gradients are full fp32 whether they are taken inside a training step,
in a test, or anywhere else, with no flag for the caller to remember.
Matrix products stay at PyTorch's default full-fp32 precision.

bf16 compute (`compute_dtype=torch.bfloat16`, JAX ops/nn.py:33-81, 109-143):
a convolution casts both operands to bf16, accumulates in fp32 and returns
bf16.  Its backward follows the JAX package's custom VJP (:160-236): dx in
bf16 through the sibling op; a k4s2p1 dw (`_dw_conv`) from the bf16
operands with fp32 sums, kept in fp32 and never rounded; any other dw
rounded to bf16 (autodiff of the bf16 convolution), then taken to the fp32
weight.  On the card the bf16 results are cuDNN's bf16 convolutions, and
the k4s2p1 dw is an fp32 convolution of the upcast bf16 operands on TF32
tensor cores: a bf16 value is exact in TF32 (8 significant bits of 11), so
its products are exact and its sums fp32, as with TF32 off.  On the CPU the bf16 operands are upcast (exactly),
convolved in fp32 and each bf16 result rounded once: the same function,
whatever oneDNN's own bf16 kernels would round.  BN of a bf16 tensor takes
fp32 statistics and applies one per-channel affine x * a + b in bf16, each
step rounded as XLA rounds it.  On the card, where no gradient is carried,
that BN and the activation after it run as ops/bn.py's two-pass kernels
(`batch_norm`, its rule `bn.takes`), a narrow "same" convolution runs
ops/conv_narrow.py's kernel (`conv2d`, its rule `conv_narrow.takes`) and
a 3x3 one of 64 channels ops/conv3x3.py's (its rule `conv3x3.takes`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..utils.profiling import counters, span
from . import bn as BN
from . import conv3x3 as C3
from . import conv_narrow as CN


@contextlib.contextmanager
def fp32_convs(allow_tf32=False):
    """cuDNN convolutions in full fp32 (TF32 off) for the enclosed calls, or
    with `allow_tf32` on TF32 tensor cores."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _upcast_on_cpu(*ts):
    """bf16 tensors on the CPU go to fp32 (exact); anything else as given."""
    if ts[0].device.type == "cpu" and ts[0].dtype == torch.bfloat16:
        return [t.float() for t in ts], torch.bfloat16
    return list(ts), None


class _Conv(torch.autograd.Function):
    """conv2d / conv_transpose2d whose forward and backward both run with
    TF32 off (a bf16 k4s2p1 dw on the card excepted: module docstring).
    x comes in its compute dtype, w as the fp32 master and is cast to x's
    dtype here, so that the backward can keep a k4s2p1 dw in fp32.  The
    backward is aten's own convolution_backward (the call autograd would
    make), only inside `fp32_convs()`."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed, b=None):
        wc = w.to(x.dtype)
        ctx.save_for_backward(x, wc)
        ctx.geom = (stride, padding, transposed, w.dtype)
        ctx.bias = None if b is None else b.dtype
        (xc, wc), back = _upcast_on_cpu(x, wc)
        if b is not None:               # the bias in the compute dtype
            b = b.to(x.dtype)
            if back is not None:
                b = b.float()
        with fp32_convs():
            if transposed:
                y = F.conv_transpose2d(xc, wc, b, stride=stride,
                                       padding=padding)
            else:
                y = F.conv2d(xc, wc, b, stride=stride, padding=padding)
        return y if back is None else y.to(back)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        stride, padding, transposed, wdtype = ctx.geom
        need_x, need_w = ctx.needs_input_grad[:2]
        grad = grad.contiguous()
        # JAX's _dw_conv: bf16 operands, fp32 sums, an fp32 result
        dw32 = (need_w and x.dtype != wdtype and stride == 2
                and padding == 1 and w.shape[-1] == 4)

        def backward_of(g, xx, ww, mask, allow_tf32=False):
            with fp32_convs(allow_tf32):
                return torch.ops.aten.convolution_backward(
                    g, xx, ww, None, [stride, stride], [padding, padding],
                    [1, 1], transposed, [0, 0], 1, [*mask, False])[:2]

        (gc, xc, wc), back = _upcast_on_cpu(grad, x, w)
        if back is not None:           # CPU bf16: both from fp32 upcasts
            gx, gw = backward_of(gc, xc, wc, [need_x, need_w])
            gx = None if gx is None else gx.to(back)
            if gw is not None and not dw32:
                gw = gw.to(back)
        else:
            gx, gw = backward_of(gc, xc, wc, [need_x, need_w and not dw32])
            if dw32:                   # card: bf16 values are exact in TF32
                gw = backward_of(gc.to(wdtype), xc.to(wdtype), wc.to(wdtype),
                                 [False, True], allow_tf32=True)[1]
        out = (gx, None if gw is None else gw.to(wdtype), None, None, None)
        if ctx.bias is None:
            return out
        gb = (grad.float().sum((0, 2, 3)).to(ctx.bias)
              if ctx.needs_input_grad[5] else None)
        return out + (gb,)


def conv2d(x, w, stride=1, padding=0, *, compute_dtype=None, bias=None):
    """2D cross-correlation, NCHW x OIHW -> NCHW (SpatialConvolution).
    `compute_dtype` (torch.bfloat16) casts both operands: bf16 out.  A
    `bias` (Cout,) is cast with the weight and added inside the
    convolution.

    A narrow bf16 CUDA call with no gradient to carry (`conv_narrow.takes`:
    stride 1, "same" padding, Cout <= 8, Cin a multiple of 16; SRGAN's tail)
    runs ops/conv_narrow.py's kernel, and a 3x3 one of 64 input channels
    (`conv3x3.takes`: stride 1, padding 1, Cout 64 or 256; SRGAN's LR and
    upsampling convs) ops/conv3x3.py's, each with the bias added in fp32
    before the one rounding; every other call runs cuDNN (a bf16 CUDA call
    of a shape a kernel fits, sent there for a gradient, counts in
    `counters["conv_narrow_plain"]` or `counters["conv3x3_plain"]`).  The
    shape is read first, in integers, so a call no kernel fits pays for
    nothing else."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    cout = w.shape[0]
    if (cout <= CN.MAX_COUT and x.is_cuda and x.dtype == torch.bfloat16
            and CN.fits(tuple(w.shape), stride, padding)):
        if CN.takes(x, w, stride, padding, bias):
            return CN.conv(x, w, bias)
        counters["conv_narrow_plain"] += 1
    elif (cout in C3.COUTS and C3.fits(tuple(w.shape), stride, padding)
          and x.is_cuda and x.dtype == torch.bfloat16):
        if C3.takes(x, w, stride, padding, bias):
            return C3.conv(x, w, bias)
        counters["conv3x3_plain"] += 1
    if bias is None:
        return _Conv.apply(x, w, stride, padding, False)
    return _Conv.apply(x, w, stride, padding, False, bias)


def conv_transpose2d(x, w, stride=2, padding=1, *, compute_dtype=None):
    """Transposed conv (SpatialFullConvolution), weight (Cin, Cout, kH, kW);
    k4 s2 p1 is exactly 2x upsampling (train.lua:99).  `compute_dtype` as
    in conv2d."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return _Conv.apply(x, w, stride, padding, True)


def _stats_dtype(x):
    """x in the dtype its statistics accumulate in: fp32, or float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_stats(x, per_image=False, groups=None):
    """(mean, biased var) over (N, H, W), or over (H, W) of each image with
    `per_image` ((N, C) results), or pooled within each of `groups` equal
    runs of consecutive images ((groups, C) results).  var = E[x^2] - mean^2
    in fp32, the JAX package's formula (ops/nn.py batch_norm); a float64 x
    (a check's exact run) keeps float64."""
    xf = _stats_dtype(x)
    if groups is not None and not per_image:
        n, c, h, w = xf.shape
        if n % groups:
            raise ValueError(f"batch {n} does not split into {groups} groups")
        xf = xf.reshape(groups, n // groups, c, h, w)
        dims = (1, 3, 4)
    else:
        dims = (2, 3) if per_image else (0, 2, 3)
    mean = xf.mean(dims)
    mean_sq = (xf * xf).mean(dims)
    return mean, mean_sq - mean * mean


def normalize(x, mean, var, scale, bias, eps=1e-5):
    """(x - mean) * (rsqrt(var + eps) * scale) + bias, in the exact fp32
    order of the JAX package.  mean/var are (C,), per-image (N, C), or per
    group (G, C) with N a multiple of G (consecutive images share a row).
    A bf16 x takes the JAX package's bf16 form: a = inv * scale and
    b = bias - mean * inv * scale from the fp32 statistics, both rounded to
    bf16, then x * a + b in bf16."""
    inv = torch.rsqrt(var + eps)
    a = inv * scale
    if x.dtype != torch.float32:
        b = (bias - mean * inv * scale).to(x.dtype)
        a = a.to(x.dtype)
        if mean.dim() == 1:
            return x * a[None, :, None, None] + b[None, :, None, None]
        rep = x.shape[0] // mean.shape[0]
        a, b = (v.repeat_interleave(rep, dim=0) for v in (a, b))
        return x * a[:, :, None, None] + b[:, :, None, None]
    if mean.dim() == 1:
        return (x - mean[None, :, None, None]) * a[None, :, None, None] \
            + bias[None, :, None, None]
    if mean.shape[0] != x.shape[0]:
        rep = x.shape[0] // mean.shape[0]
        mean = mean.repeat_interleave(rep, dim=0)
        a = a.repeat_interleave(rep, dim=0)
    return (x - mean[:, :, None, None]) * a[:, :, None, None] \
        + bias[None, :, None, None]


def batch_norm(x, scale, bias, *, state=None, train=True, per_image=False,
               groups=None, eps=1e-5, momentum=0.1, axis_name=None, act=None):
    """Torch SpatialBatchNormalization semantics, then the activation `act`
    (a key of `ACTIVATIONS`, or None).

    Train mode normalizes with biased batch statistics over (N, H, W), or
    over each image's own (H, W) with `per_image` — the JAX package's
    batch-of-one vmap (infer/tiled.py make_full_sr_fn) written out as a
    batch dimension.  Eval mode (`train=False`) uses `state`'s running
    statistics.

    `axis_name` (a parallel.Mesh: torch names the data axis by its group)
    makes the statistics cross-replica, as the JAX package's under
    shard_map: this rank's fp32 mean and mean of squares go to the ranks'
    mean as ONE concatenated collective (parallel/collectives.py pmean,
    whose backward sums the cotangents across ranks, JAX's transpose), and
    the running variance's n counts every rank's elements.  A sharded batch
    then normalizes as the whole batch would on one device.  The per-image
    and grouped statistics are inference modes and take no axis.

    A bf16 CUDA x with no gradient to carry and no `axis_name`
    (`bn.takes`) runs ops/bn.py's kernels, a ReLU or leaky ReLU folded into
    the second; anything else runs the plain composition below, its
    activation in an `act` span, and a CUDA x there counts in
    `bn.plain_cuda_calls`.  Both compute the same function.

    Returns (y, new_state); new_state = {"mean", "var"} running stats after
    a train-mode step (unbiased var, momentum 0.1, Torch defaults), None when
    `state` is None or the statistics are per image or per group.
    """
    if BN.takes(x, scale, bias, axis_name):
        running = None if train else (state["mean"], state["var"])
        fold = act if act in BN.ACTS else None
        y, mean, var = BN.bn_act(x, scale, bias, running=running,
                                 per_image=per_image, groups=groups, eps=eps,
                                 act=fold, slope=LRELU_SLOPE)
        if fold != act:
            y = activate(y, act)
        if not train:
            return y, state
    else:
        if x.is_cuda:
            BN.plain_cuda_calls += 1
        if not train:
            return activate(normalize(x, state["mean"], state["var"], scale,
                                      bias, eps), act), state
        mean, var = _train_stats(x, per_image, groups, axis_name)
        y = activate(normalize(x, mean, var, scale, bias, eps), act)
    new_state = None
    if state is not None and not per_image and groups is None:
        n = x.shape[0] * x.shape[2] * x.shape[3]
        if axis_name is not None:
            n *= axis_name.size
        unbiased = var * (n / max(n - 1, 1))
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean,
            "var": (1 - momentum) * state["var"] + momentum * unbiased,
        }
    return y, new_state


def _train_stats(x, per_image, groups, axis_name):
    """Train-mode (mean, var) of the plain path: `batch_stats`, or with
    `axis_name` the cross-replica pooled statistics."""
    if axis_name is None:
        return batch_stats(x, per_image, groups)
    if per_image or groups is not None:
        raise ValueError("cross-replica statistics (axis_name) are "
                         "pooled over the batch: per_image and groups "
                         "are inference modes and take no axis")
    from ..parallel.collectives import pmean
    xf = _stats_dtype(x)
    c = xf.shape[1]
    moments = pmean(torch.cat([xf.mean((0, 2, 3)),
                               (xf * xf).mean((0, 2, 3))]), axis_name)
    mean, mean_sq = moments[:c], moments[c:]
    return mean, mean_sq - mean * mean


def relu(x):
    return torch.clamp_min(x, 0)


LRELU_SLOPE = 0.2   # the leaky ReLU's slope in every network of the package


def leaky_relu(x, slope=LRELU_SLOPE):
    if x.dtype != torch.float32:    # a bf16 tensor meets bf16(0.2), as in XLA
        slope = torch.tensor(slope, dtype=x.dtype)
    return torch.where(x >= 0, x, x * slope)


def sigmoid(x):
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return one / (one + torch.exp(-x))      # jax.nn.sigmoid's bf16 steps


def tanh(x):
    return torch.tanh(x)


def prelu(x, slope):
    """Channel-wise PReLU: x where x >= 0, else slope[c] * x, one product
    rounded once; a bf16 x meets bf16 slopes.  The slopes are a layer's
    parameters, so the layer calls it in its own `act` span
    (models/network.py)."""
    return F.prelu(x, slope.to(x.dtype))


ACTIVATIONS = {"relu": relu, "lrelu": leaky_relu, "sigmoid": sigmoid,
               "tanh": tanh, "prelu": prelu}


def activate(x, act):
    """The activation `act` (a key of ACTIVATIONS but "prelu", which takes
    its slopes) of x in an `act` span, or x itself where `act` is None."""
    if act is None:
        return x
    with span("act"):
        return ACTIVATIONS[act](x)


def upsample_nearest(x, factor=2):
    """SpatialUpSamplingNearest: repeat each pixel factor x factor (NCHW)."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def pixel_shuffle(x, factor=2):
    """PixelShuffle (NCHW): channel c * r * r + i * r + j of x goes to
    channel c at (h * r + i, w * r + j), r = factor."""
    return F.pixel_shuffle(x, factor)
