"""Exact rewrites of the k4s2p1 conv pair into k3s1p1 convolutions (port of
dcgan_sr_tpu/ops/fast.py; the trainer's `--fast-ops`).

  conv_transpose2d k4s2p1  ==  conv k3s1p1 emitting (Co, u, v) sub-pixel
                               channels, then depth_to_space(2)
    derivation: out[2p+u] = sum_t x[(2p+u+1-t)/2] w[t] for t = u+1 (mod 2);
    as a k3 window i = p-1+alpha:
      u=0: alpha=0 -> w[3], alpha=1 -> w[1]
      u=1: alpha=1 -> w[2], alpha=2 -> w[0]     (others structurally zero)

  conv2d k4s2p1            ==  conv k3s1p1 on space_to_depth(x, 2) input
    derivation: out[j] = sum_t w[t] x[2j-1+t]; x[2(j+gamma)+u]:
      gamma=-1: u=1 -> w[0]
      gamma= 0: u=0 -> w[1], u=1 -> w[2]
      gamma=+1: u=0 -> w[3]                     (others structurally zero)

Both are the originals up to the order of the fp32 sums: the structural
zeros contribute exact 0s.  The folded convolution does 9 * 4 taps where
the original does 16, 2.25x the multiply-adds.

The layout maps are PyTorch's pixel_unshuffle / pixel_shuffle, whose
channel order is the JAX package's (c, u, v).  A folded kernel is a gather
from `w` (each of its 16 taps lands in exactly one place, the rest read a
zero appended to the taps) through an index table built once per device:
differentiable, and inside a CUDA graph nothing but device work.

The convolutions are ops/nn.py's `conv2d`: fp32 with TF32 off, as the JAX
package runs Precision.HIGHEST.  In bf16 they follow that module's rule for
a dw that is not k4s2p1 (a k3s1p1 one): the folded kernel's gradient is
rounded to bf16, then taken to the fp32 master through the gather.  That is
JAX's plain autodiff of its fast path, which runs lax.conv_general_dilated
and not the custom VJPs that keep a k4s2p1 dw in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import conv2d

# 1-D factors: (phase u, window offset) -> tap of the 4-wide kernel axis
_TAPS = {"subpixel": {(0, 0): 3, (0, 1): 1, (1, 1): 2, (1, 2): 0},
         "s2d": {(1, 0): 0, (0, 1): 1, (1, 1): 2, (0, 2): 3}}
_ZERO = 16                      # the zero appended after the 4 x 4 taps
_tables = {}


def _table(kind, device):
    """(2, 2, 3, 3) int64 on `device`: [u, v, a, b] -> the flat tap
    row * 4 + col of the window offsets (a, b) in phases (u, v), or _ZERO."""
    if (kind, device) not in _tables:
        taps = _TAPS[kind]
        idx = [[[[taps[u, a] * 4 + taps[v, b]
                  if (u, a) in taps and (v, b) in taps else _ZERO
                  for b in range(3)] for a in range(3)]
                for v in range(2)] for u in range(2)]
        _tables[kind, device] = torch.tensor(idx, dtype=torch.int64, device=device)
    return _tables[kind, device]


def _gather(w, kind):
    """w (A, B, 4, 4) -> (A, B, 2, 2, 3, 3): [.., u, v, a, b] by `kind`'s
    taps."""
    a, b = w.shape[0], w.shape[1]
    flat = F.pad(w.reshape(a, b, 16), (0, 1))
    return flat[:, :, _table(kind, w.device)]


def space_to_depth(x, f=2):
    """(B, C, H, W) -> (B, C*f*f, H/f, W/f); channel order (c, u, v)."""
    return F.pixel_unshuffle(x, f)


def depth_to_space(x, f=2):
    """Inverse of space_to_depth: (B, C*f*f, H, W) -> (B, C, H*f, W*f)."""
    return F.pixel_shuffle(x, f)


def _subpixel_kernel(w):
    """(Ci, Co, 4, 4) convT weight -> (4*Co, Ci, 3, 3) sub-pixel conv kernel.

    Output channel order ((co, u, v)) matches space_to_depth so
    depth_to_space recovers the true layout.
    """
    ci, co = w.shape[0], w.shape[1]
    k = _gather(w, "subpixel")                   # (Ci, Co, u, v, a, b)
    return k.permute(1, 2, 3, 0, 4, 5).reshape(4 * co, ci, 3, 3)


def _s2d_kernel(w):
    """(Co, Ci, 4, 4) stride-2 conv weight -> (Co, 4*Ci, 3, 3) folded kernel.

    Input channel order ((ci, u, v)) matches space_to_depth(x, 2).
    """
    co, ci = w.shape[0], w.shape[1]
    return _gather(w, "s2d").reshape(co, 4 * ci, 3, 3)


def conv_transpose2d_subpixel(x, w, *, compute_dtype=None):
    """Exact k4s2p1 transposed conv via sub-pixel k3s1p1 conv (+d2s).

    x: (B, Ci, H, W); w: (Ci, Co, 4, 4) torch layout -> (B, Co, 2H, 2W).
    """
    y = conv2d(x, _subpixel_kernel(w), 1, 1, compute_dtype=compute_dtype)
    return depth_to_space(y, 2)


def conv2d_s2d(x, w, *, compute_dtype=None):
    """Exact k4s2p1 stride-2 conv via k3s1p1 conv on s2d-folded input.

    x: (B, Ci, H, W); w: (Co, Ci, 4, 4) -> (B, Co, H/2, W/2).
    """
    return conv2d(space_to_depth(x, 2), _s2d_kernel(w), 1, 1,
                  compute_dtype=compute_dtype)
