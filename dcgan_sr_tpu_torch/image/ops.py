"""Image ops with torch7-`image` semantics (port of dcgan_sr_tpu/image/ops.py,
the parts full-image SR, its PSNR lines and the training step use).

  - box_downsample2: lr[i,j] = mean of the 2x2 HR block (train.lua:226-230) —
    the degradation model that defines the SR task.
  - rgb2gray: 0.21 R + 0.72 G + 0.07 B (train-gray.lua:54-76; intentionally
    NOT the usual 0.299/0.587/0.114 — see the comment at :55).
  - resize_bilinear: torch7 image.scale's bilinear uses endpoint-aligned
    sampling (scale = (in-1)/(out-1), i.e. align_corners=True), as two
    dense fp32 matrix products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def box_downsample2(x):
    """2x2 box mean over the last two (spatial) dims; works for HW/CHW/NCHW.

    Written as ((a + c) + (b + d)) * 0.25 over the four strided views, the
    order of ops/preprocess.py: three elementwise sums whose rounding does
    not depend on the tensor's shape (a reduction's may, on the card), so
    degrading an image and cutting tiles commute bit for bit — what
    make_overlap_sr_fn's lr_input mode rests on."""
    a, b = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
    c, d = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
    return ((a + c) + (b + d)) * 0.25


def rgb2gray(x):
    """Reference weights .21/.72/.07 over the channel axis (-3)."""
    r, g, b = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    return 0.21 * r + 0.72 * g + 0.07 * b


def normalize_pm1(x):
    """[0,1] -> [-1,1] (`out:mul(2):add(-1)`, donkey_folder.lua:68)."""
    return x * 2.0 - 1.0


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) interpolation matrix, endpoint-aligned like image.scale."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    scale = (n_in - 1) / (n_out - 1)
    src = np.arange(n_out) * scale
    lo = np.clip(np.floor(src).astype(int), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = (src - lo).astype(np.float32)
    m[np.arange(n_out), lo] += 1 - frac
    m[np.arange(n_out), hi] += frac
    return m


def resize_bilinear(x, out_h, out_w):
    """Bilinear resize of the last two dims via two dense matrix products."""
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x
    a = torch.from_numpy(_bilinear_matrix(h, out_h)).to(x.device)
    b = torch.from_numpy(_bilinear_matrix(w, out_w)).to(x.device)
    y = torch.einsum("oh,...hw->...ow", a, x)
    return torch.einsum("pw,...ow->...op", b, y)
