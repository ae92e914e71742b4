"""Image ops with torch7-`image` semantics (port of dcgan_sr_tpu/image/ops.py).

  - box_downsample2: lr[i,j] = mean of the 2x2 HR block (train.lua:226-230) —
    the degradation model that defines the SR task.
  - rgb2gray: 0.21 R + 0.72 G + 0.07 B (train-gray.lua:54-76; intentionally
    NOT the usual 0.299/0.587/0.114 — see the comment at :55).
  - resize_bilinear: torch7 image.scale's bilinear uses endpoint-aligned
    sampling (scale = (in-1)/(out-1), i.e. align_corners=True), as two
    dense fp32 matrix products.
  - gaussian_window/convolve_full: image.gaussian(11, 1.5/11, amplitude) +
    image.convolve(.., 'full') as used by calSSIM (train-gray-3.lua:201-207);
    'full' output is (H+k-1, W+k-1).  The window is computed in float64 with
    numpy, exactly as the JAX package does, then cast to fp32; the
    convolution runs with TF32 off (ops/nn.py fp32_convs).
  - crop_hflip_at: the trainHook's crop + hflip (donkey_folder.lua:63-67) as
    one batched gather at host-drawn offsets.
  - to_display: image.toDisplayTensor min-max rescale to [0,1], constant
    images map to 0 (probed by the reference's test_tensor_to_image.lua).
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


def luma_rec601(x):
    """torch image.load(path, 1) grayscale conversion (rgb2y): .299/.587/.114."""
    r, g, b = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    return 0.299 * r + 0.587 * g + 0.114 * b


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


@functools.lru_cache(maxsize=8)
def _gaussian_np(size: int, sigma_rel: float) -> np.ndarray:
    """torch image.gaussian(size, sigma, amp): center size/2+0.5 (1-indexed),
    absolute sigma = sigma_rel*size; normalized to sum 1 (calSSIM divides by sum)."""
    sigma = sigma_rel * size
    c = size / 2 + 0.5  # 1-indexed center
    i = np.arange(1, size + 1, dtype=np.float64)
    g1 = np.exp(-(((i - c) / sigma) ** 2) / 2)
    k = np.outer(g1, g1)
    return (k / k.sum()).astype(np.float32)


def gaussian_window(size=11, sigma_rel=1.5 / 11, *, device="cpu"):
    """The (size, size) fp32 window on `device`."""
    return torch.from_numpy(_gaussian_np(size, sigma_rel)).to(device)


def convolve_full(img, kernel):
    """2-D true convolution, 'full' mode: (..., H, W) -> (..., H+k-1, W+k-1)
    like image.convolve; every leading index is convolved on its own."""
    from ..ops.nn import fp32_convs

    k = kernel.shape[-1]
    lead, (h, w) = tuple(img.shape[:-2]), tuple(img.shape[-2:])
    x = img.reshape(-1, 1, h, w)
    wt = torch.flip(kernel, dims=(0, 1))[None, None].to(x.dtype)
    with fp32_convs():
        y = torch.nn.functional.conv2d(x, wt, padding=k - 1)
    return y.reshape(lead + tuple(y.shape[-2:]))


def crop(x, top, left, h, w):
    """Static crop of the last two dims (image.crop, donkey_folder.lua:63)."""
    return x[..., top:top + h, left:left + w]


def hflip(x):
    """Horizontal flip of the last dim (image.hflip, donkey_folder.lua:67)."""
    return torch.flip(x, dims=(-1,))


def check_crop_offsets(tops, lefts, hw, fine):
    """Raise unless every fine x fine window at (tops[i], lefts[i]) lies
    inside an (H, W) = `hw` canvas.  Offsets are host arrays: the JAX
    package's dynamic_slice would clamp an offset that is out of range, and
    a gather on the card would fail on the device instead of here."""
    t, le = np.asarray(tops), np.asarray(lefts)
    h, w = hw
    if t.size and (t.min() < 0 or t.max() > h - fine
                   or le.min() < 0 or le.max() > w - fine):
        raise ValueError(
            f"crop offsets out of range for a {fine}x{fine} crop of a "
            f"{h}x{w} canvas: tops {t.min()}..{t.max()}, lefts "
            f"{le.min()}..{le.max()}")


def crop_hflip_at(batch, tops, lefts, flips, fine):
    """The trainHook's crop + flip at given per-image offsets, batched
    (donkey_folder.lua:63-67: the pixel work of image.crop + image.hflip, on
    the batch's device).

    batch: (B, C, H, W) with H, W >= fine; tops/lefts: (B,) int offsets with
    top + fine <= H (resp. left + fine <= W); flips: (B,) bool.  The offsets
    are drawn on the HOST (data/folder.py sample_canvas) with the
    reference's single uniform draw over the full aspect-resized image, so
    the crop distribution is exactly the donkey trainHook's; only the
    O(pixels) work moves to the device.  Offsets given on the host (numpy or
    CPU tensors) are checked here (check_crop_offsets); offsets already on
    the card were checked before they were copied (train/loop.py).  The
    result is a gather of the batch's own values: bit-equal to slicing.
    """
    dev = batch.device
    tops, lefts, flips = (torch.as_tensor(a) for a in (tops, lefts, flips))
    if tops.device.type == "cpu":
        check_crop_offsets(tops.numpy(), lefts.numpy(), batch.shape[-2:], fine)
    tops, lefts = tops.to(dev, torch.int64), lefts.to(dev, torch.int64)
    flips = flips.to(dev, torch.bool)
    ar = torch.arange(fine, device=dev)
    rows = tops[:, None] + ar                                   # (B, fine)
    cols = lefts[:, None] + torch.where(flips[:, None], fine - 1 - ar, ar)
    b, c = batch.shape[0], batch.shape[1]
    bi = torch.arange(b, device=dev)[:, None, None, None]
    ci = torch.arange(c, device=dev)[None, :, None, None]
    return batch[bi, ci, rows[:, None, :, None], cols[:, None, None, :]]


def random_crop_hflip(generator, batch, fine):
    """`crop_hflip_at` with offsets and coins drawn from `generator` (a CPU
    torch.Generator, in place of the JAX key): per-image random crop to
    `fine` and hflip with p=0.5 (donkey_folder.lua:52-70).  Offsets in the
    reference's range ceil(uniform(1e-2, dim-fine)) = {1..dim-fine} (offset 0
    is never sampled unless dim == fine).  NOTE: uniform over the BATCH
    canvas only; the train step takes host-drawn offsets (crop_hflip_at)."""
    b, _, h, w = batch.shape
    tops = torch.randint(min(1, h - fine), h - fine + 1, (b,),
                         generator=generator)
    lefts = torch.randint(min(1, w - fine), w - fine + 1, (b,),
                          generator=generator)
    flips = torch.rand((b,), generator=generator) < 0.5
    return crop_hflip_at(batch, tops, lefts, flips, fine)


def to_display(x):
    """image.toDisplayTensor min-max rescale: (x-min)/(max-min); constant -> 0."""
    x = torch.as_tensor(x)
    lo, hi = x.min(), x.max()
    rng = hi - lo
    return torch.where(rng > 0, (x - lo) / torch.where(rng > 0, rng, 1.0),
                       torch.zeros_like(x))
