"""PSNR / SSIM / per-image-MSE metrics with the reference's exact formulas
(port of dcgan_sr_tpu/metrics/psnr_ssim.py).

  cal_psnr        MSE = sum((a-b)^2)/(H*W); 10*log10(1/MSE); MSE<=0 -> 99
                  (train-gray-3.lua:143-151; assumes [0,1] range)
  cal_mse_quarter per-image sum/(4*C*H*W) — D's fake label in train.lua:193-195
  cal_mse_hw      per-image sum/(H*W)     — train-gray.lua:199-201 (the divisor
                  is H*W regardless of channel count)
  cal_ssim        Wang et al. SSIM with K1=.01 K2=.03 L=255, 11x11 Gaussian
                  sigma 1.5, 'full' convolution, and the reference's
                  (x+1)/2*255 input rescale — applied even when the generator
                  outputs [0,1] (train-gray-3.lua:156-221, quirk at :192-193).

The batched forms take (B, H, W) and return (B,) with no loop over images:
SSIM stacks its five maps (x, y, x^2, y^2, xy) into one (B, 5, H, W) tensor
and runs a single 'full' convolution over it (image/ops.py convolve_full,
which keeps TF32 off: σ is E[x^2] - μ^2 at the 0-255 scale, a cancellation
that TF32 would move in the third decimal).
"""

from __future__ import annotations

import torch

from ..image.ops import convolve_full, gaussian_window


def cal_psnr(img1, img2):
    """PSNR over 2-D images (peak 1.0) as a 0-d tensor; MSE<=0 clamps to 99."""
    return cal_psnr_batch(torch.as_tensor(img1)[None],
                          torch.as_tensor(img2)[None])[0]


def cal_psnr_batch(a, b):
    """cal_psnr over the leading axis of (B, H, W) arrays -> (B,)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    h, w = a.shape[-2], a.shape[-1]
    mse = torch.sum((a - b) ** 2, dim=(-2, -1)) / (h * w)
    return torch.where(mse > 0,
                       10.0 * torch.log10(1.0 / torch.clamp_min(mse, 1e-38)),
                       torch.full_like(mse, 99.0))


def cal_mse_quarter(real, fake):
    """Per-image sum((r-f)^2)/(4*C*H*W) over (B, C, H, W) -> (B,) (train.lua:193)."""
    c, h, w = real.shape[-3], real.shape[-2], real.shape[-1]
    return torch.sum((real - fake) ** 2, dim=(-3, -2, -1)) / (4 * c * h * w)


def cal_mse_hw(real, fake):
    """Per-image sum((r-f)^2)/(H*W) over (B, C, H, W) -> (B,) (train-gray.lua:199)."""
    h, w = real.shape[-2], real.shape[-1]
    return torch.sum((real - fake) ** 2, dim=(-3, -2, -1)) / (h * w)


_K1, _K2, _L = 0.01, 0.03, 255.0
_C1 = (_K1 * _L) ** 2
_C2 = (_K2 * _L) ** 2


def cal_ssim(img1, img2):
    """Mean SSIM between two 2-D images, reference-exact (train-gray-3.lua:156-221)."""
    return cal_ssim_batch(torch.as_tensor(img1)[None],
                          torch.as_tensor(img2)[None])[0]


def cal_ssim_batch(a, b):
    """cal_ssim over the leading axis of (B, H, W) arrays -> (B,)."""
    x = (torch.as_tensor(a).float() + 1.0) / 2.0 * 255.0
    y = (torch.as_tensor(b).float() + 1.0) / 2.0 * 255.0
    win = gaussian_window(11, 1.5 / 11, device=x.device)
    maps = torch.stack([x, y, x * x, y * y, x * y], dim=1)    # (B, 5, H, W)
    f = convolve_full(maps, win)
    mu1, mu2 = f[:, 0], f[:, 1]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = f[:, 2] - mu1_sq
    sigma2_sq = f[:, 3] - mu2_sq
    sigma12 = f[:, 4] - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + _C1) * (2 * sigma12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2))
    return ssim_map.mean(dim=(-2, -1))
