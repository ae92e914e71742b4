"""PSNR and the per-image MSEs with the reference's exact formulas (port of
those parts of dcgan_sr_tpu/metrics/psnr_ssim.py; SSIM waits for the eval
slice).

  cal_psnr        MSE = sum((a-b)^2)/(H*W); 10*log10(1/MSE); MSE<=0 -> 99
                  (train-gray-3.lua:143-151; assumes [0,1] range)
  cal_mse_quarter per-image sum/(4*C*H*W) — D's fake label in train.lua:193-195
  cal_mse_hw      per-image sum/(H*W)     — train-gray.lua:199-201 (the divisor
                  is H*W regardless of channel count)
"""

from __future__ import annotations

import torch


def cal_psnr(img1, img2):
    """PSNR over 2-D images (peak 1.0) as a 0-d tensor; MSE<=0 clamps to 99."""
    img1, img2 = torch.as_tensor(img1), torch.as_tensor(img2)
    h, w = img1.shape[-2], img1.shape[-1]
    mse = torch.sum((img1 - img2) ** 2) / (h * w)
    return torch.where(mse > 0,
                       10.0 * torch.log10(1.0 / torch.clamp_min(mse, 1e-38)),
                       torch.full_like(mse, 99.0))


def cal_psnr_batch(a, b):
    """cal_psnr over the leading axis of (B, H, W) arrays -> (B,)."""
    return torch.stack([cal_psnr(x, y) for x, y in
                        zip(torch.as_tensor(a), torch.as_tensor(b))])


def cal_mse_quarter(real, fake):
    """Per-image sum((r-f)^2)/(4*C*H*W) over (B, C, H, W) -> (B,) (train.lua:193)."""
    c, h, w = real.shape[-3], real.shape[-2], real.shape[-1]
    return torch.sum((real - fake) ** 2, dim=(-3, -2, -1)) / (4 * c * h * w)


def cal_mse_hw(real, fake):
    """Per-image sum((r-f)^2)/(H*W) over (B, C, H, W) -> (B,) (train-gray.lua:199)."""
    h, w = real.shape[-2], real.shape[-1]
    return torch.sum((real - fake) ** 2, dim=(-3, -2, -1)) / (h * w)
