"""Criteria and the reference's three label schemes (port of
dcgan_sr_tpu/losses/schemes.py).

  - nn.MSECriterion / nn.BCECriterion, size-averaged (train.lua:142,
    train-gray-3.lua:101).
  - Label schemes (SURVEY.md §7.1): standard BCE (real 1 / fake 0 / G 1) and
    the error-regression MSE variants where D's fake target is the per-image
    reconstruction error (train.lua:237-245, train-gray.lua:258-265) and the
    real/G targets are small constants that differ per script.
"""

from __future__ import annotations

import torch

from ..metrics import cal_mse_hw, cal_mse_quarter

_BCE_EPS = 1e-12


def mse_loss(pred, target):
    """Size-averaged MSE over a (B,) prediction vector."""
    return torch.mean((pred - target) ** 2)


def bce_loss(pred, target):
    """Size-averaged binary cross-entropy; pred in (0,1) from a Sigmoid head,
    clamped away from {0,1} as the JAX package clamps it."""
    p = torch.clamp(pred, _BCE_EPS, 1.0 - _BCE_EPS)
    return -torch.mean(target * torch.log(p)
                       + (1.0 - target) * torch.log(1.0 - p))


def bce_with_logits_loss(logits, target):
    """BCE fused with the sigmoid head, evaluated from logits in the JAX
    package's formula, max(l, 0) - l*t + log1p(exp(-|l|)), so the fp32
    result matches term for term.  The train step uses this for the BCE
    variants (D's Sigmoid is folded into the loss)."""
    logits = logits.float()
    return torch.mean(torch.clamp_min(logits, 0.0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def criterion(cfg):
    return bce_loss if cfg.loss == "bce" else mse_loss


def make_labels(cfg, real, fake):
    """Returns (real_label_vec, fake_label_vec, g_label_vec), each (B,).

    `fake_label` may be the string "per_image_mse" (train-gray.lua:258-265,
    divisor H*W) or "per_image_quarter_mse" (train.lua:237-245, divisor
    4*C*H*W); those targets are plain numbers in the reference — no gradient
    flows through them (the caller detaches fake first).
    """
    b = real.shape[0]
    full = lambda v: torch.full((b,), float(v), dtype=torch.float32,  # noqa: E731
                                device=real.device)
    if cfg.fake_label == "per_image_mse":
        fake_vec = cal_mse_hw(real, fake)
    elif cfg.fake_label == "per_image_quarter_mse":
        fake_vec = cal_mse_quarter(real, fake)
    else:
        fake_vec = full(cfg.fake_label)
    return full(cfg.real_label), fake_vec, full(cfg.g_label)
