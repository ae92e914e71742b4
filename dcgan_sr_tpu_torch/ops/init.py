"""Weight init with the reference's `weights_init` semantics (train.lua:42-51):

  - any Convolution: weight ~ N(0, 0.02), bias removed (`m:noBias()`)
  - any BatchNormalization: weight ~ N(1, 0.02), bias = 0

A port-only model's layers (SRGAN's generator, models/specs.py) add a conv
bias, 0, and PReLU slopes, 0.25 (He et al. 2015's initial slope); neither
draws from the generator, so the seven variants' draws are unchanged.

Port of dcgan_sr_tpu/ops/init.py.  Draws come from an explicit CPU
`torch.Generator`, so an init is reproducible from its seed; they are not
the numbers jax.random gives for the same seed (tests carry weights across
instead of comparing seeds).
"""

from __future__ import annotations

import torch


def init_conv(shape, generator, dtype=torch.float32):
    """Conv / conv-transpose weight ~ N(0, 0.02); no bias exists anywhere."""
    return 0.02 * torch.randn(shape, generator=generator, dtype=dtype)


def init_bn(num_features, generator, dtype=torch.float32):
    """BN scale ~ N(1, 0.02), bias 0; running stats start at (0, 1)."""
    scale = 1.0 + 0.02 * torch.randn((num_features,), generator=generator,
                                     dtype=dtype)
    bias = torch.zeros((num_features,), dtype=dtype)
    state = {"mean": torch.zeros((num_features,), dtype=dtype),
             "var": torch.ones((num_features,), dtype=dtype)}
    return scale, bias, state


PRELU_INIT = 0.25


def init_prelu(num_features, dtype=torch.float32):
    """Channel-wise PReLU slopes, all PRELU_INIT."""
    return torch.full((num_features,), PRELU_INIT, dtype=dtype)
