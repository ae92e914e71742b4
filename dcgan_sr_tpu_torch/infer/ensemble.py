"""Geometric self-ensemble ("enhanced prediction", Timofte et al. 2016;
EDSR sec. 5.2): average the generator over the dihedral symmetries of its
input — transform the LR input, super-resolve, inverse-transform the output,
mean.  Port of dcgan_sr_tpu/infer/ensemble.py; a pure inference-time wrapper
(the reference has no ensembling; its eval is a single forward —
train-gray-3.lua:354-535).

Under train-mode BatchNorm each member normalizes with its own batch's
statistics — the exact rule the batch-stats inference applies to any forward
(tiled.py) — and the INPUT's per-channel moments are transform-invariant, so
the wrapper composes with both BN inference modes.  torch.rot90 and
torch.flip return strided views or copies; every consumer here (the
convolutions, the kernels' wrappers) takes either.
"""

from __future__ import annotations

import torch

# (rot90 quarter-turns k, hflip) — identity first so truncation keeps the
# plain forward; the first four shape-preserve on rectangles, odd k needs a
# square input.
_PLAN = ((0, False), (0, True), (2, False), (2, True),
         (1, False), (1, True), (3, False), (3, True))


def dihedral_plan(h, w, transforms):
    """The first `transforms` dihedral members legal for an (h, w) input."""
    if transforms < 1:
        raise ValueError(f"transforms must be >= 1, got {transforms}")
    plan = _PLAN if h == w else _PLAN[:4]
    return plan[:min(transforms, len(plan))]


def _members_of(x, plan):
    out = []
    for k, f in plan:
        xi = torch.rot90(x, k, dims=(-2, -1))
        out.append(torch.flip(xi, dims=(-1,)) if f else xi)
    return out


def _invert(ys, plan):
    out = []
    for (k, f), y in zip(plan, ys):
        if f:
            y = torch.flip(y, dims=(-1,))
        out.append(torch.rot90(y, -k, dims=(-2, -1)))
    return out


def self_ensemble(gen_fn, transforms=8, batched=False):
    """Wrap gen_fn(x, **kw) -> y with dihedral averaging.

    x, y: (..., H, W) with the spatial dims trailing (NCHW). transforms:
    1 = plain forward, 2 = + hflip, 4 = + rot180 pair (rectangle-safe),
    8 = full D4 (square inputs; rectangles fall back to 4).

    `batched=True` concatenates the N transformed copies on the leading
    (batch) axis and runs gen_fn ONCE on the (N*B, ...) batch — one
    generator call instead of N (x batched as (B, C, H, W)). With
    running-stats or no BN this is exact (same math, one call). With
    TRAIN-mode BN it is a close variant, not identical: the INPUT's moments
    are transform-invariant, but deeper activations are
    conv(rot(x)) != rot(conv(x)), so member batch moments diverge slightly
    and the joint batch pools them.
    """
    if transforms == 1:
        return gen_fn

    def wrapped(x, **kw):
        plan = dihedral_plan(x.shape[-2], x.shape[-1], transforms)
        ys = _invert([gen_fn(xi, **kw) for xi in _members_of(x, plan)], plan)
        return sum(ys) / len(ys)

    def wrapped_batched(x, **kw):
        # dihedral_plan only returns shape-preserving members (rectangles
        # get the flip subgroup), so the concat below is always legal
        plan = dihedral_plan(x.shape[-2], x.shape[-1], transforms)
        b = x.shape[0]
        y = gen_fn(torch.cat(_members_of(x, plan), dim=0), **kw)  # (N*B, ...)
        ys = _invert([y[i * b:(i + 1) * b] for i in range(len(plan))], plan)
        return sum(ys) / len(ys)

    return wrapped_batched if batched else wrapped
