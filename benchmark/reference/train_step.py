"""The GAN train step of the full-image configurations, plain float32.

One step on a batch hr (B, C, H, W) in [0, 1] (train-gray-3.lua's step as
the port documents it): lr = the 2x2 box mean of hr; G's fake = G(lr)
with batch statistics; D on the real batch (its own statistics) and on the
fake batch (its own); BCE on D's logits against the labels; D's gradient
is that of errD_real + errD_fake; G's gradient pulls errG back through the
same, not yet updated, D and its fake-batch forward.  Then torch7's Adam
(eps outside the bias correction) updates D and G.

The state is a dict: "g", "d" (lists of per-layer parameter dicts, as in
nets.py) and "adam" ({"g": {"m", "v"}, "d": {...}, "t": int}).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nets
from .precision import exact_fp32, rounding

TRAINABLE = ("w", "bn_scale", "bn_bias")


def leaves(net_params):
    """The trainable tensors of a network, layer by layer, in the order
    (w, bn_scale, bn_bias)."""
    return [p[k] for p in net_params for k in TRAINABLE if k in p]


def leaf_names(net_params):
    """Names of `leaves(net_params)`: "<layer>.<tensor>"."""
    return [f"{i}.{k}" for i, p in enumerate(net_params) for k in TRAINABLE
            if k in p]


def init_state(g_params, d_params):
    """A state from weights (copied, float32) with zero Adam moments."""
    def copy(ps):
        return [{k: v.detach().clone().float() for k, v in p.items()}
                for p in ps]
    g, d = copy(g_params), copy(d_params)
    adam = {"t": 0}
    for tag, ps in (("g", g), ("d", d)):
        adam[tag] = {"m": [torch.zeros_like(t) for t in leaves(ps)],
                     "v": [torch.zeros_like(t) for t in leaves(ps)]}
    return {"g": g, "d": d, "adam": adam}


def _adam(params, grads, st, t, cfg):
    lr, b1, b2, eps = cfg["lr"], cfg["beta1"], cfg["beta2"], cfg["eps"]
    step = lr * (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
    for p, g, m, v in zip(params, grads, st["m"], st["v"]):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        p.sub_(step * m / (v.sqrt() + eps))


def step(state, hr, g_spec, d_spec, cfg, precision="fp32", batch_rows=None):
    """One step, in place on `state`; returns the losses as floats.
    `batch_rows` (a fault for the checks' own test) keeps only the first
    rows of the batch."""
    rnd = rounding(precision)
    if batch_rows is not None:
        hr = hr[:batch_rows]
    hr = hr.float()
    with exact_fp32():
        lr_img = F.avg_pool2d(hr, 2)
        gp, dp = leaves(state["g"]), leaves(state["d"])
        for t in gp + dp:
            t.requires_grad_(True)
        fake = nets.forward(g_spec, state["g"], lr_img, "pooled", rnd=rnd)
        out_real = nets.forward(d_spec, state["d"], hr, "pooled",
                                logits=True, rnd=rnd)
        ones = torch.full_like(out_real, cfg["real_label"])
        err_d_real = F.binary_cross_entropy_with_logits(out_real, ones)
        gd_real = torch.autograd.grad(err_d_real, dp)
        out_fake = nets.forward(d_spec, state["d"], fake, "pooled",
                                logits=True, rnd=rnd)
        err_d_fake = F.binary_cross_entropy_with_logits(
            out_fake, torch.full_like(out_fake, cfg["fake_label"]))
        err_g = F.binary_cross_entropy_with_logits(
            out_fake, torch.full_like(out_fake, cfg["g_label"]))
        gd_fake = torch.autograd.grad(err_d_fake, dp, retain_graph=True)
        gg = torch.autograd.grad(err_g, gp)
        for t in gp + dp:
            t.requires_grad_(False)
        with torch.no_grad():
            state["adam"]["t"] += 1
            t = state["adam"]["t"]
            _adam(dp, [a + b for a, b in zip(gd_real, gd_fake)],
                  state["adam"]["d"], t, cfg)
            _adam(gp, gg, state["adam"]["g"], t, cfg)
    return {"errD_real": float(err_d_real.detach()),
            "errD_fake": float(err_d_fake.detach()),
            "errG": float(err_g.detach())}
