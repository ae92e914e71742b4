"""The GAN train step: fDx + fGx + both Adam updates, on one device.

Port of dcgan_sr_tpu/train/step.py, point for point (reference structure
train.lua:208-283):

  fDx: D forward/backward on the real batch -> degrade -> G forward ->
       per-image labels -> D forward/backward on the fake batch -> adam(D)
  fGx: REUSES D's fake-pass output -> backprop through D into G (no second
       forward) -> adam(G)

The JAX package expresses the reuse with jax.vjp; here autograd keeps one
graph of the D-fake forward and pulls back through it twice
(`torch.autograd.grad`, the first with `retain_graph=True`): once under
err_d_fake to D's parameters, once under err_g to `fake`.  G's gradient
therefore flows through the pre-update D that produced the output, which is
the reading the JAX package documents as the reference's intent.

BN ordering: D normalizes the real batch with real-batch statistics and the
fake batch with fake-batch statistics, in that order, and its running
statistics move real pass first, fake pass second.

Unlike the JAX step, which returns a new state, this one updates `state` in
place (parameters, running statistics, Adam moments, EMA) and returns the
same object: all in-place writes happen under no_grad after both pullbacks,
so no retained graph ever sees a modified tensor.  fp32 convolutions run with
TF32 off in the forward and in every pullback (ops/nn.py).

cfg.compute_dtype "bfloat16" (the JAX step's compute_dtype, `--bf16`): both
networks compute in bf16 from their fp32 master parameters and hand fp32
back to the losses (models/network.py); gradients reach the fp32 masters
through the casts, and Adam updates the masters in fp32.  The preprocess
still sees fp32: a bf16 feed is upcast first.

cfg.fast_ops (`--fast-ops`): both networks run every unfused k4s2p1 conv
and convT on an even input in its k3s1p1 form (ops/fast.py), as the JAX
step passes fast= to apply_network; the option belongs to the step, not to
the state.  cfg.compact_params (`--compact-params`): the state's conv
masters and Adam moments are 2-D (ops/compact.py, init_train_state); the
step itself is unchanged, since each layer views its master as 4-D.

cfg.device_preprocess (`--device-preprocess`): the batch is raw [0,1] RGB
from the folder loader, and the fused preprocess (K1) also gray-converts
(nc = 1) and maps to [-1,1] (pm1 variants).  cfg.device_augment
(`--device-augment`, which turns device_preprocess on): the batch is the
tuple (canvas, tops, lefts, flips) of data/folder.py sample_canvas, and the
trainHook's crop + hflip run on the device (image/ops.py crop_hflip_at)
before the preprocess.

Data parallel (`axis_name`, a parallel.Mesh; parallel/dp.py builds the
step with it): each rank runs this step on its slice of the global batch
with a replicated state.  Every train-mode BN takes cross-replica
statistics (ops/nn.py), whose backward sums the moments' cotangents across
ranks, as JAX transposes its pmean; then D's and G's gradients are
pmean'd, each network's as ONE flattened all_reduce, and so are the losses
(one more), before the replicated Adam updates.  The pixel loss's
cotangent keeps the local `fake.numel()`, as in JAX.  A world of one is
the single-device step, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..image.ops import crop_hflip_at
from ..losses.schemes import bce_with_logits_loss, criterion, make_labels
from ..models import Network, discriminator_spec, generator_spec, init_network
from ..ops.adam import adam_init, adam_update_
from ..ops.compact import pack_state
from ..ops.preprocess import preprocess
from ..parallel.collectives import pmean


@dataclasses.dataclass
class TrainState:
    """Both networks (parameters and BN running statistics live in the
    modules), both Adam states ({"m", "v"}: lists in `params_of` order,
    "t": a 0-d int32 tensor on the device) and, with cfg.g_ema > 0, the EMA
    copy of G's parameters in the same order (else None).  A step writes
    every one of these tensors in place and rebinds none, so a CUDA graph
    of steps (train/multi_step.py) keeps addressing the live state."""
    g: Network
    d: Network
    g_opt: Any
    d_opt: Any
    g_ema: Optional[list] = None


def params_of(net):
    """The network's trainable tensors as a flat list, layer by layer."""
    return list(net.parameters())


def init_train_state(cfg, generator, device="cuda"):
    """A fresh state on `device`, drawn from `generator` (a CPU
    torch.Generator): G first, then D.  Under cfg.compact_params the conv
    masters and their moments take ops/compact.py's 2-D layout (the JAX
    init_train_state's pack_state)."""
    g_spec, d_spec = generator_spec(cfg), discriminator_spec(cfg)
    g = Network(g_spec, *init_network(g_spec, generator), device=device,
                fuse=False, trainable=True)
    d = Network(d_spec, *init_network(d_spec, generator), device=device,
                fuse=False, trainable=True)
    ema = None
    if cfg.g_ema > 0:
        ema = [p.detach().clone() for p in params_of(g)]
    state = TrainState(g=g, d=d, g_opt=adam_init(params_of(g)),
                       d_opt=adam_init(params_of(d)), g_ema=ema)
    if cfg.compact_params:
        state = pack_state(state, g_spec, d_spec)
    return state


# ---- carried across: the JAX package's TrainState leaves as numpy ----------

def _tree_like(net, flat):
    """`flat` (a list in params_of order) in the JAX per-layer dict
    structure of `net`'s parameters."""
    it = iter(flat)
    return [{k: next(it) for k in dict(layer.named_parameters(recurse=False))}
            for layer in net.layers]


def _flat_like(net, tree):
    return [tree[i][k] for i, layer in enumerate(net.layers)
            for k in dict(layer.named_parameters(recurse=False))]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().cpu().numpy().copy()


def state_to_numpy(state):
    """The state as numpy leaves in the JAX package's TrainState structure:
    a dict of its seven fields (`g_params`, `g_state`, `g_opt`, `d_params`,
    `d_state`, `d_opt`, `g_ema_params`), `opt` = {"m", "v", "t": int32}."""
    out = {}
    for tag, net, opt in (("g", state.g, state.g_opt),
                          ("d", state.d, state.d_opt)):
        params, bn = net.trees()
        out[f"{tag}_params"], out[f"{tag}_state"] = _np(params), _np(bn)
        out[f"{tag}_opt"] = {"m": _np(_tree_like(net, opt["m"])),
                             "v": _np(_tree_like(net, opt["v"])),
                             "t": np.asarray(int(opt["t"]), np.int32)}
    out["g_ema_params"] = (None if state.g_ema is None
                           else _np(_tree_like(state.g, state.g_ema)))
    return out


def state_from_numpy(cfg, tree, device="cuda"):
    """The port's TrainState from the seven fields of the JAX package's, as
    numpy arrays (see `state_to_numpy`)."""
    return state_from_trees(generator_spec(cfg), discriminator_spec(cfg),
                            tree, device)


def state_from_trees(g_spec, d_spec, tree, device):
    """`state_from_numpy` for given specs (a checkpoint loads into its
    template's)."""
    as_t = lambda a: torch.from_numpy(  # noqa: E731  (a copy)
        np.array(a, dtype=np.float32)).to(device)
    g = Network(g_spec, tree["g_params"], tree["g_state"],
                device=device, fuse=False, trainable=True)
    d = Network(d_spec, tree["d_params"], tree["d_state"],
                device=device, fuse=False, trainable=True)
    state = TrainState(g=g, d=d, g_opt=None, d_opt=None)
    for tag, net in (("g", g), ("d", d)):
        opt = tree[f"{tag}_opt"]
        setattr(state, f"{tag}_opt", {
            "m": [as_t(a) for a in _flat_like(net, opt["m"])],
            "v": [as_t(a) for a in _flat_like(net, opt["v"])],
            "t": torch.tensor(int(opt["t"]), dtype=torch.int32,
                              device=device)})
    if tree.get("g_ema_params") is not None:
        state.g_ema = [as_t(a) for a in _flat_like(g, tree["g_ema_params"])]
    return state


# ---- the step ---------------------------------------------------------------

def _no_mark(name):
    pass


def build_train_step(cfg, *, axis_name=None, preprocess_fn=preprocess):
    """Returns train_step(state, hr_batch) -> (state, metrics).

    axis_name: None (one device), or the data axis's parallel.Mesh (torch
    names an axis by its process group); then hr_batch is this rank's
    slice and the step is the data-parallel one (module docstring).

    hr_batch: (B, C, H, W) in the variant's data range, float32 or (a
    bfloat16 feed) bfloat16, on the state's device; raw [0,1] RGB under
    cfg.device_preprocess; under cfg.device_augment the tuple (canvas,
    tops, lefts, flips), every leaf on the device.  metrics: the JAX step's
    six scalars as 0-d device tensors; reading one is the only thing that
    waits for the device.

    `preprocess_fn` computes (hr, lr) from the batch; it exists so that a
    check can run this same step with `ops.preprocess.preprocess_plain` on
    the card.  `train_step` also takes `mark=`, a callable named after each
    stage of the step as it is queued (chip_smoke.py records a CUDA event
    in it to see where the time goes).
    """
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    fast = cfg.fast_ops
    if isinstance(axis_name, str):
        raise TypeError("axis_name is the data axis's parallel.Mesh (torch "
                        "names an axis by its process group), not a name")

    crit = criterion(cfg)
    # fold D's Sigmoid head into the loss (bce_with_logits): identical math
    # to BCECriterion-on-sigmoid, but stable when D saturates
    fold = cfg.loss == "bce"
    if fold:
        crit = bce_with_logits_loss
    adam_kw = dict(lr=cfg.lr, beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps)
    # cfg.use_pallas is read nowhere: it stays in the config copy (held equal
    # to the JAX package's) and has no effect here, because this step always
    # takes (hr, lr) from the fused preprocess, flags off included
    rgb_to_gray = cfg.device_preprocess and cfg.nc == 1
    to_pm1 = cfg.device_preprocess and cfg.data_range == "pm1"
    device_augment, fine_size = cfg.device_augment, cfg.fineSize
    grad = torch.autograd.grad

    def step(state, hr, mark=_no_mark):
        if device_augment:
            hr, tops, lefts, flips = hr
        if hr.dtype == torch.bfloat16:
            hr = hr.float()          # a bf16 feed carries only input rounding
        if device_augment:
            # the donkey trainHook's crop + hflip pixel work on the device
            # (donkey_folder.lua:52-70), at offsets the loader drew on the
            # host with the reference's single uniform draw
            hr = crop_hflip_at(hr, tops, lefts, flips, fine_size)
        with torch.no_grad():
            hr, lr_img = preprocess_fn(hr, rgb_to_gray=rgb_to_gray,
                                       to_pm1=to_pm1)
        mark("preprocess")
        g_params, d_params = params_of(state.g), params_of(state.d)

        # G forward: one graph, pulled back once, for G's update
        fake = state.g(lr_img, track_stats=True, compute_dtype=cdt,
                       fast=fast, axis_name=axis_name)
        mark("g_forward")

        # D on real (own batch statistics; first running-stat update)
        out_real = state.d(hr, track_stats=True, logits=fold,
                           compute_dtype=cdt, fast=fast, axis_name=axis_name)
        err_d_real = crit(out_real, torch.full_like(out_real, cfg.real_label))
        gd_real = grad(err_d_real, d_params)
        mark("d_real_forward_backward")

        # D on fake: one forward, shared by the D-fake and the G loss
        _, fake_vec, g_vec = make_labels(cfg, hr, fake.detach())
        out_fake = state.d(fake, track_stats=True, logits=fold,
                           compute_dtype=cdt, fast=fast, axis_name=axis_name)
        mark("d_fake_forward")
        err_d_fake = crit(out_fake, fake_vec)
        err_g = crit(out_fake, g_vec)
        gd_fake = grad(err_d_fake, d_params, retain_graph=True)
        # fGx: the pullback to `fake` only (updateGradInput), never into D's
        # parameter gradients
        g_loss = err_g if cfg.gan_weight == 1.0 else err_g * cfg.gan_weight
        (dfake,) = grad(g_loss, fake)
        mark("d_fake_pullbacks")
        pixel_loss = torch.zeros((), device=hr.device)
        if cfg.pixel_loss_weight > 0:
            # surplus pixel-reconstruction term: the cotangent of
            # w * mean((fake-hr)^2) adds directly to D's pullback
            with torch.no_grad():
                diff = fake - hr
                pixel_loss = torch.mean(diff ** 2)
                dfake = dfake + (cfg.pixel_loss_weight * 2.0
                                 / fake.numel()) * diff
        gg = grad(fake, g_params, grad_outputs=dfake)
        mark("g_backward")

        # fDx accumulates real+fake gradients before one adam step
        gd = torch._foreach_add(gd_real, gd_fake)
        err_d_real, err_d_fake, err_g = (err_d_real.detach(),
                                         err_d_fake.detach(), err_g.detach())
        if axis_name is not None:
            gd, gg = pmean(gd, axis_name), pmean(gg, axis_name)
            err_d_real, err_d_fake, err_g, pixel_loss = pmean(
                [err_d_real, err_d_fake, err_g, pixel_loss], axis_name)
            mark("pmeans")
        adam_update_(d_params, gd, state.d_opt, **adam_kw)
        adam_update_(g_params, gg, state.g_opt, **adam_kw)
        if state.g_ema is not None and cfg.g_ema > 0:
            with torch.no_grad():
                torch._foreach_mul_(state.g_ema, cfg.g_ema)
                torch._foreach_add_(state.g_ema, g_params,
                                    alpha=1.0 - cfg.g_ema)
        mark("adam_updates")

        metrics = {
            "errD": err_d_real + err_d_fake,
            "errD_real": err_d_real,
            # gray-2 scales only the *printed* errD_real (train-gray-2.lua:209)
            "errD_real_reported": err_d_real * cfg.report_scale_real,
            "errD_fake": err_d_fake,
            "errG": err_g,
            "pixel_loss": pixel_loss,
        }
        return state, metrics

    return step
