"""Epoch loop: the reference's train loop shape, timers and log line (port
of dcgan_sr_tpu/train/loop.py).

Reference loop (train.lua:275-304): per step adam(fDx) then adam(fGx), a log
line `Epoch: [e][i / N] Time DataTime Err_G Err_D`, and an epoch-time line.
Per-epoch checkpoints are on whenever a directory is given.  Timers mirror
the tm / data_tm / epoch_tm triple (train.lua:159-161).
"""

from __future__ import annotations

import numpy as np
import torch

from ..image.ops import check_crop_offsets
from ..utils.logging import MetricsLogger
from ..utils.timers import Timer
from .checkpoint import save_checkpoint
from .multi_step import build_multi_step
from .step import build_train_step


def _to_device(leaves, k, feed_dtype, device):
    """One leaf of K batches as a (K, ...) tensor on `device` (K = 1: the
    batch itself), float leaves cast to `feed_dtype` first."""
    x = torch.from_numpy(np.ascontiguousarray(
        np.stack(leaves) if k > 1 else leaves[0]))
    if feed_dtype is not None and x.is_floating_point():
        x = x.to(feed_dtype)
    return x.to(device)


def train_epochs(cfg, state, batch_fn, *, niter=None, steps_per_epoch=None,
                 log_fn=None, checkpoint_dir=None,
                 logger: MetricsLogger = None, log_every=1, scan_steps=1,
                 start_epoch=0, feed_dtype=None):
    """Run the training loop; returns (state, last metrics).

    batch_fn(epoch, step_index) -> (B, C, H, W) HR batch as a numpy array,
    or under cfg.device_augment a (canvas, tops, lefts, flips) tuple of
    them; each batch (or, when scanning, each (K, B, ...) super-batch,
    stacked leaf by leaf) is copied to the state's device here, leaf by
    leaf, after the tuple's crop offsets are checked on the host
    logger: optional MetricsLogger (default: stdout-only, reference format)
    log_every: fetch/print metrics every N steps.  1 = per-step logging like
    the reference (train.lua:286-293).  A fetch is the loop's only wait for
    the device; larger values let the host queue steps ahead.
    scan_steps: K>1 runs full K-step chunks through train.multi_step; the
    epoch's remainder steps run through the single step.  Epoch math is
    unchanged (the body is the single step; tested equal).
    start_epoch: resume offset — epochs run start_epoch+1 .. niter and
    checkpoints keep their continued numbering instead of restarting at 1.
    feed_dtype: cast each batch's float leaves to this dtype on the host
    before the copy (torch.bfloat16 halves the bytes; the step upcasts at
    entry); integer and bool leaves (crop offsets, flips) pass as they are.
    """
    step_fn = build_train_step(cfg)
    multi_step_fn = build_multi_step(cfg) if scan_steps > 1 else None
    niter = niter if niter is not None else cfg.niter
    if steps_per_epoch is None:
        # ntrain counts IMAGES (config.images_consumed_per_step)
        imgs = cfg.images_consumed_per_step
        ntrain = cfg.ntrain if np.isfinite(cfg.ntrain) else imgs
        steps_per_epoch = max(int(ntrain) // imgs, 1)
    own_logger = logger is None
    if own_logger:
        logger = MetricsLogger(log_fn=log_fn)
    device = state.g.device

    tm, data_tm, epoch_tm = Timer(), Timer(), Timer()
    metrics_last = None
    try:
        for epoch in range(start_epoch + 1, niter + 1):
            epoch_tm.reset()
            i = 0
            while i < steps_per_epoch:
                k = scan_steps if (scan_steps > 1 and
                                   steps_per_epoch - i >= scan_steps) else 1
                tm.reset()
                data_tm.reset()
                batches = [batch_fn(epoch, i + j) for j in range(k)]
                if isinstance(batches[0], tuple):
                    for b in batches:
                        check_crop_offsets(b[1], b[2], b[0].shape[-2:],
                                           cfg.fineSize)
                    hr = tuple(_to_device(leaves, k, feed_dtype, device)
                               for leaves in zip(*batches))
                else:
                    hr = _to_device(batches, k, feed_dtype, device)
                data_s = data_tm.stop().time()["real"]

                if k > 1:
                    state, stacked = multi_step_fn(state, hr)
                    metrics = {key: v[-1] for key, v in stacked.items()}
                else:
                    state, metrics = step_fn(state, hr)
                metrics_last = metrics
                done = i + k
                if (done % log_every < k) or done == steps_per_epoch:
                    metrics_host = {key: float(v) for key, v in metrics.items()}
                    logger.log_step(epoch, done - 1, steps_per_epoch,
                                    tm.time()["real"], data_s, metrics_host)
                i = done
            logger.log_epoch(epoch, niter, epoch_tm.time()["real"])
            if checkpoint_dir is not None:
                save_checkpoint(checkpoint_dir, cfg.name, epoch, state)
    finally:
        if own_logger:
            logger.close()
    return state, metrics_last
