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


def _host_leaf(leaves, k, feed_dtype):
    """One leaf of K batches as a (K, ...) CPU tensor (K = 1: the batch
    itself), float leaves cast to `feed_dtype`."""
    x = torch.from_numpy(np.ascontiguousarray(
        np.stack(leaves) if k > 1 else leaves[0]))
    if feed_dtype is not None and x.is_floating_point():
        x = x.to(feed_dtype)
    return x


class _Slot:
    """One of a chunk shape's two device buffers of the staged feed, with
    its pinned host buffer and the two events that order its reuse."""

    def __init__(self, leaves, device):
        self.pinned = tuple(torch.empty(x.shape, dtype=x.dtype,
                                        pin_memory=True) for x in leaves)
        self.dev = tuple(torch.empty(x.shape, dtype=x.dtype, device=device)
                         for x in leaves)
        self.copied = torch.cuda.Event()   # the host-to-device copy is done
        self.read = torch.cuda.Event()     # the step that read `dev` is done

    def take(self):
        """The device leaves, once the current stream has waited for their
        copy."""
        torch.cuda.current_stream(self.dev[0].device).wait_event(self.copied)
        return self.dev

    def release(self):
        """Mark everything queued so far on the current stream as the last
        reader of `dev`: the next copy into it waits for that."""
        self.read.record(torch.cuda.current_stream(self.dev[0].device))


class _StagedFeed:
    """stage_ahead's feed on a card: chunk c+1 is copied from pinned host
    memory, `non_blocking`, on a copy stream, into the other of two device
    buffers while the compute stream runs chunk c.  Events order the work:
    a step waits for its buffer's copy (`_Slot.take`), and a copy waits for
    the step that last read its buffer (`_Slot.read`); the host waits for a
    pinned buffer's previous copy before it writes the buffer again."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = {}

    def put(self, leaves):
        sig = tuple((tuple(x.shape), x.dtype) for x in leaves)
        pair = self.slots.get(sig)
        if pair is None:
            pair = self.slots[sig] = [_Slot(leaves, self.device),
                                      _Slot(leaves, self.device)]
        slot = pair[0]
        pair.reverse()                     # the other buffer next time
        slot.copied.synchronize()          # its pinned buffer is free
        for p, x in zip(slot.pinned, leaves):
            p.copy_(x)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(slot.read)
            for d, p in zip(slot.dev, slot.pinned):
                d.copy_(p, non_blocking=True)
            slot.copied.record(self.stream)
        return slot


def train_epochs(cfg, state, batch_fn, *, step_fn=None, niter=None,
                 steps_per_epoch=None, log_fn=None, checkpoint_dir=None,
                 prepare_batch=None, logger: MetricsLogger = None,
                 log_every=1, scan_steps=1, multi_step_fn=None,
                 start_epoch=0, feed_dtype=None, stage_ahead=False):
    """Run the training loop; returns (state, last metrics).

    batch_fn(epoch, step_index) -> (B, C, H, W) HR batch as a numpy array,
    or under cfg.device_augment a (canvas, tops, lefts, flips) tuple of
    them; each batch (or, when scanning, each (K, B, ...) super-batch,
    stacked leaf by leaf) goes to the state's device, leaf by leaf, after
    the tuple's crop offsets are checked on the host
    step_fn: the single step (default build_train_step(cfg); the
    data-parallel CLI passes parallel.build_dp_train_step's)
    prepare_batch: optional device placement hook (parallel.shard_batch:
    this rank's slice of the batch on its device); receives the host batch
    as CPU tensors, either a (B, ...) batch or, when scanning, a (K, B, ...)
    super-batch (a tuple of them under device_augment).  It takes the place
    of the plain copy and of stage_ahead's staged copy, as in JAX; the next
    chunk is still built ahead under stage_ahead
    logger: optional MetricsLogger (default: stdout-only, reference format)
    log_every: fetch/print metrics every N steps.  1 = per-step logging like
    the reference (train.lua:286-293).  A fetch is the loop's only wait for
    the device; larger values let the host queue steps ahead.
    scan_steps: K>1 runs full K-step chunks through train.multi_step
    (multi_step_fn, default build_multi_step(cfg)): on a card one CUDA graph
    replay per chunk after the first; the epoch's remainder steps run
    through the single step.  Epoch math is unchanged (the body is the
    single step; tested equal).
    start_epoch: resume offset — epochs run start_epoch+1 .. niter and
    checkpoints keep their continued numbering instead of restarting at 1.
    feed_dtype: cast each batch's float leaves to this dtype on the host
    before the copy (torch.bfloat16 halves the bytes; the step upcasts at
    entry); integer and bool leaves (crop offsets, flips) pass as they are.
    stage_ahead: double-buffer the feed — build chunk c+1 on the host, and
    on a card copy it to the device (pinned memory, a copy stream, two
    device buffers: _StagedFeed), WHILE the device computes chunk c (the
    step is queued, and nothing has waited for it yet).  Epoch math is
    unchanged (same batches in the same order; tested identical).  Log
    semantics shift as in JAX: DataTime is the overlapped build + copy cost
    of the chunk (measured when it actually ran), Time is the chunk's wall
    (queue -> staging of the next -> fetch).
    """
    if step_fn is None:
        step_fn = build_train_step(cfg)
    if scan_steps > 1 and multi_step_fn is None:
        multi_step_fn = build_multi_step(cfg)
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
    feed = (_StagedFeed(device) if stage_ahead and device.type == "cuda"
            and prepare_batch is None else None)

    tm, data_tm, epoch_tm = Timer(), Timer(), Timer()
    metrics_last = None

    def chunk_size(i):
        return scan_steps if (scan_steps > 1
                              and steps_per_epoch - i >= scan_steps) else 1

    def build_chunk(epoch, i, k):
        """Host batch build + device placement; returns (batch or staged
        slot, seconds)."""
        data_tm.reset()
        batches = [batch_fn(epoch, i + j) for j in range(k)]
        if isinstance(batches[0], tuple):
            for b in batches:
                check_crop_offsets(b[1], b[2], b[0].shape[-2:], cfg.fineSize)
            host = tuple(_host_leaf(leaves, k, feed_dtype)
                         for leaves in zip(*batches))
        else:
            host = _host_leaf(batches, k, feed_dtype)
        if prepare_batch is not None:
            hr = prepare_batch(host)
        elif feed is not None:
            hr = feed.put(host if isinstance(host, tuple) else (host,))
        elif isinstance(host, tuple):
            hr = tuple(x.to(device) for x in host)
        else:
            hr = host.to(device)
        data_tm.stop()
        return hr, data_tm.time()["real"]

    try:
        for epoch in range(start_epoch + 1, niter + 1):
            epoch_tm.reset()
            i = 0
            staged = None
            while i < steps_per_epoch:
                k = chunk_size(i)
                tm.reset()
                hr, data_s = staged if staged is not None else \
                    build_chunk(epoch, i, k)
                slot = hr if isinstance(hr, _Slot) else None
                if slot is not None:
                    hr = slot.take()
                    if len(hr) == 1:
                        hr = hr[0]

                if k > 1:
                    state, stacked = multi_step_fn(state, hr)
                    metrics = {key: v[-1] for key, v in stacked.items()}
                else:
                    state, metrics = step_fn(state, hr)
                if slot is not None:
                    slot.release()
                metrics_last = metrics
                done = i + k
                if stage_ahead and done < steps_per_epoch:
                    # the device is computing this chunk now (nothing has
                    # waited for it yet): overlap the next chunk's host
                    # build and copy with it
                    staged = build_chunk(epoch, done, chunk_size(done))
                else:
                    staged = None
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
