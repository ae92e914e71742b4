"""The arithmetic the per-layer metrics' readers share."""

from __future__ import annotations


def idle_share(ctx):
    """% of the traced stretch in which no operation ran on the device."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(ctx):
    """% of the bf16 peak: the model FLOPs the driver counted in the traced
    stretch over the stretch's time."""
    t, flops = ctx.trace, ctx.work.get("flops")
    if t is None or not flops or t.window_s <= 0:
        return None
    return 100.0 * flops / t.window_s / ctx.peaks.BF16_FLOPS
