"""The fused bulge pair's share of its roofline, in %, found by its span:
the least time its work could take on the card (the bound of
k2_roofline.sr, benchmark/flops.py pair_work, for every call in the traced
stretch) over the device seconds of the program's `bulge` spans, which
hold the implementation choice, the glue between the two kernels and
both kernels, whatever the kernels are called."""

from benchmark.spans import device_s, totals


def read(ctx):
    bound, t = ctx.work.get("pair_bound_s"), totals()
    if not bound or t is None:
        return None
    secs, found = device_s(t, ("bulge",))
    if not found or secs <= 0:
        return None
    return 100.0 * bound / secs
