"""The model FLOPs of the calls in the traced stretch (counted from the
spec in benchmark/flops.py) over the stretch's time, as a % of the H100's
published dense bf16 peak (989 TFLOP/s)."""

from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx)
