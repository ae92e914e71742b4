"""The PixelShuffles' share of the SR pipeline, in %: the device seconds of
the `shuffle` spans (each upsampling block's channel-to-space copy, in
SRGAN's generator; its PReLU is in `act`) over those of the pipeline's
stages (the sr.* spans) in the traced calls."""

from benchmark.spans import share, sr_stage


def read(ctx):
    return share(("shuffle",), sr_stage)
