"""The residual sums' share of the SR pipeline, in %: the device seconds of
the `residual` spans (each block's sum and the long skip's, in SRGAN's
generator) over those of the pipeline's stages (the sr.* spans) in the
traced calls."""

from benchmark.spans import share, sr_stage


def read(ctx):
    return share(("residual",), sr_stage)
