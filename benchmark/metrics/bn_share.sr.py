"""The generator's BN layers' share of the SR pipeline, in %: the device
seconds of the `bn` spans (statistics, their casts, the normalisation)
over those of the pipeline's stages (the sr.* spans) in the traced
calls."""

from benchmark.spans import share, sr_stage


def read(ctx):
    return share(("bn",), sr_stage)
