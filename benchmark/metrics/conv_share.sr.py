"""The generator's cuDNN convolutions' share of the SR pipeline, in %: the
device seconds of the `conv` spans (each convolution with its weight cast
and layout changes) over those of the pipeline's stages (the sr.* spans)
in the traced calls."""

from benchmark.spans import share, sr_stage


def read(ctx):
    return share(("conv",), sr_stage)
