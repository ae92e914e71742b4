"""Share of the traced stretch in which no kernel, copy or set ran on the
device (torch.profiler's CUDA activity), in %."""

from benchmark.readers import idle_share


def read(ctx):
    return idle_share(ctx)
