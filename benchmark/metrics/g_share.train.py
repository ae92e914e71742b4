"""G's share of the train step, in %: the device seconds of the stages
train.g_forward and train.g_backward over those of all the step's stages,
in the K-step graph's last replay (the stages are event nodes of the
graph, dcgan_sr_tpu_torch/train/multi_step.py)."""

from benchmark.spans import TRAIN_STAGES, share


def read(ctx):
    return share(("train.g_forward", "train.g_backward"), TRAIN_STAGES)
