"""D's share of the train step, in %: the device seconds of the stages
train.d_real, train.d_fake_forward and train.d_fake_pullbacks over those
of all the step's stages, in the K-step graph's last replay."""

from benchmark.spans import TRAIN_STAGES, share


def read(ctx):
    return share(("train.d_real", "train.d_fake_forward",
                  "train.d_fake_pullbacks"), TRAIN_STAGES)
