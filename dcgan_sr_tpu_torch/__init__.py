"""dcgan_sr_tpu_torch — the PyTorch/CUDA port of dcgan_sr_tpu for NVIDIA Hopper.

The JAX package beside it (dcgan_sr_tpu/) is the reference; this package
imports torch, numpy and PIL and nothing of JAX or of dcgan_sr_tpu.  The
module layout mirrors the JAX package so each counterpart is easy to find:

  core/config.py       named variants + env overrides (a copy)
  models/specs.py      generator/discriminator specs (a copy)
  models/network.py    spec-driven nn.Module network (serving and training)
  ops/nn.py, init.py   conv / convT / BN / activations, weight init
  ops/adam.py          Torch7 Adam as one foreach update
  ops/bulge.py         fused convT+BN+ReLU+conv (kernel: csrc/bulge.cu)
  ops/preprocess.py    fused gray/normalize/degrade (kernel: csrc/preprocess.cu)
  ops/_build.py        nvcc + ctypes loader the kernel wrappers share
  losses/schemes.py    criteria and the label schemes
  train/step.py        the GAN train step, TrainState and its numpy form
  train/multi_step.py, loop.py   K steps per call, the epoch loop
  train/checkpoint.py  npz checkpoints, key for key with the JAX files
  data/                the folder and indexed loaders, the prefetcher, the
                       native decoder's bridge, the procedural sources
  image/, metrics/     box downsample, bilinear control, crop/flip, PNG I/O,
                       PSNR, SSIM, MSEs
  evaluation/          the dataset-slice PSNR/SSIM harness
  infer/               full-image, grid and overlap SR, seam DP, ensemble
  utils/               device choice, timers, the reference log line, stats
  reference/           plain float32 references of the port-only models
                       (SRGAN's generator), importing nothing of the port
  upscale.py, serve.py, cli.py   entry points (python -m dcgan_sr_tpu_torch.cli ...)
"""

__version__ = "0.1.0"
