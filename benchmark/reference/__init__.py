"""The plain reference: PyTorch in float32 with TF32 off.

It imports neither jax, nor the JAX package, nor anything of
dcgan_sr_tpu_torch, and takes nothing that the program made: the harness
hands it the inputs, weights and running statistics that it also handed to
the program.  `precision="fp8"` runs it as the control, in float8, the step below the
cells' bf16 that would tempt a later change: every convolution's input,
weight and output rounded to e4m3 and the gradients through them to e5m2,
each at a per-tensor scale (precision.py).
"""
