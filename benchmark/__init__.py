"""The benchmark of dcgan_sr_tpu_torch on one NVIDIA H100.

`python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once; README.md says how
the pieces are found by name.  Nothing here imports jax or the JAX package;
the plain reference under reference/ imports nothing of the port either.
"""
