"""The small CPU sizes of the cells added after benchmark/tests/small.py
was written, registered in its SMALL table before the tests run (the
tests look every cell of BENCHMARK.json up there).  SRGAN keeps its
published widths at LR 12x12, two images; the fp32 trainer takes the bf16
trainer's narrowed sizes."""

from benchmark.tests.small import SMALL

SMALL.setdefault("gray3-train-fp32", SMALL["gray3-train-bf16"])
SMALL.setdefault("srgan-bulk-bf16", {
    "config": {},
    "traffic_params": {"images": 2, "side": 12, "pool": 2, "check_calls": 1,
                       "trace_calls": 1, "check_block": 1,
                       "calib_images": 2}})
