"""The port's bench tools on the CPU at a tiny size: bench_fused prints the
JAX tool's JSON keys (tools/bench_fused.py:104-109) and the fused pair
agrees with the unfused composition; bench_infer's measure() runs the
overlap pipeline and reports under the bench's metric names, marked as a CPU
run.  Times from these runs are the host's and are not asserted."""

import contextlib
import io
import json

import pytest
import torch

from dcgan_sr_tpu_torch import bench_fused, bench_infer
from dcgan_sr_tpu_torch.core import get_config

import torch_threads  # noqa: F401

JAX_TOOL_KEYS = {"batch", "hw", "dtype", "kernel", "tm", "unfused_ms",
                 "fused_ms", "speedup", "max_abs_diff"}


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("kernel", ["bulge", "nhwc"])
def test_bench_fused_prints_the_jax_tools_keys(kernel):
    lines = _run(bench_fused.main, ["--cpu", "--batch", "2", "--hw", "16",
                                    "--kernel", kernel, "--tm", "8",
                                    "--dtype", "fp32",
                                    "--iters", "2", "--reps", "1"])
    rec = json.loads(lines[-1])
    assert JAX_TOOL_KEYS <= set(rec)
    assert (rec["batch"], rec["hw"], rec["dtype"], rec["kernel"], rec["tm"]) \
        == (2, 16, "fp32", kernel, 8)
    assert rec["device"] == "cpu"
    assert 0 <= rec["max_abs_diff"] <= 2e-4     # y tolerance of the pair
    assert rec["unfused_ms"] > 0 and rec["fused_ms"] > 0
    assert lines[0].startswith("unfused") and lines[1].startswith("fused")
    counts = json.loads(lines[-2][len("kernel launches: "):])
    assert set(counts) == {"bulge_stats", "bulge_main", "bulge_stats_bf16",
                           "bulge_main_bf16", "fused_nhwc_stats",
                           "fused_nhwc_main", "fused_nhwc_stats_bf16",
                           "fused_nhwc_main_bf16"}
    assert all(v == 0 for v in counts.values())      # CPU: plain versions
    assert lines[-3].startswith("implementation launches: ")
    by_impl = json.loads(lines[-3][len("implementation launches: "):])
    assert by_impl == {"bulge": {"wgmma": 0, "mma": 0, "fma": 0,
                                 "mma_bf16": 0, "wgmma_bf16": 0},
                       "fused_nhwc": {"mma": 0, "fma": 0, "wgmma": 0,
                                      "mma_bf16": 0, "wgmma_bf16": 0}}


def test_bench_fused_bf16_and_cpu_fallback_refused():
    """bf16 runs either kernel, and is the default dtype, as in the JAX
    tool; without --cpu and without a card the tools refuse to fall back."""
    lines = _run(bench_fused.main, ["--cpu", "--batch", "1", "--hw", "8",
                                    "--kernel", "nhwc", "--tm", "8",
                                    "--iters", "1", "--reps", "1"])
    rec = json.loads(lines[-1])
    assert (rec["dtype"], rec["kernel"]) == ("bf16", "nhwc")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--cpu"):
            bench_fused.main(["--batch", "1", "--hw", "8"])
        with pytest.raises(RuntimeError, match="--cpu"):
            bench_infer.main([])


@pytest.mark.parametrize("bn_eval", [False, True])
def test_bench_infer_measure_on_the_cpu(bn_eval):
    cfg = get_config("gray-patch-batch-overlap", env_override=False, ngf=4,
                     fineSize=16)
    mps = bench_infer.measure(n_images=2, reps=2, steps=2, bn_eval=bn_eval,
                              device="cpu", cfg=cfg)
    assert len(mps) == 2 and all(v > 0 for v in mps)
    rec = bench_infer.overlap_record(bn_eval=bn_eval, n_images=2, reps=1,
                                     steps=1, device="cpu", cfg=cfg)
    assert rec["metric"] == ("cpu_overlap_sr_upscaled_mp_per_sec"
                             + ("_bn_eval" if bn_eval else ""))
    assert rec["unit"] == "MP/s" and rec["device"] == "cpu"
    assert "vs_baseline" not in rec
