"""The port's counterpart of bench.py (python -m dcgan_sr_tpu_torch.bench)
on the CPU at a tiny size: its lines, their order and schema, the
read-only baseline file, the vs_baseline helper, and the K-step chunk it
times against the JAX package's scanned multi-step.  Times from these runs
are the host's and are not asserted."""

import contextlib
import hashlib
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bench as jax_bench
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.train import init_train_state as j_init_train_state
from dcgan_sr_tpu.train.multi_step import jit_multi_step
from dcgan_sr_tpu_torch import bench
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.train.step import state_from_numpy

import torch_threads  # noqa: F401

TINY = ["--cpu", "--ngf", "4", "--ndf", "8", "--batch", "2",
        "--patch-images", "2", "--steps", "2", "--reps", "2", "--images", "2"]
# bench.py's metric names in its print order, the flagship last
NAMES = ["overlap_sr_upscaled_mp_per_sec",
         "overlap_sr_upscaled_mp_per_sec_bn_eval",
         "train_images_per_sec_rgb_full",
         "train_images_per_sec_gray_patch_batch",
         "train_images_per_sec"]
STAMPS = {"host", "cpu_anchor_s", "device", "power_limit_w", "baseline_host"}


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def run():
    """One tiny CPU run of bench.main: (its output lines, the baseline
    file's digest before and after)."""
    before = _digest(bench.BASELINE_FILE)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(TINY)
    return buf.getvalue().splitlines(), before, _digest(bench.BASELINE_FILE)


def test_bench_prints_the_header_the_launches_and_five_lines(run):
    lines, _, _ = run
    assert len(lines) == 7
    head = json.loads(lines[0])
    assert head["metric"] == "bench_selfcert"
    assert head["unit"] == "s (first card round trip)"
    assert {"host", "cpu_anchor_s", "baseline_host", "baseline_note",
            "device", "power_limit_w"} <= set(head)
    assert head["device"] == "cpu" and head["power_limit_w"] is None
    assert lines[1].startswith("kernel launches: ")
    recs = [json.loads(line) for line in lines[2:]]
    assert [r["metric"] for r in recs] == ["cpu_" + n for n in NAMES]


def test_bench_lines_carry_spreads_and_stamps_but_no_vs_baseline(run):
    lines, _, _ = run
    head = json.loads(lines[0])
    for rec in map(json.loads, lines[2:]):
        lo, med, hi = rec["rep_spread"]
        assert lo <= med <= hi and rec["value"] == med
        assert "vs_baseline" not in rec
        assert STAMPS <= set(rec) and rec["device"] == "cpu"
        assert all(rec[k] == head[k] for k in STAMPS)
        assert rec["unit"] == ("MP/s" if "overlap" in rec["metric"]
                               else "images/sec")


def test_bench_stamps_the_host_fingerprint_on_every_line(run):
    """bench.py:222-236, 252: the header carries the host's tag and its
    description, every metric line the tag."""
    from dcgan_sr_tpu.utils.cache import machine_fingerprint as j_fingerprint
    lines, _, _ = run
    tag, desc = j_fingerprint()
    head = json.loads(lines[0])
    assert (head["host"], head["host_desc"]) == (tag, desc)
    for rec in map(json.loads, lines[2:]):
        assert rec["host"] == tag and "host_desc" not in rec


def test_bench_launch_line_counts_k1_per_trainer_and_k2_by_kernel(run):
    lines, _, _ = run
    counts = json.loads(lines[1][len("kernel launches: "):])
    # the CPU runs the plain versions: nothing is launched
    assert counts["preprocess_run"] == {"rgb-full": 0, "gray-patch-batch": 0,
                                        "gray-3": 0}
    assert set(counts["bulge"]) == {"bulge_stats", "bulge_main",
                                    "bulge_stats_bf16", "bulge_main_bf16"}
    assert set(counts["bulge_impl"]) == {"wgmma", "mma", "fma", "mma_bf16",
                                         "wgmma_bf16"}
    assert not any(counts["bulge"].values())
    assert not any(counts["bulge_impl"].values())


def test_bench_leaves_the_baseline_file_as_it_was(run):
    _, before, after = run
    assert before == after


def test_vs_baseline_is_the_value_over_the_files_baseline():
    """A card-style record of each metric over the key bench.py divides it
    by (bench.py:248, bench_infer.py:175); a missing key gives None."""
    with open(bench.BASELINE_FILE) as f:
        data = json.load(f)
    keys = dict(zip(NAMES, ["torch_cpu_overlap_mp_per_sec"] * 2
                    + ["rgb-full", "gray-patch-batch", "gray-3"]))
    assert bench.read_baselines() == data
    for name, key in keys.items():
        rec = bench.with_vs_baseline({"metric": name, "value": 1234.5}, data)
        assert rec["vs_baseline"] == round(1234.5 / data[key], 2)
        assert bench.with_vs_baseline({"metric": name, "value": 1.0},
                                      {})["vs_baseline"] is None


def test_bench_workload_is_bench_pys():
    """The step shapes and image counts of bench.py's SHAPES, K = 20 and 3
    repetitions, bf16, and bench.py's super-batch (bench.py:188-190)."""
    assert (bench.STEPS, bench.REPS) == (jax_bench.STEPS, 3)
    for variant, (_, shape, imgs) in jax_bench.SHAPES.items():
        cfg = get_config(variant, env_override=False,
                         **bench.VARIANTS[variant])
        assert bench.step_shape(cfg) == shape
        assert cfg.images_consumed_per_step == imgs
    w = bench.workload("gray-3", k=2, device="cpu", ngf=4, ndf=8,
                       batchSize=2)
    assert w.cfg.compute_dtype == "bfloat16"
    np.testing.assert_array_equal(
        w.batches.numpy(), np.random.RandomState(0).rand(2, 2, 1, 64, 64)
        .astype(np.float32))


@pytest.mark.parametrize("variant,size", [("gray-3", {"batchSize": 2}),
                                          ("gray-patch-batch",
                                           {"images_per_step": 2})])
def test_bench_chunk_is_the_jax_multi_step(variant, size):
    """One chunk of bench's workload, from the JAX package's
    init_train_state carried across as numpy, gives jit_multi_step's
    per-step losses on the same super-batch (fp32, tiny widths).  Step 0
    to rtol 1e-4; later steps of gray-3 differ by more than that, because
    a few near-zero gradients take opposite signs and Adam moves those
    elements by 2 lr (tests/test_torch_multi_step.py holds them to 2e-3)."""
    k = 3
    over = dict(ngf=4, ndf=8, compute_dtype="float32", **size)
    w = bench.workload(variant, k=k, device="cpu", **over)
    jcfg = j_get_config(variant, env_override=False, **over)
    jst = j_init_train_state(jcfg, jax.random.PRNGKey(0))
    fields = {f: jax.tree_util.tree_map(np.asarray, getattr(jst, f))
              for f in ("g_params", "g_state", "g_opt", "d_params", "d_state",
                        "d_opt", "g_ema_params")}
    w.state = state_from_numpy(w.cfg, fields, device="cpu")
    _, jm = jit_multi_step(jcfg)(jst, jnp.asarray(w.batches.numpy()))
    _, tm = w.runner(w.state, w.batches)
    assert sorted(tm) == sorted(jm)
    later = 1e-4 if variant == "gray-patch-batch" else 2e-3
    for key in tm:
        got, want = tm[key].numpy(), np.asarray(jm[key])
        assert got.shape == want.shape == (k,)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-7,
                                   err_msg=key)
        np.testing.assert_allclose(got, want, rtol=later, atol=1e-7,
                                   err_msg=key)


def test_bench_refuses_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="--cpu"):
        bench.main([])
