"""The port's `bench_infer --self-ensemble N [--ensemble-batched]` and its
knob table (`python -m dcgan_sr_tpu_torch.profile_table`) against the JAX
tools bench_infer.py and tools/profile_step.py: with the timers replaced by
recorders, both tools ask for the same measurements and print the same
lines; then one real CPU run of each at a tiny size (its times are the
host's and are not asserted)."""

import contextlib
import dataclasses
import inspect
import io
import json
import sys

import pytest

import bench_infer as jax_bench_infer
from dcgan_sr_tpu_torch import bench_infer, profile_table
from tools import profile_step as jax_profile_step

import torch_threads  # noqa: F401

CONFIG_FIELDS = ("compact_params", "fast_ops", "use_pallas", "compute_dtype",
                 "batchSize")


def _lines(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def _recorder(fn, calls, value):
    """A stand-in for `fn` that records its arguments (defaults filled in)
    and returns `value`."""
    sig = inspect.signature(fn)

    def record(*a, **kw):
        bound = sig.bind(*a, **kw)
        bound.apply_defaults()
        calls.append(dict(bound.arguments))
        return value
    return record


# ---- bench_infer --self-ensemble N [--ensemble-batched] [--bn-eval] --------

@pytest.mark.parametrize("bn_eval", [False, True])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_bench_infer_modes_match_the_jax_tool(monkeypatch, n, batched,
                                              bn_eval):
    flags = ["--self-ensemble", str(n)] + ["--ensemble-batched"] * batched \
        + ["--bn-eval"] * bn_eval
    j_calls, t_calls = [], []
    monkeypatch.setattr(jax_bench_infer, "measure_tpu", _recorder(
        jax_bench_infer.measure_tpu, j_calls, [1.0, 1.0, 1.0]))
    monkeypatch.setattr(sys, "argv", ["bench_infer.py"] + flags)
    j_recs = [json.loads(l) for l in _lines(jax_bench_infer.main)]
    monkeypatch.setattr(bench_infer, "measure", _recorder(
        bench_infer.measure, t_calls, [1.0, 1.0, 1.0]))
    t_out = _lines(bench_infer.main, flags + ["--cpu"])
    assert t_out[-1].startswith("kernel launches: ")
    t_recs = [json.loads(l) for l in t_out[:-1]]

    # the JAX tool prints the mode asked for; the port both BN modes unless
    # --bn-eval, parity first
    assert len(j_recs) == 1
    assert [c["bn_eval"] for c in t_calls] == ([True] if bn_eval
                                               else [False, True])
    (j_rec,), (j_call,) = j_recs, j_calls
    t_rec, t_call = next((r, c) for r, c in zip(t_recs, t_calls)
                         if c["bn_eval"] == bn_eval)
    assert t_rec["metric"] == "cpu_" + j_rec["metric"]
    assert t_rec["metric"] == "cpu_" + bench_infer.metric_name(bn_eval, n,
                                                                batched)
    if n != 1:
        assert j_rec["metric"] == ("overlap_sr_upscaled_mp_per_sec_tta"
                                   f"{n}{'_batched' * batched}"
                                   f"{'_bn_eval' * bn_eval}")
    for key in ("n_images", "self_ensemble", "ensemble_batched", "bn_eval"):
        assert t_call[key] == j_call[key], key
    assert t_call["n_images"] == (64 if n == 1 else max(8, 64 // n))
    for key in ("value", "unit", "rep_spread"):
        assert t_rec[key] == j_rec[key], key
    assert (t_rec["dtype"], t_rec["device"]) == ("bf16", "cpu")


def test_bench_infer_n1_lines_keep_their_schema(monkeypatch):
    """N = 1 prints the lines it printed before the flags existed."""
    monkeypatch.setattr(bench_infer, "measure", _recorder(
        bench_infer.measure, [], [2.0, 1.0, 3.0]))
    out = _lines(bench_infer.main, ["--cpu"])
    assert [list(json.loads(l)) for l in out[:2]] == [
        ["metric", "value", "unit", "rep_spread", "dtype", "device"]] * 2
    assert [json.loads(l)["metric"] for l in out[:2]] == [
        "cpu_overlap_sr_upscaled_mp_per_sec",
        "cpu_overlap_sr_upscaled_mp_per_sec_bn_eval"]
    assert json.loads(out[0])["rep_spread"] == [1.0, 2.0, 3.0]


def test_bench_infer_self_ensemble_runs_on_the_cpu():
    out = _lines(bench_infer.main, [
        "--cpu", "--ngf", "4", "--images", "2", "--steps", "1", "--reps", "1",
        "--self-ensemble", "2", "--ensemble-batched", "--dtype", "fp32"])
    recs = [json.loads(l) for l in out[:-1]]
    assert [r["metric"] for r in recs] == [
        "cpu_overlap_sr_upscaled_mp_per_sec_tta2_batched",
        "cpu_overlap_sr_upscaled_mp_per_sec_tta2_batched_bn_eval"]
    for r in recs:
        lo, med, hi = r["rep_spread"]
        assert 0 < lo <= med <= hi and r["value"] == med
        assert (r["dtype"], r["device"]) == ("fp32", "cpu")
    assert json.loads(out[-1][len("kernel launches: "):]) == {
        "bulge_stats": 0, "bulge_main": 0, "bulge_stats_bf16": 0,
        "bulge_main_bf16": 0, "bn_stats_bf16": 0, "bn_finish_bf16": 0,
        "bn_apply_bf16": 0, "bn_plain_cuda_calls": 0}


# ---- the knob table ---------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--fp32"],
                                   ["--batch", "7", "--steps", "3", "--reps",
                                    "2", "--fp32"]])
def test_knob_table_rows_and_lines_match_the_jax_tool(monkeypatch, flags):
    j_rows, j_fwd, t_rows, t_fwd = [], [], [], []
    monkeypatch.setattr(jax_profile_step, "time_variant", _recorder(
        jax_profile_step.time_variant, j_rows, 0.0125))
    monkeypatch.setattr(jax_profile_step, "time_forward", _recorder(
        jax_profile_step.time_forward, j_fwd, 0.004))
    monkeypatch.setattr(sys, "argv", ["profile_step.py"] + flags)
    j_out = _lines(jax_profile_step.main)
    monkeypatch.setattr(profile_table, "time_variant", _recorder(
        profile_table.time_variant, t_rows, 0.0125))
    monkeypatch.setattr(profile_table, "time_forward", _recorder(
        profile_table.time_forward, t_fwd, 0.004))
    t_out = _lines(profile_table.main, flags + ["--cpu"])

    assert [c["name"] for c in t_rows] == [c["name"] for c in j_rows] == [
        "baseline", "compact_params", "fast_ops", "pallas_preprocess",
        "compact+pallas"]
    for tc, jc in zip(t_rows + t_fwd, j_rows + j_fwd):
        t_cfg, j_cfg = (dataclasses.asdict(c["cfg"]) for c in (tc, jc))
        assert {f: t_cfg[f] for f in CONFIG_FIELDS} == \
            {f: j_cfg[f] for f in CONFIG_FIELDS}
        assert t_cfg == j_cfg
    for a, b in ((t_rows, j_rows), (t_fwd, j_fwd)):
        for key in ("shape", "k", "batch", "reps"):
            assert [c.get(key) for c in a] == [c.get(key) for c in b], key
    # the six row lines and the JSON line are the JAX tool's, byte for byte
    assert t_out[:6] == j_out[:6]
    assert t_out[-1] == j_out[-1]
    assert list(json.loads(t_out[-1])) == ["dtype", "batch", "ms_per_step"]
    assert t_out[6].startswith("kernel launches: ")
    assert t_out[7] == profile_table.PALLAS_NOTE and len(t_out) == 9


def test_knob_table_runs_on_the_cpu():
    launches = {}
    out = _lines(lambda a: profile_table.main(a, launches=launches),
                 ["--cpu", "--batch", "2", "--steps", "2", "--reps", "1",
                  "--ngf", "4", "--ndf", "8"])
    res = json.loads(out[-1])
    assert res["dtype"] == "bfloat16" and res["batch"] == 2
    rows = list(res["ms_per_step"])
    assert rows == ["baseline", "compact_params", "fast_ops",
                    "pallas_preprocess", "compact+pallas", "g_forward_only"]
    assert all(v > 0 for v in res["ms_per_step"].values())
    assert [l.split()[0] for l in out[:6]] == rows
    # the CPU runs the plain versions: no kernel launch is counted
    assert list(launches) == rows
    assert not any(n for c in launches.values() for n in c.values())
    assert json.loads(out[6][len("kernel launches: "):]) == {
        r: {} for r in rows}
