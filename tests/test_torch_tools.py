"""The port's user tools (python -m dcgan_sr_tpu_torch.<tool>) that serve,
score and load, and `serve --warmup-rect`, against the JAX package's, on
the CPU at small sizes (the training tools: test_torch_tools_train.py).

Every tool runs with --cpu (a card runs K1 and K2; the CPU their plain
versions).  Weights are copied from a JAX init or written by the JAX
package's save_checkpoint; results are never compared through seeds.
Tolerances: slice-mean PSNR 1e-3 dB, SSIM 1e-4."""

import contextlib
import io
import json
import os
import sys
import threading

import numpy as np
import pytest

import jax
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.data.synthetic import TexturedImages as JTextured
from dcgan_sr_tpu.evaluation import harness as JH
from dcgan_sr_tpu.train import init_train_state as j_init_state
from dcgan_sr_tpu.train.checkpoint import checkpoint_path
from dcgan_sr_tpu.train.checkpoint import save_checkpoint as j_save
from dcgan_sr_tpu_torch import (loader_bench, overlap_protocol,
                                select_checkpoint, serve, serve_load)
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.data.synthetic import TexturedImages
from dcgan_sr_tpu_torch.evaluation import evaluate_overlap_slice
from dcgan_sr_tpu_torch.train.checkpoint import load_generator

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import loader_bench as j_loader_bench  # noqa: E402

PSNR_TOL, SSIM_TOL = 1e-3, 1e-4


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue().splitlines()


# ---- serve --warmup-rect ----------------------------------------------------

@pytest.mark.parametrize("variant,fine,max_size", [
    ("gray-3", 16, 12),                    # one pipeline per mode
    ("gray-patch-batch-overlap", 32, 32),  # one pipeline per pair and mode
])
def test_warmup_rect_runs_every_ladder_pair_in_both_modes(variant, fine,
                                                         max_size):
    """warmup(rect=True) dispatches every (bh, bw) ladder pair in both modes
    (the JAX oracle: tests/test_serve.py test_rect_warmup_precompiles_all_
    pairs, buckets^2 x 2), so a later non-square request meets no new
    shape; batch_sizes= is honoured."""
    cfg = get_config(variant, env_override=False, fineSize=fine, ngf=4,
                     ndf=8)
    net, _ = load_generator(cfg, None, device="cpu")
    svc = serve.SRService(cfg, net, max_size=max_size, max_batch=2,
                          window_ms=5.0)
    try:
        nb = len(svc.buckets)
        assert nb >= 2
        svc.warmup(batch_sizes=(2,))
        assert svc.shapes_run == {(b, b, m, 2) for b in svc.buckets
                                  for m in ("2x", "restore")}
        svc.shapes_run.clear()
        svc.warmup(rect=True)
        pairs = {k[:3] for k in svc.shapes_run}
        assert len(pairs) == nb ** 2 * 2
        assert {k[3] for k in svc.shapes_run} == {1, 2}
        if cfg.patch_based:
            assert len(svc._fns) == nb ** 2 * 2
        before, fns = set(svc.shapes_run), len(svc._fns)
        h, w = svc.buckets[0] - 2, svc.buckets[1] - 2    # non-square
        out = svc.submit(np.random.RandomState(12).rand(h, w)
                         .astype(np.float32))
        assert out.shape == (2 * h, 2 * w) and np.isfinite(out).all()
        assert svc.shapes_run == before and len(svc._fns) == fns
    finally:
        svc.close()


def test_serve_parser_takes_warmup_rect(monkeypatch):
    """`serve --warmup-rect` alone warms (rect=True), as the JAX server's
    `args.warmup or args.warmup_rect` does."""
    monkeypatch.setenv("ngf", "4")
    seen = []
    warmup = serve.SRService.warmup

    def spy(self, *a, **kw):
        seen.append(kw)
        return warmup(self, *a, **kw)

    class Srv:
        def serve_forever(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(serve.SRService, "warmup", spy)
    monkeypatch.setattr(serve, "make_http_server", lambda *a, **k: Srv())
    _, out = _run(serve.main, ["--cpu", "--config", "gray-3", "--max-size",
                               "12", "--warmup-rect", "--port", "0"])
    assert seen == [{"rect": True}]
    assert any(line.startswith("warmup: 4 shapes") for line in out), out


# ---- select_checkpoint ------------------------------------------------------

def test_select_checkpoint_skips_a_torn_epoch_and_ranks_as_jax(
        tmp_path, monkeypatch):
    """Checkpoints written by the JAX package's save_checkpoint, epoch 2's G
    torn (its D intact): the SKIPPED line, and every epoch's train-slice
    PSNR within 1e-3 dB of the JAX harness on the same checkpoint, so the
    same BEST epoch."""
    for k, v in (("ngf", "4"), ("ndf", "8"), ("fineSize", "32")):
        monkeypatch.setenv(k, v)
    jcfg = j_get_config("gray-3")
    src = JTextured(jcfg.fineSize, nc=1, seed=1234)
    want = {}
    for ep in (1, 2, 3):
        st = j_init_state(jcfg, jax.random.PRNGKey(ep))
        j_save(str(tmp_path), jcfg.name, ep, st)
        if ep != 2:
            want[ep] = JH.evaluate_slice(jcfg, None, st.g_params, st.g_state,
                                         src, range(1), batch_size=100)
    with open(checkpoint_path(str(tmp_path), jcfg.name, 2, "G"), "wb") as f:
        f.write(b"PK\x03\x04 truncated mid-write")

    got = []
    evaluate = select_checkpoint.evaluate_slice

    def spy(*a, **kw):
        got.append(evaluate(*a, **kw))
        return got[-1]

    monkeypatch.setattr(select_checkpoint, "evaluate_slice", spy)
    best, out = _run(select_checkpoint.main, [
        "--dir", str(tmp_path), "--cpu", "--select-sets", "1"])
    assert any(line.startswith("epoch 2: SKIPPED unreadable checkpoint")
               for line in out), out
    assert len(got) == 2
    for r, ep in zip(got, (1, 3)):
        assert r.n_images == want[ep].n_images == 100
        assert abs(r.psnr_generator - want[ep].psnr_generator) <= PSNR_TOL
        assert abs(r.ssim_generator - want[ep].ssim_generator) <= SSIM_TOL
    jbest = max(want, key=lambda e: want[e].psnr_generator)
    assert best[0] == jbest
    assert f"BEST by train-slice PSNR: epoch {jbest} (" in out[-1]


# ---- overlap_protocol -------------------------------------------------------

@pytest.mark.parametrize("bn_eval", [False, True])
def test_overlap_protocol_rows_match_the_harness_and_jax(tmp_path,
                                                         monkeypatch,
                                                         bn_eval):
    """The tool's three rows equal the port's harness called directly on the
    same checkpoint; its set's means are within 1e-3 dB / 1e-4 of the JAX
    evaluate_overlap_slice (both BN modes; fineSize 32: 49 tiles an
    image)."""
    for k, v in (("ngf", "4"), ("ndf", "8"), ("fineSize", "32")):
        monkeypatch.setenv(k, v)
    jcfg = j_get_config("gray-patch-batch-overlap")
    st = j_init_state(jcfg, jax.random.PRNGKey(4))
    j_save(str(tmp_path), jcfg.name, 1, st)
    ckpt = checkpoint_path(str(tmp_path), jcfg.name, 1, "G")
    argv = ["--ckpt", ckpt, "--cpu", "--sets", "10000:10001"]
    res, out = _run(overlap_protocol.main, argv + (["--bn-eval"] * bn_eval))

    cfg = get_config("gray-patch-batch-overlap")
    net, _ = load_generator(cfg, ckpt, need_state=True, device="cpu")
    direct = evaluate_overlap_slice(cfg, net, TexturedImages(32, nc=1,
                                                             seed=1234),
                                    range(10000, 10001), bn_eval=bn_eval,
                                    batch_size=100)
    rows = [f"{name:13s} PSNR {p:.5f}  SSIM {s:.6f}" for name, p, s in (
        ("bilinear", direct.psnr_bilinear, direct.ssim_bilinear),
        ("naive-stitch", direct.psnr_naive, direct.ssim_naive),
        ("seam-stitch", direct.psnr_seam, direct.ssim_seam))]
    assert out == rows + ["(100 images)"]

    want = JH.evaluate_overlap_slice(jcfg, st.g_params, st.g_state,
                                     JTextured(32, nc=1, seed=1234),
                                     range(10000, 10001), bn_eval=bn_eval,
                                     batch_size=100)
    for f in ("psnr_bilinear", "psnr_naive", "psnr_seam", "ssim_bilinear",
              "ssim_naive", "ssim_seam"):
        tol = PSNR_TOL if f.startswith("psnr") else SSIM_TOL
        assert abs(getattr(res, f) - getattr(want, f)) <= tol, f


# ---- serve_load ---------------------------------------------------------------

def test_serve_load_drives_the_ports_server():
    """The load client against the port's HTTP server (mirrors
    tests/test_serve.py test_serve_load_driver): every phase line is JSON in
    order, the /healthz counters flow through, --warm 0 / --rounds 0 skip
    their phases."""
    cfg = get_config("gray-3", env_override=False, fineSize=16, ngf=4,
                     ndf=8)
    net, _ = load_generator(cfg, None, device="cpu")
    svc = serve.SRService(cfg, net, max_size=32, max_batch=4, window_ms=30.0)
    srv = serve.make_http_server(svc, port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        _, out = _run(serve_load.main, [
            "--port", str(port), "--size", "20x24", "--warm", "3",
            "--concurrency", "2", "--rounds", "1"])
        lines = [json.loads(x) for x in out]
        assert [x["phase"] for x in lines] == [
            "cold_first", "warm_single", "concurrent", "concurrent_summary",
            "healthz"]
        assert lines[0]["resp_bytes"] > 0
        assert lines[1]["n"] == 3 and lines[1]["median_ms"] > 0
        assert lines[2]["c"] == 2 and len(lines[2]["req_ms"]) == 2
        assert lines[2]["errors"] == []
        assert lines[3]["median_req_per_s"] > 0
        assert lines[4]["requests"] == 6 and lines[4]["errors"] == 0
        assert lines[4]["batch_ms_p50"] > 0
        _, out = _run(serve_load.main, [
            "--port", str(port), "--size", "20x24", "--warm", "0",
            "--concurrency", "2", "--rounds", "0"])
        assert [json.loads(x)["phase"] for x in out] == ["cold_first",
                                                         "healthz"]
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


# ---- loader_bench -------------------------------------------------------------

def test_loader_bench_prints_the_jax_tools_metrics():
    argv = ["--images", "8", "--batches", "2", "--batch-size", "4"]
    _, out = _run(loader_bench.main, argv)
    _, jout = _run(j_loader_bench.main, argv)
    got, want = [json.loads(x) for x in out], [json.loads(x) for x in jout]
    assert [g["metric"] for g in got] == [w["metric"] for w in want] == [
        "folder_sample_images_per_sec", "folder_prefetch4_images_per_sec",
        "folder_canvas_images_per_sec"]
    assert all(g["unit"] == "images/sec" and g["value"] > 0 for g in got)
