"""The port's training tools (python -m dcgan_sr_tpu_torch.zssr_photo,
validate_bf16, quality_protocol) against the JAX package's, on the CPU at
small sizes (the other tools: test_torch_tools.py).

Every tool runs with --cpu (a card runs K1 and K2; the CPU their plain
versions).  Weights are copied from a JAX init; results are never compared
through seeds.  Tolerances: slice-mean and held-out PSNR 1e-3 dB, SSIM
1e-4; the importer's arrays equal; the imported G's forward within 1e-5 of
apply_network; the zssr crops byte for byte."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.data.synthetic import TexturedImages as JTextured
from dcgan_sr_tpu.evaluation import harness as JH
from dcgan_sr_tpu.train import init_train_state as j_init_state
from dcgan_sr_tpu_torch import quality_protocol, validate_bf16, zssr_photo
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
from dcgan_sr_tpu_torch.train.step import params_of, state_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import zssr_photo as j_zssr_photo  # noqa: E402

PSNR_TOL, SSIM_TOL = 1e-3, 1e-4


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue().splitlines()


def _fields(st):
    return {f: jax.tree_util.tree_map(np.asarray, getattr(st, f)) for f in
            ("g_params", "g_state", "g_opt", "d_params", "d_state", "d_opt",
             "g_ema_params")}


# ---- zssr_photo -------------------------------------------------------------

def _photo(path, h=96, w=72):
    from PIL import Image
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 5.0)
           + 0.2 * rng.rand(h, w))
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
    return str(path)


ZSSR_ARGS = ["--cpu", "--steps", "4", "--scan", "2", "--batch", "3",
             "--seed", "7"]


def _zssr_line(out):
    line = [x for x in out if x.startswith("ZSSR_PHOTO ")]
    assert len(line) == 1, out
    return json.loads(line[0][len("ZSSR_PHOTO "):])


def test_zssr_photo_crops_and_held_out_psnr_match_jax(tmp_path, monkeypatch):
    """The same photo and seed: the port draws the JAX tool's crops byte for
    byte, and with G's weights copied from the JAX tool's init (training
    replaced by a recorder in both), the held-out PSNR/SSIM of both BN
    modes agree within 1e-3 dB / 1e-4; the ZSSR_PHOTO keys are the JAX
    tool's."""
    import dcgan_sr_tpu.train.multi_step as JMS

    photo = _photo(tmp_path / "photo.png")
    crops = {"jax": [], "port": []}

    def j_fake(cfg):
        def mstep(state, sb):
            crops["jax"].append(np.asarray(sb))
            z = jnp.zeros(sb.shape[0])
            return state, {"errG": z, "errD": z}
        return mstep

    monkeypatch.setattr(JMS, "jit_multi_step", j_fake)
    _, jout = _run(j_zssr_photo.main, ["--input", photo] + ZSSR_ARGS)
    want = _zssr_line(jout)

    class Recorder:
        def __init__(self, cfg):
            self.captured = self.replayed = {}

        def __call__(self, state, sb):
            crops["port"].append(sb.numpy().copy())
            z = torch.zeros(sb.shape[0])
            return state, {"errG": z, "errD": z}

        def stats(self):
            return {"captured": {}, "replayed": {}}

    def init_from_jax(cfg, generator, device):
        jcfg = j_get_config("gray-3", env_override=False, batchSize=3)
        return state_from_numpy(cfg, _fields(
            j_init_state(jcfg, jax.random.PRNGKey(7))), device)

    monkeypatch.setattr(zssr_photo, "build_multi_step", Recorder)
    monkeypatch.setattr(zssr_photo, "init_train_state", init_from_jax)
    got, out = _run(zssr_photo.main, ["--input", photo] + ZSSR_ARGS)
    assert got == _zssr_line(out)

    assert len(crops["port"]) == len(crops["jax"]) == 2
    for a, b in zip(crops["port"], crops["jax"]):
        assert a.shape == (2, 3, 1, 64, 64) and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.startswith("psnr"):
            assert abs(got[k] - v) <= PSNR_TOL, k
        elif k.startswith("ssim"):
            assert abs(got[k] - v) <= SSIM_TOL, k
        elif k != "train_time_s":
            assert got[k] == v, k


def test_zssr_photo_trains_and_writes_its_outputs(tmp_path):
    """The tool as a user runs it (training included): finite losses, the
    checkpoint and the held-out SR image written."""
    photo = _photo(tmp_path / "photo.png")
    res, out = _run(zssr_photo.main, [
        "--input", photo, "--cpu", "--steps", "3", "--scan", "2",
        "--batch", "4", "--ckpt-out", str(tmp_path / "ck"),
        "--sr-out", str(tmp_path / "sr.png")])
    assert "rounding 3 steps up to 4 (2 dispatches of --scan 2)" in out
    assert res["steps"] == 4 and res["holdout_hw"] == [24, 72]
    assert all(np.isfinite(v) for k, v in res.items()
               if k.startswith(("psnr", "ssim")))
    assert os.path.isfile(tmp_path / "ck" / "dcgan-sr-tpu_4_net_G.npz")
    assert os.path.isfile(tmp_path / "sr.png")
    assert out[-1].startswith("kernel launches: ")


# ---- validate_bf16 ----------------------------------------------------------

def test_validate_bf16_starts_both_dtypes_from_one_set_of_weights(
        monkeypatch):
    """Two K = 2 chunks at small width: the fp32 and the bf16 run start from
    equal weights (one copied draw), each on a runner of its own, and the
    PASS/FAIL line is printed."""
    first = []
    build = validate_bf16.build_multi_step

    def spy(cfg):
        runner = build(cfg)
        call = runner.__call__

        class Spy:
            def __call__(self, state, batches):
                if not any(r is runner for r, _, _ in first):
                    first.append((runner, cfg.compute_dtype, [
                        p.detach().clone() for p in params_of(state.g)
                        + params_of(state.d)]))
                return call(state, batches)

            def __getattr__(self, name):
                return getattr(runner, name)
        return Spy()

    monkeypatch.setattr(validate_bf16, "build_multi_step", spy)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = validate_bf16.run(steps=4, batch=4, device="cpu", k=2, ngf=4,
                               ndf=8)
    out = buf.getvalue().splitlines()
    assert [d for _, d, _ in first] == ["float32", "bfloat16"]
    assert first[0][0] is not first[1][0]
    for a, b in zip(first[0][2], first[1][2]):
        assert torch.equal(a, b)
    verdict = [x for x in out if x.startswith("delta PSNR ")]
    assert len(verdict) == 1
    assert verdict[0].endswith("-> PASS" if ok else "-> FAIL")
    assert out[0].startswith("float32  : G-PSNR ")
    assert out[1].startswith("bfloat16 : G-PSNR ")


@pytest.mark.parametrize("before", [(False, True), (True, False)])
def test_validate_bf16_runs_under_deterministic_cudnn(monkeypatch, before):
    """Both runs and both scores use cuDNN's deterministic algorithms with
    autotuning off (two card runs then give the same verdict), and the
    caller's two settings come back afterwards, also when the run raises."""
    cudnn = torch.backends.cudnn
    seen = []
    build, score = validate_bf16.build_multi_step, validate_bf16.evaluate_slice

    def spy_build(cfg):
        seen.append(("build", cfg.compute_dtype, cudnn.deterministic,
                     cudnn.benchmark))
        return build(cfg)

    def spy_score(*a, **kw):
        seen.append(("eval", None, cudnn.deterministic, cudnn.benchmark))
        return score(*a, **kw)

    monkeypatch.setattr(validate_bf16, "build_multi_step", spy_build)
    monkeypatch.setattr(validate_bf16, "evaluate_slice", spy_score)
    monkeypatch.setattr(cudnn, "deterministic", before[0])
    monkeypatch.setattr(cudnn, "benchmark", before[1])
    with contextlib.redirect_stdout(io.StringIO()):
        validate_bf16.run(steps=2, batch=4, device="cpu", k=2, ngf=4, ndf=8)
    assert [s[:2] for s in seen] == [("build", "float32"), ("eval", None),
                                     ("build", "bfloat16"), ("eval", None)]
    assert all(s[2:] == (True, False) for s in seen)
    assert (cudnn.deterministic, cudnn.benchmark) == before

    def fail(cfg):
        raise RuntimeError("runner refused")

    monkeypatch.setattr(validate_bf16, "build_multi_step", fail)
    with pytest.raises(RuntimeError, match="runner refused"):
        validate_bf16.run(steps=2, batch=4, device="cpu", k=2, ngf=4, ndf=8)
    assert (cudnn.deterministic, cudnn.benchmark) == before


# ---- quality_protocol -------------------------------------------------------

def _baseline_npz(path, jcfg, key):
    """torch_weights.npz as tools/torch_baseline.py writes it: every
    Conv2d/ConvTranspose2d weight and BatchNorm2d affine of the JAX
    package's spec_to_torch Sequential, by module index."""
    import torch.nn as nn

    from dcgan_sr_tpu.compat.pytorch_bridge import (copy_params_to_torch,
                                                    spec_to_torch)
    from dcgan_sr_tpu.models import discriminator_spec, init_network as j_init
    from dcgan_sr_tpu.models import generator_spec as j_gspec

    tensors, params = {}, {}
    for tag, spec, k in (("g", j_gspec(jcfg), key),
                         ("d", discriminator_spec(jcfg), key + 1)):
        p, s = j_init(jax.random.PRNGKey(k), spec)
        # BN affines away from their init, so that a swap would show
        p = [{n: (a if n == "w" else a + 0.1 * (i + 1))
              for n, a in layer.items()} for i, layer in enumerate(p)]
        params[tag] = (p, s)
        for i, m in enumerate(copy_params_to_torch(spec_to_torch(spec), p)):
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                tensors[f"{tag}_{i}_w"] = m.weight.detach().numpy()
            elif isinstance(m, nn.BatchNorm2d):
                tensors[f"{tag}_{i}_bn_w"] = m.weight.detach().numpy()
                tensors[f"{tag}_{i}_bn_b"] = m.bias.detach().numpy()
    np.savez(path, **tensors)
    return params


@pytest.mark.parametrize("variant", ["gray-3", "gray-patch-batch-overlap",
                                     "rgb-full", "gray"])
def test_quality_protocol_importer_matches_jax(tmp_path, variant):
    """At small width the port's positional importer gives the arrays of
    the JAX tool's load_torch_weights_into_params, and the imported G's
    forward is within 1e-5 of the JAX apply_network."""
    from dcgan_sr_tpu.compat.pytorch_bridge import spec_to_torch
    from dcgan_sr_tpu.models import apply_network, init_network as j_init
    from dcgan_sr_tpu.models import generator_spec as j_gspec
    from tools.quality_protocol import load_torch_weights_into_params

    jcfg = j_get_config(variant, env_override=False, ngf=4, ndf=8)
    cfg = get_config(variant, env_override=False, ngf=4, ndf=8)
    _baseline_npz(tmp_path / "w.npz", jcfg, 3)
    npz = np.load(tmp_path / "w.npz")
    j_spec = j_gspec(jcfg)
    p0, s0 = j_init(jax.random.PRNGKey(0), j_spec)
    want = load_torch_weights_into_params(npz, "g", spec_to_torch(j_spec), p0)
    spec = generator_spec(cfg)
    t0 = init_network(spec, torch.Generator().manual_seed(0))[0]
    got = quality_protocol.load_torch_weights_into_params(npz, "g", spec, t0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))

    state = jax.tree_util.tree_map(np.asarray, s0)
    lr = np.random.RandomState(1).rand(
        3, cfg.nc, cfg.fineSize // 2, cfg.fineSize // 2).astype(np.float32)
    if cfg.patch_based:
        lr = lr[..., :cfg.patchSize // 2, :cfg.patchSize // 2]
    j_out, _ = apply_network(j_spec, want, jnp.asarray(lr), s0, train=True)
    with torch.no_grad():
        t_out = Network(spec, got, state, device="cpu")(torch.from_numpy(lr))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5,
                               rtol=0)


def test_quality_protocol_skip_twin_scores_the_imported_weights(tmp_path):
    """`--skip-twin --cpu` on a baseline directory in torch_baseline's
    format (gray-3 at full width, as the tool's config has it): the
    imported G's train-slice means equal the JAX harness on the same
    weights within 1e-3 dB / 1e-4, fused == unfused forward, the table
    printed."""
    jcfg = j_get_config("gray-3", env_override=False, batchSize=20)
    params = _baseline_npz(tmp_path / "torch_weights.npz", jcfg, 5)
    res = {"psnr_generator": 20.0, "ssim_generator": 0.8,
           "psnr_bilinear": 28.0, "ssim_bilinear": 0.97}
    with open(tmp_path / "result.json", "w") as f:
        json.dump({"config": "gray-3", "epochs": 1, "ntrain": 40, "seed": 1,
                   "train": res, "test": res}, f)
    (rows, diff), out = _run(quality_protocol.main, [
        "--torch-dir", str(tmp_path), "--skip-twin", "--cpu"])
    assert [r[0] for r in rows] == ["torch-trained, OUR eval"]
    assert diff <= 1e-5
    assert "| stack | train PSNR/SSIM | test PSNR/SSIM |" in out
    assert out[-2].startswith("forward max|diff| = ")
    g_params, s0 = params["g"]
    src = JTextured(64, nc=1, seed=1234)
    got, test = rows[0][1:]
    want = JH.evaluate_slice(jcfg, None, g_params, s0, src, range(5))
    assert got.n_images == want.n_images == test.n_images == 100
    assert abs(got.psnr_generator - want.psnr_generator) <= PSNR_TOL
    assert abs(got.ssim_generator - want.ssim_generator) <= SSIM_TOL
