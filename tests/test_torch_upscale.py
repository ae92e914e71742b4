"""The port's upscale tool (python -m dcgan_sr_tpu_torch.upscale) and the
image/metric ops under it, against the JAX package on the CPU with the
full-width gray-3 fixture.

Tolerances: image ops 1e-6 (the same few fp32 products); PSNR lines to the
printed 3 decimals; saved PNGs within 1 level of 255 (an fp32 difference
of a few ulp can cross a rounding edge)."""

import contextlib
import dataclasses
import io
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.image import io as JIO
from dcgan_sr_tpu.image import ops as JO
from dcgan_sr_tpu.infer.tiled import make_full_sr_fn as j_full_sr_fn
from dcgan_sr_tpu.metrics import cal_psnr as j_psnr
from dcgan_sr_tpu.train import init_train_state
from dcgan_sr_tpu.train.checkpoint import load_branch as j_load_branch
from dcgan_sr_tpu_torch import upscale
from dcgan_sr_tpu_torch.image import io as TIO
from dcgan_sr_tpu_torch.image import ops as TO
from dcgan_sr_tpu_torch.metrics import cal_psnr, cal_psnr_batch

import torch_threads  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "gray3_textured_net_G.npz")


def test_image_ops_match_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 3, 10, 14).astype(np.float32)
    np.testing.assert_allclose(TO.box_downsample2(torch.from_numpy(x)).numpy(),
                               np.asarray(JO.box_downsample2(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TO.rgb2gray(torch.from_numpy(x)).numpy(),
                               np.asarray(JO.rgb2gray(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    for oh, ow in ((20, 28), (7, 5), (10, 14), (1, 3)):
        np.testing.assert_allclose(
            TO.resize_bilinear(torch.from_numpy(x), oh, ow).numpy(),
            np.asarray(JO.resize_bilinear(jnp.asarray(x), oh, ow)),
            rtol=1e-6, atol=1e-6)


def test_psnr_matches_jax():
    rng = np.random.RandomState(1)
    a = rng.rand(3, 12, 9).astype(np.float32)
    b = (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)
    np.testing.assert_allclose(float(cal_psnr(a[0], b[0])),
                               float(j_psnr(jnp.asarray(a[0]), jnp.asarray(b[0]))),
                               rtol=1e-6)
    np.testing.assert_allclose(cal_psnr_batch(a, b).numpy(),
                               [float(j_psnr(jnp.asarray(x), jnp.asarray(y)))
                                for x, y in zip(a, b)], rtol=1e-6)
    assert float(cal_psnr(a[0], a[0])) == 99.0


def test_image_io_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    path = str(tmp_path / "rgb.png")
    Image.fromarray((rng.rand(9, 11, 3) * 255).astype(np.uint8)).save(path)
    for nc in (1, 3):
        for dtype in ("float", "byte"):
            np.testing.assert_array_equal(TIO.load_image(path, nc, dtype),
                                          JIO.load_image(path, nc, dtype))
    img = rng.rand(9, 11).astype(np.float32)
    TIO.save_image(str(tmp_path / "t.png"), img)
    JIO.save_image(str(tmp_path / "j.png"), img, native=False)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


@pytest.fixture(scope="module")
def jax_weights():
    cfg = j_get_config("gray-3", env_override=False)
    st = init_train_state(cfg, jax.random.PRNGKey(0))
    with np.load(FIXTURE) as data:
        return (cfg, j_load_branch(data, "params", st.g_params),
                j_load_branch(data, "state", st.g_state))


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        upscale.main(["--cpu", "--ckpt", FIXTURE] + argv)
    return buf.getvalue()


@pytest.mark.parametrize("bn_eval", [False, True])
def test_upscale_protocol_matches_jax(tmp_path, jax_weights, bn_eval):
    cfg, gp, gs = jax_weights
    rng = np.random.RandomState(3)
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    Image.fromarray((rng.rand(22, 30) * 255).astype(np.uint8)).save(src)
    out = _run(["--input", src, "--output", dst]
               + (["--bn-eval"] if bn_eval else []))
    hw = TIO.load_image(src, nc=1)[0]
    want = np.asarray(j_full_sr_fn(cfg, bn_eval=bn_eval)(
        gp, gs, jnp.asarray(hw)[None, None]))[0, 0]
    got = np.asarray(Image.open(dst), np.int16)
    want8 = np.clip(np.round(want * 255.0), 0, 255).astype(np.int16)
    assert got.shape == (22, 30) and np.abs(got - want8).max() <= 1
    psnr = float(re.search(r"PSNR\(G\)=([0-9.]+)", out).group(1))
    assert psnr == pytest.approx(float(j_psnr(jnp.asarray(hw),
                                              jnp.asarray(want))), abs=1e-3)
    assert "PSNR(bilinear)=" in out


def test_upscale_true_2x_directory(tmp_path, jax_weights):
    cfg, gp, gs = jax_weights
    rng = np.random.RandomState(4)
    ind, outd = tmp_path / "in", tmp_path / "out"
    ind.mkdir()
    for name, shape in (("a.png", (12, 16)), ("b.png", (10, 7))):
        Image.fromarray((rng.rand(*shape) * 255).astype(np.uint8)).save(ind / name)
    out = _run(["--input", str(ind), "--output", str(outd), "--true-2x"])
    assert "a.png: 12x16 -> 24x32" in out and "b.png: 10x7 -> 20x14" in out
    imgs = [TIO.load_image(str(ind / n), nc=1)[0] for n in ("a.png", "b.png")]
    batch = np.stack([np.pad(im, ((0, 12 - im.shape[0]), (0, 16 - im.shape[1])),
                             mode="edge") for im in imgs])
    want = np.asarray(j_full_sr_fn(cfg, lr_input=True)(
        gp, gs, jnp.asarray(batch)[:, None]))[:, 0]
    for n, im, w in zip(("a", "b"), imgs, want):
        got = np.asarray(Image.open(outd / f"{n}_sr.png"), np.int16)
        h, wd = im.shape
        w8 = np.clip(np.round(w[:2 * h, :2 * wd] * 255.0), 0, 255)
        assert got.shape == (2 * h, 2 * wd)
        assert np.abs(got - w8.astype(np.int16)).max() <= 1


def test_upscale_refuses_unported_modes_and_cpu_fallback(tmp_path,
                                                          monkeypatch):
    """Grid and overlap modes are ported, and so is --t7: the fixture's
    weights exported as a reference Torch checkpoint upscale to the bytes
    of --ckpt.  --dp is ported: without a launcher it is the plain run
    (tests/test_torch_dp.py runs it over two ranks)."""
    from dcgan_sr_tpu_torch.compat import export_torch_generator
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.train.checkpoint import load_generator

    net, _ = load_generator(get_config("gray-3", env_override=False),
                            FIXTURE, device="cpu")
    t7 = export_torch_generator(str(tmp_path / "net_G.t7"), net.spec,
                                *net.trees())
    src = str(tmp_path / "in.png")
    Image.fromarray((np.random.RandomState(6).rand(22, 30) * 255)
                    .astype(np.uint8)).save(src)
    outs = []
    for weights in (["--ckpt", FIXTURE], ["--t7", t7]):
        dst = str(tmp_path / f"{weights[0][2:]}.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            upscale.main(["--cpu", "--config", "gray-3", "--bn-eval",
                          "--input", src, "--output", dst] + weights)
        outs.append(open(dst, "rb").read())
    assert f"loaded Torch checkpoint {t7}" in buf.getvalue()
    assert outs[0] == outs[1]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    dst = str(tmp_path / "dp.png")
    with contextlib.redirect_stdout(io.StringIO()):
        upscale.main(["--cpu", "--config", "gray-3", "--bn-eval", "--input",
                      src, "--output", dst, "--dp", "--ckpt", FIXTURE])
    assert open(dst, "rb").read() == outs[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--cpu"):
            upscale.main(["--input", "x.png", "--output",
                          str(tmp_path / "o.png")])


# ---- the patch configs: grid and overlap modes against tools/upscale.py ----

@pytest.fixture(scope="module")
def patch_ckpts(tmp_path_factory):
    """ngf-4 checkpoints of the two patch generators, saved by the JAX
    package, with running statistics away from the init's 0 / 1."""
    from dcgan_sr_tpu.train.checkpoint import save_checkpoint
    d = tmp_path_factory.mktemp("patch_ckpts")
    out = {}
    for variant in ("gray-patch-batch-overlap", "gray-patch"):
        cfg = j_get_config(variant, env_override=False, ngf=4, ndf=8)
        st = init_train_state(cfg, jax.random.PRNGKey(3))
        rng = np.random.RandomState(5)
        st = dataclasses.replace(st, g_state=jax.tree_util.tree_map(
            lambda a: jnp.asarray(0.5 + 0.3 * np.abs(rng.randn(*a.shape)),
                                  jnp.float32), st.g_state))
        sub = d / variant
        save_checkpoint(str(sub), cfg.name, 1, st)
        out[variant] = str(sub / f"{cfg.name}_1_net_G.npz")
    return out


def _jax_tool(monkeypatch, argv):
    """tools/upscale.py main() in this process (it reads sys.argv)."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools import upscale as j_upscale
    monkeypatch.setattr(sys, "argv", ["upscale.py", "--cpu"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        j_upscale.main()
    return buf.getvalue()


def _port_tool(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        upscale.main(["--cpu"] + argv)
    return buf.getvalue()


def _same_png(a, b, shape):
    got = np.asarray(Image.open(a), np.int16)
    want = np.asarray(Image.open(b), np.int16)
    assert got.shape == want.shape == shape
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("variant,mode,extra", [
    ("gray-patch-batch-overlap", "overlap", []),
    ("gray-patch-batch-overlap", "overlap", ["--bn-eval", "--both-seams"]),
    ("gray-patch-batch-overlap", "overlap",
     ["--self-ensemble", "4", "--ensemble-batched"]),
    ("gray-patch", "grid", []),
    ("gray-patch", "grid", ["--bn-eval"]),
    ("gray-patch", "auto", []),
], ids=["overlap", "overlap-bn_eval-both_seams", "overlap-tta4-batched",
        "grid", "grid-bn_eval", "auto-is-grid"])
def test_upscale_grid_and_overlap_match_jax_tool(tmp_path, monkeypatch,
                                                 patch_ckpts, variant, mode,
                                                 extra):
    monkeypatch.setenv("ngf", "4")
    monkeypatch.setenv("ndf", "8")
    src = str(tmp_path / "in.png")
    Image.fromarray((np.random.RandomState(6).rand(21, 30) * 255)
                    .astype(np.uint8)).save(src)
    argv = ["--config", variant, "--mode", mode, "--ckpt",
            patch_ckpts[variant], "--input", src] + extra
    want = _jax_tool(monkeypatch, argv + ["--output", str(tmp_path / "j.png")])
    got = _port_tool(argv + ["--output", str(tmp_path / "t.png")])
    _same_png(tmp_path / "t.png", tmp_path / "j.png", (21, 30))
    pad = re.search(r"padded 21x30 -> (\d+x\d+) for (\w+) tiling", got)
    assert pad and pad.groups() == re.search(
        r"padded 21x30 -> (\d+x\d+) for (\w+) tiling", want).groups()
    p_got = float(re.search(r"PSNR\(G\)=([0-9.]+)", got).group(1))
    p_want = float(re.search(r"PSNR\(G\)=([0-9.]+)", want).group(1))
    assert p_got == pytest.approx(p_want, abs=2e-3)


@pytest.mark.parametrize("extra", [[], ["--bn-eval"]], ids=["parity", "bn_eval"])
def test_upscale_tiled_true_2x_and_directory_match_jax_tool(
        tmp_path, monkeypatch, patch_ckpts, extra):
    monkeypatch.setenv("ngf", "4")
    monkeypatch.setenv("ndf", "8")
    variant = "gray-patch-batch-overlap"
    rng = np.random.RandomState(7)
    ind = tmp_path / "in"
    ind.mkdir()
    for name, shape in (("a.png", (11, 14)), ("b.png", (9, 6))):
        Image.fromarray((rng.rand(*shape) * 255).astype(np.uint8)).save(ind / name)
    base = ["--config", variant, "--ckpt", patch_ckpts[variant]] + extra
    # one LR image -> 2H x 2W through half-geometry tiles
    one = base + ["--true-2x", "--input", str(ind / "a.png")]
    _jax_tool(monkeypatch, one + ["--output", str(tmp_path / "j.png")])
    out = _port_tool(one + ["--output", str(tmp_path / "t.png")])
    assert "padded LR 11x14 -> 12x14 for overlap tiling" in out
    assert "true-2x: 11x14 -> 22x28" in out
    _same_png(tmp_path / "t.png", tmp_path / "j.png", (22, 28))
    # the directory, protocol mode and true-2x
    for flags, scale in (([], 1), (["--true-2x"], 2)):
        jd, td = tmp_path / f"j{scale}", tmp_path / f"t{scale}"
        _jax_tool(monkeypatch, base + flags + ["--input", str(ind),
                                               "--output", str(jd)])
        out = _port_tool(base + flags + ["--input", str(ind),
                                         "--output", str(td)])
        assert "batch: 2 images" in out
        for name, (h, w) in (("a", (11, 14)), ("b", (9, 6))):
            _same_png(td / f"{name}_sr.png", jd / f"{name}_sr.png",
                      (scale * h, scale * w))
