"""The port's dump_samples (dcgan_sr_tpu_torch.cli) against the JAX
package's on the CPU: the same initial weights (the JAX init, carried across
as numpy), the same sample, for gray-3, rgb-full (three channels), a pm1
variant, an nc = 1 config handed a raw RGB canvas, a patch variant and the
overlap variant (tests/test_dump_samples.py's cases).

Held equal: the file names; the PNG pixels within one level of 255; the
stats lines' names and order, their numbers within 1e-5 of their scale
(the generators agree to 1e-5 per pixel, and a sum adds 4096 of them); the
PSNR/SSIM lines within 1e-3.  utils/stats prints JAX's lines character for
character on the same array."""

import os
import re

import numpy as np
import pytest

import jax
from dcgan_sr_tpu.cli import dump_samples as j_dump_samples
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.train import init_train_state as j_init_train_state
from dcgan_sr_tpu.utils.stats import print_tensor_stats as j_print_stats
from dcgan_sr_tpu_torch.cli import dump_samples
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.image.io import load_image
from dcgan_sr_tpu_torch.train.step import state_from_numpy
from dcgan_sr_tpu_torch.utils.stats import print_tensor_stats, tensor_stats

import torch_threads  # noqa: F401

FIELDS = ("g_params", "g_state", "g_opt", "d_params", "d_state", "d_opt",
          "g_ema_params")
STAT = re.compile(r"^(\w+)-(max|sum): (-?[\d.]+)  \1-(min|std): (-?[\d.]+)$")
SCORE = re.compile(r"^(PSNR|SSIM) btwn real & (\w+): (-?[\d.]+)$")


def _run(variant, sample, tmp_path, capsys):
    kw = dict(env_override=False, ngf=4, ndf=8)
    jcfg, cfg = j_get_config(variant, **kw), get_config(variant, **kw)
    jst = j_init_train_state(jcfg, jax.random.PRNGKey(0))
    fields = {f: jax.tree_util.tree_map(np.asarray, getattr(jst, f))
              for f in FIELDS}
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    capsys.readouterr()
    j_dump_samples(jcfg, jst, str(jdir), sample)
    jout = capsys.readouterr().out.splitlines()
    dump_samples(cfg, state_from_numpy(cfg, fields, "cpu"), str(tdir), sample)
    tout = capsys.readouterr().out.splitlines()
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names and names
    for f in names:
        a = load_image(str(tdir / f), 3, "byte").astype(int)
        b = load_image(str(jdir / f), 3, "byte").astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, f
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        mt, mj = STAT.match(t) or SCORE.match(t), STAT.match(j) or SCORE.match(j)
        assert mt and mj, (t, j)
        nums = [i for i, g in enumerate(mt.groups()) if re.match(r"-?[\d.]+$", g)]
        assert [g for i, g in enumerate(mt.groups()) if i not in nums] == \
            [g for i, g in enumerate(mj.groups()) if i not in nums], (t, j)
        for i in nums:
            x, y = float(mt.groups()[i]), float(mj.groups()[i])
            tol = 1e-3 if SCORE.match(t) else 1e-5 * max(1.0, abs(y))
            assert abs(x - y) <= tol, (t, j)
    return names, tout


def test_gray3_dump(tmp_path, capsys):
    sample = np.random.RandomState(0).rand(1, 64, 64).astype(np.float32)
    names, _ = _run("gray-3", sample, tmp_path, capsys)
    assert names == ["fake_none_sample.png", "real_bilinear_sample.png",
                     "real_none_sample.png", "real_reduced_sample.png"]


def test_rgb_full_three_channel_dump(tmp_path, capsys):
    sample = np.random.RandomState(0).rand(3, 64, 64).astype(np.float32)
    names, _ = _run("rgb-full", sample, tmp_path, capsys)
    assert "real_none_color_sample.png" not in names


def test_pm1_variant_dump(tmp_path, capsys):
    base = np.random.RandomState(1).rand(64, 64).astype(np.float32)
    _run("gray", base, tmp_path, capsys)


def test_nc1_config_grays_a_raw_rgb_canvas(tmp_path, capsys):
    sample = np.random.RandomState(2).rand(3, 64, 64).astype(np.float32)
    names, _ = _run("gray", sample, tmp_path, capsys)
    assert "real_none_color_sample.png" in names


@pytest.mark.parametrize("variant", ["gray-patch-batch",
                                     "gray-patch-batch-overlap"])
def test_patch_variant_dump(variant, tmp_path, capsys):
    sample = np.random.RandomState(3).rand(64, 64).astype(np.float32)
    names, out = _run(variant, sample, tmp_path, capsys)
    if variant.endswith("overlap"):
        assert "fake_none_overlap_sample.png" in names
    assert any(line.startswith("PSNR btwn real & fake:") for line in out)


def test_stats_lines_equal_jax(capsys):
    x = np.random.RandomState(4).randn(3, 17, 5).astype(np.float32)
    lines, want = [], []
    print_tensor_stats("real_none_sample", x, log_fn=lines.append)
    j_print_stats("real_none_sample", x, log_fn=want.append)
    assert lines == want
    import torch
    assert tensor_stats(torch.from_numpy(x)) == tensor_stats(x)
    assert tensor_stats(np.ones(1))["std"] == 0.0
