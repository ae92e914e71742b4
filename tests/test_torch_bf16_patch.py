"""The patch variants in bf16 on the CPU: the gray-patch-batch train step
against the JAX package's bf16 step (the helpers and tolerances of
tests/test_torch_bf16_step.py, at 128 patches of 8x8, two images' grids),
the patch variants' trainer batches (cli.build_data's grid extraction
against the JAX CLI's build_data on the same procedural images), the CLI's
data routing, and the training CLI training gray-patch-batch in bf16 with a
bf16 feed, then resuming."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dcgan_sr_tpu import cli as jcli
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu_torch import cli
from dcgan_sr_tpu_torch.core import get_config

from test_torch_bf16_step import (check_gradients, check_losses,
                                  check_parameters_and_statistics)

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bf16_patch_step_losses_match_jax():
    check_losses("gray-patch-batch")


def test_bf16_patch_step_gradients_match_jax():
    check_gradients("gray-patch-batch")


def test_bf16_patch_step_parameters_and_statistics_match_jax():
    check_parameters_and_statistics("gray-patch-batch")


def _images(n, nc=1, size=64, seed=0):
    return np.random.RandomState(seed).rand(n, nc, size, size).astype(
        np.float32)


@pytest.mark.parametrize("variant", ["gray-patch", "gray-patch-batch",
                                     "gray-patch-batch-overlap"])
def test_patch_batches_match_the_jax_cli(variant, monkeypatch):
    """The same procedural images through both CLIs' build_data: the grid
    of patchSize tiles of each image, images_consumed_per_step images a
    step, (B*(64/8)^2, 1, 8, 8)."""
    kw = dict(env_override=False)
    jcfg, cfg = j_get_config(variant, **kw), get_config(variant, **kw)
    args = type("A", (), {"synthetic": True, "textured": False,
                          "data_root": None, "native_loader": False})()
    _, jfn = jcli.build_data(jcfg, args)
    _, fn = cli.build_data(cfg, args)
    for step in (0, 3):
        want, got = np.asarray(jfn(1, step)), fn(1, step)
        n = cfg.images_consumed_per_step
        assert got.shape == (n * 64, 1, 8, 8) == want.shape
        np.testing.assert_array_equal(got, want)
    imgs = _images(2)
    tiles = cli.patch_grid(imgs, 8)
    assert np.array_equal(tiles[9, 0], imgs[0, 0, 8:16, 8:16])
    assert np.array_equal(tiles[64 + 63, 0], imgs[1, 0, 56:, 56:])


def _cli(args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"ngf": "4", "ndf": "8"})
    return subprocess.run(
        [sys.executable, "-m", "dcgan_sr_tpu_torch.cli", "--cpu", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


def test_cli_trains_a_patch_variant_in_bf16_and_resumes(tmp_path):
    ck = str(tmp_path)
    base = ["--config", "gray-patch-batch", "--synthetic", "--bf16",
            "--feed-bf16", "--seed", "1", "--checkpoint-dir", ck]
    r = _cli(base + ["--steps", "2", "--epochs", "1"])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert "compute_dtype='bfloat16'" in lines[0]
    steps = [l for l in lines if l.startswith("Epoch: [1]")]
    assert len(steps) == 2
    for l in steps:
        assert "nan" not in l and "inf" not in l
    name = get_config("gray-patch-batch", env_override=False).name
    assert {f"{name}_1_net_G.npz", f"{name}_1_net_D.npz"} <= set(os.listdir(ck))
    r = _cli(base + ["--steps", "1", "--epochs", "2", "--resume"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed from epoch 1" in r.stdout.splitlines()
    with np.load(os.path.join(ck, f"{name}_2_net_G.npz")) as data:
        assert int(data["_opt_/_t_"]) == 3


def test_cli_routes_data_as_the_jax_cli(tmp_path, capsys):
    """A route that exists loads through the loader the JAX CLI picks, and
    gives the JAX CLI's batches; one that does not prints the JAX CLI's line
    for the right loader and falls back to the procedural source."""
    from PIL import Image

    from dcgan_sr_tpu.core import get_config as jget

    cfg = get_config("gray-3", env_override=False, batchSize=2)
    rng = np.random.RandomState(0)
    for n in range(1, 5):                    # CelebA-like %06d.jpg files
        Image.fromarray((rng.rand(109, 89, 3) * 255).astype(np.uint8)).save(
            str(tmp_path / f"{n:06d}.jpg"), quality=90)
    A = lambda **kw: type("A", (), {"synthetic": False, **kw})()  # noqa: E731
    loader, fn = cli.build_data(cfg, A(data_root=str(tmp_path)))
    jloader, jfn = jcli.build_data(jget("gray-3", env_override=False,
                                        batchSize=2),
                                   A(data_root=str(tmp_path)))
    try:
        assert type(loader).__name__ == "IndexedCelebA"
        np.testing.assert_array_equal(fn(1, 1), np.asarray(jfn(1, 1)))
    finally:
        loader.close()
    assert cli.build_data(cfg, A(data_root=str(tmp_path), synthetic=True))[1](
        1, 0).shape == (2, 1, 64, 64)
    missing = str(tmp_path / "missing")
    capsys.readouterr()
    cli.build_data(cfg, A(data_root=missing))
    assert capsys.readouterr().out == (f"indexed CelebA not found at {missing};"
                                       " using synthetic data\n")
    rgb = get_config("rgb-full", env_override=False, batchSize=2, nThreads=1,
                     manualSeed=3)
    jrgb = jget("rgb-full", env_override=False, batchSize=2, nThreads=1,
                manualSeed=3)
    loader, fn = cli.build_data(rgb, A(data_root=str(tmp_path)))
    jloader, jfn = jcli.build_data(jrgb, A(data_root=str(tmp_path)))
    try:
        assert type(loader).__name__ == "PrefetchLoader"
        for _ in range(2):             # the same seeded worker streams
            np.testing.assert_array_equal(fn(1, 0), np.asarray(jfn(1, 0)))
    finally:
        loader.close()
        jloader.close()
    capsys.readouterr()
    _, fn = cli.build_data(rgb, A(data_root=missing))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"DATA_ROOT {missing} not found; falling back to " \
                     "synthetic data"
    assert out[-1].startswith(f"indexed CelebA not found at {missing}")
    assert fn(1, 0).shape == (2, 3, 64, 64)
