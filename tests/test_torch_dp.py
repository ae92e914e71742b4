"""The port's data-parallel training and inference (parallel/dp.py, the DP
step of train/step.py, its K-step chunk, sharded SR in infer/tiled.py, and
`--dp` on the trainer and on upscale) on the CPU, over gloo.

Two launches of two ranks (tests/torch_dp_worker.py): job "dp" and job
"cli"; each rank writes one npz that the cases below read.  The JAX
references are computed here; the ranks never import jax.

The DP step: gray-3 at ngf 4 / ndf 8, global batch 16 (8 a rank), two
steps from the JAX init's weights (written with the JAX package's
save_checkpoint, read by the port's load_checkpoint):
  * the six metrics against the JAX single-device step at rtol 1e-3 /
    atol 1e-4 (tests/test_train_step.py test_dp_matches_single_device);
  * Adam's first moment after step 1 (m = (1 - beta1) g, which shows the
    gradient's scale) against the JAX step's, at the package-to-package
    gradient tolerance of tests/test_torch_train_step.py, and each
    network's gradient norm to 1e-3 of JAX's.  A tighter bound cannot hold
    in fp32: the single-device port and the JAX package already differ by
    fp32 noise through G's train-mode BN backward (up to 1.9e-3 of a G
    leaf's scale at this size, and 5.5e-6 on a D leaf of scale 1);
  * the same step in float64, DP (4 images, 2 a rank) against the port's
    single-device step: m and the running statistics at rtol 1e-4 /
    atol 1e-6, where only the DP decomposition differs;
  * the two ranks' states, bit for bit.
The K-step chunk (K = 3, global batch 4) against three single-device steps
at the tolerance of tests/test_multi_step.py; a device_augment tuple and a
patch variant's tiles (gray-patch-batch) through the DP step against the
single-device step; sharded overlap SR (naive and seam, per-image and
running BN, lr_input) and full SR against the unsharded call, atol 1e-5.

The trainer and upscale as users start them, each rank a launcher's rank
(RANK, WORLD_SIZE, MASTER_ADDR/PORT on localhost): `cli --cpu --dp` for two
steps logs the losses of a single-process run (the first step's at rtol
1e-4, the second's at the second-step tolerance of
tests/test_torch_train_step.py, rtol 2e-3 / atol 2e-4), only rank 0 saves; `upscale --cpu --dp` over 3 images (padded to 4) writes the bytes of
a run without --dp."""

import contextlib
import io
import json
import os
import socket
import sys

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from dcgan_sr_tpu.train.step import (build_train_step as j_build_train_step,
                                     init_train_state as j_init_train_state)
from dcgan_sr_tpu_torch import cli, upscale

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_threads  # noqa: E402,F401
from torch_dp_worker import flat, launch  # noqa: E402

REPO = os.path.dirname(HERE)
FIXTURE = os.path.join(REPO, "fixtures", "gray3_textured_net_G.npz")
KW = dict(env_override=False, ngf=4, ndf=8, batchSize=16)
FIELDS = ("g_params", "g_state", "g_opt", "d_params", "d_state", "d_opt",
          "g_ema_params")
G_NOISE = 1e-2       # tests/test_torch_train_step.py


def _j_flat(jst, prefix):
    out = {}
    for f in FIELDS:
        flat(jax.tree_util.tree_map(np.asarray, getattr(jst, f)),
             f"{prefix}/{f}", out)
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The two ranks' npz dicts, and the JAX step's metrics and state after
    each of the two steps."""
    jcfg = j_get_config("gray-3", **KW)
    jst = j_init_train_state(jcfg, jax.random.PRNGKey(3))
    weights = tmp_path_factory.mktemp("weights")
    j_save_checkpoint(str(weights), jcfg.name, 0, jst)
    ranks = launch("dp", 2, tmp_path_factory.mktemp("dp"),
                   json.dumps({"weights": str(weights)}))
    batches = np.random.RandomState(7).rand(2, 16, 1, 64, 64).astype(
        np.float32)
    step = jax.jit(j_build_train_step(jcfg))
    ref = {}
    for i in range(2):
        jst, m = step(jst, jnp.asarray(batches[i]))
        ref[f"metrics{i}"] = np.array([float(m[k]) for k in sorted(m)])
        ref.update(_j_flat(jst, f"state{i}"))
    return ranks, ref, jcfg


@pytest.mark.parametrize("i", [0, 1])
def test_dp_step_metrics_match_jax(dp, i):
    ranks, ref, _ = dp
    np.testing.assert_allclose(ranks[0][f"step/metrics{i}"],
                               ref[f"metrics{i}"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("net", ["g", "d"])
def test_dp_step_gradient_matches_jax(dp, net):
    ranks, ref, jcfg = dp
    scale = 1.0 / (1.0 - jcfg.beta1)
    key = f"state0/{net}_opt/m/"
    names = sorted(k for k in ref if k.startswith(key))
    assert names and names == sorted(k[5:] for k in ranks[0]
                                     if k.startswith("step/" + key))
    norms = np.zeros(2)
    for k in names:
        w, g = ref[k] * scale, ranks[0]["step/" + k] * scale
        big = np.abs(w).max()
        atol = G_NOISE * big if net == "g" else max(1e-6, 1e-5 * big)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol, err_msg=k)
        norms += [np.sum(g.astype(np.float64) ** 2),
                  np.sum(w.astype(np.float64) ** 2)]
    # the gradient's scale: a DP gradient off by any factor fails here
    assert abs(np.sqrt(norms[0] / norms[1]) - 1) < 1e-3


@pytest.mark.parametrize("field", ["g_opt/m", "d_opt/m", "g_state",
                                   "d_state"])
def test_dp_step_float64_equals_single_device(dp, field):
    got = dp[0][0]
    names = [k for k in got if k.startswith(f"f64_single/{field}/")]
    assert names
    for k in names:
        np.testing.assert_allclose(got["f64_dp" + k[10:]], got[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_dp_ranks_stay_bit_equal(dp):
    r0, r1 = dp[0]
    keys = [k for k in r0 if k.startswith(("step/", "f64_dp/", "multi/"))]
    assert len(keys) > 100
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_dp_multi_step_matches_single_steps(dp):
    r0, r1 = dp[0]
    np.testing.assert_allclose(r0["multi/errG"], r1["multi_single/errG"],
                               rtol=1e-4, atol=1e-5)
    keys = [k for k in r1 if k.startswith("multi_single/g_params/")]
    assert keys
    diff = max(np.abs(r0["multi/g_params/" + k[len("multi_single/g_params/"):]]
                      - r1[k]).max() for k in keys)
    # two Adam sign-steps of lr = 2e-4 bound fp32 reassociation noise
    assert diff < 2 * 2e-4


@pytest.mark.parametrize("case", ["augment", "patch"])
def test_dp_step_batches_match_single_device(dp, case):
    r0, r1 = dp[0]
    if case == "augment":
        assert bool(r0["augment/rows_match"]) and bool(r1["augment/rows_match"])
    np.testing.assert_allclose(r0[f"{case}/dp"], r0[f"{case}/single"],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(r0[f"{case}/dp"], r1[f"{case}/dp"])


@pytest.mark.parametrize("tag", [f"overlap/{b}{l}/{k}" for b in (0, 1)
                                 for l in (0, 1) for k in ("naive", "seam")]
                         + ["full/0", "full/1"])
def test_sharded_sr_matches_unsharded(dp, tag):
    r0, r1 = dp[0]
    alone = (r0 if tag + "_alone" in r0 else r1)[tag + "_alone"]
    for r in (r0, r1):                   # every rank returns the whole batch
        assert r[tag].shape == alone.shape and alone.shape[0] == 2 + 2 * (
            tag.startswith("full"))
        np.testing.assert_allclose(r[tag], alone, atol=1e-5)


# ---- the trainer and upscale under --dp --------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _in_process(main, args, env=()):
    saved = {k: os.environ.get(k) for k in dict(env)}
    os.environ.update(dict(env))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(args)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return buf.getvalue()


@pytest.fixture(scope="module")
def entry_points(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entry")
    src = tmp / "in"
    src.mkdir()
    rng = np.random.RandomState(5)
    for i, (h, w) in enumerate(((20, 24), (22, 22), (18, 26))):
        Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8)).save(
            src / f"im{i}.png")
    env = {"ngf": "4", "ndf": "8", "batchSize": "4"}

    def trainer(tag):
        return ["--cpu", "--config", "gray-3", "--synthetic", "--steps", "2",
                "--epochs", "1", "--seed", "1", "--checkpoint-dir",
                str(tmp / f"ck_{tag}"), "--metrics-jsonl",
                str(tmp / f"{tag}.jsonl")]

    def upscaler(tag):
        return ["--cpu", "--config", "gray-3", "--ckpt", FIXTURE, "--input",
                str(src), "--output", str(tmp / f"out_{tag}")]

    args = {"ports": [_free_port(), _free_port()],
            "cli": trainer("dp") + ["--dp"], "cli_env": env,
            "upscale": upscaler("dp") + ["--dp"]}
    (tmp / "ranks").mkdir()
    ranks = launch("cli", 2, tmp / "ranks", json.dumps(args))
    single = {"cli": _in_process(cli.main, trainer("single"), env),
              "upscale": _in_process(upscale.main, upscaler("single"))}
    return tmp, [json.loads(str(r["log"])) for r in ranks], \
        [r["saves"] for r in ranks], single


def _jsonl(path):
    return [json.loads(line) for line in open(path)]


def test_dp_cli_logs_the_single_process_losses(entry_points):
    tmp, logs, saves, single = entry_points
    dp_rows, one_rows = _jsonl(tmp / "dp.jsonl"), _jsonl(tmp / "single.jsonl")
    assert [r["step"] for r in dp_rows] == [r["step"] for r in one_rows] == \
        [0, 1]
    # step 1 from one state at rtol 1e-4; step 2 at the second-step
    # tolerance of tests/test_torch_train_step.py: Adam's first step is
    # sign-like, so fp32 noise in a near-zero gradient flips a whole lr step
    for a, b, tol in zip(dp_rows, one_rows, (dict(rtol=1e-4),
                                             dict(rtol=2e-3, atol=2e-4))):
        for k in ("errG", "errD", "errD_real", "errD_fake"):
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)
    assert "data-parallel over 2 ranks" in logs[0]["cli"]
    assert "Epoch: [1]" in logs[0]["cli"] and "Epoch:" not in logs[1]["cli"]
    # rank 0 alone saves: epoch 1's pair, as the single-process run
    assert list(saves[0]) == [1] and list(saves[1]) == []
    assert sorted(os.listdir(tmp / "ck_dp")) == sorted(
        os.listdir(tmp / "ck_single")) == ["dcgan-sr-tpu_1_net_D.npz",
                                           "dcgan-sr-tpu_1_net_G.npz"]


def test_dp_upscale_writes_the_plain_runs_bytes(entry_points):
    tmp, logs, _, single = entry_points
    names = sorted(os.listdir(tmp / "out_single"))
    assert names == ["im0_sr.png", "im1_sr.png", "im2_sr.png"]
    assert sorted(os.listdir(tmp / "out_dp")) == names
    for n in names:
        assert (tmp / "out_dp" / n).read_bytes() == \
            (tmp / "out_single" / n).read_bytes(), n
    assert "sharded over 2 ranks" in logs[0]["upscale"]
    assert "batch: 3 images" in logs[0]["upscale"]
    assert "batch:" not in logs[1]["upscale"]
    assert "single device" in single["upscale"]
