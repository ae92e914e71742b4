"""bf16 inference on the CPU: the port's full-image generator (fused and
unfused) and overlap pipeline (both BN modes) with
compute_dtype=torch.bfloat16, against the JAX package's make_full_sr_fn /
make_overlap_sr_fn with compute_dtype=jnp.bfloat16, on the same weights and
images; then the entry points that take bf16 (the server with --warmup, the
upscale tool, bench_fused --dtype bf16, bench_infer).

Tolerance, for each compared output: max |port bf16 - JAX bf16| at most
twice max |JAX bf16 - JAX fp32| (how far bf16 itself moves it) plus 1e-3.
The fused pair's bf16 kernel normalises the hidden tensor in fp32 and rounds
it once, where the unfused layers round after the convT and again after the
affine; both lie inside that bound.  The seam stitch is discontinuous (a
near-tie of its DP flips and swaps pixels between tiles), so it is held to
the bound on all but 1% of its pixels."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.infer import tiled as JT
from dcgan_sr_tpu.train import init_train_state
from dcgan_sr_tpu.train.checkpoint import load_branch as j_load_branch
from dcgan_sr_tpu_torch import bench_fused, bench_infer, upscale
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.infer import tiled as TT
from dcgan_sr_tpu_torch.models import Network, generator_spec
from dcgan_sr_tpu_torch.serve import SRService
from dcgan_sr_tpu_torch.train.checkpoint import load_generator

import torch_threads  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures")
GRAY3 = os.path.join(FIXTURES, "gray3_textured_net_G.npz")
BF = torch.bfloat16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _hold(got, want, ref, what, share=0.0):
    got, want, ref = (np.asarray(a, np.float64) for a in (got, want, ref))
    assert got.shape == want.shape == ref.shape
    r = np.abs(want - ref).max()
    off = np.abs(got - want) > 2 * r + 1e-3
    assert off.mean() <= share, (f"{what}: {off.sum()} of {off.size} beyond "
                                 f"2 * {r:.3e} + 1e-3 (max "
                                 f"{np.abs(got - want).max():.3e})")


@pytest.fixture(scope="module")
def gray3():
    cfg = j_get_config("gray-3", env_override=False)
    st = init_train_state(cfg, jax.random.PRNGKey(0))
    with np.load(GRAY3) as data:
        gp = j_load_branch(data, "params", st.g_params)
        gs = j_load_branch(data, "state", st.g_state)
    tcfg = get_config("gray-3", env_override=False)
    nets = {fuse: Network(generator_spec(tcfg), _np(gp), _np(gs),
                          device="cpu", fuse=fuse) for fuse in (True, False)}
    return cfg, gp, gs, nets


@pytest.mark.parametrize("bn_eval", [False, True])
@pytest.mark.parametrize("lr_input", [False, True])
def test_bf16_full_image_generator_matches_jax(gray3, bn_eval, lr_input):
    cfg, gp, gs, nets = gray3
    imgs = np.random.RandomState(1).rand(2, 1, 20, 26).astype(np.float32)
    want, ref = (np.asarray(JT.make_full_sr_fn(
        cfg, compute_dtype=dt, bn_eval=bn_eval, lr_input=lr_input)(
            gp, gs, jnp.asarray(imgs))) for dt in (jnp.bfloat16, None))
    for fuse, net in nets.items():
        got = TT.make_full_sr_fn(net, compute_dtype=BF, bn_eval=bn_eval,
                                 lr_input=lr_input)(torch.from_numpy(imgs))
        assert got.dtype == torch.float32
        _hold(got.numpy(), want, ref, f"fuse={fuse}")


@pytest.fixture(scope="module")
def overlap():
    kw = dict(env_override=False, ngf=4, ndf=8)
    jcfg = j_get_config("gray-patch-batch-overlap", **kw)
    cfg = get_config("gray-patch-batch-overlap", **kw)
    st = init_train_state(jcfg, jax.random.PRNGKey(2))
    rng = np.random.RandomState(3)
    gs = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.5 + 0.3 * np.abs(rng.randn(*a.shape)),
                              jnp.float32), st.g_state)
    nets = {fuse: Network(generator_spec(cfg), _np(st.g_params), _np(gs),
                          device="cpu", fuse=fuse) for fuse in (True, False)}
    return jcfg, st.g_params, gs, cfg, nets


@pytest.mark.parametrize("bn_eval", [False, True])
def test_bf16_overlap_pipeline_matches_jax(overlap, bn_eval):
    jcfg, gp, gs, cfg, nets = overlap
    fine = (24, 32)
    imgs = np.random.RandomState(4).rand(2, *fine).astype(np.float32)
    want, ref = ({k: np.asarray(v) for k, v in JT.make_overlap_sr_fn(
        jcfg, compute_dtype=dt, fine=fine, bn_eval=bn_eval)(
            gp, gs, jnp.asarray(imgs)).items()} for dt in (jnp.bfloat16, None))
    for fuse, net in nets.items():
        got = TT.make_overlap_sr_fn(cfg, net, compute_dtype=BF, fine=fine,
                                    bn_eval=bn_eval)(torch.from_numpy(imgs))
        assert got["tiles"].dtype == torch.float32
        _hold(got["naive"].numpy(), want["naive"], ref["naive"],
              f"naive fuse={fuse}")
        _hold(got["seam"].numpy(), want["seam"], ref["seam"],
              f"seam fuse={fuse}", share=0.01)


def test_bf16_ensemble_runs_in_bf16(overlap):
    """self_ensemble and ensemble_batched take compute_dtype too: the
    batched members under running statistics equal the sequential ones."""
    _, _, _, cfg, nets = overlap
    imgs = torch.from_numpy(np.random.RandomState(5).rand(1, 24, 24)
                            .astype(np.float32))
    outs = [TT.make_overlap_sr_fn(cfg, nets[True], compute_dtype=BF,
                                  bn_eval=True, fine=(24, 24),
                                  self_ensemble=4, ensemble_batched=b)(imgs)
            for b in (False, True)]
    torch.testing.assert_close(outs[0]["tiles"], outs[1]["tiles"])


def test_warmup_runs_every_square_bucket_before_serving(gray3):
    """--warmup: every square (bucket, mode) at batch 1 and max_batch runs
    through the dispatcher before the first request.  On the CPU nothing
    builds or launches."""
    _, _, _, nets = gray3
    cfg = get_config("gray-3", env_override=False)
    svc = SRService(cfg, nets[True], max_size=48, max_batch=2,
                    window_ms=1.0, compute_dtype=BF)
    seen = []
    run_batch = svc._run_batch

    def spy(items):
        seen.append((items[0]["mode"], len(items[0]["imgs"]),
                     items[0]["imgs"][0].shape))
        run_batch(items)

    svc._run_batch = spy
    try:
        assert svc.buckets == [32, 48]
        svc.warmup()
        want = [(mode, n, (b, b) if mode == "2x" else (2 * b, 2 * b))
                for b in svc.buckets for mode in ("2x", "restore")
                for n in (1, 2)]
        assert seen == want
        h = svc.health()
        assert h["ready"] is True and h["dtype"] == "bf16"
        assert h["batches"] == len(want) and h["errors"] == 0
        out = svc.submit(np.random.RandomState(6).rand(20, 26)
                         .astype(np.float32))
        direct = TT.make_full_sr_fn(nets[True], compute_dtype=BF,
                                    lr_input=True, bn_eval=True)(
            torch.from_numpy(np.pad(
                np.random.RandomState(6).rand(20, 26).astype(np.float32),
                ((0, 12), (0, 6)), mode="edge"))[None, None])[0, 0]
        np.testing.assert_array_equal(out, direct.numpy()[:40, :52])
    finally:
        svc.close()


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def test_upscale_bf16_every_mode(tmp_path):
    src = tmp_path / "in.png"
    Image.fromarray((np.random.RandomState(7).rand(30, 36) * 255)
                    .astype(np.uint8)).save(src)
    d = tmp_path / "dir"
    d.mkdir()
    Image.open(src).save(d / "a.png")
    # the full-width gray-3 fixture; the patch configs random at ngf 4
    env = {"ngf": "4", "ndf": "8"}
    old = {k: os.environ.get(k) for k in env}
    try:
        for args, size in (
                (["--config", "gray-3", "--ckpt", GRAY3], (36, 30)),
                (["--config", "gray-3", "--ckpt", GRAY3, "--true-2x"],
                 (72, 60)),
                (["--config", "gray-patch", "--mode", "grid"], (36, 30)),
                (["--config", "gray-patch-batch-overlap"], (36, 30)),
                (["--config", "gray-patch-batch-overlap", "--true-2x"],
                 (72, 60))):
            if "--ckpt" not in args:
                os.environ.update(env)
            out = tmp_path / "o.png"
            lines = _run(upscale.main, ["--cpu", "--bf16", "--input", str(src),
                                        "--output", str(out)] + args)
            assert Image.open(out).size == size, (args, lines)
        outd = tmp_path / "outd"
        _run(upscale.main, ["--cpu", "--bf16", "--config",
                            "gray-patch-batch-overlap", "--input", str(d),
                            "--output", str(outd)])
        assert Image.open(outd / "a_sr.png").size == (36, 30)
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)


def test_bench_fused_bf16_bulge():
    lines = _run(bench_fused.main, ["--cpu", "--batch", "2", "--hw", "16",
                                    "--dtype", "bf16", "--iters", "2",
                                    "--reps", "1"])
    rec = json.loads(lines[-1])
    assert (rec["dtype"], rec["kernel"], rec["device"]) == ("bf16", "bulge",
                                                            "cpu")
    # the fused pair rounds h once, the unfused bf16 layers twice: a few
    # bf16 steps of y, which is O(1) here
    assert 0 <= rec["max_abs_diff"] <= 0.1


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_bench_infer_records_its_dtype(dtype):
    cfg = get_config("gray-patch-batch-overlap", env_override=False, ngf=4,
                     fineSize=16)
    rec = bench_infer.overlap_record(bn_eval=True, n_images=2, reps=1,
                                     steps=1, device="cpu", cfg=cfg,
                                     dtype=dtype)
    assert rec["dtype"] == dtype and rec["value"] >= 0   # rounded: tiny here
    assert rec["metric"] == "cpu_overlap_sr_upscaled_mp_per_sec_bn_eval"


def test_serve_defaults_to_the_jax_servers_config(monkeypatch):
    """`serve` with no --config serves gray-patch-batch-overlap, as the JAX
    server does (tools/serve.py), so the same command serves the same
    model; --warmup runs before the server is made."""
    from dcgan_sr_tpu_torch import serve

    class Made(Exception):
        pass

    seen = {}

    def fake_server(service, port, host):
        seen.update(variant=service.cfg.variant,
                    batches=service.stats["batches"])
        service.close()
        raise Made

    monkeypatch.setenv("ngf", "4")
    monkeypatch.setattr(serve, "make_http_server", fake_server)
    with pytest.raises(Made):
        serve.main(["--cpu", "--max-size", "16", "--max-batch", "1",
                    "--warmup", "--bf16"])
    assert seen["variant"] == "gray-patch-batch-overlap"
    assert seen["batches"] == 2             # one bucket, 2 modes
