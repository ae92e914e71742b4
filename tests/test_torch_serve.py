"""The port's server (dcgan_sr_tpu_torch.serve) against the JAX package's
(tools/serve.py) on the CPU: the same fixture, the same images, float
outputs (--no-u8-io), both request modes and both BN settings.  Plus the
HTTP front, request validation, coalescing, and the oversized-request
chunking that now queues every chunk before waiting.

Tolerance: 1e-5 abs + rel on [0, 1] outputs (fp32 sums in a different
order, as in tests/test_torch_network.py); 0 for the u8 path against the
float path quantized."""

import http.client
import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.train import init_train_state
from dcgan_sr_tpu.train.checkpoint import load_branch as j_load_branch
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.serve import SRService, make_http_server
from dcgan_sr_tpu_torch.train.checkpoint import load_generator

import torch_threads  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.serve import SRService as JaxSRService  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "gray3_textured_net_G.npz")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def net():
    return load_generator(get_config("gray-3", env_override=False), FIXTURE,
                          device="cpu")[0]


@pytest.fixture(scope="module")
def services(net):
    """(port, jax) service pairs keyed by bn_eval, one 32-pixel LR bucket."""
    cfg = j_get_config("gray-3", env_override=False)
    st = init_train_state(cfg, jax.random.PRNGKey(0))
    with np.load(FIXTURE) as data:
        gp = j_load_branch(data, "params", st.g_params)
        gs = j_load_branch(data, "state", st.g_state)
    tcfg = get_config("gray-3", env_override=False)
    out = {}
    for bn_eval in (False, True):
        out[bn_eval] = (
            SRService(tcfg, net, max_size=32, max_batch=4, window_ms=30.0,
                      bn_eval=bn_eval),
            JaxSRService(cfg, gp, gs, max_size=32, max_batch=4,
                         window_ms=30.0, bn_eval=bn_eval))
    yield out
    for pair in out.values():
        for svc in pair:
            svc.close()


def test_bucket_ladder_matches_jax():
    cfg = get_config("gray-3", env_override=False)
    svc = SRService(cfg, load_generator(cfg, None, device="cpu")[0])
    jsvc = JaxSRService(j_get_config("gray-3", env_override=False), None, None)
    try:
        assert svc.buckets == jsvc.buckets == [32, 48, 72, 108, 162, 244, 256]
        for hw in ((10, 300), (33, 47), (245, 1), (100, 72)):
            try:
                assert svc.bucket_for(*hw) == jsvc.bucket_for(*hw)
            except ValueError:
                with pytest.raises(ValueError):
                    jsvc.bucket_for(*hw)
    finally:
        svc.close()
        jsvc.close()


@pytest.mark.parametrize("bn_eval", [False, True])
@pytest.mark.parametrize("mode,shape", [("2x", (20, 26)),
                                        ("restore", (40, 50))])
def test_service_matches_jax_service(services, bn_eval, mode, shape):
    svc, jsvc = services[bn_eval]
    rng = np.random.RandomState(len(shape) + shape[0])
    imgs = [rng.rand(*shape).astype(np.float32),
            rng.rand(shape[0] - 6, shape[1] - 2).astype(np.float32)]
    got = svc.submit_many(imgs, mode)
    want = jsvc.submit_many(imgs, mode)
    for g, w, im in zip(got, want, imgs):
        scale = 2 if mode == "2x" else 1
        assert g.shape == (scale * im.shape[0], scale * im.shape[1])
        np.testing.assert_allclose(g, w, **TOL)


def test_u8_io_matches_quantized_float_path(net):
    cfg = get_config("gray-3", env_override=False)
    f32 = SRService(cfg, net, max_size=32, max_batch=4, window_ms=5.0)
    u8 = SRService(cfg, net, max_size=32, max_batch=4, window_ms=5.0,
                   u8_io=True)
    rng = np.random.RandomState(11)
    img = (rng.randint(0, 256, (26, 31)) / 255.0).astype(np.float32)
    try:
        for mode in ("2x", "restore"):
            q = lambda a: np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
            np.testing.assert_array_equal(q(u8.submit(img, mode)),
                                          q(f32.submit(img, mode)))
    finally:
        f32.close()
        u8.close()


def test_concurrent_requests_coalesce_and_stay_independent(services):
    svc, _ = services[False]            # per-image statistics
    imgs = [np.random.RandomState(i).rand(16, 16).astype(np.float32)
            for i in range(4)]
    b0 = svc.stats["batches"]
    results = [None] * 4

    def post(i):
        results[i] = svc.submit(imgs[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert svc.stats["batches"] - b0 < 4
    np.testing.assert_allclose(results[2], svc.submit(imgs[2]), **TOL)


def test_oversized_request_queues_all_chunks_before_waiting(net):
    """submit_many of 6 images at max_batch 4 goes as chunks of 4 and 2,
    both queued before the first completes; the partial chunk then
    coalesces with another request's 2 images into one dispatch."""
    cfg = get_config("gray-3", env_override=False)
    svc = SRService(cfg, net, max_size=32, max_batch=4, window_ms=200.0)
    hold, entered = threading.Event(), threading.Event()
    sizes = []
    orig = svc._run_batch

    def spy(items):
        sizes.append(sum(len(it["imgs"]) for it in items))
        if len(sizes) == 1:
            entered.set()
            hold.wait(timeout=60)
        return orig(items)

    svc._run_batch = spy
    rng = np.random.RandomState(41)
    big = [rng.rand(16, 16).astype(np.float32) for _ in range(6)]
    other = [rng.rand(16, 16).astype(np.float32) for _ in range(2)]
    out = {}
    try:
        ta = threading.Thread(target=lambda: out.update(a=svc.submit_many(big)))
        ta.start()
        assert entered.wait(timeout=60)
        # first chunk is held in dispatch; the second is already queued
        assert svc._q.qsize() == 1
        tb = threading.Thread(target=lambda: out.update(b=svc.submit_many(other)))
        tb.start()
        deadline = time.monotonic() + 60
        while svc._q.qsize() < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert svc._q.qsize() == 2
        hold.set()
        ta.join(timeout=60)
        tb.join(timeout=60)
        assert not ta.is_alive() and not tb.is_alive()
    finally:
        hold.set()
        svc.close()
    assert sizes == [4, 4]                   # [chunk 1], [chunk 2 + other]
    assert len(out["a"]) == 6 and len(out["b"]) == 2
    np.testing.assert_allclose(out["a"][5], svc_solo(net, big[5]), **TOL)


def svc_solo(net, img):
    from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn
    padded = np.pad(img, ((0, 16), (0, 16)), mode="edge")   # bucket 32
    y = make_full_sr_fn(net, bn_eval=True, lr_input=True)(
        torch.from_numpy(padded)[None, None])
    return y[0, 0, :32, :32].numpy()


def test_validation_rejects_before_queueing(services):
    svc, _ = services[True]
    e0 = svc.stats["errors"]
    with pytest.raises(ValueError, match="expects"):
        svc.submit(np.zeros((3, 16, 16), np.float32))
    with pytest.raises(ValueError, match="exceeds max bucket"):
        svc.submit(np.zeros((80, 80), np.float32))
    with pytest.raises(ValueError, match="100x100"):
        svc.submit(np.zeros((100, 100), np.float32), mode="restore")
    assert svc.stats["errors"] == e0 + 3
    assert svc.submit(np.zeros((16, 16), np.float32)).shape == (32, 32)


def test_patch_configs_not_yet_ported(net, tmp_path, monkeypatch):
    """The patch configs serve now (the tiled tests below), in bf16 too,
    and so does a reference Torch checkpoint: `serve --t7` answers with the
    bytes the same weights give through SRService."""
    from dcgan_sr_tpu_torch import serve
    from dcgan_sr_tpu_torch.compat import export_torch_generator
    cfg = get_config("gray-patch-batch-overlap", env_override=False, ngf=4)
    pnet = load_generator(cfg, None, device="cpu")[0]
    svc = SRService(cfg, pnet, max_size=16)
    try:
        assert svc.tiled and svc.health()["tiled"] is True
    finally:
        svc.close()
    bf = SRService(cfg, pnet, max_size=16, compute_dtype=torch.bfloat16)
    try:        # bf16 serves now (tests/test_torch_bf16_infer.py)
        assert bf.health()["dtype"] == "bf16"
    finally:
        bf.close()
    path = export_torch_generator(str(tmp_path / "net_G.t7"), pnet.spec,
                                  *pnet.trees())
    img = np.random.RandomState(5).rand(16, 12).astype(np.float32)
    served = {}

    class Front:                 # the HTTP front, answering one request
        def __init__(self, service):
            served["out"] = service.submit(img)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(serve, "make_http_server", lambda svc, *a: Front(svc))
    monkeypatch.setenv("ngf", "4")
    serve.main(["--cpu", "--config", "gray-patch-batch-overlap", "--t7", path,
                "--max-size", "16", "--max-batch", "1", "--window-ms", "0"])
    ref = SRService(cfg, pnet, max_size=16, max_batch=1, window_ms=0,
                    u8_io=True)
    try:
        np.testing.assert_array_equal(served["out"], ref.submit(img))
    finally:
        ref.close()


# ---- the tiled service: patch configs through the overlap pipeline ---------

@pytest.fixture(scope="module")
def tiled_services():
    """(port, jax) tiled service pairs keyed by (bn_eval, self_ensemble),
    gray-patch-batch-overlap at ngf 4, LR buckets up to 24."""
    jcfg = j_get_config("gray-patch-batch-overlap", env_override=False, ngf=4,
                        ndf=8)
    cfg = get_config("gray-patch-batch-overlap", env_override=False, ngf=4,
                     ndf=8)
    st = init_train_state(jcfg, jax.random.PRNGKey(4))
    rng = np.random.RandomState(8)
    gs = jax.tree_util.tree_map(
        lambda a: jax.numpy.asarray(0.5 + 0.3 * np.abs(rng.randn(*a.shape)),
                                    jax.numpy.float32), st.g_state)
    from dcgan_sr_tpu_torch.models import Network, generator_spec
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pnet = Network(generator_spec(cfg), tonp(st.g_params), tonp(gs),
                   device="cpu")
    out = {}
    for bn_eval, tta in ((False, 1), (True, 1), (True, 2)):
        out[bn_eval, tta] = (
            SRService(cfg, pnet, max_size=24, max_batch=4, window_ms=30.0,
                      bn_eval=bn_eval, self_ensemble=tta),
            JaxSRService(jcfg, st.g_params, gs, max_size=24, max_batch=4,
                         window_ms=30.0, bn_eval=bn_eval, self_ensemble=tta))
    yield out
    for pair in out.values():
        for svc in pair:
            svc.close()


def _levels(a):
    return np.clip(np.round(np.asarray(a) * 255.0), 0, 255).astype(np.int16)


def test_tiled_bucket_ladder_matches_jax(tiled_services):
    svc, jsvc = tiled_services[True, 1]
    assert svc.buckets == jsvc.buckets == [24]
    cfg = get_config("gray-patch-batch-overlap", env_override=False, ngf=4)
    big = SRService(cfg, svc.net)
    jbig = JaxSRService(j_get_config("gray-patch-batch-overlap",
                                     env_override=False), None, None)
    try:
        assert big.buckets == jbig.buckets
        assert all((2 * b - 4) % 4 == 0 for b in big.buckets)   # overlap-legal
        for hw in ((10, 300), (33, 47), (245, 1), (100, 72)):
            try:
                assert big.bucket_for(*hw) == jbig.bucket_for(*hw)
            except ValueError:
                with pytest.raises(ValueError):
                    jbig.bucket_for(*hw)
    finally:
        big.close()
        jbig.close()


@pytest.mark.parametrize("key", [(False, 1), (True, 1), (True, 2)],
                         ids=["parity-bn", "bn_eval", "bn_eval-tta2"])
@pytest.mark.parametrize("mode,shape", [("2x", (14, 20)),
                                        ("restore", (30, 22))])
def test_tiled_service_matches_jax_service(tiled_services, key, mode, shape):
    """Mixed sizes in one request; float outputs within 1 level of 255 of
    the JAX server's on at least 99% of the pixels (a near-tie of the seam DP
    may flip between the packages and swaps whole pixels between tiles)."""
    svc, jsvc = tiled_services[key]
    rng = np.random.RandomState(shape[0])
    imgs = [rng.rand(*shape).astype(np.float32),
            rng.rand(shape[0] - 5, shape[1] - 2).astype(np.float32)]
    got = svc.submit_many(imgs, mode)
    want = jsvc.submit_many(imgs, mode)
    for g, w, im in zip(got, want, imgs):
        scale = 2 if mode == "2x" else 1
        assert g.shape == w.shape == (scale * im.shape[0], scale * im.shape[1])
        assert (np.abs(_levels(g) - _levels(w)) <= 1).mean() >= 0.99


def test_tiled_http_round_trip(tiled_services):
    from PIL import Image

    svc, jsvc = tiled_services[True, 1]
    srv = make_http_server(svc, port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        arr = (np.random.RandomState(9).rand(13, 18) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/upscale", body=buf.getvalue())
        resp = conn.getresponse()
        assert resp.status == 200
        got = np.asarray(Image.open(io.BytesIO(resp.read())), np.int16)
        want = _levels(jsvc.submit(arr.astype(np.float32) / 255.0))
        assert got.shape == want.shape == (26, 36)
        assert (np.abs(got - want) <= 1).mean() >= 0.99
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["tiled"] is True and health["config"] == \
            "gray-patch-batch-overlap"
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_round_trip_and_errors(services):
    from PIL import Image

    svc, _ = services[True]
    srv = make_http_server(svc, port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        buf = io.BytesIO()
        arr = (np.random.RandomState(3).rand(20, 24) * 255).astype(np.uint8)
        Image.fromarray(arr).save(buf, format="PNG")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/upscale", body=buf.getvalue())
        resp = conn.getresponse()
        assert resp.status == 200
        assert Image.open(io.BytesIO(resp.read())).size == (48, 40)

        conn.request("POST", "/upscale?mode=restore", body=buf.getvalue())
        resp = conn.getresponse()
        assert resp.status == 200
        assert Image.open(io.BytesIO(resp.read())).size == (24, 20)

        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200 and health["ready"] is True
        assert health["device"] == "cpu" and health["buckets_lr"] == [32]
        assert set(health["kernel_launches"]) == {
            "bulge_stats", "bulge_main", "bulge_stats_bf16", "bulge_main_bf16"}

        errs = svc.stats["errors"]
        conn.request("POST", "/upscale", body=b"not a png at all")
        resp = conn.getresponse()
        assert resp.status == 400 and "error" in json.loads(resp.read())
        assert svc.stats["errors"] == errs + 1

        conn.request("GET", "/nope")
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_refuses_to_fall_back_to_the_cpu():
    from dcgan_sr_tpu_torch import serve
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="--cpu"):
        serve.main(["--port", "0"])
