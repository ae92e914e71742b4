"""The port's inference pipelines (dcgan_sr_tpu_torch.infer.tiled) against
the JAX package's on the CPU: the same weights (copied from the JAX init or
loaded from the fixtures), the same numpy images, small width (ngf 4) and a
few tiles.

Tolerances: generator tiles and the naive stitch 1e-5 abs + rel (the same
fp32 sums in another order, as in tests/test_torch_network.py); the seam
stitch bit for bit on the same tiles; end to end the seam output is held to
1e-5 wherever the two packages' seams chose alike (a 1e-7 difference in the
tiles may flip a near-tie of the DP, which swaps whole pixels between
neighbouring tiles) and the share of flipped pixels to 1%; fixture forwards
rtol 1e-4."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.infer import tiled as JT
from dcgan_sr_tpu.models import apply_network
from dcgan_sr_tpu.models import generator_spec as j_generator_spec
from dcgan_sr_tpu.train import init_train_state
from dcgan_sr_tpu.train.checkpoint import load_branch as j_load_branch
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.infer import tiled as TT
from dcgan_sr_tpu_torch.infer.seam_device import seam_stitch_device
from dcgan_sr_tpu_torch.models import Network, generator_spec
from dcgan_sr_tpu_torch.train.checkpoint import load_generator

import torch_threads  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures")
TOL = dict(rtol=1e-5, atol=1e-5)
FINE = (24, 32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, params, state, port cfg, port net) for the overlap variant
    at ngf 4, with running statistics that are not the init's 0 / 1."""
    jcfg = j_get_config("gray-patch-batch-overlap", env_override=False, ngf=4,
                        ndf=8)
    cfg = get_config("gray-patch-batch-overlap", env_override=False, ngf=4,
                     ndf=8)
    st = init_train_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    gs = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.5 + 0.3 * np.abs(rng.randn(*a.shape)),
                              jnp.float32), st.g_state)
    net = Network(generator_spec(cfg), _np(st.g_params), _np(gs), device="cpu")
    return jcfg, st.g_params, gs, cfg, net


@pytest.mark.parametrize("d", list(range(1, 40)) + [63, 64, 65, 100, 255, 256])
def test_pad_dims_equal_jax(d):
    for patch, ov in ((8, 4), (12, 6), (9, 4), (8, 2)):
        assert TT.overlap_pad_dim(d, patch, ov) == JT.overlap_pad_dim(d, patch, ov)
        assert TT.lr_pad_dim(d, patch, ov) == JT.lr_pad_dim(d, patch, ov)


def test_odd_overlap_is_unsatisfiable():
    with pytest.raises(ValueError, match="unsatisfiable"):
        JT.overlap_pad_dim(10, 9, 3)
    with pytest.raises(ValueError, match="unsatisfiable"):
        TT.overlap_pad_dim(10, 9, 3)


def _held_to_jax(got, want, jax_tiles=None, both_seams=False):
    np.testing.assert_allclose(got["naive"].numpy(), np.asarray(want["naive"]),
                               **TOL)
    seam, jseam = got["seam"].numpy(), np.asarray(want["seam"])
    close = np.abs(seam - jseam) <= 1e-5 + 1e-5 * np.abs(jseam)
    assert close.mean() >= 0.99, f"{(~close).sum()} pixels flipped"
    if jax_tiles is not None:
        np.testing.assert_allclose(got["tiles"].numpy(), jax_tiles, **TOL)
        # on the JAX package's own tiles the port's stitcher gives its seam
        # bit for bit
        np.testing.assert_array_equal(
            seam_stitch_device(torch.from_numpy(jax_tiles), FINE, 8, 4,
                               both_seams=both_seams).numpy(), jseam)


@pytest.mark.parametrize("kw", [
    dict(), dict(bn_eval=True), dict(both_seams=True),
    dict(bn_eval=True, both_seams=True), dict(self_ensemble=4),
    dict(self_ensemble=8, ensemble_batched=True),
    dict(bn_eval=True, self_ensemble=2, ensemble_batched=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "parity")
def test_overlap_sr_fn_matches_jax(pair, kw):
    jcfg, gp, gs, cfg, net = pair
    imgs = np.random.RandomState(1).rand(3, *FINE).astype(np.float32)
    want = JT.make_overlap_sr_fn(jcfg, fine=FINE, **kw)(gp, gs,
                                                        jnp.asarray(imgs))
    got = TT.make_overlap_sr_fn(cfg, net, fine=FINE, **kw)(
        torch.from_numpy(imgs))
    assert got["seam"].shape == (3, *FINE) and got["tiles"].shape == (3, 35, 8, 8)
    _held_to_jax(got, want)


def test_parity_bn_is_per_image(pair):
    """Under train-mode BN an image's result does not depend on what it was
    batched with (each image's tiles are one BN batch), and differs from
    pooling the statistics over the whole tile batch."""
    _, _, _, cfg, net = pair
    imgs = torch.from_numpy(np.random.RandomState(2).rand(3, *FINE)
                            .astype(np.float32))
    fn = TT.make_overlap_sr_fn(cfg, net, fine=FINE)
    together, alone = fn(imgs), fn(imgs[1:2])
    np.testing.assert_allclose(together["naive"][1].numpy(),
                               alone["naive"][0].numpy(), **TOL)
    pooled = net(TT.box_downsample2(TT.extract_overlap_patches(imgs, 8, 4))
                 .reshape(-1, 1, 4, 4), bn_stats="pooled")
    assert (pooled.reshape(3, 35, 8, 8)[1] - alone["tiles"][0]).abs().max() > 1e-4


def test_tile_budget_chunks_whole_images(pair, monkeypatch):
    _, _, _, cfg, net = pair
    imgs = torch.from_numpy(np.random.RandomState(3).rand(5, *FINE)
                            .astype(np.float32))
    for kw in (dict(), dict(bn_eval=True)):
        fn = TT.make_overlap_sr_fn(cfg, net, fine=FINE, **kw)
        whole = fn(imgs)
        monkeypatch.setattr(TT, "TILE_BUDGET", 2 * 35 + 1)   # two images a call
        chunked = fn(imgs)
        monkeypatch.undo()
        np.testing.assert_allclose(chunked["tiles"].numpy(),
                                   whole["tiles"].numpy(), **TOL)


@pytest.mark.parametrize("bn_eval", [False, True])
def test_lr_input_matches_jax_and_the_protocol_path(pair, bn_eval):
    jcfg, gp, gs, cfg, net = pair
    imgs = np.random.RandomState(4).rand(2, *FINE).astype(np.float32)
    lr = np.asarray(JT.box_downsample2(jnp.asarray(imgs)))
    want = JT.make_overlap_sr_fn(jcfg, fine=FINE, lr_input=True,
                                 bn_eval=bn_eval)(gp, gs, jnp.asarray(lr))
    got = TT.make_overlap_sr_fn(cfg, net, fine=FINE, lr_input=True,
                                bn_eval=bn_eval)(torch.from_numpy(lr.copy()))
    _held_to_jax(got, want)
    # half-geometry tiles of the degraded image == degraded full tiles
    proto = TT.make_overlap_sr_fn(cfg, net, fine=FINE, bn_eval=bn_eval)(
        torch.from_numpy(imgs))
    half = TT.make_overlap_sr_fn(cfg, net, fine=FINE, lr_input=True,
                                 bn_eval=bn_eval)(
        TT.box_downsample2(torch.from_numpy(imgs)))
    assert torch.equal(proto["tiles"], half["tiles"])
    assert torch.equal(proto["seam"], half["seam"])


def test_overlap_sr_fn_refusals(pair, tmp_path):
    _, _, _, cfg, net = pair
    with pytest.raises(ValueError, match="flat_tiles requires bn_eval"):
        TT.make_overlap_sr_fn(cfg, net, flat_tiles=True)
    odd = get_config("gray-patch-batch-overlap", env_override=False, ngf=4,
                     patchSize=9, overlap=4)
    with pytest.raises(ValueError, match="even patchSize and overlap"):
        TT.make_overlap_sr_fn(odd, net, lr_input=True)
    # mesh= is ported: over a world of one (a gloo group in this process)
    # it returns the unsharded result; two ranks: tests/test_torch_dp.py
    import torch.distributed as dist
    from dcgan_sr_tpu_torch.parallel import create_mesh, initialize_distributed
    imgs = torch.from_numpy(np.random.RandomState(2).rand(2, 64, 64)
                            .astype(np.float32))
    initialize_distributed(f"file://{tmp_path}/store", 1, 0, backend="gloo")
    try:
        mesh = create_mesh()
        for make, x in ((lambda **kw: TT.make_overlap_sr_fn(cfg, net, **kw),
                         imgs),
                        (lambda **kw: TT.make_full_sr_fn(net, **kw),
                         imgs[:, None])):
            got, want = make(mesh=mesh)(x), make()(x)
            for k in (("tiles", "naive", "seam") if isinstance(want, dict)
                      else (None,)):
                a, b = (got, want) if k is None else (got[k], want[k])
                assert torch.equal(a, b)
            make(compute_dtype=torch.bfloat16)  # ported: test_torch_bf16_infer
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("both_seams,device_seam", [(False, True), (True, True),
                                                    (False, False)])
def test_sr_overlap_image_matches_jax(pair, both_seams, device_seam):
    jcfg, gp, gs, cfg, net = pair
    img = np.random.RandomState(5).rand(*FINE).astype(np.float32)
    want = JT.sr_overlap_image(jcfg, JT.make_generator_fn(jcfg), gp, gs, img,
                               both_seams=both_seams, device_seam=device_seam)
    got = TT.sr_overlap_image(cfg, TT.make_generator_fn(net),
                              torch.from_numpy(img), both_seams=both_seams,
                              device_seam=device_seam)
    _held_to_jax(got, want, np.array(want["tiles"]), both_seams)


@pytest.mark.parametrize("kw", [dict(), dict(bn_eval=True),
                                dict(self_ensemble=8, ensemble_batched=True)],
                         ids=["parity", "bn_eval", "tta8-batched"])
def test_sr_grid_patches_matches_jax(kw):
    jcfg = j_get_config("gray-patch", env_override=False, ngf=4, ndf=8)
    cfg = get_config("gray-patch", env_override=False, ngf=4, ndf=8)
    st = init_train_state(jcfg, jax.random.PRNGKey(1))
    net = Network(generator_spec(cfg), _np(st.g_params), _np(st.g_state),
                  device="cpu")
    img = np.random.RandomState(6).rand(16, 24).astype(np.float32)
    want = JT.sr_grid_patches(jcfg, JT.make_generator_fn(jcfg, **kw),
                              st.g_params, st.g_state, img)
    got = TT.sr_grid_patches(cfg, TT.make_generator_fn(net, **kw),
                             torch.from_numpy(img))
    assert got.shape == (16, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [
    dict(self_ensemble=4), dict(self_ensemble=8, ensemble_batched=True),
    dict(bn_eval=True, self_ensemble=8, ensemble_batched=True)],
    ids=["tta4", "tta8-batched", "bn_eval-tta8-batched"])
def test_full_sr_fn_self_ensemble_matches_jax(kw):
    jcfg = j_get_config("gray-3", env_override=False, ngf=4, ndf=8)
    cfg = get_config("gray-3", env_override=False, ngf=4, ndf=8)
    st = init_train_state(jcfg, jax.random.PRNGKey(2))
    net = Network(generator_spec(cfg), _np(st.g_params), _np(st.g_state),
                  device="cpu")
    x = np.random.RandomState(7).rand(2, 1, 12, 12).astype(np.float32)
    want = JT.make_full_sr_fn(jcfg, lr_input=True, **kw)(
        st.g_params, st.g_state, jnp.asarray(x))
    got = TT.make_full_sr_fn(net, lr_input=True, **kw)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [True, False], ids=["train-bn", "eval-bn"])
@pytest.mark.parametrize("variant,fixture", [
    ("gray-patch-batch-overlap", "overlap_textured_net_G.npz"),
    ("gray-patch", "graypatch_textured_net_G.npz"),
    ("gray-patch-batch", "gpb_textured_net_G.npz")])
def test_patch_fixture_forward_equals_jax(variant, fixture, train):
    """Each patch generator builds from its full-width fixture with the
    fused pair on, and its forward equals apply_network on the same tiles."""
    path = os.path.join(FIXTURES, fixture)
    jcfg = j_get_config(variant, env_override=False)
    cfg = get_config(variant, env_override=False)
    st = init_train_state(jcfg, jax.random.PRNGKey(0))
    with np.load(path) as data:
        gp = j_load_branch(data, "params", st.g_params)
        gs = j_load_branch(data, "state", st.g_state)
    net, _ = load_generator(cfg, path, need_state=True, device="cpu")
    assert len(net.pairs) == 1          # convT(2g, g) + conv(g, 2g)
    tiles = np.random.RandomState(8).rand(6, 1, 4, 4).astype(np.float32)
    want, _ = apply_network(j_generator_spec(jcfg), gp, jnp.asarray(tiles), gs,
                            train=train)
    got = net(torch.from_numpy(tiles),
              bn_stats="pooled" if train else "running")
    assert got.shape == (6, 1, 8, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_grouped_statistics_equal_each_group_alone(pair):
    """`groups=G` of batch_norm, the fused pair and Network.forward: group g
    of the batch gets the result it would get as a batch of its own."""
    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import nn as N
    rng = np.random.RandomState(9)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    x, scale, bias = t(6, 3, 4, 4), 1 + 0.1 * t(3), 0.1 * t(3)
    y, new = N.batch_norm(x, scale, bias, groups=3,
                          state={"mean": torch.zeros(3), "var": torch.ones(3)})
    assert new is None                      # no running update from groups
    for g in range(3):
        y1, _ = N.batch_norm(x[2 * g:2 * g + 2], scale, bias)
        np.testing.assert_allclose(y[2 * g:2 * g + 2].numpy(), y1.numpy(),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="does not split"):
        N.batch_stats(x, groups=4)
    x, wT, wC = t(6, 4, 4, 4), 0.1 * t(4, 4, 4, 4), 0.1 * t(8, 4, 4, 4)
    scale, bias = 1 + 0.1 * t(4), 0.1 * t(4)
    y, (m, v) = K.bulge(x, wT, scale, bias, wC, groups=2)
    y1, (m1, v1) = K.bulge(x[3:], wT, scale, bias, wC)
    assert m.shape == v.shape == (2, 4)
    np.testing.assert_allclose(m[1].numpy(), m1.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y[3:].numpy(), y1.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="does not split"):
        K.bulge(x, wT, scale, bias, wC, groups=4)
    _, _, _, _, net = pair
    tiles = t(6, 1, 4, 4)
    with torch.inference_mode():
        out = net(tiles, bn_stats="pooled", groups=2)
        np.testing.assert_allclose(out[:3].numpy(),
                                   net(tiles[:3], bn_stats="pooled").numpy(),
                                   rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError, match="groups goes with"):
            net(tiles, bn_stats="running", groups=2)
