"""The raw-RGB feed into the port's step (cfg.device_preprocess) and the
device-side trainHook crop + hflip (cfg.device_augment,
image/ops.py crop_hflip_at), against the JAX package's on the CPU, as
tests/test_device_augment.py and tests/test_device_preprocess.py hold the
JAX package's own.  Weights come from the JAX init (carried across as
numpy); on the port's side K1 runs its plain version (CPU tensors), on the
JAX side the Pallas kernel in interpret mode.

Tolerances: crops bit for bit; the port's device_preprocess step against
the same step fed the host-preprocessed batch: losses rtol 1e-5, parameters
1e-6; against the JAX package's step: losses rtol 1e-5, parameters 1e-6 on
all but max(8, 5%) of a leaf's elements and 2.1 lr on every element (Adam's
first step is sign-like, so a last-bit gradient difference on a near-zero
element flips a whole lr step: the rule of tests/test_torch_train_step.py);
K = 2 chunks of tuple batches equal two single steps exactly."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.data.folder import FolderDataset as JFolder
from dcgan_sr_tpu.image.ops import crop_hflip_at as j_crop_hflip_at
from dcgan_sr_tpu.train.step import build_train_step as j_build_train_step
from dcgan_sr_tpu.train.step import init_train_state as j_init_train_state
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.data.folder import FolderDataset, crop_start
from dcgan_sr_tpu_torch.image.ops import (check_crop_offsets, crop_hflip_at,
                                          normalize_pm1, random_crop_hflip,
                                          rgb2gray)
from dcgan_sr_tpu_torch.train.loop import train_epochs
from dcgan_sr_tpu_torch.train.step import (build_train_step, state_from_numpy,
                                           state_to_numpy)

import torch_threads  # noqa: F401

TINY = dict(env_override=False, ngf=4, ndf=8, manualSeed=11)
FIELDS = ("g_params", "g_state", "g_opt", "d_params", "d_state", "d_opt",
          "g_ema_params")


def _tiny_folder(tmp_path, n=5, hw=(120, 100)):
    rng = np.random.RandomState(7)
    root = tmp_path / "celeba"
    (root / "faces").mkdir(parents=True)
    for i in range(n):
        arr = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(str(root / "faces" / f"{i}.png"))
    return str(root)


def test_crop_hflip_at_is_bit_equal_to_jax():
    rng = np.random.RandomState(1)
    canvas = rng.rand(6, 3, 40, 36).astype(np.float32)
    tops = rng.randint(0, 40 - 16 + 1, 6).astype(np.int32)
    lefts = rng.randint(0, 36 - 16 + 1, 6).astype(np.int32)
    flips = rng.rand(6) > 0.5
    want = np.asarray(j_crop_hflip_at(jnp.asarray(canvas), jnp.asarray(tops),
                                      jnp.asarray(lefts), jnp.asarray(flips),
                                      16))
    got = crop_hflip_at(torch.from_numpy(canvas), tops, lefts, flips, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # tensors in, tensors of the canvas's device out; bf16 stays bf16
    got_t = crop_hflip_at(torch.from_numpy(canvas).bfloat16(),
                          torch.from_numpy(tops), torch.from_numpy(lefts),
                          torch.from_numpy(flips), 16)
    assert got_t.dtype == torch.bfloat16 and got_t.is_contiguous()
    np.testing.assert_array_equal(got_t.float().numpy(),
                                  torch.from_numpy(want.copy()).bfloat16().float())


def test_out_of_range_offsets_raise_on_the_host():
    canvas = torch.zeros(2, 3, 24, 24)
    with pytest.raises(ValueError, match="out of range"):
        crop_hflip_at(canvas, [0, 9], [0, 0], [False, False], 16)
    with pytest.raises(ValueError, match="out of range"):
        check_crop_offsets(np.array([0, 0]), np.array([-1, 0]), (24, 24), 16)
    check_crop_offsets(np.array([8, 0]), np.array([0, 8]), (24, 24), 16)


def test_random_crop_hflip_draws_the_reference_range():
    g = torch.Generator().manual_seed(0)
    pos = (torch.arange(40.)[:, None] * 1000 + torch.arange(40.)[None])
    canvas = pos.expand(64, 3, 40, 40).contiguous()
    out = random_crop_hflip(g, canvas, 16)
    tops = (out[:, 0, 0].amin(dim=1) // 1000).long()
    assert out.shape == (64, 3, 16, 16)
    assert tops.min() >= 1 and tops.max() <= 40 - 16
    flipped = out[:, 0, 0, 0] > out[:, 0, 0, -1]
    assert 0 < int(flipped.sum()) < 64


def test_composed_device_crop_matches_host_hook_bitexact(tmp_path):
    """sample_canvas + crop_hflip_at == sample(normalize=False) bit for bit
    under equal-seeded rngs, and the canvas equals the JAX package's."""
    root = _tiny_folder(tmp_path)
    ds = FolderDataset(root, load_size=96, fine_size=64, nc=3,
                       cache_dir=str(tmp_path / "cache"))
    host = ds.sample(16, np.random.RandomState(3), normalize=False)
    canvas, tops, lefts, flips = ds.sample_canvas(16, np.random.RandomState(3))
    dev = crop_hflip_at(torch.from_numpy(canvas), tops, lefts, flips, 64)
    np.testing.assert_array_equal(dev.numpy(), host)
    jds = JFolder(root, load_size=96, fine_size=64, nc=3,
                  cache_dir=str(tmp_path / "jcache"))
    np.testing.assert_array_equal(
        jds.sample_canvas(16, np.random.RandomState(3))[0], canvas)
    assert tops.min() >= 0 and tops.max() <= 96 - 64
    assert lefts.min() >= 0 and lefts.max() <= 96 - 64
    assert 0.2 < flips.mean() < 0.8


def test_composed_crop_bitexact_when_loadsize_equals_finesize(tmp_path):
    root = _tiny_folder(tmp_path, hw=(120, 80))
    ds = FolderDataset(root, load_size=64, fine_size=64, nc=3,
                       cache_dir=str(tmp_path / "cache"))
    host = ds.sample(8, np.random.RandomState(9), normalize=False)
    canvas, tops, lefts, flips = ds.sample_canvas(8, np.random.RandomState(9))
    assert tops.max() == 0 and lefts.max() == 0
    dev = crop_hflip_at(torch.from_numpy(canvas), tops, lefts, flips, 64)
    np.testing.assert_array_equal(dev.numpy(), host)


def test_total_offset_support_is_reference_uniform(tmp_path):
    """The composed total offset (host pre-crop + device residual) covers
    the reference's one-draw support {1..dim-fine} without triangular bias
    (tests/test_device_augment.py:113)."""
    root = _tiny_folder(tmp_path, n=1)
    ls, fs, long_dim = 24, 16, 40
    ds = FolderDataset(root, load_size=ls, fine_size=fs, nc=3,
                       cache_dir=str(tmp_path / "cache"))
    pos = (np.arange(long_dim)[:, None] * 1000.0
           + np.arange(ls)[None, :]).astype(np.float32)
    ds._load_resized = lambda path: np.broadcast_to(
        pos, (3, long_dim, ls)).copy()
    rng = np.random.RandomState(0)
    totals = []
    for _ in range(40):
        canvas, tops, lefts, flips = ds.sample_canvas(16, rng)
        ch = (canvas[:, 0, 0, 0] // 1000).astype(int)
        totals.extend((ch + tops).tolist())
        assert np.all(lefts >= 1) and np.all(lefts <= ls - fs)
    totals = np.asarray(totals)
    lo, hi = 1, long_dim - fs
    assert totals.min() == lo and totals.max() == hi
    counts = np.bincount(totals, minlength=hi + 1)[lo:]
    assert counts.min() > 0 and counts.max() < 3.0 * counts.mean()
    host = [crop_start(np.random.RandomState(s), long_dim, fs)
            for s in range(200)]
    assert min(host) >= lo and max(host) <= hi


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(variant, **over):
    jcfg = j_get_config(variant, **TINY, **over)
    cfg = get_config(variant, **TINY, **over)
    jst = j_init_train_state(jcfg, jax.random.PRNGKey(1))
    fields = {f: _np_tree(getattr(jst, f)) for f in FIELDS}
    return jcfg, cfg, jst, fields


def _params(fields):
    return [a for f in ("g_params", "d_params")
            for a in jax.tree_util.tree_leaves(fields[f])]


def _hold_to_jax(cfg, jm, tm, jst0, jst1, tfields):
    """Losses rtol 1e-5; each parameter's move within 1e-6 of JAX's move,
    but for a few sign flips of Adam's first step on near-zero gradients."""
    for k in ("errD", "errD_real", "errD_fake", "errG"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    before = _params({f: _np_tree(getattr(jst0, f)) for f in FIELDS})
    want = _params({f: _np_tree(getattr(jst1, f)) for f in FIELDS})
    for b, w, g in zip(before, want, _params(tfields)):
        diff = np.abs(g - w)
        assert diff.max() < 2.1 * cfg.lr
        n_off = int((diff > 1e-6).sum())
        assert n_off <= max(8, 0.05 * diff.size), (n_off, diff.size)


@pytest.mark.parametrize("variant", ["gray", "rgb-full"])
def test_device_preprocess_step_matches_host_and_jax(variant):
    raw = np.random.RandomState(0).rand(6, 3, 64, 64).astype(np.float32)
    jcfg, cfg, jst, fields = _init(variant, device_preprocess=True)
    # the same port step fed the host-preprocessed batch
    _, hcfg, _, _ = _init(variant)
    host = normalize_pm1(torch.from_numpy(raw))
    if cfg.nc == 1:
        host = normalize_pm1(rgb2gray(torch.from_numpy(raw)))[:, None]
    st_d, m_d = build_train_step(cfg)(state_from_numpy(cfg, fields, "cpu"),
                                      torch.from_numpy(raw))
    st_h, m_h = build_train_step(hcfg)(state_from_numpy(hcfg, fields, "cpu"),
                                       host.contiguous())
    for k in m_h:
        np.testing.assert_allclose(float(m_d[k]), float(m_h[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    got = state_to_numpy(st_d)
    for a, b in zip(_params(got), _params(state_to_numpy(st_h))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # and the JAX package's device_preprocess step
    jst1, jm = jax.jit(j_build_train_step(jcfg))(jst, jnp.asarray(raw))
    _hold_to_jax(cfg, jm, m_d, jst, jst1, got)


def test_device_augment_step_matches_jax():
    rng = np.random.RandomState(3)
    canvas = rng.rand(4, 3, 96, 96).astype(np.float32)
    tops = np.asarray([1, 5, 9, 32], np.int32)
    lefts = np.asarray([0, 31, 2, 13], np.int32)
    flips = np.asarray([True, False, True, False])
    jcfg, cfg, jst, fields = _init("gray", device_augment=True,
                                   device_preprocess=True)
    jst1, jm = jax.jit(j_build_train_step(jcfg))(
        jst, tuple(jnp.asarray(a) for a in (canvas, tops, lefts, flips)))
    st, tm = build_train_step(cfg)(
        state_from_numpy(cfg, fields, "cpu"),
        tuple(torch.from_numpy(a) for a in (canvas, tops, lefts, flips)))
    _hold_to_jax(cfg, jm, tm, jst, jst1, state_to_numpy(st))
    # the same step on the host-cropped batch: the crop is the only change
    _, pcfg, _, _ = _init("gray", device_preprocess=True)
    cropped = crop_hflip_at(torch.from_numpy(canvas), tops, lefts, flips, 64)
    _, pm = build_train_step(pcfg)(state_from_numpy(pcfg, fields, "cpu"),
                                   cropped)
    for k in pm:
        assert float(pm[k]) == float(tm[k]), k


@pytest.mark.parametrize("feed_bf16", [False, True])
def test_tuple_chunks_equal_single_steps(feed_bf16):
    """K = 2 chunks of (canvas, tops, lefts, flips) batches through the loop
    equal the same batches one step at a time; --feed-bf16 casts only the
    canvas."""
    _, cfg, _, fields = _init("gray", device_augment=True,
                              device_preprocess=True, batchSize=3)
    rng = np.random.RandomState(4)
    batches = [(rng.rand(3, 3, 96, 96).astype(np.float32),
                rng.randint(0, 33, 3).astype(np.int32),
                rng.randint(0, 33, 3).astype(np.int32), rng.rand(3) > 0.5)
               for _ in range(4)]
    seen = []

    def batch_fn(epoch, i):
        seen.append(i)
        return batches[i]

    dt = torch.bfloat16 if feed_bf16 else None
    runs = []
    for scan in (2, 1):
        st = state_from_numpy(cfg, fields, "cpu")
        st, last = train_epochs(cfg, st, batch_fn, niter=1, steps_per_epoch=4,
                                scan_steps=scan, log_fn=lambda s: None,
                                feed_dtype=dt)
        runs.append((state_to_numpy(st), float(last["errG"])))
    assert seen == [0, 1, 2, 3] * 2
    assert runs[0][1] == runs[1][1]
    for a, b in zip(_params(runs[0][0]), _params(runs[1][0])):
        np.testing.assert_array_equal(a, b)


def test_loop_refuses_out_of_range_offsets_before_the_copy():
    _, cfg, _, fields = _init("gray", device_augment=True,
                              device_preprocess=True, batchSize=2)
    bad = (np.zeros((2, 3, 96, 96), np.float32), np.array([0, 40], np.int32),
           np.zeros(2, np.int32), np.zeros(2, bool))
    with pytest.raises(ValueError, match="out of range"):
        train_epochs(cfg, state_from_numpy(cfg, fields, "cpu"),
                     lambda e, i: bad, niter=1, steps_per_epoch=1,
                     log_fn=lambda s: None)
