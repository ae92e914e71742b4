"""Card-only tests of ops/bn.py's two-pass BN kernels (csrc/bn.cu): they
have no CPU mode, so these skip without an NVIDIA card.  The file imports
neither JAX nor the JAX package:

  python -m pytest tests/test_torch_bn_cuda.py --noconftest -q -p no:cacheprovider

What they hold the kernels to:
  - mean and var against a float64 reduction of the same bf16 map: the
    kernel sums in fp32 (a vector's eight, then along a thread, a block and
    the chunks of a slice), so the mean is within 1e-5 of the map's root
    mean square and var within 1e-5 of its mean square (var = E[x^2] -
    mean^2 loses what E[x^2] carries);
  - a and b against the plain path's (ops/nn.py batch_stats and normalize's
    bf16 form): equal, or one bf16 step apart where the plain path's own
    fp32 statistics, summed in another order, round the other way;
  - y bit for bit against the plain composition (x * a + b in bf16, then
    the activation) run with the kernel's own a and b, NaNs and zeros
    planted in x included;
  - the same input gives the same bits on every run;
  - the generators in bf16, whose BN layers now run on the kernels, within
    the bf16 tolerance of tests/test_torch_cuda.py (2 levels of 255 on all
    but 5% of the pixels) of the same generator with BN on the plain path.
"""

import os

import pytest
import torch

from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn, make_overlap_sr_fn
from dcgan_sr_tpu_torch.models import Network
from dcgan_sr_tpu_torch.ops import bn as BN
from dcgan_sr_tpu_torch.ops import nn as N
from dcgan_sr_tpu_torch.train.checkpoint import load_generator

pytestmark = pytest.mark.cuda
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "gray3_textured_net_G.npz")
PATCH_FIXTURE = os.path.join(os.path.dirname(FIXTURE),
                             "overlap_textured_net_G.npz")
BF16 = torch.bfloat16

# (shape, statistics): per image, grouped at the overlap pipeline's 225
# tiles an image (32x32 and 16x16 maps), pooled, running; odd run lengths
MODES = [((4, 16, 64, 64), "per_image"), ((450, 32, 32, 32), 2),
         ((450, 64, 16, 16), 2), ((6, 16, 40, 24), "pooled"),
         ((6, 16, 40, 24), "running"), ((3, 5, 7, 9), "per_image"),
         ((6, 3, 5, 3), 3), ((5, 7, 3, 1), "pooled")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _map(shape, device, seed=0, offset=0):
    """A bf16 map with a per-channel mean and spread, at `offset` elements
    past a 16-byte boundary (a contiguous view of a larger buffer)."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    mu = torch.randn((1, c, 1, 1), generator=g, device=device)
    sd = 0.5 + torch.rand((1, c, 1, 1), generator=g, device=device)
    x = (mu + sd * torch.randn(shape, generator=g, device=device)).to(BF16)
    if not offset:
        return x
    buf = torch.empty(x.numel() + 8, device=device, dtype=BF16)
    view = buf[offset:offset + x.numel()].view(shape)
    view.copy_(x)
    return view


def _vectors(c, device, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return (1 + 0.1 * torch.randn(c, generator=g, device=device),
            0.1 * torch.randn(c, generator=g, device=device),
            0.1 * torch.randn(c, generator=g, device=device),
            0.5 + torch.rand(c, generator=g, device=device))


def _kw(mode):
    if mode == "per_image":
        return dict(per_image=True)
    if mode == "pooled":
        return {}
    return dict(groups=mode)


def _rows64(x, mode):
    """float64 (G, C, elements) of x for the statistics mode."""
    n, c = x.shape[:2]
    x64 = x.double().reshape(n, c, -1)
    if mode == "per_image":
        return x64
    g = 1 if mode == "pooled" else mode
    return x64.reshape(g, n // g, c, -1).transpose(1, 2).reshape(g, c, -1)


def _ulps(a, b):
    """bf16 steps between two bf16 tensors of one sign (int16 patterns)."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def _plain_ab(mean, var, scale, bias, eps=1e-5):
    inv = torch.rsqrt(var + eps)
    return (inv * scale).to(BF16), (bias - mean * inv * scale).to(BF16)


def _compose(x, a, b, act):
    """The plain bf16 form with given a, b (G, C): x * a + b, then act."""
    rep = x.shape[0] // a.shape[0]
    a, b = (v.repeat_interleave(rep, dim=0)[:, :, None, None] for v in (a, b))
    return N.activate(x * a + b, act)


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("shape,mode", MODES)
def test_statistics_against_float64_and_the_plain_path(cuda, shape, mode,
                                                       offset):
    x = _map(shape, cuda, offset=offset)
    scale, bias, rmean, rvar = _vectors(shape[1], cuda)
    n0 = dict(BN.launches)
    if mode == "running":
        a, b = BN.running_ab(x, scale, bias, (rmean, rvar))
        pa, pb = _plain_ab(rmean, rvar, scale, bias)
        assert BN.launches["bn_stats_bf16"] == n0["bn_stats_bf16"]
    else:
        mean, var, a, b = BN.stats(x, scale, bias, **_kw(mode))
        r = _rows64(x, mode)
        m64, sq64 = r.mean(-1), (r * r).mean(-1)
        assert mean.shape == var.shape == m64.shape
        assert ((mean.double() - m64).abs() <= 1e-5 * sq64.sqrt()).all()
        assert ((var.double() - (sq64 - m64 * m64)).abs()
                <= 1e-5 * sq64).all()
        pm, pv = N.batch_stats(x, **_kw(mode))
        pa, pb = _plain_ab(pm.reshape(mean.shape), pv.reshape(var.shape),
                           scale, bias)
        assert BN.launches["bn_stats_bf16"] == n0["bn_stats_bf16"] + 1
    assert BN.launches["bn_finish_bf16"] == n0["bn_finish_bf16"] + 1
    assert a.dtype == b.dtype == BF16
    assert (_ulps(a, pa.reshape(a.shape)) <= 1).all()
    assert (_ulps(b, pb.reshape(b.shape)) <= 1).all()


@pytest.mark.parametrize("act", ["relu", "lrelu", None])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("shape,mode", MODES)
def test_apply_is_bit_equal_to_the_plain_composition(cuda, shape, mode,
                                                     offset, act):
    x = _map(shape, cuda, seed=2, offset=offset)
    flat = x.view(-1)
    flat[::97] = 0.0
    flat[5::89] = -0.0
    flat[7::1013] = float("nan")
    scale, bias, rmean, rvar = _vectors(shape[1], cuda)
    if mode == "running":
        a, b = BN.running_ab(x, scale, bias, (rmean, rvar))
    else:
        a, b = BN.stats(x, scale, bias, **_kw(mode))[2:]
    n0 = BN.launches["bn_apply_bf16"]
    y = BN.apply(x, a, b, act, N.LRELU_SLOPE)
    assert BN.launches["bn_apply_bf16"] == n0 + 1
    want = _compose(x, a, b, act)
    assert y.shape == x.shape and y.dtype == BF16
    assert y.data_ptr() % 16 == x.data_ptr() % 16
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("act", ["relu", "lrelu", None])
@pytest.mark.parametrize("shape,mode", MODES)
def test_batch_norm_on_the_kernels_against_the_plain_path(cuda, shape, mode,
                                                          act):
    """ops/nn.py batch_norm takes the kernels for a bf16 CUDA map with no
    gradient.  Its y against the plain path's: a or b one bf16 step off
    moves x * a + b by at most a step of |x a| and one of |b|, and the
    sum's rounding by one step of y.  Its running statistics' update comes
    from the kernel's mean and var."""
    x = _map(shape, cuda, seed=3)
    scale, bias, rmean, rvar = _vectors(shape[1], cuda)
    state = {"mean": rmean, "var": rvar}
    kw = dict(train=mode != "running", **({} if mode == "running"
                                          else _kw(mode)))
    n0, p0 = dict(BN.launches), BN.plain_cuda_calls
    y, new = N.batch_norm(x, scale, bias, state=state, act=act, **kw)
    assert BN.launches["bn_apply_bf16"] == n0["bn_apply_bf16"] + 1
    assert BN.plain_cuda_calls == p0
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        want, want_new = N.batch_norm(xg, scale, bias, state=state, act=act,
                                      **kw)
    assert BN.plain_cuda_calls == p0 + 1
    want = want.detach()
    if mode == "running":
        pa, pb = _plain_ab(rmean, rvar, scale, bias)
    else:
        pm, pv = N.batch_stats(x, **_kw(mode))
        pa, pb = _plain_ab(pm, pv, scale, bias)
    ax, bx = (v.reshape(-1, shape[1]).repeat_interleave(
        shape[0] // v.reshape(-1, shape[1]).shape[0], dim=0)[:, :, None, None]
        .float().abs() for v in (pa, pb))
    tol = 2.0 ** -7 * (x.float().abs() * ax + bx) \
        + 2.0 ** -7 * torch.maximum(y.abs(), want.abs()).float()
    assert ((y.float() - want.float()).abs() <= tol).all()
    if mode == "pooled":
        for k in ("mean", "var"):
            torch.testing.assert_close(new[k], want_new[k].detach(),
                                       rtol=1e-5, atol=1e-5)
    else:
        assert (new is state) == (mode == "running")


@pytest.mark.parametrize("shape,mode", [((16, 16, 1024, 1024), "per_image"),
                                        ((14400, 32, 32, 32), 64),
                                        ((14400, 64, 16, 16), 64),
                                        ((8, 16, 256, 256), "pooled")])
def test_two_runs_give_the_same_bits(cuda, shape, mode):
    x = _map(shape, cuda, seed=4)
    scale, bias, _, _ = _vectors(shape[1], cuda)
    runs = []
    for _ in range(2):
        mean, var, a, b = BN.stats(x, scale, bias, **_kw(mode))
        runs.append((mean, var, a, b, BN.apply(x, a, b, "relu")))
    for u, v in zip(*runs):
        assert torch.equal(u.view(torch.int16 if u.dtype == BF16
                                  else torch.int32),
                           v.view(torch.int16 if v.dtype == BF16
                                  else torch.int32))


def test_the_rule_sends_gradients_fp32_and_cross_replica_to_plain(cuda):
    x = _map((4, 8, 16, 16), cuda, seed=5)
    scale, bias, _, _ = _vectors(8, cuda)
    n0, p0 = dict(BN.launches), BN.plain_cuda_calls
    with torch.enable_grad():
        N.batch_norm(x, scale.clone().requires_grad_(True), bias)
        N.batch_norm(x.detach().requires_grad_(True), scale, bias)
        N.batch_norm(x.float(), scale, bias)
    assert BN.plain_cuda_calls == p0 + 3 and BN.launches == n0
    with torch.no_grad():
        N.batch_norm(x, scale.clone().requires_grad_(True), bias)
    assert BN.launches["bn_apply_bf16"] == n0["bn_apply_bf16"] + 1
    assert BN.plain_cuda_calls == p0 + 3


def _lists(net):
    p, s = net.trees()
    return ([{k: v.detach() for k, v in d.items()} for d in p],
            [{"bn": {k: v.clone() for k, v in d["bn"].items()}} if d else {}
             for d in s])


def _within_bf16_tolerance(got, want):
    d = (torch.round(got * 255) - torch.round(want * 255)).abs()
    return got.dtype == torch.float32 and (d > 2).float().mean() <= 0.05


@pytest.mark.parametrize("bn_eval", [False, True])
def test_gray3_generator_on_the_kernels_against_plain_bn(cuda, bn_eval,
                                                        monkeypatch):
    """The fused gray-3 generator in bf16 (BN on the kernels) against the
    unfused one with every BN on the plain path (the rule patched to send
    every call there)."""
    cfg = get_config("gray-3", env_override=False)
    fused, _ = load_generator(cfg, FIXTURE, device=cuda)
    plain = Network(fused.spec, *_lists(fused), device=cuda, fuse=False)
    x = torch.rand((2, 1, 40, 28), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(0))
    n0, p0 = BN.launches["bn_apply_bf16"], BN.plain_cuda_calls
    got = make_full_sr_fn(fused, lr_input=True, bn_eval=bn_eval,
                          compute_dtype=BF16)(x)
    n_bn = sum(1 for i, layer in enumerate(fused.spec) if layer.get("bn")
               and i not in fused.pairs)
    assert BN.launches["bn_apply_bf16"] == n0 + n_bn
    assert BN.plain_cuda_calls == p0
    monkeypatch.setattr(BN, "takes", lambda *a, **k: False)
    want = make_full_sr_fn(plain, lr_input=True, bn_eval=bn_eval,
                           compute_dtype=BF16)(x)
    assert BN.plain_cuda_calls == p0 + n_bn + 1
    assert _within_bf16_tolerance(got, want)


@pytest.mark.parametrize("bn_eval", [False, True])
def test_overlap_pipeline_on_the_kernels_against_plain_bn(cuda, bn_eval,
                                                         monkeypatch):
    cfg = get_config("gray-patch-batch-overlap", env_override=False)
    fused, _ = load_generator(cfg, PATCH_FIXTURE, device=cuda)
    plain = Network(fused.spec, *_lists(fused), device=cuda, fuse=False)
    images = torch.rand((2, 64, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    p0 = BN.plain_cuda_calls
    got = make_overlap_sr_fn(cfg, fused, compute_dtype=BF16,
                             bn_eval=bn_eval)(images)
    assert BN.plain_cuda_calls == p0
    monkeypatch.setattr(BN, "takes", lambda *a, **k: False)
    want = make_overlap_sr_fn(cfg, plain, compute_dtype=BF16,
                              bn_eval=bn_eval)(images)
    assert BN.plain_cuda_calls > p0
    for k in ("tiles", "naive"):
        assert _within_bf16_tolerance(got[k], want[k])
