"""ops/conv_narrow.py on the CPU: the rule that sends a convolution to the
narrow kernel (`conv_narrow.takes`), which convolutions of the generators
and the trainers it takes, that a CPU or fp32 call never reaches the
kernel, and the kernel's arithmetic (the plan, the packed weights, the
folded horizontal taps) emulated in float64 against the convolution.  The
kernel itself runs on the card only (tests/test_torch_conv_narrow_cuda.py).

The rule reads only what the input shows: a 4-D bf16 CUDA x, no gradient
to carry, stride 1, a square odd kernel up to 9 with padding k // 2, Cout
<= 8 and Cin a multiple of 16 up to 64.  Where the networks run here, on
the CPU, each call's verdict is read from a stand-in of its x that claims
to be a bf16 CUDA tensor, so the test shows what the card would do: of
SRGAN's 37 convolutions the rule takes the 9x9 64->3 tail and nothing else,
and of the gray-3 and overlap generators and the trainers, nothing.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from dcgan_sr_tpu_torch.core import MODELS, get_config
from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn, make_overlap_sr_fn
from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
from dcgan_sr_tpu_torch.ops import conv_narrow as CN
from dcgan_sr_tpu_torch.ops import nn as N
from dcgan_sr_tpu_torch.train.step import build_train_step, init_train_state
from dcgan_sr_tpu_torch.utils.profiling import counters

import torch_threads  # noqa: F401

BF16 = torch.bfloat16
H100_SMEM = 232448          # shared memory a block may opt into on an H100
H100_SMS = 132
TAIL = (3, 64, 9, 9)        # SRGAN's tail conv weight


def _stand_in(shape=(2, 64, 8, 8), is_cuda=True, dtype=BF16,
              requires_grad=False):
    """What `takes` reads of a tensor, without a card."""
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                                 requires_grad=requires_grad,
                                 shape=torch.Size(shape),
                                 dim=lambda: len(shape))


@pytest.mark.parametrize("case,want", [
    (dict(), True),
    (dict(bias=False), True),
    (dict(is_cuda=False), False),
    (dict(dtype=torch.float32), False),
    (dict(dtype=torch.float16), False),
    (dict(shape=(64, 8, 8)), False),
    (dict(x_grad=True), False),
    (dict(w_grad=True), False),
    (dict(bias_grad=True), False),
    (dict(x_grad=True, w_grad=True, grad_mode=False), True),
    (dict(bias_grad=True, grad_mode=False), True),
    (dict(stride=2), False),
    (dict(padding=3), False),
])
def test_the_rule_reads_device_dtype_gradients_and_geometry(case, want):
    x = _stand_in(case.get("shape", (2, 64, 8, 8)), case.get("is_cuda", True),
                  case.get("dtype", BF16), case.get("x_grad", False))
    w = types.SimpleNamespace(shape=torch.Size(TAIL),
                              requires_grad=case.get("w_grad", False))
    bias = (_stand_in((3,), requires_grad=case.get("bias_grad", False))
            if case.get("bias", True) else None)
    with torch.set_grad_enabled(case.get("grad_mode", True)):
        assert CN.takes(x, w, case.get("stride", 1), case.get("padding", 4),
                        bias) is want


@pytest.mark.parametrize("w_shape,stride,padding,want", [
    (TAIL, 1, 4, True),
    ((8, 16, 3, 3), 1, 1, True),
    ((1, 48, 5, 5), 1, 2, True),
    ((8, 64, 1, 1), 1, 0, True),
    ((9, 64, 9, 9), 1, 4, False),         # Cout 9
    (TAIL, 2, 4, False),
    (TAIL, 1, 3, False),
    ((3, 64, 4, 4), 1, 2, False),         # even k
    ((3, 64, 11, 11), 1, 5, False),       # k past 9
    ((3, 64, 9, 7), 1, 4, False),         # not square
    ((3, 8, 9, 9), 1, 4, False),          # Cin not a multiple of 16
    ((3, 24, 9, 9), 1, 4, False),
    ((3, 80, 9, 9), 1, 4, False),         # Cin past 64
    ((64, 3, 9, 9), 1, 4, False),         # SRGAN's head
    ((64, 64, 3, 3), 1, 1, False),        # its body
    ((256, 64, 3, 3), 1, 1, False),       # its upsampling convs
    ((1, 32, 4, 4), 2, 1, False),         # the gray-3 tail
    ((1, 64, 4, 4), 2, 1, False),         # the overlap tail
])
def test_the_shapes_it_fits(w_shape, stride, padding, want):
    assert CN.fits(w_shape, stride, padding) is want


@pytest.fixture
def verdicts(monkeypatch):
    """[(weight shape, would the rule take the call on the card in bf16)]
    of every ops/nn.py conv2d call, the CPU code running unchanged."""
    seen = []
    conv2d = N.conv2d

    def spy(x, w, stride=1, padding=0, *, compute_dtype=None, bias=None):
        card = _stand_in(tuple(x.shape), requires_grad=x.requires_grad)
        seen.append((tuple(w.shape), CN.takes(card, w, stride, padding,
                                              bias)))
        return conv2d(x, w, stride, padding, compute_dtype=compute_dtype,
                      bias=bias)

    monkeypatch.setattr(N, "conv2d", spy)
    return seen


def _srgan(trainable=False):
    spec = generator_spec(MODELS["srgan-x4"])
    return Network(spec, *init_network(spec, torch.Generator().manual_seed(0)),
                   device="cpu", trainable=trainable)


def test_of_srgans_convolutions_it_takes_the_tail_alone(verdicts):
    x = torch.rand((1, 3, 8, 8), generator=torch.Generator().manual_seed(1))
    y = make_full_sr_fn(_srgan(), compute_dtype=BF16, lr_input=True,
                        bn_eval=True)(x)
    assert y.shape == (1, 3, 32, 32)
    assert len(verdicts) == 37
    assert [v for _, v in verdicts] == [False] * 36 + [True]
    assert verdicts[-1][0] == TAIL


def test_srgan_with_gradients_runs_every_conv_on_cudnn(verdicts):
    net = _srgan(trainable=True)
    x = torch.rand((1, 3, 8, 8), generator=torch.Generator().manual_seed(2))
    with torch.enable_grad():
        net(x, "running", compute_dtype=BF16).float().sum().backward()
    assert len(verdicts) == 37 and verdicts[-1][0] == TAIL
    assert not any(v for _, v in verdicts)


@pytest.mark.parametrize("variant", ["gray-3", "gray-patch-batch-overlap"])
def test_the_2x_generators_run_every_conv_on_cudnn(variant, verdicts):
    """Published widths: the k4 s2 p1 tails (32 -> 1, 64 -> 1) fail the
    rule on their stride, kernel size and Cin; the transposed convs never
    reach it."""
    cfg = get_config(variant, env_override=False)
    spec = generator_spec(cfg)
    net = Network(spec, *init_network(spec, torch.Generator().manual_seed(3)),
                  device="cpu")
    if variant == "gray-3":
        x = torch.rand((1, 1, 16, 16),
                       generator=torch.Generator().manual_seed(4))
        make_full_sr_fn(net, compute_dtype=BF16)(x)
    else:
        x = torch.rand((1, 24, 32), generator=torch.Generator().manual_seed(4))
        make_overlap_sr_fn(cfg, net, compute_dtype=BF16, fine=(24, 32))(x)
    assert verdicts and not any(v for _, v in verdicts)
    assert verdicts[-1][0][:2] in ((1, 32), (1, 64))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_trainer_runs_every_conv_on_cudnn(dtype, verdicts):
    """A gray-3 training step (G and D, gradients carried) at NGF 4 / NDF
    8: no conv is the kernel's."""
    cfg = get_config("gray-3", env_override=False, ngf=4, ndf=8, batchSize=2,
                     compute_dtype=dtype)
    state = init_train_state(cfg, torch.Generator().manual_seed(5),
                             device="cpu")
    hr = torch.rand((2, 1, 64, 64), generator=torch.Generator().manual_seed(6))
    build_train_step(cfg)(state, hr)
    assert len(verdicts) > 4 and not any(v for _, v in verdicts)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_a_cpu_call_never_reaches_the_kernel(dtype, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel was called on the CPU")

    monkeypatch.setattr(CN, "conv", refuse)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((1, 64, 6, 10), generator=g).to(dtype)
    w, b = 0.02 * torch.randn(TAIL, generator=g), torch.randn(3, generator=g)
    before = dict(counters)
    y = N.conv2d(x, w, 1, 4, bias=b)
    assert counters == before
    want = F.conv2d(x.float(), w.to(dtype).float(), b.to(dtype).float(),
                    padding=4).to(dtype)
    assert y.dtype == dtype and torch.equal(y, want)


# (N, Cin, H, W, Cout, k): SRGAN's tail on a small map, then ragged maps,
# every kernel size, Cout 1 to 8, Cin 16 to 64
SHAPES = [(1, 64, 12, 70, 3, 9), (2, 16, 1, 1, 1, 3), (1, 32, 5, 131, 8, 5),
          (2, 48, 9, 64, 8, 9), (1, 64, 3, 2, 8, 9), (3, 16, 13, 9, 1, 7),
          (1, 16, 7, 7, 8, 1), (1, 64, 4, 65, 3, 3)]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_the_kernels_arithmetic_is_the_convolution(shape, with_bias):
    """emulate (the plan's strips, the packed weights, the partial sums over
    (dy, ci) and each output's k taps in order) in float64 against
    F.conv2d in float64 on the same bf16 operands."""
    n, cin, h, w, cout, k = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn((n, cin, h, w), generator=g).to(BF16)
    wt = torch.randn((cout, cin, k, k), generator=g) / (cin * k * k) ** 0.5
    b = torch.randn((cout,), generator=g) if with_bias else None
    want = F.conv2d(x.double(), wt.to(BF16).double(),
                    None if b is None else b.to(BF16).double(), padding=k // 2)
    got = CN.emulate(x, wt, b)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    want32 = F.conv2d(x.float(), wt.to(BF16).float(), None, padding=k // 2)
    if b is not None:
        want32 = want32 + b.to(BF16).float()[None, :, None, None]
    assert torch.equal(CN.plain(x, wt, b), want32.to(BF16))


@pytest.mark.parametrize("cin", [16, 32, 48, 64])
def test_every_shape_it_takes_has_a_launch_on_an_h100(cin):
    for cout in range(1, 9):
        for k in (1, 3, 5, 7, 9):
            p = CN.plan(3, cin, 37, 70, cout, k, H100_SMEM, H100_SMS)
            assert p.smem == CN.smem_bytes(cin, cout, k, p.groups, p.n)
            assert p.smem <= H100_SMEM
            assert p.n in CN.WIDTHS and cout * k <= p.n
            assert p.n == min(v for v in CN.WIDTHS if v >= cout * k)
            assert p.rows % p.groups == 0
            assert p.grid == (2, -(-37 // p.rows), 3)


def test_the_plan_at_srgans_tail():
    """Four warpgroups (rows in flight), wgmma N = 32, 230,080 bytes: one
    block an SM, 19 strips of 56 columns, 16 images."""
    p = CN.plan(16, 64, 1024, 1024, 3, 9, H100_SMEM, H100_SMS)
    assert (p.groups, p.n, p.smem) == (4, 32, 230080)
    assert p.grid[0] == 19 and p.grid[2] == 16
    assert p.grid[1] == -(-1024 // p.rows)


def test_the_packed_weights():
    """[dy * Cin / 16 + kc, h, co * k + dx, e] = w[co, 16 kc + 8 h + e, dy,
    dx]: each k-step's B as wgmma's K-major core matrices."""
    g = torch.Generator().manual_seed(8)
    w = torch.randn((3, 32, 5, 5), generator=g)
    wp = CN.pack_weights(w, 16)
    assert wp.shape == (10, 2, 16, 8) and wp.dtype == BF16
    for co, ci, dy, dx in ((0, 0, 0, 0), (2, 31, 4, 4), (1, 7, 3, 0),
                           (0, 20, 2, 3)):
        kc, h, e = ci // 16, (ci % 16) // 8, ci % 8
        assert wp[dy * 2 + kc, h, co * 5 + dx, e] == w[co, ci, dy, dx].to(BF16)
    assert not wp[:, :, 15:].any()
