"""ops/conv3x3.py on the CPU: the rule that sends a convolution to the 3x3
kernel (`conv3x3.takes`), which convolutions of the generators and the
trainers it takes, that a CPU or fp32 call never reaches the kernel, the
launch plan, the packed weights and their reuse, and the kernel's
arithmetic (the strips, the transposed rows, the k-steps in order)
emulated in float64 against the convolution.  The kernel itself runs on
the card only (tests/test_torch_conv3x3_cuda.py).

The rule reads only what the input shows: w (Cout, 64, 3, 3) with Cout 64
or 256 at stride 1 and padding 1, a 4-D bf16 CUDA x, no gradient to carry.
Where the networks run here, on the CPU, each call's verdict is read from a
stand-in of its x that claims to be a bf16 CUDA tensor, so the test shows
what the card would do: of SRGAN's 37 convolutions the rule takes the 33
LR convs and the two upsampling convs, conv_narrow's rule the tail and
neither the 9x9 head; of the gray-3 and overlap generators and the
trainers, nothing.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from dcgan_sr_tpu_torch.core import MODELS, get_config
from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn, make_overlap_sr_fn
from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
from dcgan_sr_tpu_torch.ops import conv3x3 as C3
from dcgan_sr_tpu_torch.ops import conv_narrow as CN
from dcgan_sr_tpu_torch.ops import nn as N
from dcgan_sr_tpu_torch.train.step import build_train_step, init_train_state
from dcgan_sr_tpu_torch.utils.profiling import counters

import torch_threads  # noqa: F401

BF16 = torch.bfloat16
H100_SMS = 132
LR = (64, 64, 3, 3)         # SRGAN's body convs
UP = (256, 64, 3, 3)        # its upsampling convs
HEAD, TAIL = (64, 3, 9, 9), (3, 64, 9, 9)


def _stand_in(shape=(2, 64, 8, 8), is_cuda=True, dtype=BF16,
              requires_grad=False):
    """What `takes` reads of a tensor, without a card."""
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                                 requires_grad=requires_grad,
                                 shape=torch.Size(shape),
                                 dim=lambda: len(shape))


@pytest.mark.parametrize("w_shape", [LR, UP])
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
    (dict(padding=0), False),
])
def test_the_rule_reads_device_dtype_gradients_and_geometry(w_shape, case,
                                                            want):
    x = _stand_in(case.get("shape", (2, 64, 8, 8)), case.get("is_cuda", True),
                  case.get("dtype", BF16), case.get("x_grad", False))
    w = types.SimpleNamespace(shape=torch.Size(w_shape),
                              requires_grad=case.get("w_grad", False))
    bias = (_stand_in((w_shape[0],), requires_grad=case.get("bias_grad",
                                                            False))
            if case.get("bias", True) else None)
    with torch.set_grad_enabled(case.get("grad_mode", True)):
        assert C3.takes(x, w, case.get("stride", 1), case.get("padding", 1),
                        bias) is want


@pytest.mark.parametrize("w_shape,stride,padding,want", [
    (LR, 1, 1, True),
    (UP, 1, 1, True),
    (LR, 2, 1, False),
    (LR, 1, 0, False),                    # the patch D's k3 convs
    (LR, 1, 2, False),
    ((128, 64, 3, 3), 1, 1, False),       # Cout neither 64 nor 256
    ((32, 64, 3, 3), 1, 1, False),
    ((64, 32, 3, 3), 1, 1, False),        # Cin not 64
    ((64, 128, 3, 3), 1, 1, False),
    ((64, 64, 5, 5), 1, 2, False),        # not 3x3
    ((64, 64, 3, 1), 1, 1, False),
    ((64, 64, 1, 1), 1, 0, False),
    (HEAD, 1, 4, False),
    (TAIL, 1, 4, False),
    ((64, 32, 4, 4), 2, 1, False),        # the 2x generators' k4 s2 p1
    ((1, 64, 4, 4), 2, 1, False),
])
def test_the_shapes_it_fits(w_shape, stride, padding, want):
    assert C3.fits(w_shape, stride, padding) is want


@pytest.fixture
def verdicts(monkeypatch):
    """[(weight shape, would conv3x3's rule take the call on the card in
    bf16, would conv_narrow's)] of every ops/nn.py conv2d call, the CPU
    code running unchanged."""
    seen = []
    conv2d = N.conv2d

    def spy(x, w, stride=1, padding=0, *, compute_dtype=None, bias=None):
        card = _stand_in(tuple(x.shape), requires_grad=x.requires_grad)
        seen.append((tuple(w.shape),
                     C3.takes(card, w, stride, padding, bias),
                     CN.takes(card, w, stride, padding, bias)))
        return conv2d(x, w, stride, padding, compute_dtype=compute_dtype,
                      bias=bias)

    monkeypatch.setattr(N, "conv2d", spy)
    return seen


def _srgan(trainable=False):
    spec = generator_spec(MODELS["srgan-x4"])
    return Network(spec, *init_network(spec, torch.Generator().manual_seed(0)),
                   device="cpu", trainable=trainable)


def test_of_srgans_convolutions_it_takes_the_35_3x3_ones(verdicts):
    x = torch.rand((1, 3, 8, 8), generator=torch.Generator().manual_seed(1))
    y = make_full_sr_fn(_srgan(), compute_dtype=BF16, lr_input=True,
                        bn_eval=True)(x)
    assert y.shape == (1, 3, 32, 32)
    assert len(verdicts) == 37
    assert [v for _, v, _ in verdicts] == [False] + [True] * 35 + [False]
    assert [s for s, _, _ in verdicts] == [HEAD] + [LR] * 33 + [UP] * 2 \
        + [TAIL]
    # conv_narrow takes the tail, cuDNN the head
    assert [n for _, _, n in verdicts] == [False] * 36 + [True]


def test_srgan_with_gradients_runs_every_conv_on_cudnn(verdicts):
    net = _srgan(trainable=True)
    x = torch.rand((1, 3, 8, 8), generator=torch.Generator().manual_seed(2))
    with torch.enable_grad():
        net(x, "running", compute_dtype=BF16).float().sum().backward()
    assert len(verdicts) == 37
    assert sum(C3.fits(s, 1, 1) for s, _, _ in verdicts) == 35
    assert not any(v for _, v, _ in verdicts)


@pytest.mark.parametrize("variant", ["gray-3", "gray-patch-batch-overlap"])
def test_the_2x_generators_never_reach_it(variant, verdicts):
    """Published widths: every conv is k4 s2 p1 (or a transposed conv,
    which never reaches conv2d)."""
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
    assert verdicts and not any(v for _, v, _ in verdicts)
    assert not any(C3.fits(s, 1, 1) for s, _, _ in verdicts)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_training_step_never_reaches_it(dtype, verdicts):
    """A gray-3 training step (G and D, gradients carried) at NGF 4 / NDF
    8: no conv is the kernel's."""
    cfg = get_config("gray-3", env_override=False, ngf=4, ndf=8, batchSize=2,
                     compute_dtype=dtype)
    state = init_train_state(cfg, torch.Generator().manual_seed(5),
                             device="cpu")
    hr = torch.rand((2, 1, 64, 64), generator=torch.Generator().manual_seed(6))
    build_train_step(cfg)(state, hr)
    assert len(verdicts) > 4 and not any(v for _, v, _ in verdicts)


@pytest.mark.parametrize("w_shape", [LR, UP])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_a_cpu_call_never_reaches_the_kernel(dtype, w_shape, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel was called on the CPU")

    monkeypatch.setattr(C3, "conv", refuse)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((1, 64, 6, 10), generator=g).to(dtype)
    w = 0.05 * torch.randn(w_shape, generator=g)
    b = torch.randn(w_shape[0], generator=g)
    before = dict(counters)
    y = N.conv2d(x, w, 1, 1, bias=b)
    assert counters == before
    want = F.conv2d(x.float(), w.to(dtype).float(), b.to(dtype).float(),
                    padding=1).to(dtype)
    assert y.dtype == dtype and torch.equal(y, want)


# (N, H, W, Cout): SRGAN's shapes on small maps, then ragged maps: widths
# and heights of 1 and 2, widths past one and two strips of 128 columns
SHAPES = [(1, 6, 20, 64), (2, 5, 8, 256), (1, 1, 1, 64), (2, 2, 2, 256),
          (1, 1, 130, 64), (1, 3, 129, 256), (1, 7, 257, 64),
          (3, 2, 1, 64), (1, 9, 136, 256)]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_the_kernels_arithmetic_is_the_convolution(shape, with_bias):
    """emulate (the strips, the transposed rows with their zero padding,
    the packed weights, the 36 k-steps in order, the bias) in float64
    against F.conv2d in float64 on the same bf16 operands."""
    n, h, w, cout = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn((n, 64, h, w), generator=g).to(BF16)
    wt = torch.randn((cout, 64, 3, 3), generator=g) / 24
    b = torch.randn((cout,), generator=g) if with_bias else None
    want = F.conv2d(x.double(), wt.to(BF16).double(),
                    None if b is None else b.to(BF16).double(), padding=1)
    got = C3.emulate(x, wt, b)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    want32 = F.conv2d(x.float(), wt.to(BF16).float(), None, padding=1)
    if b is not None:
        want32 = want32 + b.to(BF16).float()[None, :, None, None]
    assert torch.equal(C3.plain(x, wt, b), want32.to(BF16))


def test_the_edges_are_zero_padding():
    """A map of ones through a weight of ones: each output counts the taps
    inside the image (4 at a corner, 6 on an edge, 9 inside), times 64."""
    x = torch.ones((1, 64, 3, 130), dtype=BF16)
    got = C3.emulate(x, torch.ones((64, 64, 3, 3)))
    taps = torch.full((3, 130), 9.0, dtype=torch.float64)
    taps[[0, -1], :] = 6
    taps[:, [0, -1]] = 6
    taps[0, 0] = taps[0, -1] = taps[-1, 0] = taps[-1, -1] = 4
    assert torch.equal(got, (64 * taps).expand(1, 64, 3, 130))


@pytest.mark.parametrize("shape,want", [
    # SRGAN's shapes at B = 16: (N, H, W, Cout) -> (tiles, strips, rows,
    # groups, grid)
    ((16, 256, 256, 64), (1, 2, 63, 131, 131)),
    ((16, 256, 256, 256), (4, 2, 249, 33, 132)),
    ((16, 512, 512, 256), (4, 4, 993, 33, 132)),
    ((1, 1, 1, 64), (1, 1, 1, 1, 1)),
    ((2, 5, 300, 256), (4, 3, 1, 30, 120)),
])
def test_the_plan(shape, want):
    p = C3.plan(*shape, H100_SMS)
    assert (p.tiles, p.strips, p.rows, p.groups, p.grid) == want
    n, h, w, _ = shape
    assert p.grid <= H100_SMS
    assert (p.groups - 1) * p.rows < n * p.strips * h <= p.groups * p.rows


def test_the_packed_weights():
    """[t, ks, kh, m, e] = w[64 t + m, 16 kc + 8 kh + e, dy, dx], ks = (3 dy
    + dx) * 4 + kc: each k-step's A as wgmma's K-major core matrices."""
    g = torch.Generator().manual_seed(8)
    w = torch.randn(UP, generator=g)
    wp = C3.pack_weights(w)
    assert wp.shape == (4, 36, 2, 64, 8) and wp.dtype == BF16
    for co, ci, dy, dx in ((0, 0, 0, 0), (255, 63, 2, 2), (70, 9, 1, 0),
                           (129, 40, 0, 2), (191, 23, 2, 1)):
        t, m = divmod(co, 64)
        kc, kh, e = ci // 16, (ci % 16) // 8, ci % 8
        ks = (3 * dy + dx) * 4 + kc
        assert wp[t, ks, kh, m, e] == w[co, ci, dy, dx].to(BF16)


def test_the_packing_is_kept_while_the_weights_stay():
    """One packing a weight tensor: the same packed tensor and fp32 bias on
    every call while neither tensor changes, made anew after an in-place
    update of either."""
    g = torch.Generator().manual_seed(9)
    w, b = torch.randn(LR, generator=g), torch.randn(64, generator=g)
    cpu = torch.device("cpu")
    wpk, b32 = C3._operands(w, b, cpu)
    assert torch.equal(wpk, C3.pack_weights(w))
    assert b32.dtype == torch.float32 and torch.equal(b32, b.to(BF16).float())
    again = C3._operands(w, b, cpu)
    assert again[0] is wpk and again[1] is b32
    with torch.no_grad():
        w.add_(1.0)
    moved = C3._operands(w, b, cpu)
    assert moved[0] is not wpk and torch.equal(moved[0], C3.pack_weights(w))
    with torch.no_grad():
        b.mul_(2.0)
    assert torch.equal(C3._operands(w, b, cpu)[1], b.to(BF16).float())
    assert C3._operands(w, None, cpu)[1] is None
