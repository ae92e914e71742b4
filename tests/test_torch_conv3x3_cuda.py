"""Card-only tests of ops/conv3x3.py's kernel (csrc/conv3x3.cu): it has no
CPU mode, so these skip without an NVIDIA card.  The file imports neither
JAX nor the JAX package:

  python -m pytest tests/test_torch_conv3x3_cuda.py --noconftest -q -p no:cacheprovider

What they hold the kernel to:
  - `plain`: F.conv2d in fp32 (TF32 off) on the same bf16 operands, the
    bias added in fp32: within one bf16 step on every element, the step
    taken at the reference's value or at 1/64 of the output's root mean
    square, whichever is larger (tests/test_torch_conv_narrow_cuda.py's
    convention); at SRGAN's three shapes cut to two images, at ragged
    sizes (widths and heights of 1 and 2, widths that leave a partial strip
    of 128 columns), Cout 64 and 256, with and without a bias, and x
    16-byte aligned (the TMA path) or a view 6 or 8 bytes past a 16-byte
    boundary (the plain-load path);
  - the same input gives the same bits on every run;
  - ops/nn.py conv2d's rule on the card: a gradient to carry, fp32 or a
    shape it does not take runs cuDNN; only a shape it fits, left to cuDNN
    for a gradient, counts as plain; one bf16 SRGAN call launches the
    kernel 35 times and leaves none of its convs to cuDNN, one under a
    gradient launches it 0 times and counts 35 plain;
  - SRGAN's bf16 generator, its 35 3x3 convs on the kernel, within the
    bf16 tolerance of tests/test_torch_bn_cuda.py (2 levels of 255 on all
    but 5% of the pixels) of the same generator with them forced to cuDNN.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from dcgan_sr_tpu_torch.core import MODELS
from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn
from dcgan_sr_tpu_torch.models import Network, generator_spec
from dcgan_sr_tpu_torch.ops import conv3x3 as C3
from dcgan_sr_tpu_torch.ops import nn as N
from dcgan_sr_tpu_torch.reference import srgan as R
from dcgan_sr_tpu_torch.utils.profiling import counters

import torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16

# (N, H, W, Cout): SRGAN's three shapes cut to two images, then ragged and
# small maps at every edge
SHAPES = [(2, 256, 256, 64), (2, 256, 256, 256), (2, 512, 512, 256),
          (1, 37, 70, 64), (2, 1, 1, 64), (1, 2, 2, 256), (1, 5, 300, 256),
          (3, 13, 129, 64), (1, 9, 136, 256), (2, 3, 8, 64),
          (1, 70, 37, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _operands(shape, device, seed=0, offset=0):
    """x (bf16, `offset` elements past a 16-byte boundary), w and bias
    (fp32, as a model holds them) at a conv's scale."""
    n, h, w, cout = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, 64, h, w), generator=g, device=device).to(BF16)
    if offset:
        buf = torch.empty(x.numel() + 8, device=device, dtype=BF16)
        view = buf[offset:offset + x.numel()].view(x.shape)
        view.copy_(x)
        x = view
    wt = torch.randn((cout, 64, 3, 3), generator=g, device=device) / 24
    b = 0.5 * torch.randn((cout,), generator=g, device=device)
    return x, wt, b


def _reference(x, wt, b):
    """F.conv2d in fp32 with TF32 off on the bf16 operands, the bf16 bias
    added in fp32: unrounded."""
    with N.fp32_convs():
        y = F.conv2d(x.float(), wt.to(BF16).float(), None, padding=1)
    if b is not None:
        y = y + b.to(BF16).float()[None, :, None, None]
    return y


def _bf16_step(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _within_one_step(y, want):
    floor = want.square().mean().sqrt() / 64
    tol = _bf16_step(torch.maximum(want.abs(), floor))
    return bool(((y.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("offset", [0, 3, 4])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_against_fp32_conv2d(cuda, shape, with_bias, offset):
    x, wt, b = _operands(shape, cuda, seed=sum(shape), offset=offset)
    b = b if with_bias else None
    n0 = counters["conv3x3"]
    y = C3.conv(x, wt, b)
    torch.cuda.synchronize()
    assert counters["conv3x3"] == n0 + 1
    assert y.dtype == BF16 and y.shape == (shape[0], shape[3], *shape[1:3])
    assert _within_one_step(y, _reference(x, wt, b))


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_kernel_against_plain(cuda, shape):
    """The kernel and `plain` round the same fp32 sums once: equal but
    where the sums' order moves a value across a rounding boundary."""
    x, wt, b = _operands(shape, cuda, seed=11)
    y, want = C3.conv(x, wt, b), C3.plain(x, wt, b)
    assert _within_one_step(y, want.float())
    assert (y != want).float().mean() <= 0.01


def test_two_runs_give_the_same_bits(cuda):
    for shape in SHAPES[:2]:
        x, wt, b = _operands(shape, cuda, seed=7)
        ys = [C3.conv(x, wt, b).view(torch.int16) for _ in range(3)]
        assert all(torch.equal(ys[0], v) for v in ys[1:])


def test_the_rule_on_the_card(cuda):
    x, wt, b = _operands((1, 16, 16, 64), cuda, seed=3)
    n0, p0 = counters["conv3x3"], counters["conv3x3_plain"]
    with torch.no_grad():
        y = N.conv2d(x, wt, 1, 1, bias=b)
    assert counters["conv3x3"] == n0 + 1
    assert _within_one_step(y, _reference(x, wt, b))
    with torch.enable_grad():
        N.conv2d(x, wt.clone().requires_grad_(True), 1, 1, bias=b)
        N.conv2d(x, wt, 1, 1, bias=b.clone().requires_grad_(True))
        N.conv2d(x.detach().requires_grad_(True), wt, 1, 1, bias=b)
    with torch.no_grad():       # shapes it does not fit, fp32: not counted
        N.conv2d(x, wt, 1, 0, bias=b)                        # padding 0
        N.conv2d(x, wt, 2, 1, bias=b)                        # stride 2
        N.conv2d(x.float(), wt, 1, 1, bias=b)                # fp32
        N.conv2d(x[:, :32], wt[:, :32], 1, 1, bias=b)        # Cin 32
        N.conv2d(x, wt[:32], 1, 1, bias=b[:32])              # Cout 32
        N.conv2d(x, torch.cat([wt] * 4), 1, 1)               # Cout 256 takes
    assert counters["conv3x3"] == n0 + 2
    assert counters["conv3x3_plain"] == p0 + 3


def _srgan(cuda, trainable=False):
    sizes = dataclasses.asdict(MODELS["srgan-x4"])
    params, state = R.draw(sizes, torch.Generator(device=cuda).manual_seed(4),
                           cuda)
    return Network(generator_spec(MODELS["srgan-x4"]), params, state,
                   device=cuda, trainable=trainable)


def test_the_counts_of_one_srgan_call(cuda):
    """One bf16 call: 35 launches and no 3x3 conv left to cuDNN; one under
    a gradient: no launch and 35 left to cuDNN."""
    x = torch.rand((2, 3, 32, 32), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(6))
    run = make_full_sr_fn(_srgan(cuda), compute_dtype=BF16, lr_input=True,
                          bn_eval=True)
    n0, p0 = counters["conv3x3"], counters["conv3x3_plain"]
    run(x)
    assert (counters["conv3x3"] - n0, counters["conv3x3_plain"] - p0) \
        == (35, 0)
    net = _srgan(cuda, trainable=True)
    n0, p0 = counters["conv3x3"], counters["conv3x3_plain"]
    with torch.enable_grad():
        net(x, "running", compute_dtype=BF16).float().sum().backward()
    assert (counters["conv3x3"] - n0, counters["conv3x3_plain"] - p0) \
        == (0, 35)


def _within_bf16_tolerance(got, want):
    d = (torch.round(got * 255) - torch.round(want * 255)).abs()
    return got.dtype == torch.float32 and (d > 2).float().mean() <= 0.05


def test_srgan_generator_with_the_3x3_convs_on_the_kernel(cuda, monkeypatch):
    """SRGAN's generator in bf16 at its published widths on two LR images of
    32x32: the 33 LR convs and the two upsampling convs on the kernel,
    against the same generator with them on cuDNN."""
    run = make_full_sr_fn(_srgan(cuda), compute_dtype=BF16, lr_input=True,
                          bn_eval=True)
    x = torch.rand((2, 3, 32, 32), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(5))
    n0, p0 = counters["conv3x3"], counters["conv3x3_plain"]
    got = run(x)
    assert counters["conv3x3"] == n0 + 35
    assert counters["conv3x3_plain"] == p0
    monkeypatch.setattr(C3, "takes", lambda *a, **k: False)
    want = run(x)
    assert counters["conv3x3"] == n0 + 35
    assert counters["conv3x3_plain"] == p0 + 35
    assert got.shape == want.shape == (2, 3, 128, 128)
    assert _within_bf16_tolerance(got, want)
