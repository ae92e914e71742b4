"""Card-only tests of ops/conv_narrow.py's kernel (csrc/conv_narrow.cu): it
has no CPU mode, so these skip without an NVIDIA card.  The file imports
neither JAX nor the JAX package:

  python -m pytest tests/test_torch_conv_narrow_cuda.py --noconftest -q -p no:cacheprovider

What they hold the kernel to:
  - F.conv2d in fp32 (TF32 off) on the same bf16 operands, the bias added
    in fp32: within one bf16 step on every element, the step taken at the
    reference's value or at 1/64 of the output's root mean square, whichever
    is larger (near zero the fp32 sums' own rounding, in either order, is
    larger than a bf16 step of the value); at SRGAN's tail cut to two images
    of 256x256, at ragged sizes, k 1 / 3 / 5 / 9, Cout 1 / 3 / 8, Cin 16 to
    64, with and without a bias, and x 16-byte aligned (the cp.async path)
    or a view 6 or 8 bytes past a 16-byte boundary (the plain-load path);
  - the same input gives the same bits on every run;
  - ops/nn.py conv2d's rule on the card: a gradient to carry, fp32 or a
    shape it does not take runs cuDNN; only a shape it fits, left to cuDNN
    for a gradient, counts as plain;
  - SRGAN's bf16 generator, its tail on the kernel, within the bf16
    tolerance of tests/test_torch_bn_cuda.py (2 levels of 255 on all but 5%
    of the pixels) of the same generator with the tail forced to cuDNN.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from dcgan_sr_tpu_torch.core import MODELS
from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn
from dcgan_sr_tpu_torch.models import Network, generator_spec
from dcgan_sr_tpu_torch.ops import conv_narrow as CN
from dcgan_sr_tpu_torch.ops import nn as N
from dcgan_sr_tpu_torch.reference import srgan as R
from dcgan_sr_tpu_torch.utils.profiling import counters

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16

# (N, Cin, H, W, Cout, k): SRGAN's tail cut to two 256x256 images, then
# ragged and small maps at every edge
SHAPES = [(2, 64, 256, 256, 3, 9), (1, 64, 37, 70, 3, 9), (2, 16, 1, 1, 1, 3),
          (1, 16, 5, 300, 3, 9), (1, 32, 5, 300, 8, 5), (1, 48, 9, 64, 8, 9),
          (3, 16, 13, 129, 1, 9), (2, 64, 21, 8, 8, 3), (1, 64, 70, 37, 3, 1),
          (1, 64, 3, 2, 8, 9)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _operands(shape, device, seed=0, offset=0):
    """x (bf16, `offset` elements past a 16-byte boundary), w and bias
    (fp32, as a model holds them) at a conv's scale."""
    n, cin, h, w, cout, k = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, cin, h, w), generator=g, device=device).to(BF16)
    if offset:
        buf = torch.empty(x.numel() + 8, device=device, dtype=BF16)
        view = buf[offset:offset + x.numel()].view(x.shape)
        view.copy_(x)
        x = view
    wt = torch.randn((cout, cin, k, k), generator=g, device=device) \
        / (cin * k * k) ** 0.5
    b = 0.5 * torch.randn((cout,), generator=g, device=device)
    return x, wt, b


def _reference(x, wt, b):
    """F.conv2d in fp32 with TF32 off on the bf16 operands, the bf16 bias
    added in fp32: unrounded."""
    with N.fp32_convs():
        y = F.conv2d(x.float(), wt.to(BF16).float(), None,
                     padding=wt.shape[-1] // 2)
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
    n0 = counters["conv_narrow"]
    y = CN.conv(x, wt, b)
    torch.cuda.synchronize()
    assert counters["conv_narrow"] == n0 + 1
    assert y.dtype == BF16 and y.shape == (shape[0], shape[4], *shape[2:4])
    assert _within_one_step(y, _reference(x, wt, b))


def test_two_runs_give_the_same_bits(cuda):
    x, wt, b = _operands(SHAPES[0], cuda, seed=7)
    ys = [CN.conv(x, wt, b).view(torch.int16) for _ in range(3)]
    assert all(torch.equal(ys[0], v) for v in ys[1:])


def test_the_rule_on_the_card(cuda):
    x, wt, b = _operands((1, 64, 16, 16, 3, 9), cuda, seed=3)
    n0, p0 = counters["conv_narrow"], counters["conv_narrow_plain"]
    with torch.no_grad():
        y = N.conv2d(x, wt, 1, 4, bias=b)
    assert counters["conv_narrow"] == n0 + 1
    assert _within_one_step(y, _reference(x, wt, b))
    with torch.enable_grad():
        N.conv2d(x, wt.clone().requires_grad_(True), 1, 4, bias=b)
        N.conv2d(x, wt, 1, 4, bias=b.clone().requires_grad_(True))
        N.conv2d(x.detach().requires_grad_(True), wt, 1, 4, bias=b)
    with torch.no_grad():       # shapes it does not fit, fp32: not counted
        N.conv2d(x, wt[:, :, 1:-1, 1:-1], 1, 4, bias=b)      # padding not k // 2
        N.conv2d(x, wt, 2, 4, bias=b)                        # stride 2
        N.conv2d(x.float(), wt, 1, 4, bias=b)                # fp32
        N.conv2d(x[:, :48], wt[:, :48], 1, 4, bias=b)        # Cin 48 still takes
    assert counters["conv_narrow"] == n0 + 2
    assert counters["conv_narrow_plain"] == p0 + 3


def _within_bf16_tolerance(got, want):
    d = (torch.round(got * 255) - torch.round(want * 255)).abs()
    return got.dtype == torch.float32 and (d > 2).float().mean() <= 0.05


def test_srgan_generator_with_the_tail_on_the_kernel(cuda, monkeypatch):
    """SRGAN's generator in bf16 at its published widths on two LR images of
    32x32: the tail (64 -> 3, 9x9, at 128x128) on the kernel, the other 36
    convs on cuDNN, against the same generator with every conv on cuDNN."""
    sizes = dataclasses.asdict(MODELS["srgan-x4"])
    params, state = R.draw(sizes, torch.Generator(device=cuda).manual_seed(4),
                           cuda)
    net = Network(generator_spec(MODELS["srgan-x4"]), params, state,
                  device=cuda)
    run = make_full_sr_fn(net, compute_dtype=BF16, lr_input=True,
                          bn_eval=True)
    x = torch.rand((2, 3, 32, 32), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(5))
    n0, p0 = counters["conv_narrow"], counters["conv_narrow_plain"]
    got = run(x)
    assert counters["conv_narrow"] == n0 + 1
    assert counters["conv_narrow_plain"] == p0
    monkeypatch.setattr(CN, "takes", lambda *a, **k: False)
    want = run(x)
    assert counters["conv_narrow"] == n0 + 1
    assert counters["conv_narrow_plain"] == p0 + 1
    assert got.shape == want.shape == (2, 3, 128, 128)
    assert _within_bf16_tolerance(got, want)
