"""The launch path of the fused preprocess (ops/preprocess.py) as far as the
CPU reaches it: the contract of its outputs, and every precondition of the
kernel still raising before anything is launched.  The
kernel itself, eager and under CUDA graph capture, is held on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 5)."""

import pytest
import torch

from dcgan_sr_tpu_torch.ops import preprocess as P

import torch_threads  # noqa: F401


@pytest.mark.parametrize("b,c,h,w", [(100, 1, 64, 64), (100, 3, 64, 64),
                                     (1280, 1, 8, 8), (3, 1, 50, 38),
                                     (1, 1, 2, 2)])
@pytest.mark.parametrize("gray", [False, True])
def test_outputs_keep_their_contract(b, c, h, w, gray):
    """Shapes, strides and alignment of (hr, lr) as the step reads them: the
    launch path allocates nothing else and returns no view of x."""
    c = 3 if gray else c
    x = torch.rand((b, c, h, w), generator=torch.Generator().manual_seed(b))
    hr, lr = P.preprocess(x, rgb_to_gray=gray, to_pm1=True)
    c_out = 1 if gray else c
    assert hr.shape == (b, c_out, h, w) and lr.shape == (b, c_out, h // 2, w // 2)
    assert hr.dtype == lr.dtype == torch.float32
    assert hr.is_contiguous() and lr.is_contiguous()
    assert hr.stride() == (c_out * h * w, h * w, w, 1)
    assert lr.stride() == (c_out * h * w // 4, h * w // 4, w // 2, 1)
    assert hr.data_ptr() % 8 == 0 and lr.data_ptr() % 8 == 0
    assert hr.data_ptr() != x.data_ptr()
    assert -1.0 <= lr.min() and lr.max() <= 1.0


@pytest.mark.parametrize("gray,pm1", [(False, False), (True, True),
                                      (False, True), (True, False)])
def test_cpu_contract_is_the_plain_version(gray, pm1):
    x = torch.rand((4, 3, 16, 12), generator=torch.Generator().manual_seed(0))
    n0 = P.launches["preprocess"]
    hr, lr = P.preprocess(x, rgb_to_gray=gray, to_pm1=pm1)
    hp, lp = P.preprocess_plain(x, rgb_to_gray=gray, to_pm1=pm1)
    assert P.launches["preprocess"] == n0
    assert hr.shape == (4, 1 if gray else 3, 16, 12)
    assert lr.shape == (4, 1 if gray else 3, 8, 6)
    assert torch.equal(hr, hp) and torch.equal(lr, lp)


def test_a_tensor_that_requires_grad_and_a_view_are_taken():
    x = torch.rand((2, 1, 8, 20), generator=torch.Generator().manual_seed(1))
    want = P.preprocess_plain(x[..., 2:18])[1]
    assert torch.equal(P.preprocess(x[..., 2:18])[1], want)
    leaf = x.clone().requires_grad_(True)
    assert torch.equal(P.preprocess(leaf)[1].detach(), P.preprocess_plain(x)[1])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_every_precondition_still_raises(device):
    z = lambda *s, **k: torch.zeros(s, device=device, **k)  # noqa: E731
    n0 = P.launches["preprocess"]
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        P.preprocess(z(4, 4))
    with pytest.raises(ValueError, match="float32"):
        P.preprocess(z(1, 1, 4, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="float32"):
        P.preprocess(z(1, 1, 4, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="even"):
        P.preprocess(z(1, 1, 7, 8))
    with pytest.raises(ValueError, match="even"):
        P.preprocess(z(1, 1, 8, 7))
    with pytest.raises(ValueError, match="3 channels"):
        P.preprocess(z(1, 1, 4, 4), rgb_to_gray=True)
    with pytest.raises(ValueError, match="3 channels"):
        P.preprocess(z(1, 4, 4, 4), rgb_to_gray=True)
    if device == "meta":
        with pytest.raises(ValueError, match="cpu or cuda"):
            P.preprocess(z(1, 1, 4, 4))
    assert P.launches["preprocess"] == n0
