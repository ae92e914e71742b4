"""The committed fixtures meet, through the port, the quality claims that
the JAX package's tests/test_*_fixture_quality.py assert: the same fixture
files, the same held-out TexturedImages file_sets and batch sizes, the same
margins over the bilinear control (and, for the overlap variant, seam >
naive > bilinear).  The port runs alone here: the JAX side of these claims
is its own tests' business.  (gray3_textured_net_G.npz has no quality
claim in JAX; tests/test_torch_eval.py holds it to JAX's numbers.)"""

import os

import numpy as np
import pytest
import torch

from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.data.synthetic import TexturedImages
from dcgan_sr_tpu_torch.evaluation import (evaluate_overlap_slice,
                                           evaluate_slice)
from dcgan_sr_tpu_torch.image.ops import box_downsample2, resize_bilinear
from dcgan_sr_tpu_torch.infer.tiled import make_overlap_sr_fn
from dcgan_sr_tpu_torch.metrics import cal_psnr_batch
from dcgan_sr_tpu_torch.train.checkpoint import load_generator

import torch_threads  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures")

# fixture -> (variant, nc, branch, file_set, batch, PSNR margin, SSIM claim)
# as in tests/test_{gray,gray2,rgb,graypatch,patch}_fixture_quality.py
FULL = {
    "gray": ("gray", 1, "ema", 2001, 100, 0.2, True),
    "gray2": ("gray-2", 1, "params", 2001, 100, 1.5, False),
    "rgb": ("rgb-full", 3, "params", 4002, 50, 3.5, True),
    "graypatch": ("gray-patch", 1, "params", 20000, 16, 1.0, True),
    "gpb": ("gray-patch-batch", 1, "params", 20000, 50, 2.0, True),
}


def _fixture(name):
    return os.path.join(FIXTURES, f"{name}_textured_net_G.npz")


def _check_full(name):
    variant, nc, branch, fs, batch, margin, ssim = FULL[name]
    cfg = get_config(variant, env_override=False)
    net, _ = load_generator(cfg, _fixture(name), ema=branch == "ema",
                            device="cpu")
    r = evaluate_slice(cfg, net, TexturedImages(cfg.fineSize, nc=nc,
                                                seed=1234), [fs],
                       batch_size=batch)
    assert r.n_images == batch
    assert r.psnr_generator > r.psnr_bilinear + margin, (
        r.psnr_generator, r.psnr_bilinear)
    if ssim:
        assert r.ssim_generator > r.ssim_bilinear, (r.ssim_generator,
                                                    r.ssim_bilinear)


def _check_overlap():
    """tests/test_overlap_fixture_quality.py, both cases: the stitches on
    file_set 62500 at batch 16 with running-stats BN, then the CLI's
    evaluate_overlap_slice path on the same slice."""
    cfg = get_config("gray-patch-batch-overlap", env_override=False)
    net, _ = load_generator(cfg, _fixture("overlap"), need_state=True,
                            device="cpu")
    src = TexturedImages(cfg.fineSize, nc=1, seed=1234)
    hr = torch.from_numpy(src.load_batch(62500, 16))[:, 0]
    out = make_overlap_sr_fn(cfg, net, bn_eval=True)(hr)
    bil = resize_bilinear(box_downsample2(hr), cfg.fineSize, cfg.fineSize)
    p_bil = float(cal_psnr_batch(hr, bil).mean())
    p_naive = float(cal_psnr_batch(hr, out["naive"]).mean())
    p_seam = float(cal_psnr_batch(hr, out["seam"]).mean())
    assert p_naive > p_bil + 0.5, (p_naive, p_bil)
    assert p_seam > p_naive + 0.2, (p_seam, p_naive)

    res = evaluate_overlap_slice(cfg, net, src, [62500], batch_size=16,
                                 bn_eval=True)
    assert res.n_images == 16
    assert res.psnr_naive > res.psnr_bilinear + 0.5
    assert res.psnr_seam > res.psnr_naive + 0.2
    assert 0.5 < res.ssim_seam <= 1.0
    lines = []
    res.print_reference_style("Test-set", log_fn=lines.append)
    assert any("fake_none_overlap" in ln for ln in lines)
    np.testing.assert_allclose(res.psnr_seam, p_seam, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(FULL) + ["overlap"])
def test_fixture_meets_the_jax_quality_claim(name):
    if not os.path.isfile(_fixture(name)):
        pytest.skip("fixture not committed")
    if name == "overlap":
        _check_overlap()
    else:
        _check_full(name)
