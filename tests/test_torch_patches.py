"""The port's patch decomposition (dcgan_sr_tpu_torch.image.patches) against
the JAX package's on the same numpy inputs: pure gathers and reshapes, so the
results are held to equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.image import patches as JP
from dcgan_sr_tpu_torch.image import patches as TP

import torch_threads  # noqa: F401

# square reference geometry, then the rectangles of tests/test_rect_tiling.py
GEOMS = [(64, 64, 8, 4), (36, 24, 8, 4), (24, 36, 8, 4), (64, 32, 8, 4),
         (32, 64, 8, 4), (30, 18, 12, 6)]


@pytest.mark.parametrize("fh,fw,patch", [(64, 64, 8), (16, 48, 8), (30, 12, 6)])
def test_grid_extract_and_reassemble_equal_jax(fh, fw, patch):
    x = np.random.RandomState(0).rand(2, fh, fw).astype(np.float32)
    got = TP.extract_grid_patches(torch.from_numpy(x), patch)
    want = np.asarray(JP.extract_grid_patches(jnp.asarray(x), patch))
    np.testing.assert_array_equal(got.numpy(), want)
    back = TP.reassemble_grid_patches(got, fh, fw)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JP.reassemble_grid_patches(jnp.asarray(want),
                                                            fh, fw)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("fh,fw,patch,ov", GEOMS)
def test_overlap_extract_equals_jax(fh, fw, patch, ov):
    x = np.random.RandomState(1).rand(3, fh, fw).astype(np.float32)
    got = TP.extract_overlap_patches(torch.from_numpy(x), patch, ov).numpy()
    want = np.asarray(JP.extract_overlap_patches(jnp.asarray(x), patch, ov))
    np.testing.assert_array_equal(got, want)
    # one image without a batch dimension gives the same tiles
    np.testing.assert_array_equal(
        TP.extract_overlap_patches(torch.from_numpy(x[1]), patch, ov).numpy(),
        want[1])


@pytest.mark.parametrize("fh,fw,patch,ov", GEOMS)
def test_naive_stitch_equals_jax(fh, fw, patch, ov):
    (lh, lw), n = TP.overlap_grid((fh, fw), patch, ov)
    assert ((lh, lw), n) == JP.overlap_grid((fh, fw), patch, ov)
    tiles = np.random.RandomState(2).rand(2, n, patch, patch).astype(np.float32)
    got = TP.stitch_overlap_naive(torch.from_numpy(tiles), (fh, fw), patch, ov)
    want = np.asarray(JP.stitch_overlap_naive(jnp.asarray(tiles), (fh, fw),
                                              patch, ov))
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(TP._ownership((fh, fw), patch, ov),
                    JP._ownership((fh, fw), patch, ov)):
        np.testing.assert_array_equal(a, b)


def test_int_fine_is_the_square():
    assert TP.overlap_grid(64, 8, 4) == JP.overlap_grid(64, 8, 4) == (15, 225)
    assert TP.overlap_grid(np.int64(64), 8, 4) == (15, 225)
    tiles = np.random.RandomState(3).rand(225, 8, 8).astype(np.float32)
    a = TP.stitch_overlap_naive(torch.from_numpy(tiles), 64, 8, 4)
    b = TP.stitch_overlap_naive(torch.from_numpy(tiles), (64, 64), 8, 4)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(JP.stitch_overlap_naive(jnp.asarray(tiles), 64,
                                                      8, 4)))


def test_extract_then_naive_stitch_is_the_identity():
    img = torch.from_numpy(np.random.RandomState(4).rand(36, 24).astype(np.float32))
    tiles = TP.extract_overlap_patches(img, 8, 4)
    assert torch.equal(TP.stitch_overlap_naive(tiles, (36, 24), 8, 4), img)
