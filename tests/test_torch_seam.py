"""The port's seam stitchers — the host replay (infer/seam.py) and the
batched DP on the device (infer/seam_device.py) — against the JAX package's
seam_stitch and seam_stitch_device on the same tiles.  The DP is
comparisons, minima and one addition per cell in a fixed order, so all four
are held to bit equality, ties included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.infer.seam import seam_stitch as j_host
from dcgan_sr_tpu.infer.seam_device import seam_stitch_device as j_device
from dcgan_sr_tpu_torch.infer.seam import seam_stitch as t_host
from dcgan_sr_tpu_torch.infer.seam_device import (_backtrack, _dp_paths,
                                                  seam_stitch_device as t_device)

import torch_threads  # noqa: F401


def _tiles(kind, n, patch, seed):
    rng = np.random.RandomState(seed)
    if kind == "ties":      # quantized tiles force DP ties
        return (rng.randint(0, 4, (n, patch, patch)) / 4.0).astype(np.float32)
    return rng.rand(n, patch, patch).astype(np.float32)


# 64/8/4 is the reference geometry; rectangles and 30x18 at 12/6 others
@pytest.mark.parametrize("both_seams", [False, True])
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("fine,patch,ov", [(64, 8, 4), ((36, 24), 8, 4),
                                           ((24, 36), 8, 4), ((30, 18), 12, 6),
                                           ((12, 12), 8, 4)])
def test_host_and_device_seam_bit_identical_to_jax(fine, patch, ov, kind,
                                                   both_seams):
    fh, fw = (fine, fine) if isinstance(fine, int) else fine
    n = ((fh - ov) // (patch - ov)) * ((fw - ov) // (patch - ov))
    tiles = _tiles(kind, n, patch, seed=fh + fw)
    want = j_host(tiles, fine, patch, ov, both_seams=both_seams)
    np.testing.assert_array_equal(
        np.asarray(j_device(jnp.asarray(tiles), fine, patch, ov,
                            both_seams=both_seams)), want)
    np.testing.assert_array_equal(
        t_host(tiles, fine, patch, ov, both_seams=both_seams), want)
    got = t_device(torch.from_numpy(tiles), fine, patch, ov,
                   both_seams=both_seams)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("both_seams", [False, True])
def test_device_seam_takes_a_batch_of_images(both_seams):
    tiles = np.stack([_tiles("random", 225, 8, 0), _tiles("ties", 225, 8, 1),
                      _tiles("random", 225, 8, 2)])
    got = t_device(torch.from_numpy(tiles), 64, 8, 4, both_seams=both_seams)
    assert got.shape == (3, 64, 64)
    for g, t in zip(got.numpy(), tiles):
        np.testing.assert_array_equal(
            g, j_host(t, 64, 8, 4, both_seams=both_seams))


def test_device_seam_on_a_strided_view():
    """rot90 and flips hand the stitcher views; the gathers must not depend
    on contiguity."""
    base = torch.from_numpy(_tiles("random", 225, 8, 5))
    view = torch.rot90(base, 1, dims=(-2, -1))
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        t_device(view, 64, 8, 4).numpy(),
        j_host(view.contiguous().numpy(), 64, 8, 4))


def test_identity_when_tiles_agree():
    from dcgan_sr_tpu_torch.image.patches import extract_overlap_patches
    img = torch.from_numpy(np.random.RandomState(4).rand(64, 64).astype(np.float32))
    tiles = extract_overlap_patches(img, 8, 4)
    assert torch.equal(t_device(tiles, 64, 8, 4), img)
    np.testing.assert_array_equal(t_host(tiles.numpy(), 64, 8, 4), img.numpy())


def test_dp_table_and_backtrack_equal_jax():
    from dcgan_sr_tpu.infer import seam_device as JD
    delta = np.abs(_tiles("ties", 40, 8, 7)[:, :, :4]
                   - _tiles("ties", 40, 8, 8)[:, :, 4:])
    path = _dp_paths(torch.from_numpy(delta))
    jpath = JD._dp_paths(jnp.asarray(delta))
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(_backtrack(path).numpy(),
                                  np.asarray(JD._backtrack(jpath)))
