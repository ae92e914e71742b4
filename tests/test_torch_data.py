"""The port's procedural image source (data/synthetic.py) is bit-equal to
the JAX package's: the same numpy code on the same seeds."""

import numpy as np
import pytest

from dcgan_sr_tpu.data.folder import _resize_chw as j_resize_chw
from dcgan_sr_tpu.data.synthetic import SyntheticImages as JSynthetic
from dcgan_sr_tpu_torch.data.synthetic import SyntheticImages, _resize_chw

import torch_threads  # noqa: F401


@pytest.mark.parametrize("fine,nc,seed", [(64, 1, 1234), (64, 3, 7),
                                          (32, 1, 1), (8, 1, 99)])
def test_load_one_bit_equal(fine, nc, seed):
    a, b = SyntheticImages(fine, nc, seed), JSynthetic(fine, nc, seed)
    for index in (1, 2, 1000):
        x, y = a.load_one(index), b.load_one(index)
        assert x.dtype == y.dtype == np.float32 and x.shape == (nc, fine, fine)
        np.testing.assert_array_equal(x, y)
        assert x.min() == 0.0 and x.max() == 1.0


def test_load_batch_bit_equal_and_sequential():
    a, b = SyntheticImages(64, 1, 5), JSynthetic(64, 1, 5)
    x = a.load_batch(2, 6)
    np.testing.assert_array_equal(x, b.load_batch(2, 6))
    assert x.shape == (6, 1, 64, 64)
    # file order: set n holds images n*size+1 .. n*size+size
    np.testing.assert_array_equal(x[0], a.load_one(13))
    assert a.exists()


@pytest.mark.parametrize("shape,out", [((1, 9, 9), (64, 64)),
                                       ((3, 5, 7), (10, 4)),
                                       ((2, 1, 6), (3, 3))])
def test_resize_chw_bit_equal(shape, out):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(_resize_chw(x, *out), j_resize_chw(x, *out))
