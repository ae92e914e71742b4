"""The port's bridge to the committed native decoder
(dcgan_sr_tpu_torch.data.native -> native/libdcgansr.so): decode equal to the
PIL path, the sorted index of decodable files, the batch loader, and clean
failures.  It skips, as tests/test_native.py does, only when the committed
library does not load here; it never builds into native/."""

import os

import numpy as np
import pytest
from PIL import Image

from dcgan_sr_tpu.data import native as jnative
from dcgan_sr_tpu_torch.data import native
from dcgan_sr_tpu_torch.data.folder import _resize_chw
from dcgan_sr_tpu_torch.data.indexed import IndexedCelebA
from dcgan_sr_tpu_torch.image.io import load_image, save_image

import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"the committed native library does not load: "
                    f"{native.load_error()}")
    return True


def _pngs(d, n=3, hw=(40, 30), seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = str(d / f"{i + 1:06d}.png")
        save_image(p, rng.rand(3, *hw).astype(np.float32))
        out.append(p)
    return out


def test_library_is_the_committed_file():
    assert native.LIB_PATH == os.path.abspath(jnative._LIB_PATHS[0])


@pytest.mark.parametrize("nc,out", [(1, 16), (3, 20)])
def test_decode_equals_pil(lib, tmp_path, nc, out):
    [p] = _pngs(tmp_path, n=1)
    got = native.load_image(p, nc=nc, out_h=out, out_w=out)
    want = _resize_chw(load_image(p, nc=nc), out, out)
    assert got.shape == (nc, out, out)
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_array_equal(got, jnative.load_image(p, nc, out, out))


def test_index_dir_sorted_and_decodable_only(lib, tmp_path):
    for d in ("c", "a", "b"):
        (tmp_path / d).mkdir()
        _pngs(tmp_path / d, n=2)
    (tmp_path / "a" / "skip.bmp").write_bytes(b"BM fake")
    (tmp_path / "b" / "skip.ppm").write_bytes(b"P6 fake")
    paths = native.index_dir(str(tmp_path))
    assert paths == sorted(paths) == jnative.index_dir(str(tmp_path))
    assert len(paths) == 6 and all(p.endswith(".png") for p in paths)
    assert native.index_dir(str(tmp_path / "a" / "none")) == []


def test_batch_loader_equals_the_python_loader(lib, tmp_path):
    rng = np.random.RandomState(1)
    for i in range(1, 9):
        arr = (rng.rand(24, 18, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(str(tmp_path / f"{i:06d}.jpg"), quality=95)
    loader = native.NativeIndexedLoader(str(tmp_path), fine_size=16, nc=1,
                                        n_threads=2)
    try:
        assert loader.exists()
        batch = loader.load_batch(1, 4)             # files 000005 .. 000008
        one = loader.load_one(5)
    finally:
        loader.close()
    assert batch.shape == (4, 1, 16, 16) and np.isfinite(batch).all()
    py = IndexedCelebA(str(tmp_path), 16, nc=1, n_threads=0).load_batch(1, 4)
    np.testing.assert_allclose(batch, py, atol=2e-6)
    np.testing.assert_array_equal(batch[0], one)


def test_missing_file_raises(lib, tmp_path):
    loader = native.NativeIndexedLoader(str(tmp_path), fine_size=8, nc=1)
    try:
        with pytest.raises(IOError, match="failed to decode"):
            loader.load_batch(0, 2)
        with pytest.raises(IOError, match="native decode failed"):
            loader.load_one(3)
    finally:
        loader.close()


def test_null_loader_handle_raises_cleanly():
    """A NULL dsr_loader_create return raises RuntimeError instead of being
    handed to dsr_loader_load_batch (a NULL dereference)."""

    class StubLib:
        def dsr_loader_create(self, *a):
            return None  # ctypes c_void_p restype maps NULL to None

    loader = native.NativeIndexedLoader.__new__(native.NativeIndexedLoader)
    loader._lib = StubLib()
    loader.route = "/nonexistent"
    loader.fine_size, loader.nc = 64, 1
    loader._handles, loader._n_threads = {}, 2
    with pytest.raises(RuntimeError, match="dsr_loader_create failed"):
        loader._handle(batch_size=4)
    assert loader._handles == {}  # a failed create is never cached
