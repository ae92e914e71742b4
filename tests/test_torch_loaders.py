"""The port's host-side loaders (dcgan_sr_tpu_torch.data, image/io.py)
against the JAX package's on the CPU, on a temporary tree of PNG and JPEG
files written with PIL from a seed: equal-seeded rngs give the same batches
bit for bit, the index cache one package writes the other reads, and the
prefetcher keeps the reference's discipline (tests/test_prefetch_stress.py's
cases)."""

import json
import os
import threading
import time

import numpy as np
import pytest
from PIL import Image

from dcgan_sr_tpu.data import PrefetchLoader as JPrefetch
from dcgan_sr_tpu.data import make_dataset as j_make_dataset
from dcgan_sr_tpu.data.folder import FolderDataset as JFolder
from dcgan_sr_tpu.data.indexed import IndexedCelebA as JIndexed
from dcgan_sr_tpu.data.synthetic import TexturedImages as JTextured
from dcgan_sr_tpu.image import io as JIO
from dcgan_sr_tpu_torch.data import (FolderDataset, IndexedCelebA,
                                     PrefetchLoader, SyntheticImages,
                                     TexturedImages, celeba_path,
                                     make_dataset)
from dcgan_sr_tpu_torch.image import io as TIO

import torch_threads  # noqa: F401


def _img(rng, h, w):
    """A smooth RGB image (JPEG keeps it close) as uint8 HWC."""
    base = rng.rand(max(h // 8, 2), max(w // 8, 2), 3)
    return np.asarray(Image.fromarray((base * 255).astype(np.uint8)).resize(
        (w, h), Image.BILINEAR))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """root/{faces,scenes}/ with PNG and JPEG files of several aspects."""
    root = tmp_path_factory.mktemp("tree") / "imgs"
    rng = np.random.RandomState(7)
    for cls, n in (("faces", 5), ("scenes", 3)):
        (root / cls).mkdir(parents=True)
        for i in range(n):
            h, w = ((120, 100), (90, 140), (80, 80))[i % 3]
            ext = "png" if i % 2 else "jpg"
            Image.fromarray(_img(rng, h, w)).save(str(root / cls / f"{i}.{ext}"))
    (root / "faces" / "notes.txt").write_text("not an image")
    return str(root)


@pytest.fixture
def both(tree, tmp_path):
    cache = str(tmp_path / "cache")
    return (FolderDataset(tree, 96, 64, 3, cache_dir=cache),
            JFolder(tree, 96, 64, 3, cache_dir=cache + "_j"))


def test_folder_index_matches_jax(both):
    ds, jds = both
    assert ds.classes == jds.classes == ["faces", "scenes"]
    assert ds.paths == jds.paths and ds.labels == jds.labels
    assert ds.size() == 8 and not any(p.endswith(".txt") for p in ds.paths)


def test_folder_cache_is_shared_both_ways(tree, tmp_path):
    cache = str(tmp_path / "cache")
    path = FolderDataset._cache_path(tree, cache)
    assert path == JFolder._cache_path(tree, cache)
    jds = JFolder(tree, 96, 64, 3, cache_dir=cache)       # JAX writes
    with open(path) as f:
        d = json.load(f)
    d["paths"] = d["paths"][:3]            # a planted cache proves the read
    d["labels"] = d["labels"][:3]
    with open(path, "w") as f:
        json.dump(d, f)
    assert FolderDataset(tree, 96, 64, 3, cache_dir=cache).paths == \
        jds.paths[:3]
    os.remove(path)
    ds = FolderDataset(tree, 96, 64, 3, cache_dir=cache)  # the port writes
    assert os.path.isfile(path)
    assert JFolder(tree, 96, 64, 3, cache_dir=cache).paths == ds.paths


@pytest.mark.parametrize("split", [100, 60, 34])
def test_folder_split_matches_jax(tree, tmp_path, split):
    kw = dict(cache_dir=str(tmp_path / "c"), split=split, seed=4)
    ds, jds = FolderDataset(tree, 96, 64, 3, **kw), JFolder(tree, 96, 64, 3,
                                                            **kw)
    assert ds.paths == jds.paths and ds.test_paths == jds.test_paths
    assert ds.size() + ds.test_size() == 8
    if split < 100:
        np.testing.assert_array_equal(ds.get_test(1, ds.test_size()),
                                      jds.get_test(1, jds.test_size()))


def test_train_hook_sample_and_get_bit_equal(both):
    ds, jds = both
    for normalize in (True, False):
        np.testing.assert_array_equal(
            ds.sample(6, np.random.RandomState(3), normalize=normalize),
            jds.sample(6, np.random.RandomState(3), normalize=normalize))
    np.testing.assert_array_equal(
        ds.train_hook(ds.paths[1], np.random.RandomState(9)),
        jds.train_hook(jds.paths[1], np.random.RandomState(9)))
    np.testing.assert_array_equal(ds.get(2, 5), jds.get(2, 5))


def test_sample_canvas_bit_equal(both):
    ds, jds = both
    got = ds.sample_canvas(7, np.random.RandomState(5))
    want = jds.sample_canvas(7, np.random.RandomState(5))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (7, 3, 96, 96)


@pytest.fixture(scope="module")
def celeba(tmp_path_factory):
    """000001.jpg .. 000012.jpg, CelebA-like aspect."""
    route = tmp_path_factory.mktemp("celeba")
    rng = np.random.RandomState(2)
    for n in range(1, 13):
        Image.fromarray(_img(rng, 109, 89)).save(str(route / f"{n:06d}.jpg"),
                                                 quality=90)
    return str(route)


@pytest.mark.parametrize("nc", [1, 3])
def test_indexed_load_batch_bit_equal(celeba, nc):
    assert celeba_path("/r", 7) == os.path.join("/r", "000007.jpg")
    assert celeba_path("/r", 202599).endswith("202599.jpg")
    src = IndexedCelebA(celeba, 32, nc=nc, n_threads=2)
    want = JIndexed(celeba, 32, nc=nc, n_threads=0).load_batch(2, 4)
    try:
        assert src.exists()
        got = src.load_batch(2, 4)            # files 000009 .. 000012
    finally:
        src.close()
    assert got.shape == (4, nc, 32, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not IndexedCelebA(celeba + "/missing", n_threads=0).exists()


def test_textured_images_bit_equal():
    src, jsrc = TexturedImages(64, nc=3, seed=1234), JTextured(64, nc=3,
                                                                seed=1234)
    np.testing.assert_array_equal(src.load_batch(3, 5), jsrc.load_batch(3, 5))
    first = src.load_one(17)
    assert src.load_one(17) is first              # the render cache
    np.testing.assert_array_equal(first, jsrc.load_one(17))
    small = TexturedImages(32, nc=1, seed=9, cache_images=1)
    small.load_one(1)
    small.load_one(2)
    assert list(small._cache) == [1]              # the cap holds


def _draw(rng):
    return np.array([rng.randint(0, 1 << 30)])


def test_prefetch_strict_matches_jax_and_reproduces():
    def run(cls):
        with cls(_draw, n_threads=2, manual_seed=11) as loader:
            return [int(loader.get_batch()[0]) for _ in range(20)]

    a, b = run(PrefetchLoader), run(PrefetchLoader)
    assert a == b == run(JPrefetch)
    s1, s2 = np.random.RandomState(12), np.random.RandomState(13)
    assert a == [int((s1 if i % 2 == 0 else s2).randint(0, 1 << 30))
                 for i in range(20)]
    sync = PrefetchLoader(_draw, n_threads=0, manual_seed=4)
    jsync = JPrefetch(_draw, n_threads=0, manual_seed=4)
    assert [int(sync.get_batch()[0]) for _ in range(3)] == \
        [int(jsync.get_batch()[0]) for _ in range(3)]


def test_prefetch_strict_bounded_in_flight_and_close_joins():
    counter = {"n": 0}
    lock = threading.Lock()

    def sample(rng):
        with lock:
            counter["n"] += 1
        time.sleep(0.002)
        return rng.rand(1)

    loader = PrefetchLoader(sample, n_threads=3, manual_seed=5)
    for _ in range(30):
        loader.get_batch()
    time.sleep(0.1)
    assert counter["n"] <= 30 + 3        # consumed + n prefetched, never more
    loader.close()
    assert loader._threads and all(not t.is_alive() for t in loader._threads)


@pytest.mark.parametrize("n_threads", [1, 8])
def test_prefetch_many_threads_and_a_slow_consumer(n_threads):
    with PrefetchLoader(lambda rng: rng.rand(4), n_threads=n_threads,
                        manual_seed=3) as loader:
        batches = [loader.get_batch() for _ in range(100)]
        for _ in range(5):
            time.sleep(0.01)
            loader.get_batch()
    assert len(batches) == 100 and all(b.shape == (4,) for b in batches)
    assert all(not t.is_alive() for t in loader._threads)


@pytest.mark.parametrize("n_threads", [0, 2])
def test_prefetch_hands_a_worker_error_to_the_consumer(n_threads):
    def sample(rng):
        raise OSError("unreadable image")

    with PrefetchLoader(sample, n_threads=n_threads,
                        manual_seed=0) as loader:
        with pytest.raises(OSError, match="unreadable"):
            loader.get_batch()


def test_make_dataset_dispatch(tree, tmp_path):
    ds = make_dataset("folder", root=tree, cache_dir=str(tmp_path / "c"))
    jds = j_make_dataset("folder", root=tree, cache_dir=str(tmp_path / "j"))
    assert isinstance(ds, FolderDataset) and ds.paths == jds.paths
    assert isinstance(make_dataset("imagenet", root=tree,
                                   cache_dir=str(tmp_path / "c")),
                      FolderDataset)
    src = make_dataset("indexed", root="/nowhere", n_threads=0)
    assert isinstance(src, IndexedCelebA) and src.nc == 3
    syn = make_dataset("synthetic", fine_size=16, nc=1, seed=3)
    assert isinstance(syn, SyntheticImages)
    np.testing.assert_array_equal(
        syn.load_batch(0, 2),
        j_make_dataset("synthetic", fine_size=16, nc=1, seed=3).load_batch(0,
                                                                           2))
    with pytest.raises(NotImplementedError, match="lsun"):
        make_dataset("lsun")
    with pytest.raises(ValueError, match="Unknown dataset"):
        make_dataset("mnist")


@pytest.mark.parametrize("ext", [".png", ".bmp"])
def test_save_image_display_and_size_round_trip(tmp_path, ext):
    rng = np.random.RandomState(5)
    for shape in ((3, 21, 33), (17, 19), (1, 8, 6)):
        img = rng.rand(*shape).astype(np.float32)
        p, jp = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
        TIO.save_image(p, img)
        JIO.save_image(jp, img, native=False)
        np.testing.assert_array_equal(TIO.load_image(p, 3, "byte"),
                                      JIO.load_image(jp, 3, "byte"))
        h, w = shape[-2], shape[-1]
        assert TIO.image_size(p) == JIO.image_size(jp) == (w, h)
    x = (rng.randn(9, 7) * 3).astype(np.float32)
    TIO.save_display(str(tmp_path / "d.png"), x)
    JIO.save_display(str(tmp_path / "e.png"), x)
    np.testing.assert_array_equal(
        TIO.load_image(str(tmp_path / "d.png"), 1, "byte"),
        TIO.load_image(str(tmp_path / "e.png"), 1, "byte"))
    TIO.save_display(str(tmp_path / "c.png"), np.full((8, 8), -1.0,
                                                      np.float32))
    assert int(TIO.load_image(str(tmp_path / "c.png"), 1, "byte").max()) == 0


def test_save_image_writes_the_format_its_extension_names(tmp_path):
    img = np.random.RandomState(6).rand(3, 12, 10).astype(np.float32)
    for ext, fmt in ((".png", "PNG"), (".bmp", "BMP"), (".jpg", "JPEG")):
        p = str(tmp_path / f"x{ext}")
        TIO.save_image(p, img)
        with Image.open(p) as f:
            assert f.format == fmt and f.size == (10, 12)
