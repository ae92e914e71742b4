"""Folder dataset: the reference's dataset.lua + donkey_folder.lua, natively
(port of dcgan_sr_tpu/data/folder.py; numpy + PIL on the host, bit-equal to
the JAX package's with equal-seeded rngs).

Replaces the LuaJIT-FFI path arena + GNU `find` shell-out indexer
(dataset.lua:135-217) with an os.scandir walk writing a cached flat index
(parity with `cache/<sanitized-path>_trainCache.t7`, donkey_folder.lua:24-27),
and the per-thread `trainHook` (donkey_folder.lua:52-70): aspect-preserving
resize so the short side equals loadSize, random crop to fineSize, hflip with
p=0.5, then [0,1] -> [-1,1].  The index cache keeps the JAX package's file
name and JSON format, so either package reads the other's cache.

Sampling is the reference's balanced scheme (dataset.lua:313-347): uniform
class, then uniform image within the class.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from ..image.io import load_image
from ..image.ops import _bilinear_matrix

_EXTS = {".jpg", ".jpeg", ".png", ".ppm", ".bmp"}


def crop_start(rng, dim, fs):
    """Random crop start offset (donkey_folder.lua:57-62): the reference draws
    h1 = math.ceil(torch.uniform(1e-2, dim-fs)) in {1..dim-fs} and passes it
    to image.crop, whose offsets are 0-BASED (dst(y,x) = src(y+y1, x+x1) in
    the image C lib) — so offset 0 is never sampled and dim-fs is the max."""
    return int(np.ceil(rng.uniform(1e-2, dim - fs))) if dim > fs else 0


def _resize_chw(chw, out_h, out_w):
    """Host-side bilinear resize using the same endpoint-aligned matrices as
    the device op (image/ops.py) — one resize algorithm everywhere."""
    a = _bilinear_matrix(chw.shape[-2], out_h)
    b = _bilinear_matrix(chw.shape[-1], out_w)
    return np.einsum("oh,chw,pw->cop", a, chw, b, optimize=True)


class FolderDataset:
    """'flat folder = class' dataset with cached index and balanced sampling."""

    def __init__(self, root, load_size=96, fine_size=64, nc=3,
                 cache_dir="cache", verbose=False, split=100, seed=0):
        """`split` = % of images in the train partition (dataset.lua:251-297:
        a deterministic random permutation divides each class split/100-
        (100-split)/100; split=100 keeps everything in train)."""
        if not os.path.isdir(root):
            raise FileNotFoundError(f"Did not find directory: {root}")
        self.root = root
        self.load_size = load_size
        self.fine_size = fine_size
        self.nc = nc
        self.classes, paths, labels = self._index(root, cache_dir, verbose)
        if not paths:
            raise RuntimeError(f"no images found under {root}")
        if split >= 100:
            self.paths, self.labels = paths, labels
            self.test_paths, self.test_labels = [], []
        else:
            rng = np.random.RandomState(seed)
            self.paths, self.labels = [], []
            self.test_paths, self.test_labels = [], []
            by_class = {}
            for p, l in zip(paths, labels):
                by_class.setdefault(l, []).append(p)
            for l in sorted(by_class):
                cls_paths = by_class[l]
                perm = rng.permutation(len(cls_paths))
                n_train = int(np.floor(len(cls_paths) * split / 100.0))
                for j, idx in enumerate(perm):
                    if j < n_train:
                        self.paths.append(cls_paths[idx])
                        self.labels.append(l)
                    else:
                        self.test_paths.append(cls_paths[idx])
                        self.test_labels.append(l)
        # Precomputed class -> paths map for the balanced sampler. The
        # reference builds its per-class index tensors once at construction
        # (dataset.lua:219-249); rebuilding per sample() call would be
        # O(dataset) Python work on every batch in every loader thread.
        self._by_class = {}
        for p, l in zip(self.paths, self.labels):
            self._by_class.setdefault(l, []).append(p)
        self._class_ids = sorted(self._by_class)

    # ---- indexing with cache (dataset.lua class discovery + path packing) --
    @staticmethod
    def _cache_path(root, cache_dir):
        key = root.replace("/", "_")
        digest = hashlib.sha1(root.encode()).hexdigest()[:8]
        return os.path.join(cache_dir, f"{key}_{digest}_trainCache.json")

    def _index(self, root, cache_dir, verbose):
        cache_file = self._cache_path(root, cache_dir)
        if os.path.isfile(cache_file):
            if verbose:
                print("Loading train metadata from cache")
            with open(cache_file) as f:
                d = json.load(f)
            return d["classes"], d["paths"], d["labels"]
        if verbose:
            print("Creating train metadata")
        subdirs = sorted(e.name for e in os.scandir(root) if e.is_dir())
        classes = subdirs if subdirs else ["."]
        paths, labels = [], []
        for ci, cls in enumerate(classes):
            base = os.path.join(root, cls) if cls != "." else root
            for dirpath, _, files in os.walk(base):
                for fn in sorted(files):
                    if os.path.splitext(fn)[1].lower() in _EXTS:
                        paths.append(os.path.join(dirpath, fn))
                        labels.append(ci)
        os.makedirs(cache_dir, exist_ok=True)
        with open(cache_file, "w") as f:
            json.dump({"classes": classes, "paths": paths, "labels": labels}, f)
        if verbose:
            print("saved metadata cache at", cache_file)
        return classes, paths, labels

    def size(self):
        return len(self.paths)

    # ---- trainHook (donkey_folder.lua:33-70) -------------------------------
    def _load_resized(self, path):
        img = load_image(path, nc=3)
        h, w = img.shape[-2], img.shape[-1]
        ls = self.load_size
        if w < h:
            out_w, out_h = ls, max(int(round(ls * h / w)), ls)
        else:
            out_w, out_h = max(int(round(ls * w / h)), ls), ls
        return _resize_chw(img, out_h, out_w)

    def train_hook(self, path, rng, normalize=True):
        """Decode + aspect resize + random crop + hflip (+ [0,1]->[-1,1]).

        normalize=False leaves raw [0,1] RGB for the device-side preprocess
        path (cfg.device_preprocess: convert/normalize happen on-chip).
        The gray variant converts AFTER the hook with .21/.72/.07 weights
        (train-gray.lua:220-222), so 3 channels are always returned here.
        """
        img = self._load_resized(path)
        h, w = img.shape[-2], img.shape[-1]
        fs = self.fine_size
        h1 = crop_start(rng, h, fs)
        w1 = crop_start(rng, w, fs)
        out = img[:, h1:h1 + fs, w1:w1 + fs]
        if rng.rand() > 0.5:
            out = out[:, :, ::-1]
        if normalize:
            out = out * 2.0 - 1.0  # [0,1] -> [-1,1]
        return np.ascontiguousarray(out, np.float32)

    # ---- balanced sampler (dataset.lua:313-347) ----------------------------
    def sample(self, batch_size, rng=None, normalize=True):
        rng = rng or np.random.RandomState()
        by_class, class_ids = self._by_class, self._class_ids
        out = np.empty((batch_size, 3, self.fine_size, self.fine_size), np.float32)
        for i in range(batch_size):
            cls = class_ids[rng.randint(len(class_ids))]
            path = by_class[cls][rng.randint(len(by_class[cls]))]
            out[i] = self.train_hook(path, rng, normalize=normalize)
        return out

    def sample_canvas(self, batch_size, rng=None):
        """Batch for device-side augmentation (cfg.device_augment): raw [0,1]
        (B, 3, loadSize, loadSize) canvases plus HOST-drawn crop offsets and
        flip coins — `(canvas, tops, lefts, flips)`.

        The crop offsets come from the trainHook's SINGLE uniform draw over
        the full aspect-resized image (donkey_folder.lua:57-62, same
        crop_start and same per-image rng order as train_hook), then split
        into a host pre-crop to the static loadSize canvas plus an in-canvas
        residual in {0..loadSize-fineSize} for the device. Composing two
        independent uniform draws instead (host long-dim crop x device crop)
        would yield a triangular total-offset distribution that never samples
        offset 1 — not the reference's. With equal-seeded rngs the composed
        device crop (image/ops.py crop_hflip_at) reproduces sample(normalize=
        False) BIT-EXACTLY (tested)."""
        rng = rng or np.random.RandomState()
        by_class, class_ids = self._by_class, self._class_ids
        ls, fs = self.load_size, self.fine_size
        out = np.empty((batch_size, 3, ls, ls), np.float32)
        tops = np.empty(batch_size, np.int32)
        lefts = np.empty(batch_size, np.int32)
        flips = np.empty(batch_size, bool)
        for i in range(batch_size):
            cls = class_ids[rng.randint(len(class_ids))]
            path = by_class[cls][rng.randint(len(by_class[cls]))]
            img = self._load_resized(path)
            h, w = img.shape[-2], img.shape[-1]
            # the reference's one-draw total offsets over the FULL image,
            # in train_hook's exact rng order (h1, w1, flip)
            t_h = crop_start(rng, h, fs)
            t_w = crop_start(rng, w, fs)
            flips[i] = rng.rand() > 0.5
            # host pre-crop keeping the chosen window inside the canvas:
            # residual r = t - c lands in {0..ls-fs} by construction
            # (when ls == fs the residual range is {0} — the host crop must
            # absorb the whole offset, hence the min(1, ls-fs) back-off;
            # dynamic_slice would silently CLAMP an out-of-range residual)
            back = min(1, ls - fs)
            ch = min(max(t_h - back, 0), h - ls)
            cw = min(max(t_w - back, 0), w - ls)
            out[i] = img[:, ch:ch + ls, cw:cw + ls]
            tops[i] = t_h - ch
            lefts[i] = t_w - cw
            if not (0 <= tops[i] <= ls - fs and 0 <= lefts[i] <= ls - fs):
                raise ValueError(
                    f"crop residual out of the canvas: {(t_h, t_w, ch, cw)} "
                    f"for an image {h}x{w}, loadSize {ls}, fineSize {fs}")
        return out, tops, lefts, flips

    def get(self, i1, i2, rng=None):
        """Sequential slice (dataset.lua:349-365), 1-based inclusive like Lua."""
        rng = rng or np.random.RandomState(0)
        idx = range(i1 - 1, i2)
        out = np.empty((len(idx), 3, self.fine_size, self.fine_size), np.float32)
        for j, i in enumerate(idx):
            out[j] = self.train_hook(self.paths[i], rng)
        return out

    def test_hook(self, path):
        """Deterministic test-partition hook: aspect resize + center crop +
        [-1,1] normalize (no augmentation)."""
        img = self._load_resized(path)
        h, w = img.shape[-2], img.shape[-1]
        fs = self.fine_size
        h1, w1 = max((h - fs) // 2, 0), max((w - fs) // 2, 0)
        out = img[:, h1:h1 + fs, w1:w1 + fs]
        return np.ascontiguousarray(out * 2.0 - 1.0, np.float32)

    def get_test(self, i1, i2):
        """Sequential test-partition slice (requires split < 100)."""
        idx = range(i1 - 1, i2)
        out = np.empty((len(idx), 3, self.fine_size, self.fine_size), np.float32)
        for j, i in enumerate(idx):
            out[j] = self.test_hook(self.test_paths[i])
        return out

    def test_size(self):
        return len(self.test_paths)
