"""Deterministic synthetic image source (port of dcgan_sr_tpu/data/synthetic.py
SyntheticImages; pure numpy, bit-equal to the JAX package's).

CelebA is not shipped with this repo; tests, smoke runs and benchmarks use a
procedural stand-in: smooth low-frequency fields with a few blob highlights —
enough spatial structure that 2x SR is a meaningful task.  Fully
deterministic per (seed, index), so sequential 'file order' reads reproduce
exactly like the reference's indexed loader.
"""

from __future__ import annotations

import numpy as np

from ..image.ops import _bilinear_matrix


def _resize_chw(chw, out_h, out_w):
    """Host-side bilinear resize using the same endpoint-aligned matrices as
    the device op (image/ops.py) — one resize algorithm everywhere."""
    a = _bilinear_matrix(chw.shape[-2], out_h)
    b = _bilinear_matrix(chw.shape[-1], out_w)
    return np.einsum("oh,chw,pw->cop", a, chw, b, optimize=True)


class SyntheticImages:
    def __init__(self, fine_size=64, nc=1, seed=1234):
        self.fine_size = fine_size
        self.nc = nc
        self.seed = seed

    def exists(self):
        return True

    def load_one(self, index):
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % (2**31 - 1))
        fs = self.fine_size
        # low-frequency base: random 9x9 field, bilinear-upscaled
        base = rng.rand(self.nc, 9, 9).astype(np.float32)
        img = _resize_chw(base, fs, fs)
        # a couple of gaussian blobs for mid-frequency content
        yy, xx = np.mgrid[0:fs, 0:fs].astype(np.float32)
        for _ in range(3):
            cy, cx = rng.rand(2) * fs
            s = 2.0 + rng.rand() * 6.0
            amp = (rng.rand() - 0.5) * 0.8
            img += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        img -= img.min()
        m = img.max()
        if m > 0:
            img /= m
        return img.astype(np.float32)

    def load_batch(self, file_set_num, batch_size):
        nums = [file_set_num * batch_size + i for i in range(1, batch_size + 1)]
        return np.stack([self.load_one(n) for n in nums])
