"""Deterministic synthetic image sources (port of dcgan_sr_tpu/data/synthetic.py:
SyntheticImages and TexturedImages; pure numpy, bit-equal to the JAX
package's, TexturedImages' render cache included).

CelebA is not shipped with this repo; tests, smoke runs and benchmarks use a
procedural stand-in: smooth low-frequency fields with a few blob highlights —
enough spatial structure that 2x SR is a meaningful task.  Fully
deterministic per (seed, index), so sequential 'file order' reads reproduce
exactly like the reference's indexed loader.
"""

from __future__ import annotations

import numpy as np

from .folder import _resize_chw


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


class TexturedImages:
    """Texture-rich procedural image source for quality-parity protocols.

    The smooth SyntheticImages set is a degenerate SR task: bilinear
    interpolation is near-optimal there, so a generator can never beat the
    control (VERDICT.md round-1 'what's weak' #1).  This set is built so the
    HR detail IS recoverable from the LR observation, the regime real SR
    lives in:

      - piecewise-constant shapes (discs, rotated half-planes) with
        anti-aliased edges: the 2x2 box degrade encodes each edge's sub-pixel
        position in the boundary pixel values, so a learned model can
        re-sharpen what bilinear must blur;
      - oriented sinusoidal gratings at 2-7 cycles / 64 px — below the LR
        Nyquist (16 c/img), so fully represented in LR, but bilinear
        attenuates their amplitude while a learned kernel can restore it;
      - a smooth background gradient for low-frequency context.

    Generated at 4x supersampling (analytic coverage) then box-reduced, so HR
    edges are properly antialiased rather than aliased.  Deterministic per
    (seed, index) with an in-memory cache (protocol epochs re-read the same
    index ranges, like the reference's sequential CelebA reads).
    """

    def __init__(self, fine_size=64, nc=1, seed=1234, cache_images=32768):
        # cache must cover the training index range (ntrain=10000 for the
        # gray-3 protocol) or the tail re-renders every epoch (~15 ms/img)
        self.fine_size = fine_size
        self.nc = nc
        self.seed = seed
        self._cache = {}
        self._cache_cap = cache_images

    def exists(self):
        return True

    def _render(self, index):
        rng = np.random.RandomState(
            (self.seed * 2_000_003 + index) % (2**31 - 1))
        fs = self.fine_size
        ss = 4 * fs  # 4x supersampled canvas
        yy, xx = np.mgrid[0:ss, 0:ss].astype(np.float32) / (4.0)
        # smooth background: bilinear corners
        c = rng.rand(2, 2).astype(np.float32)
        u, v = yy / fs, xx / fs
        img = ((1 - u) * (1 - v) * c[0, 0] + (1 - u) * v * c[0, 1]
               + u * (1 - v) * c[1, 0] + u * v * c[1, 1])
        # piecewise-constant shapes: discs and rotated half-plane strips
        for _ in range(rng.randint(4, 8)):
            g = 0.05 + 0.9 * rng.rand()
            if rng.rand() < 0.6:
                cy, cx = rng.rand(2) * fs
                r = 3.0 + rng.rand() * 18.0
                mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
            else:
                th = rng.rand() * np.pi
                d = (yy - rng.rand() * fs) * np.cos(th) \
                    + (xx - rng.rand() * fs) * np.sin(th)
                w = 2.0 + rng.rand() * 10.0
                mask = np.abs(d) < w
            img = np.where(mask, g, img)
        # oriented gratings, LR-representable frequencies (2-7 cycles/img)
        for _ in range(rng.randint(1, 3)):
            th = rng.rand() * np.pi
            freq = (2.0 + 5.0 * rng.rand()) / fs  # cycles per pixel
            phase = rng.rand() * 2 * np.pi
            amp = 0.1 + 0.15 * rng.rand()
            wave = np.sin(2 * np.pi * freq
                          * (yy * np.cos(th) + xx * np.sin(th)) + phase)
            if rng.rand() < 0.5:  # masked to a disc region half the time
                cy, cx = rng.rand(2) * fs
                r = 8.0 + rng.rand() * 20.0
                region = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
                img = img + np.where(region, amp * wave, 0.0)
            else:
                img = img + amp * wave
        # 4x box reduce -> antialiased HR image in [0,1]
        img = img.reshape(fs, 4, fs, 4).mean(axis=(1, 3))
        img = np.clip(img, 0.0, 1.0).astype(np.float32)
        return np.repeat(img[None], self.nc, axis=0)

    def load_one(self, index):
        out = self._cache.get(index)
        if out is None:
            out = self._render(index)
            if len(self._cache) < self._cache_cap:
                self._cache[index] = out
        return out

    def load_batch(self, file_set_num, batch_size):
        nums = [file_set_num * batch_size + i for i in range(1, batch_size + 1)]
        return np.stack([self.load_one(n) for n in nums])
