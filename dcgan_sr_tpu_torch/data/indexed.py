"""Direct indexed CelebA reader — the data path of train-gray-2/-3/-patch*
(port of dcgan_sr_tpu/data/indexed.py).

The reference builds zero-padded six-digit paths by hand
(train-gray-3.lua:242-254) and loads each file with image.load(path, 1,
'float') + image.scale to fineSize, in strictly sequential file order
(file_num = file_set_num * batchSize + i).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..image.io import load_image
from .folder import _resize_chw

DEFAULT_ROUTE = "/CelebA/Img/img_align_celeba/Img/"


def celeba_path(route, file_num):
    """Zero-padded '%06d.jpg' (the if-ladder at train-gray-3.lua:242-254)."""
    return os.path.join(route, f"{file_num:06d}.jpg")


class IndexedCelebA:
    def __init__(self, route=DEFAULT_ROUTE, fine_size=64, nc=1, n_threads=4):
        self.route = route
        self.fine_size = fine_size
        self.nc = nc
        self._pool = ThreadPoolExecutor(n_threads) if n_threads > 0 else None

    def exists(self):
        return os.path.isfile(celeba_path(self.route, 1))

    def load_one(self, file_num):
        img = load_image(celeba_path(self.route, file_num), nc=self.nc)
        return _resize_chw(img, self.fine_size, self.fine_size).astype(np.float32)

    def load_batch(self, file_set_num, batch_size):
        """Files file_set_num*batch_size + [1..batch_size] -> (B, nc, H, W)."""
        nums = [file_set_num * batch_size + i for i in range(1, batch_size + 1)]
        if self._pool is not None:
            imgs = list(self._pool.map(self.load_one, nums))
        else:
            imgs = [self.load_one(n) for n in nums]
        return np.stack(imgs)

    def close(self):
        """Stop the decode threads (waits for a batch in progress)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
