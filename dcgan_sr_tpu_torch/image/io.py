"""Host-side image decode/encode with torch-`image` conventions (port of
dcgan_sr_tpu/image/io.py).

Decode: image.load(path, nc, 'float') -> CHW float32 in [0,1]; nc=1 on an
RGB source converts via rgb2y (Rec.601 luma .299/.587/.114) — DIFFERENT from
the training-time rgb2gray (.21/.72/.07) the gray variant applies itself.
Encode: [0,1] floats to round-to-nearest bytes.  The reference always saves
samples through image.toDisplayTensor (save_display), which min-max rescales
to [0,1] (constant images -> 0, i.e. black).
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from .ops import to_display


def load_image(path, nc=3, dtype="float"):
    """Decode to CHW; float32 [0,1] or uint8 per `dtype` ('float'|'byte')."""
    img = Image.open(path).convert("RGB")
    chw = (np.asarray(img, dtype=np.float32) / 255.0).transpose(2, 0, 1)
    if nc == 1:
        chw = (0.299 * chw[0] + 0.587 * chw[1] + 0.114 * chw[2])[None]
    elif nc != 3:
        raise ValueError(f"nc must be 1 or 3, got {nc}")
    if dtype == "byte":
        return np.clip(np.round(chw * 255.0), 0, 255).astype(np.uint8)
    return chw.astype(np.float32)


def save_image(path, arr):
    """Save [0,1] float HW / CHW / HWC to disk (round-to-nearest bytes)."""
    a = np.asarray(arr, np.float32)
    if a.ndim == 3 and a.shape[0] in (1, 3):  # CHW -> HWC
        a = a.transpose(1, 2, 0)
        if a.shape[-1] == 1:
            a = a[..., 0]
    byte = np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8)
    Image.fromarray(byte).save(path)


def save_display(path, arr):
    """image.save(image.toDisplayTensor(x)) parity: min-max rescale then save."""
    save_image(path, to_display(np.asarray(arr, np.float32)).numpy())


def image_size(path):
    """(W, H) of an image file, read from its header."""
    with Image.open(path) as img:
        return img.size
