"""The training step's device-side preprocess, fused: rgb->gray, [0,1]->[-1,1]
and the 2x2 box degrade in one pass over the batch.

Port of dcgan_sr_tpu/ops/pallas_kernels.py pallas_preprocess.  From a batch
x (B, C, H, W) in [0, 1] it returns hr (B, C', H, W), the discriminator's
input, and lr (B, C', H/2, W/2), the generator's input; C' = 1 with
`rgb_to_gray`, else C.

`preprocess()` is the entry.  On a CPU tensor it runs `preprocess_plain()`,
the plain PyTorch composition; on a CUDA tensor it launches the hand-written
kernel (csrc/preprocess.cu, built at first use by ops/_build.py) and nothing
else: no fallback.  Both sum the 2x2 window rows first, then columns,
((a + c) + (b + d)) * 0.25 for [[a, b], [c, d]], which is the rounding of
the TPU kernel's P_h @ x @ P_w^T with 0.5-weight pair matrices; the kernel
keeps its products and sums uncontracted (no FMA), so the two agree to the
last bit.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..image.ops import normalize_pm1, rgb2gray
from ._build import compile_and_load, stream_ptr

# Launches of the kernel in this process: the wrapper adds one where it
# launches, and nowhere else (CPU calls run the plain version).
launches = {"preprocess": 0}

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def build():
    """Compile csrc/preprocess.cu (once per source content) and load it."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_and_load("preprocess")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.preprocess_f32.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.preprocess_f32.restype = i
        _lib = lib
        return lib


def preprocess_plain(x, *, rgb_to_gray=False, to_pm1=False):
    """The same function in plain PyTorch ops; `hr` is `x` itself when both
    flags are off."""
    if rgb_to_gray:
        x = rgb2gray(x)[:, None]
    if to_pm1:
        x = normalize_pm1(x)
    b, c, h, w = x.shape
    win = x.reshape(b, c, h // 2, 2, w // 2, 2)
    rows = win[:, :, :, 0] + win[:, :, :, 1]          # (b, c, h/2, w/2, 2)
    return x, (rows[..., 0] + rows[..., 1]) * 0.25


def _check(x, rgb_to_gray):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"preprocess takes float32, got {x.dtype}")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"H and W must be even for the 2x2 degrade, got "
                         f"{tuple(x.shape)}")
    if rgb_to_gray and x.shape[1] != 3:
        raise ValueError(f"rgb_to_gray needs 3 channels, got {x.shape[1]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"preprocess runs on cpu or cuda, not {x.device.type}")


def preprocess(x, *, rgb_to_gray=False, to_pm1=False):
    """(hr, lr) of a batch x (B, C, H, W), contiguous or not, float32 in
    [0, 1]; see the module docstring."""
    _check(x, rgb_to_gray)
    if x.device.type == "cpu":
        return preprocess_plain(x, rgb_to_gray=rgb_to_gray, to_pm1=to_pm1)
    lib = _lib or build()
    b, c, h, w = x.shape
    c_out = 1 if rgb_to_gray else c
    if b * c_out * (h // 2) * (w // 2) >= 2 ** 31 * 256:
        raise ValueError(f"batch {tuple(x.shape)} is too large for one launch")
    x = x.detach().contiguous()
    if x.data_ptr() % 8:
        x = x.clone()           # the kernel reads pixel pairs as 8-byte words
    hr = torch.empty((b, c_out, h, w), device=x.device, dtype=torch.float32)
    lr = torch.empty((b, c_out, h // 2, w // 2), device=x.device,
                     dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.preprocess_f32(x.data_ptr(), hr.data_ptr(), lr.data_ptr(),
                                 b, c, h, w, int(rgb_to_gray), int(to_pm1),
                                 stream_ptr(x))
    if err:
        raise RuntimeError(f"preprocess launch failed: cudaError {err}")
    launches["preprocess"] += 1
    return hr, lr
