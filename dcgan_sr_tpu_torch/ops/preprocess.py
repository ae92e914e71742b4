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

The kernel's device work at the trainer's shapes is about two microseconds,
so the CUDA path is written for the host: the preconditions are checked
inline on Python ints, the stream is read as a plain int, the switch to the
tensor's device (when it is not the current one) happens inside the C entry
instead of a Python device guard, and nothing synchronises, so a call may be
captured into a CUDA graph (torch.cuda.graph) and replayed.  hr and lr are
two `new_empty` calls: carving both out of one buffer was measured at 12.8 us
of host time on the H100's host (empty + split + two views; 7.7 us at best,
with as_strided) against 5.0 us for the two allocations.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..image.ops import normalize_pm1, rgb2gray
from ._build import compile_and_load, raw_stream

# Launches of the kernel in this process: the wrapper adds one where it
# launches, and nowhere else (CPU calls run the plain version).  A call
# captured into a CUDA graph counts once, when it is captured: replays of the
# graph do not pass through the wrapper.
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
        lib.preprocess_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
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


def preprocess(x, *, rgb_to_gray=False, to_pm1=False):
    """(hr, lr) of a batch x (B, C, H, W), contiguous or not, float32 in
    [0, 1]; see the module docstring."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype is not torch.float32:
        raise ValueError(f"preprocess takes float32, got {x.dtype}")
    b, c, h, w = x.shape
    if (h | w) & 1:
        raise ValueError(f"H and W must be even for the 2x2 degrade, got "
                         f"{tuple(x.shape)}")
    if rgb_to_gray and c != 3:
        raise ValueError(f"rgb_to_gray needs 3 channels, got {c}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return preprocess_plain(x, rgb_to_gray=rgb_to_gray, to_pm1=to_pm1)
        raise ValueError(f"preprocess runs on cpu or cuda, not "
                         f"{x.device.type}")
    lib = _lib or build()
    c_out = 1 if rgb_to_gray else c
    if b * c_out * h * w >= 2 ** 33 * 256:
        raise ValueError(f"batch {tuple(x.shape)} is too large for one launch")
    if x.requires_grad:
        x = x.detach()
    if not x.is_contiguous():
        x = x.contiguous()
    src = x.data_ptr()
    if src & 7:                 # the kernel reads pixel pairs as 8-byte words
        x = x.clone()
        src = x.data_ptr()
    hr = x.new_empty((b, c_out, h, w))
    lr = x.new_empty((b, c_out, h >> 1, w >> 1))
    index = x.get_device()
    err = lib.preprocess_f32(src, hr.data_ptr(), lr.data_ptr(), b, c, h, w,
                             rgb_to_gray, to_pm1, index, raw_stream(index))
    if err:
        raise RuntimeError(f"preprocess launch failed: cudaError {err}")
    launches["preprocess"] += 1
    return hr, lr
