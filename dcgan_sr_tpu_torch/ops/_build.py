"""Build a CUDA source of csrc/ into a shared library and load it with ctypes.

Every kernel of the port is one `.cu` file with a plain C interface.  Its
wrapper calls `compile_and_load("<stem>")` at first use: nvcc compiles
csrc/<stem>.cu for sm_90a into _build/ beside the package (a directory git
ignores), and ctypes loads the result.  The wrapper declares the argtypes.

The library's name carries a hash of the source and the flags, so an edited
kernel rebuilds; two threads or processes building the same source at once
are safe because the finished file is moved into place atomically.  No
library is cached here: each wrapper keeps its own loaded library, so
distinct sources build in parallel from distinct threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels "
                       "are built from csrc/ at first use")


def compile_and_load(stem):
    """(ctypes.CDLL of csrc/<stem>.cu, nvcc's output: the `-Xptxas -v`
    resource lines, or "" when a finished build was reused)."""
    src_path = os.path.join(CSRC, stem + ".cu")
    with open(src_path, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")
    log = ""
    if not os.path.exists(so):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            r = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
                               capture_output=True, text=True)
            log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src_path}:\n{log}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(so), log


_sm_count = {}


def sm_count(device):
    """Streaming multiprocessors of the card `device`, read once per device
    (the persistent kernels launch that many times the blocks that fit)."""
    n = _sm_count.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device.index] = n
    return n


def _raw_stream_public(index):
    return torch.cuda.current_stream(index).cuda_stream


# The handle of PyTorch's current CUDA stream on device `index`, a plain int
# (what a ctypes argument declared c_void_p takes); read without building a
# torch.cuda.Stream where this PyTorch can.
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _raw_stream_public)
