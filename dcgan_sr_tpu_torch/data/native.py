"""ctypes bridge to the committed native decoder (port of
dcgan_sr_tpu/data/native.py; the library is native/libdcgansr.so, built from
native/dataio.cpp).

N C++ threads decode libjpeg/libpng straight into a preallocated batch
buffer: the reference's donkey pool + `image` C library without the Lua
layer.  This bridge only loads the library that is in the repository; it
never builds it (that would rewrite a tracked file).  When the library does
not load (not there, or its libjpeg/libpng missing on this machine),
`available()` is False and callers use the Python loaders, as the JAX CLI
does.  This is host-side decode: nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libdcgansr.so")

_lib = None
_lib_error = None
_lib_lock = threading.Lock()


def _load():
    """The loaded library, or None (the reason in `load_error()`)."""
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError as e:        # missing file or missing libjpeg/libpng
            _lib_error = str(e)
            return None
        p, i, ll = ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong
        fp = ctypes.POINTER(ctypes.c_float)
        lib.dsr_load_image.restype = i
        lib.dsr_load_image.argtypes = [p, i, i, i, fp]
        lib.dsr_loader_create.restype = ctypes.c_void_p
        lib.dsr_loader_create.argtypes = [p, i, i, i, i]
        lib.dsr_loader_load_batch.restype = i
        lib.dsr_loader_load_batch.argtypes = [ctypes.c_void_p, ll, fp]
        lib.dsr_loader_destroy.restype = None
        lib.dsr_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.dsr_index_dir.restype = ll
        lib.dsr_index_dir.argtypes = [p, p, ll]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def load_error():
    """Why the library did not load (None if it did, or was not tried)."""
    return _lib_error


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library did not load from {LIB_PATH}: "
                           f"{_lib_error}")
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_image(path, nc=1, out_h=64, out_w=64):
    """Decode+resize one image natively -> (nc, out_h, out_w) float32 [0,1]."""
    lib = _require()
    out = np.empty((nc, out_h, out_w), np.float32)
    if lib.dsr_load_image(path.encode(), nc, out_h, out_w, _fptr(out)) != 0:
        raise IOError(f"native decode failed for {path}")
    return out


def index_dir(root):
    """Recursive native directory walk -> sorted list of the image paths it
    can decode (.jpg/.jpeg/.png).

    The C walk returns the bytes it needs and copies only into a buffer that
    holds them all, so the buffer is sized by a first call and the SECOND
    call's return value says what was written: if the directory grew in
    between (nothing copied) the walk is asked again with the new size."""
    lib = _require()
    need = lib.dsr_index_dir(root.encode(), None, 0)
    while need > 0:
        buf = ctypes.create_string_buffer(int(need))
        got = lib.dsr_index_dir(root.encode(), buf, need)
        if got <= need:
            # the C walk sorts per directory but pops its stack LIFO: sort
            # here for the documented deterministic index -> file mapping
            return sorted(buf.raw[:got].decode().splitlines())
        need = got
    return []


class NativeIndexedLoader:
    """Native-threaded sequential indexed loader (IndexedCelebA-compatible:
    files file_set * batch + [1..batch] of `route`)."""

    def __init__(self, route, fine_size=64, nc=1, n_threads=8):
        self._lib = _require()
        self.route = route
        self.fine_size = fine_size
        self.nc = nc
        self._handles = {}
        self._n_threads = n_threads

    def _handle(self, batch_size):
        h = self._handles.get(batch_size)
        if h is None:
            h = self._lib.dsr_loader_create(
                self.route.encode(), self.nc, self.fine_size, batch_size,
                self._n_threads)
            if not h:  # NULL c_void_p: fail loudly, not with a C segfault
                raise RuntimeError(
                    f"dsr_loader_create failed (route={self.route!r}, "
                    f"nc={self.nc}, batch={batch_size})")
            self._handles[batch_size] = h
        return h

    def exists(self):
        from .indexed import celeba_path
        return os.path.isfile(celeba_path(self.route, 1))

    def load_one(self, file_num):
        from .indexed import celeba_path
        return load_image(celeba_path(self.route, file_num), self.nc,
                          self.fine_size, self.fine_size)

    def load_batch(self, file_set_num, batch_size):
        out = np.empty((batch_size, self.nc, self.fine_size, self.fine_size),
                       np.float32)
        ok = self._lib.dsr_loader_load_batch(
            self._handle(batch_size), file_set_num, _fptr(out))
        if ok < batch_size:
            raise IOError(f"{batch_size - ok} images failed to decode in "
                          f"file_set {file_set_num}")
        return out

    def close(self):
        for h in self._handles.values():
            self._lib.dsr_loader_destroy(h)
        self._handles.clear()
