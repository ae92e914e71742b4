"""Torch7 `.t7` serialization: reader and writer (port of
dcgan_sr_tpu/compat/t7.py, a copy: the module is numpy-only, and the port
keeps its own).

The reference saves and loads checkpoints with torch.save / torch.load
(train.lua:297-299).  Reading a reference-trained net_G.t7 lets the port
serve actual Torch weights (compat/torch_import.py); the writer exports the
port's weights to Torch users (compat/torch_export.py) and writes the same
bytes as the JAX package's for the same trees.

Binary format (little-endian), per torch7 File:writeObject:
  object  := int32 type_tag, payload
  tags    :  0 nil | 1 number | 2 string | 3 table | 4 torch class |
             5 boolean | 6/7/8 function variants (unsupported here)
  number  := float64
  string  := int32 len, bytes
  boolean := int32
  table   := int32 heap_index, int32 count, count * (key obj, value obj)
  torch   := int32 heap_index, string version ("V <n>") or classname,
             [string classname if versioned], class payload
  Tensor payload  := int32 ndim, int64[ndim] sizes, int64[ndim] strides,
                     int64 storage_offset (1-based), object storage (or nil)
  Storage payload := int64 size, raw elements
Heap indices dedupe shared objects: a repeated index is a back-reference.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np

_TNIL, _TNUM, _TSTR, _TTABLE, _TTORCH, _TBOOL = 0, 1, 2, 3, 4, 5
_TFUNC, _TLEGACY_RECUR_FUNC, _TRECUR_FUNC = 6, 7, 8

_STORAGE_DTYPES = {
    "torch.FloatStorage": np.float32,
    "torch.DoubleStorage": np.float64,
    "torch.LongStorage": np.int64,
    "torch.IntStorage": np.int32,
    "torch.ShortStorage": np.int16,
    "torch.CharStorage": np.int8,
    "torch.ByteStorage": np.uint8,
    "torch.CudaStorage": np.float32,
}
_TENSOR_TO_STORAGE = {
    "torch.FloatTensor": "torch.FloatStorage",
    "torch.DoubleTensor": "torch.DoubleStorage",
    "torch.LongTensor": "torch.LongStorage",
    "torch.IntTensor": "torch.IntStorage",
    "torch.ShortTensor": "torch.ShortStorage",
    "torch.CharTensor": "torch.CharStorage",
    "torch.ByteTensor": "torch.ByteStorage",
    "torch.CudaTensor": "torch.FloatStorage",
}


@dataclass
class T7Object:
    """A deserialized torch class instance that is not a tensor/storage."""
    torch_type: str
    attrs: Dict[Any, Any] = field(default_factory=dict)

    def __getitem__(self, k):
        return self.attrs[k]

    def get(self, k, default=None):
        return self.attrs.get(k, default)

    def __contains__(self, k):
        return k in self.attrs


class _Reader:
    def __init__(self, f):
        self.f = f
        self.memo: Dict[int, Any] = {}

    def _read(self, fmt, n):
        return struct.unpack(fmt, self.f.read(n))

    def read_int(self):
        return self._read("<i", 4)[0]

    def read_long(self):
        return self._read("<q", 8)[0]

    def read_double(self):
        return self._read("<d", 8)[0]

    def read_string(self):
        n = self.read_int()
        return self.f.read(n).decode("latin1")

    def read_object(self):
        tag = self.read_int()
        if tag == _TNIL:
            return None
        if tag == _TNUM:
            v = self.read_double()
            return int(v) if v == int(v) and abs(v) < 2**53 else v
        if tag == _TSTR:
            return self.read_string()
        if tag == _TBOOL:
            return bool(self.read_int())
        if tag == _TTABLE:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            out: Dict[Any, Any] = {}
            self.memo[idx] = out
            count = self.read_int()
            for _ in range(count):
                k = self.read_object()
                out[k] = self.read_object()
            return out
        if tag == _TTORCH:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            name = self.read_string()
            if name.startswith("V "):
                name = self.read_string()
            return self._read_torch_class(idx, name)
        if tag in (_TFUNC, _TLEGACY_RECUR_FUNC, _TRECUR_FUNC):
            raise NotImplementedError("t7 function payloads are not supported")
        raise ValueError(f"unknown t7 type tag {tag}")

    def _read_torch_class(self, idx, name):
        if name in _STORAGE_DTYPES:
            dtype = _STORAGE_DTYPES[name]
            size = self.read_long()
            data = np.frombuffer(self.f.read(size * np.dtype(dtype).itemsize),
                                 dtype=dtype).copy()
            self.memo[idx] = data
            return data
        if name in _TENSOR_TO_STORAGE:
            ndim = self.read_int()
            sizes = [self.read_long() for _ in range(ndim)]
            strides = [self.read_long() for _ in range(ndim)]
            offset = self.read_long() - 1
            placeholder = {}
            self.memo[idx] = placeholder
            storage = self.read_object()
            if storage is None or ndim == 0:
                arr = np.zeros(sizes, _STORAGE_DTYPES[_TENSOR_TO_STORAGE[name]])
            else:
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:],
                    shape=sizes,
                    strides=[s * storage.dtype.itemsize for s in strides],
                ).copy()
            self.memo[idx] = arr
            return arr
        # generic nn.* / custom class: payload is one object (usually a table)
        obj = T7Object(torch_type=name)
        self.memo[idx] = obj
        payload = self.read_object()
        if isinstance(payload, dict):
            obj.attrs = payload
        else:
            obj.attrs = {"__payload__": payload}
        return obj


def load_t7(path):
    with open(path, "rb") as f:
        return _Reader(f).read_object()


class _Writer:
    def __init__(self, f):
        self.f = f
        self.next_index = 1
        # id(obj) -> (heap index, obj). Holding the object itself keeps it
        # alive for the duration of the save: without the reference, a freed
        # temporary's id can be REUSED by a later object and serialize as a
        # false back-reference (the same reason pickle's memo stores the
        # object alongside its index)
        self.memo: Dict[int, tuple] = {}

    def write_int(self, v):
        self.f.write(struct.pack("<i", v))

    def write_long(self, v):
        self.f.write(struct.pack("<q", v))

    def write_string(self, s):
        b = s.encode("latin1")
        self.write_int(len(b))
        self.f.write(b)

    def write_object(self, obj):
        if obj is None:
            self.write_int(_TNIL)
        elif isinstance(obj, bool):
            self.write_int(_TBOOL)
            self.write_int(1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self.write_int(_TNUM)
            self.f.write(struct.pack("<d", float(obj)))
        elif isinstance(obj, str):
            self.write_int(_TSTR)
            self.write_string(obj)
        elif isinstance(obj, dict):
            self.write_int(_TTABLE)
            if id(obj) in self.memo:
                self.write_int(self.memo[id(obj)][0])
                return
            self.memo[id(obj)] = (self.next_index, obj)
            self.write_int(self.next_index)
            self.next_index += 1
            self.write_int(len(obj))
            for k, v in obj.items():
                self.write_object(k)
                self.write_object(v)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, T7Object):
            self.write_int(_TTORCH)
            if id(obj) in self.memo:
                self.write_int(self.memo[id(obj)][0])
                return
            self.memo[id(obj)] = (self.next_index, obj)
            self.write_int(self.next_index)
            self.next_index += 1
            self.write_string("V 1")
            self.write_string(obj.torch_type)
            self.write_object(dict(obj.attrs))
        else:
            raise TypeError(f"cannot serialize {type(obj)} to t7")

    def _write_tensor(self, arr):
        dtype_to_tensor = {np.dtype(v): k for k, v in
                           (("torch.FloatTensor", np.float32),
                            ("torch.DoubleTensor", np.float64),
                            ("torch.LongTensor", np.int64),
                            ("torch.IntTensor", np.int32),
                            ("torch.ByteTensor", np.uint8))}
        name = dtype_to_tensor[arr.dtype]
        self.write_int(_TTORCH)
        # heap memo, like dicts/T7Objects: an array referenced twice in the
        # object graph (shared weights) back-references one heap entry, so
        # the reader (and real Torch) reconstructs the shared identity
        if id(arr) in self.memo:
            self.write_int(self.memo[id(arr)][0])
            return
        self.memo[id(arr)] = (self.next_index, arr)
        self.write_int(self.next_index)
        self.next_index += 1
        self.write_string("V 1")
        self.write_string(name)
        arr = np.ascontiguousarray(arr)
        self.write_int(arr.ndim)
        for s in arr.shape:
            self.write_long(s)
        strides = [st // arr.dtype.itemsize for st in arr.strides]
        for s in strides:
            self.write_long(s)
        self.write_long(1)  # storage offset, 1-based
        # storage
        self.write_int(_TTORCH)
        self.write_int(self.next_index)
        self.next_index += 1
        self.write_string("V 1")
        self.write_string(_TENSOR_TO_STORAGE[name])
        self.write_long(arr.size)
        self.f.write(arr.tobytes())


def save_t7(path, obj):
    with open(path, "wb") as f:
        _Writer(f).write_object(obj)
