"""ctypes binding of the native libsvm tokenizer (the port's copy of
``distlr_tpu/data/_native.py``).

``native/libsvm_parser.cc`` is built with ``g++`` at first use into
``build/native/`` at the root of the checkout (:mod:`distlr_tpu_torch.
utils.native`), never next to the JAX package's copy.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from distlr_tpu_torch.utils import native

SOURCE = Path(__file__).resolve().parent / "native" / "libsvm_parser.cc"
# the JAX package's data/native/Makefile flags (no threads in the tokenizer)
FLAGS = ("-std=c++17", "-O3", "-Wall", "-Wextra", "-fPIC")

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                path = native.build("libdistlr_torch_libsvm", [SOURCE], shared=True, flags=FLAGS)
                lib = ctypes.CDLL(str(path))
                lib.libsvm_count.restype = ctypes.c_int
                lib.libsvm_count.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ]
                lib.libsvm_parse.restype = ctypes.c_int64
                lib.libsvm_parse.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ]
                _lib = lib
    return _lib


def parse_libsvm_bytes(data: bytes, multiclass: bool):
    """Returns ``(labels i32, row_ptr i64, cols i32, vals f32)``."""
    lib = _load()
    n = len(data)
    n_rows = ctypes.c_int64()
    n_nnz = ctypes.c_int64()
    lib.libsvm_count(data, n, ctypes.byref(n_rows), ctypes.byref(n_nnz))
    labels = np.empty(n_rows.value, dtype=np.int32)
    row_ptr = np.empty(n_rows.value + 1, dtype=np.int64)
    cols = np.empty(n_nnz.value, dtype=np.int32)
    vals = np.empty(n_nnz.value, dtype=np.float32)
    parsed = lib.libsvm_parse(
        data, n, int(multiclass),
        labels.ctypes.data_as(ctypes.c_void_p),
        row_ptr.ctypes.data_as(ctypes.c_void_p),
        cols.ctypes.data_as(ctypes.c_void_p),
        vals.ctypes.data_as(ctypes.c_void_p),
    )
    if parsed != n_rows.value:
        raise ValueError(f"malformed libsvm input (parsed {parsed} of {n_rows.value} rows)")
    return labels, row_ptr, cols, vals
