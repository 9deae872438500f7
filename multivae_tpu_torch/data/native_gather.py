"""ctypes binding of the threaded row gather (``csrc/gather.cpp``).

Counterpart of ``multivae_tpu/data/native_gather.py``, with the port's own
copy of the C++ source. The library is built with ``g++`` into
``build/native/`` at first use (``ops/cuda_build.py``: the same lock and
hash-named cache as the CUDA kernels). A failed build raises instead of
dropping to numpy, so a broken toolchain shows. The index rules are the
JAX module's: negative or out-of-range indices and a source that is not
C-contiguous go to numpy's bounds-checked gather; so do indices that are
not integers (a boolean mask), which the C routine would read as rows 0
and 1.

Each call starts its own threads, one per ``BYTES_PER_THREAD`` of output
(up to 8 and the host's cores), where the JAX module starts
``min(8, cores)`` on any batch: on the 8-core host of an NVIDIA H100
80GB HBM3 (700.00 W) machine 8 threads made a 256-row PolyMNIST modality
(2.4 MB) 10x slower than numpy's single-threaded copy, their start
costing more than they copied (``chip_smoke.py``'s ``resident_data``
phase prints the times by thread count).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_LIB = None
_LOCK = threading.Lock()
BYTES_PER_THREAD = 4 << 20
MAX_THREADS = 8


def _library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            from ..ops import cuda_build

            lib = cuda_build.load("gather")
            lib.gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            lib.gather_rows.restype = None
            _LIB = lib
        return _LIB


def gather_rows(src: np.ndarray, indices: np.ndarray, n_threads: int = None) -> np.ndarray:
    """``src[indices]`` along the first axis, the rows copied by
    ``n_threads`` threads (by default one per ``BYTES_PER_THREAD`` of
    output, at most ``MAX_THREADS`` and the host's cores).

    ``src`` may have any row shape; the result is a new C-contiguous array.
    """
    indices = np.asarray(indices)
    if (not src.flags["C_CONTIGUOUS"] or indices.ndim != 1
            or not np.issubdtype(indices.dtype, np.integer)):
        return src[indices]
    # the C routine trusts its indices: anything numpy would wrap or refuse
    # goes through numpy's bounds-checked gather
    if indices.size and (indices.min() < 0 or indices.max() >= len(src)):
        return src[indices]
    lib = _library()
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.empty((len(indices), *src.shape[1:]), dtype=src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    if n_threads is None:
        n_threads = max(1, min(MAX_THREADS, os.cpu_count() or 1,
                               out.nbytes // BYTES_PER_THREAD))
    lib.gather_rows(src.ctypes.data, indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    out.ctypes.data, len(indices), row_bytes, n_threads)
    return out


def native_available() -> bool:
    """Whether the library is built and loaded (building it now if needed;
    a failed build raises)."""
    return _library() is not None
