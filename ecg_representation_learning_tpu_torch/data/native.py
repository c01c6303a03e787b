"""ctypes bindings for the native ingest library (the JAX package's
``data/native.py``).

The library is the port's own copy of the C++ decoder,
``data/csrc/wfdb_native.cpp``, compiled at first use with the host compiler
into ``build/torch_kernels/`` (``ops/_build.build_host``).  Every entry point
has a pure-numpy version (data/readers.py), so the readers work without it:
with no C++ compiler on the machine ``load_native()`` is None and the
callers take the numpy path.  A compiler that is present and fails raises
with its output.  It is a throughput accelerator for the host data plane,
not a GPU kernel.  ``disabled()`` forces the numpy path for a block.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..ops import _build

SOURCE = Path(__file__).resolve().parent / 'csrc' / 'wfdb_native.cpp'

_LIB = None
_TRIED = False
_DISABLED = False
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
    i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    f64p = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
    for name in ('decode_fmt212', 'decode_fmt16', 'decode_fmt24', 'decode_fmt80'):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, ctypes.c_int64, i32p, ctypes.c_int64]
        fn.restype = None
    lib.dig2phys.argtypes = [i32p, ctypes.c_int64, ctypes.c_double, ctypes.c_int32,
                             ctypes.c_int32, ctypes.c_int32, f32p]
    lib.dig2phys.restype = None
    i64p = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
    lib.read_records_16.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        f64p, i32p, i64p, f32p, ctypes.c_int32]
    lib.read_records_16.restype = ctypes.c_int64
    return lib


def load_native():
    """The shared library handle (built at first use), or None when there is
    no C++ compiler or inside ``disabled()``."""
    global _LIB, _TRIED
    if _DISABLED:
        return None
    with _lock:
        if not _TRIED:
            path = _build.build_host(SOURCE)
            _LIB = None if path is None else _bind(ctypes.CDLL(str(path)))
            _TRIED = True
    return _LIB


def native_available() -> bool:
    return load_native() is not None


@contextlib.contextmanager
def disabled():
    """Within the block every reader takes its numpy path."""
    global _DISABLED
    old, _DISABLED = _DISABLED, True
    try:
        yield
    finally:
        _DISABLED = old


def decode_fmt(raw: bytes, fmt: int, n_values: int) -> Optional[np.ndarray]:
    """Native packed-format decode; None when the library is not available
    or the format has no native decoder (32)."""
    lib = load_native()
    if lib is None:
        return None
    fn = {212: lib.decode_fmt212, 16: lib.decode_fmt16,
          24: lib.decode_fmt24, 80: lib.decode_fmt80}.get(fmt)
    if fn is None:
        return None
    buf = np.frombuffer(raw, np.uint8)
    out = np.empty(n_values, np.int32)
    fn(np.ascontiguousarray(buf), buf.size, out, n_values)
    return out


def read_records_16_batch(paths: Sequence[str], n_ch: int, n_samples: int,
                          gains: np.ndarray, baselines: np.ndarray,
                          offsets: Optional[np.ndarray] = None,
                          n_threads: int = 8) -> Optional[np.ndarray]:
    """Threaded batch read of same-shape fmt-16 records -> (N, C, L) float32.

    ``offsets``: optional per-record leading byte counts to skip (the CinC
    ``16+24`` .mat layout).  None when the native library is not available
    or a record could not be read (the caller falls back to the numpy
    thread-pool reader).
    """
    lib = load_native()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, n_ch, n_samples), np.float32)
    blob = b'\0'.join(p.encode() for p in paths) + b'\0'
    if offsets is None:
        offsets = np.zeros(n, np.int64)
    got = lib.read_records_16(
        blob, n, n_ch, n_samples,
        np.ascontiguousarray(gains, np.float64).reshape(n, n_ch),
        np.ascontiguousarray(baselines, np.int32).reshape(n, n_ch),
        np.ascontiguousarray(offsets, np.int64).reshape(n),
        out, n_threads)
    if got != n:
        return None
    return out
