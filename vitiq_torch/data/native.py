"""The native row gather of the packed-shard reader (counterpart of
`vitiq/data/native.py`): ctypes bindings of `_native/gather.c`.

The C source is compiled at first use with the system gcc into the
checkout's git-ignored ``build/vitiq_torch_native/`` (one library per source
hash; nothing is built at import) and loaded with ctypes. This is a host
memcpy, not a device kernel: where the library is unavailable (no compiler, a
read-only checkout, ``VITIQ_NO_NATIVE=1``) every caller takes the numpy path,
and `available()` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "_native" / "gather.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vitiq_torch_native"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("VITIQ_NO_NATIVE") == "1":
        return None
    try:
        tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"gather-{tag}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["gcc", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                           check=True, capture_output=True, timeout=60)
            tmp.replace(so)  # atomic: concurrent builds race benignly
        lib = ctypes.CDLL(str(so))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gather_rows.argtypes = [ctypes.c_char_p, ctypes.c_char_p, i64p, ctypes.c_int64,
                                    ctypes.c_int64]
        lib.gather_rows.restype = None
        lib.gather_scatter_rows.argtypes = [ctypes.c_char_p, i64p, ctypes.c_char_p, i64p,
                                            ctypes.c_int64, ctypes.c_int64]
        lib.gather_scatter_rows.restype = None
        _lib = lib
    except (OSError, subprocess.SubprocessError):
        _lib = None
    return _lib


def available() -> bool:
    """True where the native gather runs, False where callers take numpy."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_char_p)


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _qualifies(lib, dst: np.ndarray, src: np.ndarray) -> bool:
    return (lib is not None and dst.flags.c_contiguous and src.flags.c_contiguous
            and dst.dtype == src.dtype and dst.shape[1:] == src.shape[1:])


def _checked_rows(rows, limit: int) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if len(rows) and (rows.min() < 0 or rows.max() >= limit):
        raise IndexError(f"row index out of range for {limit} rows")
    return rows


def gather_rows(dst: np.ndarray, src: np.ndarray, rows: np.ndarray) -> bool:
    """dst[:len(rows)] = src[rows] natively. Needs C-contiguous dst and src
    with the same row shape and dtype; returns False (nothing copied) where
    the library is unavailable or the layout does not qualify, and the caller
    takes numpy."""
    lib = _load()
    if not _qualifies(lib, dst, src) or len(rows) > len(dst):
        return False
    rows = _checked_rows(rows, len(src))
    row_bytes = int(np.prod(src.shape[1:])) * src.dtype.itemsize
    lib.gather_rows(_ptr(dst), _ptr(src), _i64(rows), len(rows), row_bytes)
    return True


def gather_scatter_rows(dst: np.ndarray, dst_rows: np.ndarray,
                        src: np.ndarray, src_rows: np.ndarray) -> bool:
    """dst[dst_rows] = src[src_rows] natively (scattered destination rows);
    returns False where unavailable, and the caller takes numpy."""
    lib = _load()
    if not _qualifies(lib, dst, src) or len(dst_rows) != len(src_rows):
        return False
    dst_rows = _checked_rows(dst_rows, len(dst))
    src_rows = _checked_rows(src_rows, len(src))
    row_bytes = int(np.prod(src.shape[1:])) * src.dtype.itemsize
    lib.gather_scatter_rows(_ptr(dst), _i64(dst_rows), _ptr(src), _i64(src_rows),
                            len(dst_rows), row_bytes)
    return True
