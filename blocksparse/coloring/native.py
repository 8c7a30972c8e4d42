"""ctypes binding to the native (C++) coloring library.

Builds ``native/coloring.cpp`` on first use with g++ (no pybind11 in the
image; plain C ABI + ctypes).  The build artifact is cached next to this
module and rebuilt whenever the source is newer.  All entry points raise on
failure so callers (blocksparse.coloring.color_blocks) can fall back to
the pure-Python implementation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["dsatur_color_native", "validate_coloring_native", "available"]

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "coloring.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_SO = _BUILD_DIR / "libbspcoloring.so"

_lock = threading.Lock()
_lib = None
_failed = False


def _load():
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed:
        raise ImportError("native coloring library unavailable")
    with _lock:
        if _lib is not None:
            return _lib
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = _SO.with_suffix(f".tmp{os.getpid()}.so")
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(str(_SO))
            lib.bsp_dsatur_color.restype = ctypes.c_int64
            lib.bsp_dsatur_color.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.bsp_validate_coloring.restype = ctypes.c_int64
            lib.bsp_validate_coloring.argtypes = lib.bsp_dsatur_color.argtypes
            _lib = lib
            return _lib
        except Exception:
            _failed = True
            raise


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _pack(indexlists):
    lists = [np.asarray(ix, dtype=np.int32).ravel() for ix in indexlists]
    offsets = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([ix.size for ix in lists], out=offsets[1:])
    idx = np.concatenate(lists) if lists else np.zeros(0, dtype=np.int32)
    return np.ascontiguousarray(idx), offsets


def dsatur_color_native(indexlists) -> np.ndarray:
    """DSATUR coloring; returns int color assignment per block."""
    lib = _load()
    idx, offsets = _pack(indexlists)
    n = len(indexlists)
    out = np.zeros(n, dtype=np.int32)
    rc = lib.bsp_dsatur_color(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc < 0:
        raise RuntimeError("bsp_dsatur_color failed")
    return out.astype(np.int64)


def validate_coloring_native(indexlists, assignment) -> bool:
    lib = _load()
    idx, offsets = _pack(indexlists)
    n = len(indexlists)
    colors = np.ascontiguousarray(np.asarray(assignment, dtype=np.int32))
    rc = lib.bsp_validate_coloring(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        colors.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return rc == 1
