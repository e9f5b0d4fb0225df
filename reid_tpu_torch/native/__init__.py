"""Native C++ JPEG loader, exposed via ctypes.

An own copy of `reid_tpu/native` (the same `loader.cpp`), so that the port
imports nothing of the JAX package. `decode_batch(paths, h, w)` is a
pthread-pooled libjpeg decode + bilinear resize. The shared library is
compiled with g++ at first use into this directory (git ignores `*.so`),
through a per-process temporary name so that concurrent processes never
load a half-written file; without g++ or libjpeg the caller falls back to
PIL (see `reid_tpu_torch.data.dataset`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "loader.cpp")
_LIB = os.path.join(_DIR, "libreidloader.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _build() -> bool:
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp,
           "-ljpeg", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                _failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            lib.rtl_decode_batch.restype = ctypes.c_int
            lib.rtl_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
            ]
            _lib = lib
        except Exception:
            _failed = True
        return _lib


def available() -> bool:
    return load_library() is not None


def decode_batch(paths: Sequence[str], height: int, width: int
                 ) -> np.ndarray:
    """Decode + resize a batch of JPEGs -> uint8 (N, H, W, 3), one thread
    per hardware thread; files that fail to decode are zero-filled."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    out = np.empty((n, height, width, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.rtl_decode_batch(
        arr, n, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), 0)
    return out
