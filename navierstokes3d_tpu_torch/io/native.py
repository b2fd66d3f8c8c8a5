"""ctypes bindings for the native I/O runtime (the repository's
csrc/ns3dio.cpp: a cache-blocked column-major transpose and a background
writer thread).

The library is built with g++ at first use into the package's `_build/`
directory (listed in .gitignore), under a name keyed by a hash of the
source and flags, written to a temporary file and renamed into place, so
concurrent first uses never load a half-written library. `lib()` returns
None where the source or g++ is missing or the build fails (the reason is
kept in `build_error`), and binio.py then writes with numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "csrc" / "ns3dio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False
build_error: Optional[str] = None


def _build() -> Optional[Path]:
    global build_error
    if not SRC.exists():
        build_error = f"{SRC} not found"
        return None
    key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    so = BUILD_DIR / f"libns3dio-{key.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"{type(e).__name__}: {getattr(e, 'stderr', e)}"
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lb = ctypes.CDLL(str(so))
        except OSError as e:
            build_error = str(e)
            return None
        i64 = ctypes.c_int64
        fp = ctypes.POINTER(ctypes.c_float)
        for fn in (lb.ns3dio_write_f32, lb.ns3dio_write_f32_async,
                   lb.ns3dio_read_f32):
            fn.argtypes = [ctypes.c_char_p, fp, i64, i64, i64]
            fn.restype = ctypes.c_int
        lb.ns3dio_drain.argtypes = []
        lb.ns3dio_drain.restype = None
        lb.ns3dio_pending.argtypes = []
        lb.ns3dio_pending.restype = i64
        _lib = lb
        return _lib


def write_f32(path: str, a: np.ndarray, asynchronous: bool = False) -> bool:
    """Write a 3D array in the reference's .bin format through the native
    runtime. Returns False if the native library is unavailable. The
    asynchronous writer copies the data before it returns."""
    lb = lib()
    if lb is None or a.ndim != 3:
        return False
    buf = np.ascontiguousarray(a, dtype=np.float32)
    fn = lb.ns3dio_write_f32_async if asynchronous else lb.ns3dio_write_f32
    ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    return fn(path.encode(), ptr, *buf.shape) == 0


def read_f32(path: str, shape) -> Optional[np.ndarray]:
    lb = lib()
    if lb is None or len(shape) != 3:
        return None
    out = np.empty(shape, dtype=np.float32)
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    return out if lb.ns3dio_read_f32(path.encode(), ptr, *shape) == 0 \
        else None


def drain():
    """Wait for all in-flight asynchronous writes (before reading frames
    back or at exit)."""
    lb = lib()
    if lb is not None:
        lb.ns3dio_drain()
