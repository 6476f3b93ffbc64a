"""ctypes binding of loader.cpp, built with g++ at first use into
`build/plsvo_torch_native/<source hash>/` (never next to the source)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_ROOT = _SRC.parents[2] / "build" / "plsvo_torch_native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_failed = False


def _build() -> Optional[Path]:
    """Compile the library (cached by the source hash); None when g++ or
    zlib is missing."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    out = BUILD_ROOT / h.hexdigest()[:16] / "libplsvo_loader.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp), "-lz",
                        "-lpthread"], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded library, or None when it cannot be built or loaded."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = _build()
        try:
            lib = ctypes.CDLL(str(path)) if path is not None else None
        except OSError:
            lib = None
        if lib is None:
            _failed = True
            return None
        lib.load_gray.restype = ctypes.c_int
        lib.load_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.prefetcher_create.restype = ctypes.c_void_p
        lib.prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.prefetcher_next.restype = ctypes.c_int
        lib.prefetcher_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.prefetcher_destroy.restype = None
        lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def load_gray(path: str, max_pixels: int = 4096 * 4096) -> Optional[np.ndarray]:
    """Grayscale float32 image in [0, 255], or None (no library, or a file
    the decoder does not read)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty(max_pixels, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    n = lib.load_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_pixels, ctypes.byref(w), ctypes.byref(h))
    if n <= 0:
        return None
    return buf[: n].reshape(h.value, w.value).copy()


class Prefetcher:
    """Background-thread image prefetch over a fixed file list of
    width x height images."""

    def __init__(self, paths: List[str], width: int, height: int, depth: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._w, self._h = width, height
        self._paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.prefetcher_create(self._paths, len(paths), width,
                                             height, depth)
        self._n = len(paths)

    def __iter__(self):
        buf = np.empty(self._h * self._w, np.float32)
        for _ in range(self._n):
            ok = self._lib.prefetcher_next(
                self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if not ok:
                break
            yield buf.reshape(self._h, self._w).copy()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
