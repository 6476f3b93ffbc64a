"""Build and load the hand-written CUDA kernels of `plsvo_torch/csrc`.

Every `csrc/*.cu` file exposes a plain C interface. At first use each
source is compiled by its own `nvcc` process (all started together) for
`sm_90a`, the objects are linked into one shared library under
`build/plsvo_torch_kernels/<source hash>/libplsvo_kernels.so` at the root
of the checkout, and the library is loaded with ctypes. A later call with
unchanged sources loads the cached library.

Nothing here runs at import time: the CPU-only test machines import every
module but never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "plsvo_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream are void*, every C entry
# returns the cudaError_t of its launch (0 = success)
SIGNATURES = {
    # (image, mask and score pointer tables, (H, W) table, n, thr, stream)
    "plsvo_fast_score_levels": [_P, _P, _P, _P, _I, _F, _P],
    # (13 inputs, 3 outputs, N, n_iter, conv_eps, conv_sq, stream)
    "plsvo_mixed_align": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _I, _I, _F, _F, _P],
    # (level pointer tables, (h, w) x 2 and scale table, n_levels, 10
    # inputs, 8 outputs, scratch, B, N, M, K, n_iter, fx, fy, cx, cy, stream)
    "plsvo_sparse_align": [_P, _P, _P, _P, _I] + [_P] * 19 + [_I] * 5
                          + [_F] * 4 + [_P],
    # (11 inputs, 12 outputs, B, N, M, n_iter, n_iter_ref, focal,
    # reproj_thresh / focal, stream)
    "plsvo_pose_opt": [_P] * 23 + [_I] * 5 + [_F] * 2 + [_P],
}

_lib = None
build_seconds = None  # wall time of the build (or cache load) that ran


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link the
    shared library; returns its path. Cached by the source hash."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libplsvo_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"tmp{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs = []
    errors = []
    for src, obj, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(f"[nvcc {src.name}]\n{out}", flush=True)
        if p.returncode != 0:
            errors.append(f"{src.name}:\n{out}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp_lib = tmp / "libplsvo_kernels.so"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", str(tmp_lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def load_library(verbose: bool = False):
    """The loaded kernel library (built on first use). Raises when the
    build or the load fails; callers never fall back to plain code."""
    global _lib, build_seconds
    if _lib is None:
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(build(verbose=verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        build_seconds = time.perf_counter() - t0
    return _lib


def table(ctype, values):
    """A C array of `values`, for a kernel's argument tables."""
    return (ctype * len(values))(*values)


def as_input(x, dt, dev, name: str):
    """x as a contiguous `dt` tensor on card `dev`, for a C entry (no copy
    when it is one); raises for a tensor on another device."""
    if x.device != dev:
        raise ValueError(f"{name}: a tensor on {x.device}, not on {dev}")
    return x.to(dt).contiguous()


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
