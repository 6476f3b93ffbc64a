"""The mixed 2-D/1-D feature-alignment Gauss-Newton loop: the hand-written
CUDA kernel (`csrc/mixed_align.cu`) and its plain PyTorch twin.

Port of `plsvo_tpu/ops/pallas_align.py::mixed_align_loop_pallas`; the
plain twin is the loop of `plsvo_tpu/ops/feature_align.py::
align_mixed_atlas`. `mixed_align` dispatches on the device: a CPU tensor
takes the plain twin, any other tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from plsvo_torch import _build

launches = 0  # kernel launches (incremented only where the kernel launches)
capture = None  # optional callable(args, kwargs) run before each launch


def mixed_align_plain(win, corner, ref_patch, ref_dx, ref_dy, dgrad, h3inv,
                      h1inv, d, is_1d, uv_init, wh, valid, *,
                      patch_size: int = 8, wp: int = 16, n_iter: int = 10,
                      conv_eps: float = 0.03):
    """Early-exit GN loop. Returns (uv (N,2), converged (N,), mean_diff (N,))."""
    from plsvo_torch.image import sample_patch_windows

    N = win.shape[0]
    whp = (wh[:, 0], wh[:, 1])
    uv = uv_init.to(torch.float32)
    md = torch.zeros(N, dtype=torch.float32, device=win.device)
    conv = torch.zeros(N, dtype=torch.bool, device=win.device)
    for _ in range(n_iter):
        I_cur, in_frame = sample_patch_windows(win, corner, uv, patch_size,
                                               wh=whp)
        r = I_cur - ref_patch + md[:, None]
        b3 = torch.stack([(ref_dx * r).sum(-1), (ref_dy * r).sum(-1),
                          r.sum(-1)], -1)
        u3 = (h3inv @ b3[..., None])[..., 0]
        b1 = torch.stack([(dgrad * r).sum(-1), r.sum(-1)], -1)
        u1 = (h1inv @ b1[..., None])[..., 0]
        d_uv = torch.where(is_1d[:, None], u1[:, 0:1] * d, u3[:, :2])
        d_md = torch.where(is_1d, u1[:, 1], u3[:, 2])
        step = torch.where(is_1d, u1[:, 0].abs(),
                           torch.linalg.norm(u3[:, :2], dim=-1))
        active = valid & in_frame & ~conv
        uv = torch.where(active[:, None], uv - d_uv, uv)
        md = torch.where(active, md - d_md, md)
        conv = conv | (active & (step < conv_eps))
        if not bool((valid & in_frame & ~conv).any()):
            break
    _, ok = sample_patch_windows(win, corner, uv, patch_size, wh=whp)
    return uv, conv & valid & ok, md


_F32 = torch.float32
_BOOL = torch.bool
# per input, in argument order: values per row, dtype, read as float4s
_INPUTS = ((256, _F32, True), (2, _F32, False), (64, _F32, True),
           (64, _F32, True), (64, _F32, True), (64, _F32, True),
           (9, _F32, False), (4, _F32, False), (2, _F32, False),
           (1, _BOOL, False), (2, _F32, False), (2, _F32, False),
           (1, _BOOL, False))


def _pointers(inputs, N, dev):
    """Device pointers of the kernel's inputs, all on card `dev`. The main path's inputs are
    already f32/bool, contiguous and aligned: then nothing is copied.
    Returns (pointers, the tensors they point into)."""
    ptrs, keep = [], []
    for a, (k, dt, vec) in zip(inputs, _INPUTS):
        if a.dtype is not dt or not a.is_contiguous():
            a = a.to(dt).contiguous()
        p = a.data_ptr()
        if vec and p % 16:  # float4 reads need 16-byte alignment
            a = a.clone()
            p = a.data_ptr()
        if a.device != dev or a.numel() != N * k:
            raise ValueError(f"mixed_align_cuda: an input of shape "
                             f"{tuple(a.shape)} on {a.device} is not {k} "
                             f"values per row on {dev}")
        ptrs.append(p)
        keep.append(a)
    return ptrs, keep


@functools.lru_cache(maxsize=None)
def conv_sq(conv_eps: float) -> float:
    """The f32 threshold T with x < T exactly when sqrtf(x) < conv_eps for
    every f32 x >= 0 (sqrtf correctly rounded): sqrtf(x) < e holds iff
    sqrt(x) lies below the midpoint m of e and its f32 predecessor, i.e.
    iff x < m * m (exact in f64), i.e. iff x < the least f32 above m * m."""
    e = np.float32(conv_eps)
    if e <= 0:
        return 0.0
    m = (float(np.nextafter(e, np.float32(0))) + float(e)) / 2
    t = np.float32(m * m)
    if float(t) <= m * m:
        t = np.nextafter(t, np.float32(np.inf))
    return float(t)


def mixed_align_cuda(win, corner, ref_patch, ref_dx, ref_dy, dgrad, h3inv,
                     h1inv, d, is_1d, uv_init, wh, valid, *,
                     patch_size: int = 8, wp: int = 16, n_iter: int = 10,
                     conv_eps: float = 0.03):
    """Launch the CUDA kernel: 8 lanes per row, all iterations in one
    launch. Same arguments and results as mixed_align_plain."""
    global launches
    lib = _build.load_library()
    if win.device.type != "cuda":
        raise ValueError(f"mixed_align_cuda needs CUDA tensors, got {win.device}")
    if patch_size != 8 or wp != 16:
        raise ValueError("the kernel is built for 8x8 patches in 16x16 windows")
    N = win.shape[0]
    inputs = (win, corner, ref_patch, ref_dx, ref_dy, dgrad, h3inv, h1inv, d,
              is_1d, uv_init, wh, valid)
    ptrs, keep = _pointers(inputs, N, win.device)
    # one allocation: uv (N, 2) f32 | mean_diff (N,) f32 | converged (N,) bool
    out = torch.empty(13 * N, dtype=torch.uint8, device=win.device)
    base = out.data_ptr()
    if capture is not None:
        capture(inputs, dict(patch_size=patch_size, wp=wp, n_iter=n_iter,
                             conv_eps=conv_eps))
    # the C entry launches on the thread's current device: make it the
    # inputs' (a mesh may hold shards on several cards)
    with torch.cuda.device(win.device):
        _build.check(lib.plsvo_mixed_align(
            *ptrs, base, base + 12 * N, base + 8 * N, N, int(n_iter),
            float(conv_eps), conv_sq(conv_eps),
            torch.cuda.current_stream(win.device).cuda_stream),
            "plsvo_mixed_align")
    del keep  # the copies, if any, stay alive until the launch is queued
    uv = out[:8 * N].view(_F32).view(N, 2)
    md = out[8 * N:12 * N].view(_F32)
    conv = out[12 * N:].view(_BOOL)
    launches += 1
    return uv, conv, md


def mixed_align(*args, **kwargs):
    if args[0].device.type == "cpu":
        return mixed_align_plain(*args, **kwargs)
    return mixed_align_cuda(*args, **kwargs)
