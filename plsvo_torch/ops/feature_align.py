"""Batched subpixel feature alignment (inverse-compositional KLT).

Port of `plsvo_tpu/ops/feature_align.py`: `ref_patch_gradients`, `align2d`
(bootstrap KLT), `align1d` and `align1d_atlas` (1-D refinement along a
direction), `align2d_atlas` (direct matching without edgelets, plain
torch as in the JAX package) and `align_mixed_atlas`, whose Gauss-Newton
loop is `ops.mixed_align.mixed_align` (the CUDA kernel for CUDA tensors).
The window gather and the H^-1 prefix stay plain torch, as they sit
outside the kernel in the JAX package too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from plsvo_torch.batlin import inv2x2, inv3x3
from plsvo_torch.image import bilinear_sample, patch_offsets


class AlignOut(NamedTuple):
    uv: torch.Tensor  # (N, 2)
    converged: torch.Tensor  # (N,) bool
    mean_diff: torch.Tensor  # (N,)


def ref_patch_gradients(ref_patch_with_border: torch.Tensor, patch_size: int):
    """Interior patch + central-difference gradients from a bordered
    (patch_size+2)^2 patch; each (N, patch_size^2)."""
    B = patch_size + 2
    p = ref_patch_with_border.reshape(-1, B, B)
    dx = 0.5 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2])
    dy = 0.5 * (p[:, 2:, 1:-1] - p[:, :-2, 1:-1])
    P = patch_size * patch_size
    return (p[:, 1:-1, 1:-1].reshape(-1, P), dx.reshape(-1, P),
            dy.reshape(-1, P))


def _jtj(J):
    return torch.einsum("npi,npj->nij", J, J)


def align2d(cur_img, ref_patch, ref_dx, ref_dy, uv_init, valid, *,
            patch_size: int = 8, n_iter: int = 10,
            conv_eps: float = 0.03) -> AlignOut:
    """Refine each feature position by IC-KLT with (u, v, mean_diff),
    sampling the full image each iteration (early exit when no row is
    active: one host sync per iteration on a GPU)."""
    N = ref_patch.shape[0]
    dev = ref_patch.device
    offs = patch_offsets(patch_size, device=dev)
    J = torch.stack([ref_dx, ref_dy, torch.ones_like(ref_dx)], -1)
    Hinv = inv3x3(_jtj(J), 1e-6)
    uv = uv_init.to(torch.float32)
    md = torch.zeros(N, dtype=torch.float32, device=dev)
    conv = torch.zeros(N, dtype=torch.bool, device=dev)
    for _ in range(n_iter):
        I_cur, ok = bilinear_sample(cur_img, uv[:, None, :] + offs[None])
        in_frame = ok.all(-1)
        r = I_cur - ref_patch + md[:, None]
        b = torch.einsum("npi,np->ni", J, r)
        upd = (Hinv @ b[..., None])[..., 0]
        active = valid & in_frame & ~conv
        uv = torch.where(active[:, None], uv - upd[:, :2], uv)
        md = torch.where(active, md - upd[:, 2], md)
        conv = conv | (active & (torch.linalg.norm(upd[:, :2], dim=-1) < conv_eps))
        if not bool((valid & in_frame & ~conv).any()):
            break
    _, ok = bilinear_sample(cur_img, uv[:, None, :] + offs[None])
    return AlignOut(uv=uv, converged=conv & valid & ok.all(-1), mean_diff=md)


def _dir_jacobian(ref_dx, ref_dy, direction):
    """Unit direction d, J = [d . grad, 1] per tap and H^-1 of the 1-D
    (distance along d, mean_diff) model."""
    d = direction / torch.linalg.norm(direction, dim=-1,
                                      keepdim=True).clamp_min(1e-8)
    dgrad = ref_dx * d[:, 0:1] + ref_dy * d[:, 1:2]
    J = torch.stack([dgrad, torch.ones_like(dgrad)], -1)
    return d, dgrad, J, inv2x2(_jtj(J), 1e-6)


def _align1d_loop(sample, ref_patch, J, Hinv, uv_init, d, valid, n_iter,
                  conv_eps):
    """The 1-D GN loop over `sample(uv) -> (I_cur (N, P), in_frame (N,))`:
    all n_iter iterations with per-row predication and no host sync, which
    gives the JAX while_loop's result (an inactive row never changes
    again). Returns (uv, converged before the final frame check, md)."""
    N = ref_patch.shape[0]
    uv0 = uv_init.to(torch.float32)
    dist = torch.zeros(N, dtype=torch.float32, device=uv0.device)
    md = torch.zeros_like(dist)
    conv = torch.zeros(N, dtype=torch.bool, device=uv0.device)
    for _ in range(n_iter):
        I_cur, in_frame = sample(uv0 + dist[:, None] * d)
        r = I_cur - ref_patch + md[:, None]
        b = torch.einsum("npi,np->ni", J, r)
        upd = (Hinv @ b[..., None])[..., 0]
        active = valid & in_frame & ~conv
        dist = torch.where(active, dist - upd[:, 0], dist)
        md = torch.where(active, md - upd[:, 1], md)
        conv = conv | (active & (upd[:, 0].abs() < conv_eps))
    return uv0 + dist[:, None] * d, conv, md


def align1d(cur_img, ref_patch, ref_dx, ref_dy, uv_init, direction, valid, *,
            patch_size: int = 8, n_iter: int = 10,
            conv_eps: float = 0.03) -> AlignOut:
    """Refine each feature along its 1-D direction (distance along d,
    mean_diff), sampling the full image each iteration (edgelets)."""
    offs = patch_offsets(patch_size, device=ref_patch.device)
    d, _, J, Hinv = _dir_jacobian(ref_dx, ref_dy, direction)

    def sample(uv):
        I_cur, ok = bilinear_sample(cur_img, uv[:, None, :] + offs[None])
        return I_cur, ok.all(-1)

    uv, conv, md = _align1d_loop(sample, ref_patch, J, Hinv, uv_init, d,
                                 valid, n_iter, conv_eps)
    return AlignOut(uv=uv, converged=conv & valid & sample(uv)[1],
                    mean_diff=md)


def align1d_atlas(atlas, x_off, sizes, ref_patch, ref_dx, ref_dy, uv_init,
                  direction, level, valid, *, patch_size: int = 8,
                  n_iter: int = 10, conv_eps: float = 0.03) -> AlignOut:
    """align1d with per-feature pyramid levels through the atlas: one 18x18
    window per row (as align2d_atlas) gathered before the loop, every
    iteration resampled inside it. Plain torch: K2 takes 16x16 windows,
    whose clamp and in-frame edges differ."""
    from plsvo_torch.image import (gather_patch_windows_atlas,
                                   sample_patch_windows)

    wp = patch_size + 1 + 2 * 4
    wp += wp % 2
    d, _, J, Hinv = _dir_jacobian(ref_dx, ref_dy, direction)
    win, corner = gather_patch_windows_atlas(
        atlas, x_off, uv_init.to(torch.float32), level, wp)
    wh = (sizes[level, 1].float(), sizes[level, 0].float())

    def sample(uv):
        return sample_patch_windows(win, corner, uv, patch_size, wh=wh)

    uv, conv, md = _align1d_loop(sample, ref_patch, J, Hinv, uv_init, d,
                                 valid, n_iter, conv_eps)
    return AlignOut(uv=uv, converged=conv & valid & sample(uv)[1],
                    mean_diff=md)


def align2d_atlas(atlas, x_off, sizes, ref_patch, ref_dx, ref_dy, uv_init,
                  level, valid, *, patch_size: int = 8, n_iter: int = 10,
                  conv_eps: float = 0.03, seq=None) -> AlignOut:
    """align2d with per-feature pyramid levels through the atlas: one
    (P+1+2*4, rounded up to even: 18x18 at P=8) window per row is gathered
    before the loop, and every iteration resamples inside it. A row
    drifting past the window margin is masked invalid.

    The loop runs all n_iter iterations with per-row predication and no
    host sync. That gives the JAX while_loop's result, which stops once no
    row is active: an inactive row never changes again. With `seq` (N,),
    atlas is a batch (B, H, W_total) and row n reads atlas seq[n]."""
    from plsvo_torch.image import (gather_patch_windows_atlas,
                                   sample_patch_windows)

    N = ref_patch.shape[0]
    wp = patch_size + 1 + 2 * 4
    wp += wp % 2
    J = torch.stack([ref_dx, ref_dy, torch.ones_like(ref_dx)], -1)
    Hinv = inv3x3(_jtj(J), 1e-6)
    uv = uv_init.to(torch.float32)
    win, corner = gather_patch_windows_atlas(atlas, x_off, uv, level, wp, seq)
    wh = (sizes[level, 1].float(), sizes[level, 0].float())
    md = torch.zeros(N, dtype=torch.float32, device=uv.device)
    conv = torch.zeros(N, dtype=torch.bool, device=uv.device)
    for _ in range(n_iter):
        I_cur, in_frame = sample_patch_windows(win, corner, uv, patch_size,
                                               wh=wh)
        r = I_cur - ref_patch + md[:, None]
        b = torch.einsum("npi,np->ni", J, r)
        upd = (Hinv @ b[..., None])[..., 0]
        active = valid & in_frame & ~conv
        uv = torch.where(active[:, None], uv - upd[:, :2], uv)
        md = torch.where(active, md - upd[:, 2], md)
        conv = conv | (active & (torch.linalg.norm(upd[:, :2], dim=-1)
                                 < conv_eps))
    _, ok = sample_patch_windows(win, corner, uv, patch_size, wh=wh)
    return AlignOut(uv=uv, converged=conv & valid & ok, mean_diff=md)


def align_mixed_atlas(atlas, x_off, sizes, ref_patch, ref_dx, ref_dy, uv_init,
                      direction, is_1d, level, valid, *, patch_size: int = 8,
                      n_iter: int = 10, conv_eps: float = 0.03,
                      seq=None) -> AlignOut:
    """One GN loop refining 2-D rows (u, v, mean_diff) and 1-D rows
    (distance along `direction`, mean_diff) together, from per-row 16x16
    windows of the pyramid atlas. Rows are independent, so the rows of B
    sequences go through one loop (one K2 launch): with `seq` (N,), atlas
    is a batch (B, H, W_total) and row n's window comes from atlas
    seq[n]."""
    from plsvo_torch.image import gather_patch_windows_atlas
    from plsvo_torch.ops.mixed_align import mixed_align

    wp = 2 * ((patch_size + 8) // 2)
    ones = torch.ones_like(ref_dx)
    H3inv = inv3x3(_jtj(torch.stack([ref_dx, ref_dy, ones], -1)), 1e-6)
    d, dgrad, _, H1inv = _dir_jacobian(ref_dx, ref_dy, direction)
    uv0 = uv_init.to(torch.float32)
    win, corner = gather_patch_windows_atlas(atlas, x_off, uv0, level, wp, seq)
    wh = torch.stack([sizes[level, 1].float(), sizes[level, 0].float()], -1)
    uv, conv, md = mixed_align(
        win, corner, ref_patch, ref_dx, ref_dy, dgrad, H3inv, H1inv, d, is_1d,
        uv0, wh, valid, patch_size=patch_size, wp=wp, n_iter=n_iter,
        conv_eps=conv_eps)
    return AlignOut(uv=uv, converged=conv, mean_diff=md)
