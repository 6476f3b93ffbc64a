"""Homography RANSAC + decomposition for the two-view bootstrap.

Port of `plsvo_tpu/ops/homography.py`. The hypothesis draws take a
`torch.Generator`, or explicit `draws` (n_hyp, 4) indices into the valid
rows so that a caller can reproduce another generator's hypotheses. The
decomposition of the one 3x3 matrix is host numpy, copied as it is.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plsvo_torch.device import resolve_device


def _dlt_4pt(src, dst):
    """DLT from exactly 4 correspondences (..., 4, 2) -> ((..., 3, 3), ok)."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)
    A = torch.cat([rows_u, rows_v], -2)
    b = torch.cat([u, v], -1)[..., None]
    det_ok = torch.linalg.det(A).abs() > 1e-12
    eye8 = torch.eye(8, dtype=A.dtype, device=A.device)
    A_safe = torch.where(det_ok[..., None, None], A, eye8)
    h = torch.linalg.solve(A_safe, b)[..., 0]
    H = torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(
        *h.shape[:-1], 3, 3)
    eye3 = torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.where(det_ok[..., None, None], H, eye3), det_ok


def _transfer_error(H, src, dst):
    sh = torch.cat([src, torch.ones_like(src[..., :1])], -1)
    p = torch.einsum("...ij,nj->...ni", H, sh)
    w = torch.where(p[..., 2].abs() < 1e-12, torch.full_like(p[..., 2], 1e-12),
                    p[..., 2])
    return torch.linalg.norm(p[..., :2] / w[..., None] - dst, dim=-1)


def ransac_homography(src, dst, valid, thresh: float, n_hyp: int = 256, *,
                      generator: torch.Generator = None, draws=None):
    """Vectorized RANSAC over n_hyp 4-point hypotheses. `draws` (n_hyp, 4)
    index the valid rows in order (drawn from [0, n_valid) when absent).
    Returns (H_best (3,3), inlier_mask (N,), n_inliers ())."""
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    if draws is None:
        n_valid = max(int(valid.sum()), 1)
        draws = torch.randint(0, n_valid, (n_hyp, 4), generator=generator,
                              device=generator.device if generator is not None
                              else "cpu")
    if not torch.is_tensor(draws):
        draws = torch.as_tensor(np.array(draws))
    idx = order[draws.to(src.device).long()]
    hyp_valid = valid[idx].all(-1)
    Hs, dlt_ok = _dlt_4pt(src[idx], dst[idx])
    inl = (_transfer_error(Hs, src, dst) < thresh) & valid[None, :]
    scores = inl.sum(-1) * (hyp_valid & dlt_ok)
    best = torch.argmax(scores)
    return Hs[best], inl[best], scores[best]


def decompose_homography(H: np.ndarray, src: np.ndarray, dst: np.ndarray,
                         inliers: np.ndarray):
    """Faugeras SVD decomposition of a unit-plane homography into
    (R, t, n, ok), keeping the solution with the most inliers in front of
    both cameras (host numpy)."""
    U, S, Vt = np.linalg.svd(H)
    d1, d2, d3 = S
    if d1 / d2 < 1.0001 or d2 / d3 < 1.0001:
        R = H / d2
        Ur, _, Vtr = np.linalg.svd(R)
        R = Ur @ Vtr
        if np.linalg.det(R) < 0:
            R = -R
        return R, np.zeros(3), np.array([0.0, 0.0, 1.0]), True

    s = np.linalg.det(U) * np.linalg.det(Vt)
    V = Vt.T
    d1, d2, d3 = d1 / d2, 1.0, d3 / d2
    x1a = np.sqrt(max((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0))
    x3a = np.sqrt(max((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    eps = [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    candidates = []
    for e1, e3 in eps:
        x1, x3 = e1 * x1a, e3 * x3a
        sin_t = (d1 - d3) * x1 * x3 / d2
        cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2
        Rp = np.array([[cos_t, 0, -sin_t], [0, 1, 0], [sin_t, 0, cos_t]])
        tp = (d1 - d3) * np.array([x1, 0.0, -x3])
        np_ = np.array([x1, 0.0, x3])
        candidates.append((s * U @ Rp @ Vt, U @ tp, V @ np_))
    for e1, e3 in eps:
        x1, x3 = e1 * x1a, e3 * x3a
        sin_p = (d1 + d3) * x1 * x3 / d2
        cos_p = (d3 * x1 * x1 - d1 * x3 * x3) / d2
        Rp = np.array([[cos_p, 0, sin_p], [0, -1, 0], [sin_p, 0, -cos_p]])
        tp = (d1 + d3) * np.array([x1, 0.0, x3])
        np_ = np.array([x1, 0.0, x3])
        candidates.append((s * U @ Rp @ Vt, U @ tp, V @ np_))

    src_in = src[inliers]
    dst_in = dst[inliers]
    best = None
    best_score = -1
    for R, t, n in candidates:
        if np.linalg.det(R) < 0:
            continue
        good = 0
        for a, b in zip(src_in[:50], dst_in[:50]):
            fa = np.array([a[0], a[1], 1.0])
            fa /= np.linalg.norm(fa)
            fb = np.array([b[0], b[1], 1.0])
            fb /= np.linalg.norm(fb)
            A = np.stack([R @ fa, -fb], axis=-1)
            x, *_ = np.linalg.lstsq(A, -t, rcond=None)
            if x[0] > 0 and x[1] > 0:
                good += 1
        if good > best_score:
            best_score = good
            best = (R, t, n)
    if best is None:
        return np.eye(3), np.zeros(3), np.array([0.0, 0, 1.0]), False
    R, t, n = best
    if n[2] < 0:
        n = -n
    return R, t, n, True


class InitResult(NamedTuple):
    R_cur_ref: np.ndarray
    t_cur_ref: np.ndarray
    inliers: np.ndarray  # (N,) bool
    depths_ref: np.ndarray  # (N,) ref-frame ranges (0 where invalid)
    ok: bool


def homography_init(f_ref: np.ndarray, f_cur: np.ndarray, valid: np.ndarray,
                    *, focal: float, reproj_thresh_px: float = 2.0,
                    min_inliers: int = 30, device=None,
                    generator: torch.Generator = None,
                    draws=None) -> InitResult:
    """RANSAC H on unit-plane coords, decomposition, triangulation of the
    inliers (map scale is fixed by the caller)."""
    from plsvo_torch.ops.matcher import triangulate_depth

    device = resolve_device(device)
    src = (f_ref[:, :2] / f_ref[:, 2:3]).astype(np.float32)
    dst = (f_cur[:, :2] / f_cur[:, 2:3]).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    H, inl, n_in = ransac_homography(
        t(src), t(dst), t(valid), float(np.float32(reproj_thresh_px / focal)),
        generator=generator, draws=draws)
    inl = inl.cpu().numpy()
    if int(n_in) < min_inliers:
        return InitResult(np.eye(3), np.zeros(3), inl, np.zeros(len(src)), False)
    R, tt, n, ok = decompose_homography(H.cpu().numpy(), src, dst, inl)
    if not ok:
        return InitResult(np.eye(3), np.zeros(3), inl, np.zeros(len(src)), False)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    d_ref, _, tri_ok = triangulate_depth(f32(R), f32(tt), f32(f_ref), f32(f_cur))
    tri_ok = tri_ok.cpu().numpy() & inl
    depths = np.where(tri_ok, d_ref.cpu().numpy(), 0.0)
    return InitResult(R, tt, tri_ok, depths, True)
