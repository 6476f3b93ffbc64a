"""Matcher ops: affine warp, search-level selection, warped reference
patches, epipolar ZMSSD search, two-view triangulation.

Port of `plsvo_tpu/ops/matcher.py`: the per-level functions
(`warp_patches_affine`, `epipolar_search_zmssd`, `find_match_direct`: the
reference's matcher, one pyramid level at a time) and the atlas forms the
pipeline runs (one pass over a packed pyramid, the same math).
Everything is batched over the feature axis; with a per-row sequence
index `seq` the atlas forms run the rows of B sequences together, each
reading its own sequence's images.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plsvo_torch.batlin import inv2x2
from plsvo_torch.indexing import to_int32
from plsvo_torch.image import (bilinear_sample, bilinear_sample_atlas,
                               bilinear_taps, gather_windows_raw,
                               patch_offsets, sample_in_window)
from plsvo_torch.ops.feature_align import (align2d, align2d_atlas,
                                          align_mixed_atlas,
                                          ref_patch_gradients)


def get_warp_affine(fx, fy, cx, cy, uv_ref, f_ref, depth_ref, level_ref,
                    R_cur_ref, t_cur_ref, halfpatch: int = 5):
    """First-order affine warp A_cur_ref (N,2,2) from projecting the anchor
    point and its du/dv neighbours. R/t are per feature ((N,3,3), (N,3))."""
    xyz_ref = f_ref * depth_ref[..., None]
    step = (1 << level_ref.long()).to(uv_ref.dtype)[..., None]
    z = torch.zeros_like(depth_ref)
    hp = torch.full_like(depth_ref, float(halfpatch))
    du = torch.stack([hp, z], -1) * step
    dv = torch.stack([z, hp], -1) * step

    def unproject_z(uv):
        x = (uv[..., 0] - cx) / fx
        y = (uv[..., 1] - cy) / fy
        return torch.stack([x, y, torch.ones_like(x)], -1)

    r_du = unproject_z(uv_ref + du)
    r_dv = unproject_z(uv_ref + dv)
    xyz_du = r_du * (xyz_ref[..., 2:3] / r_du[..., 2:3])
    xyz_dv = r_dv * (xyz_ref[..., 2:3] / r_dv[..., 2:3])

    def proj_cur(p):
        q = (R_cur_ref @ p[..., None])[..., 0] + t_cur_ref
        qz = torch.where(q[..., 2].abs() < 1e-10, torch.full_like(q[..., 2], 1e-10),
                         q[..., 2])
        return torch.stack([fx * q[..., 0] / qz + cx, fy * q[..., 1] / qz + cy], -1)

    px = proj_cur(xyz_ref)
    col0 = (proj_cur(xyz_du) - px) / halfpatch
    col1 = (proj_cur(xyz_dv) - px) / halfpatch
    return torch.stack([col0, col1], -1)


def best_search_level(A_cur_ref: torch.Tensor, max_level: int) -> torch.Tensor:
    """Pyramid level where the warped patch's area is <= 3."""
    D = (A_cur_ref[..., 0, 0] * A_cur_ref[..., 1, 1]
         - A_cur_ref[..., 0, 1] * A_cur_ref[..., 1, 0]).abs()
    L = torch.ceil(torch.log2((D / 3.0).clamp_min(1e-6)) * 0.5)
    return to_int32(L).clamp(0, max_level)


class EpipolarResult(NamedTuple):
    uv_level: torch.Tensor  # (N,2) best-match px at the search level
    zmssd: torch.Tensor  # (N,)
    ok: torch.Tensor  # (N,)


def zmssd(ref_patch, cur_patch, dim=-1):
    """Zero-mean sum of squared differences (vk::patch_score::ZMSSD)."""
    r = ref_patch - ref_patch.mean(dim, keepdim=True)
    c = cur_patch - cur_patch.mean(dim, keepdim=True)
    return ((r - c) ** 2).sum(dim)


def _linspace01(n: int, device):
    """jnp.linspace(0, 1, n) in f32: i * f32(1 / (n - 1)), the last exactly
    1 (torch.linspace rounds other elements differently)."""
    a = torch.arange(n, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(max(n - 1, 1)))
    a[-1] = 1.0
    return a


def _epipolar_px0(f_A, f_B, n_steps, fx, fy, cx, cy):
    """(N, n_steps, 2) level-0 px of n_steps evenly spaced unit-plane points
    from the projection of f_A to that of f_B."""
    uvA = f_A[..., :2] / f_A[..., 2:3]
    uvB = f_B[..., :2] / f_B[..., 2:3]
    al = _linspace01(n_steps, f_A.device)
    uv_n = uvA[:, None, :] + al[None, :, None] * (uvB - uvA)[:, None, :]
    return torch.stack([fx * uv_n[..., 0] + cx, fy * uv_n[..., 1] + cy], -1)


def _best_step(score, oks, px0, scale):
    """Per row the least score over the steps with full support (inf
    elsewhere; the first minimum on ties, as jnp.argmin takes it) and its
    step's px0 * scale."""
    score = torch.where(oks, score, torch.full_like(score, float("inf")))
    sidx = torch.argmin(score, -1)
    best = score.gather(-1, sidx[:, None])[:, 0]
    uv = px0[torch.arange(px0.shape[0], device=px0.device), sidx]
    return best, uv * scale


def epipolar_search_zmssd(cur_pyr, ref_patch, f_A, f_B, search_level, valid,
                          fx, fy, cx, cy, *, patch_size: int = 8,
                          n_steps: int = 64,
                          threshold_factor: float = 2000.0) -> EpipolarResult:
    """ZMSSD sampled at n_steps points of the epipolar segment between the
    projections of the two depth-extreme bearings f_A, f_B (current-frame
    rays), in each feature's search level of the current pyramid, one level
    at a time. ok: the best score under threshold_factor * patch area."""
    N, P = ref_patch.shape
    px0 = _epipolar_px0(f_A, f_B, n_steps, fx, fy, cx, cy)
    offs = patch_offsets(patch_size, device=ref_patch.device)
    best = torch.full((N,), float("inf"), device=ref_patch.device)
    best_uv = torch.zeros((N, 2), device=ref_patch.device)
    ref_zm = ref_patch - ref_patch.mean(-1, keepdim=True)
    for lvl, img in enumerate(cur_pyr):
        scale = float(np.float32(1.0 / (1 << lvl)))
        vals, ok = bilinear_sample(img, px0[..., None, :] * scale + offs)
        cur_zm = vals - vals.mean(-1, keepdim=True)
        score = ((ref_zm[:, None, :] - cur_zm) ** 2).sum(-1)
        sbest, uv_lvl = _best_step(score, ok.all(-1), px0, scale)
        better = (search_level == lvl) & (sbest < best)
        best = torch.where(better, sbest, best)
        best_uv = torch.where(better[:, None], uv_lvl, best_uv)
    return EpipolarResult(uv_level=best_uv, zmssd=best,
                          ok=valid & (best < threshold_factor * P))


def epipolar_search_zmssd_atlas(cur_atlas, x_off, sizes, ref_patch, f_A, f_B,
                                search_level, valid, fx, fy, cx, cy, *,
                                patch_size: int = 8, n_steps: int = 64,
                                threshold_factor: float = 2000.0
                                ) -> EpipolarResult:
    """epipolar_search_zmssd through the current frame's pyramid atlas: every
    row samples its own search level in one pass."""
    N, P = ref_patch.shape
    px0 = _epipolar_px0(f_A, f_B, n_steps, fx, fy, cx, cy)
    offs = patch_offsets(patch_size, device=ref_patch.device)
    sl = search_level.long()
    scale = 1.0 / (1 << sl).float()
    vals, ok = bilinear_sample_atlas(
        cur_atlas, x_off, sizes, px0[..., None, :] * scale[:, None, None, None]
        + offs, sl[:, None, None])
    ref_zm = ref_patch - ref_patch.mean(-1, keepdim=True)
    cur_zm = vals - vals.mean(-1, keepdim=True)
    score = ((ref_zm[:, None, :] - cur_zm) ** 2).sum(-1)
    best, uv_lvl = _best_step(score, ok.all(-1), px0, scale[:, None])
    return EpipolarResult(
        uv_level=uv_lvl, zmssd=best,
        ok=valid & (best < threshold_factor * P) & torch.isfinite(best))


def _dot3_fma(a, b):
    """f32 3-term dot product as a chain of fused multiply-adds,
    fma(a2, b2, fma(a1, b1, a0*b0)), the order XLA's f32 dot takes. The
    FMA is exact in f64 and rounded once to f32."""
    s = a[..., 0] * b[..., 0]
    for i in (1, 2):
        s = (a[..., i].double() * b[..., i].double() + s.double()).float()
    return s


def triangulate_depth(R_cur_ref, t_cur_ref, f_ref, f_cur):
    """Two-view least-squares depths: d_ref*(R f_ref) - d_cur*f_cur = -t.
    Returns (depth_ref, depth_cur, ok). The 2x2 normal equations of
    near-parallel rays cancel badly in f32 (det ~ sin^2 of the ray angle),
    so their dot products round as the JAX package's do: with plain f32
    sums the depths differ from it by ~2e-4 relative."""
    Rf = _dot3_fma(R_cur_ref, f_ref[..., None, :])
    nt = -t_cur_ref.expand_as(Rf)
    a00, a01, a11 = _dot3_fma(Rf, Rf), _dot3_fma(Rf, -f_cur), _dot3_fma(f_cur, f_cur)
    b0, b1 = _dot3_fma(Rf, nt), _dot3_fma(-f_cur, nt)
    det = a00 * a11 - a01 * a01
    ok = det.abs() > 1e-10
    det_s = torch.where(ok, det, torch.ones_like(det))
    d_ref = (a11 * b0 - a01 * b1) / det_s
    d_cur = (a00 * b1 - a01 * b0) / det_s
    return d_ref, d_cur, ok & (d_ref > 0) & (d_cur > 0)


class MatchResult(NamedTuple):
    uv: torch.Tensor  # (N,2) refined level-0 positions
    level: torch.Tensor  # (N,) search level
    ok: torch.Tensor  # (N,)


def _bordered_offsets(patch_size, device):
    B = patch_size + 2
    r = torch.arange(B, dtype=torch.float32, device=device) - B / 2.0 + 0.5
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)


def warp_patches_affine(pyr_stack, kf_idx, uv_ref, level_ref, A_ref_cur,
                        search_level, patch_size: int = 8):
    """Warped bordered (P+2)^2 reference patches, level by level: each
    feature samples its own keyframe image kf_idx at its anchor level
    level_ref of pyr_stack (levels of (K, h, w)), at uv_ref / 2^level_ref +
    A_ref_cur @ (offsets * 2^search_level). Returns (vals (N, (P+2)^2),
    ok (N,))."""
    N = uv_ref.shape[0]
    dev = uv_ref.device
    offs = _bordered_offsets(patch_size, dev)
    sl = (1 << search_level.long()).float()[:, None, None]
    offs_ref0 = torch.einsum("nij,npj->npi", A_ref_cur, offs[None] * sl)
    out = torch.zeros((N, offs.shape[0]), device=dev)
    ok_out = torch.zeros(N, dtype=torch.bool, device=dev)
    for lvl, imgs in enumerate(pyr_stack):
        pos = uv_ref[:, None, :] * (1.0 / (1 << lvl)) + offs_ref0
        vals, ok = _bilinear_batched(imgs, pos, kf_idx)
        sel = level_ref == lvl
        out = torch.where(sel[:, None], vals, out)
        ok_out = torch.where(sel, ok.all(-1), ok_out)
    return out, ok_out


def warp_patches_affine_atlas(kf_flat, kf_idx, uv_ref, level_ref, A_ref_cur,
                              search_level, patch_size: int = 8,
                              window: int = 24, seq=None):
    """Warped bordered (P+2)^2 reference patches through each feature's own
    keyframe atlas: one (window x window) gather per feature, taps
    interpolated inside it; the anchor level is bumped when the warp's tap
    spacing would not fit. With `seq` (N,), kf_flat.flat is a batch
    (B, H, K*Wa) and row n reads sequence seq[n]'s keyframes. Returns
    (vals (N, (P+2)^2), ok (N,))."""
    dev = uv_ref.device
    offs = _bordered_offsets(patch_size, dev)
    max_level = kf_flat.sizes.shape[0] - 1
    sl = (1 << search_level.long()).float()[:, None, None]
    offs_cur0 = offs[None] * sl
    offs_ref = torch.einsum("nij,npj->npi", A_ref_cur, offs_cur0)
    spacing = torch.sqrt((A_ref_cur * A_ref_cur).sum(1).amax(-1)
                         .clamp_min(1e-12)) * sl[:, 0, 0]
    lref = level_ref.long()
    extra = to_int32(torch.ceil(torch.log2((spacing / 1.9).clamp_min(1.0)))).long()
    extra = torch.minimum(extra.clamp_min(0), (max_level - lref).clamp_min(0))
    lvl_eff = lref + extra
    rescale = 1.0 / (1 << extra).float()
    scale_ref = 1.0 / (1 << lvl_eff).float()
    center = uv_ref * scale_ref[:, None]
    pos = center[:, None, :] + offs_ref * rescale[:, None, None]
    h = kf_flat.sizes[lvl_eff, 0].float()[:, None]
    w = kf_flat.sizes[lvl_eff, 1].float()[:, None]
    u = pos[..., 0]
    v = pos[..., 1]
    in_level = (u >= 0) & (v >= 0) & (u <= w - 1) & (v <= h - 1)
    H, Wt = kf_flat.flat.shape[-2:]
    wp = window
    xo = kf_flat.x_off[lvl_eff] + kf_idx.long() * kf_flat.width.long()
    cu = (torch.floor(center[:, 0]).long() - wp // 2 + 1 + xo).clamp(0, max(Wt - wp, 0))
    cv = (torch.floor(center[:, 1]).long() - wp // 2 + 1).clamp(0, max(H - wp, 0))
    win = gather_windows_raw(kf_flat.flat, torch.stack([cu, cv], -1), wp, seq)
    corner = torch.stack([cu.float() - xo.float(), cv.float()], -1)
    vals, ok = sample_in_window(win, corner, pos)
    vals = torch.where(in_level, vals, torch.zeros_like(vals))
    return vals, (in_level & ok).all(-1)


def _warp_and_level(uv_ref, f_ref, depth_ref, level_ref, R, t, fx, fy, cx,
                    cy, max_level):
    """The affine warp A, whether it is invertible, its inverse (identity
    where it is not) and the search level of each feature."""
    A = get_warp_affine(fx, fy, cx, cy, uv_ref, f_ref, depth_ref, level_ref,
                        R, t)
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    A_ok = det.abs() > 1e-6
    eye = torch.eye(2, dtype=A.dtype, device=A.device)
    A_inv = inv2x2(torch.where(A_ok[:, None, None], A, eye))
    slevel = best_search_level(A, max_level)
    return A, A_ok, A_inv, slevel


def find_match_direct(ref_pyr_stack, cur_pyr, kf_idx, uv_ref, f_ref,
                      depth_ref, level_ref, R_cur_ref, t_cur_ref, uv_cur_init,
                      valid, fx, fy, cx, cy, *, patch_size: int = 8,
                      n_iter: int = 10, max_level: int = 4) -> MatchResult:
    """Batched direct match, level by level (Matcher::findMatchDirect):
    affine-warp the anchor patch from each feature's keyframe pyramid
    (levels of (K, h, w)), pick the search level, then align2d in that
    level of the current pyramid. R/t are per feature. It has no edgelet
    branch, as in the JAX package."""
    A, A_ok, A_inv, slevel = _warp_and_level(
        uv_ref, f_ref, depth_ref, level_ref, R_cur_ref, t_cur_ref, fx, fy, cx,
        cy, max_level)
    patches_b, warp_ok = warp_patches_affine(
        ref_pyr_stack, kf_idx, uv_ref, level_ref, A_inv, slevel,
        patch_size=patch_size)
    ref_patch, ref_dx, ref_dy = ref_patch_gradients(patches_b, patch_size)
    ok0 = valid & warp_ok & A_ok
    uv_out = uv_cur_init
    conv_out = torch.zeros_like(ok0)
    for lvl in range(len(cur_pyr)):
        scale = 1.0 / (1 << lvl)
        sel = slevel == lvl
        res = align2d(cur_pyr[lvl], ref_patch, ref_dx, ref_dy,
                      uv_cur_init * scale, ok0 & sel, patch_size=patch_size,
                      n_iter=n_iter)
        uv_out = torch.where(sel[:, None], res.uv / scale, uv_out)
        conv_out = torch.where(sel, res.converged, conv_out)
    return MatchResult(uv=uv_out, level=slevel, ok=conv_out & ok0)


def find_match_direct_atlas(kf_flat, cur_atlas, cur_x_off, cur_sizes, kf_idx,
                            uv_ref, f_ref, depth_ref, level_ref, R_cur_ref,
                            t_cur_ref, uv_cur_init, valid, fx, fy, cx, cy,
                            ftype=None, grad_dir=None, *, patch_size: int = 8,
                            n_iter: int = 10, max_level: int = 2,
                            has_edgelets: bool = False,
                            seq=None) -> MatchResult:
    """Batched direct match: affine-warp the anchor patch, pick the search
    level, refine in the current frame. With has_edgelets, corners 2-D and
    edgelets 1-D along the warped gradient direction in one mixed GN loop;
    without, every row 2-D through align2d_atlas. With `seq` (N,), the
    atlases are batches over sequences and row n reads sequence seq[n]'s."""
    A, A_ok, A_inv, slevel = _warp_and_level(
        uv_ref, f_ref, depth_ref, level_ref, R_cur_ref, t_cur_ref, fx, fy, cx,
        cy, max_level)
    patches_b, warp_ok = warp_patches_affine_atlas(
        kf_flat, kf_idx, uv_ref, level_ref, A_inv, slevel,
        patch_size=patch_size, seq=seq)
    ref_patch, ref_dx, ref_dy = ref_patch_gradients(patches_b, patch_size)
    ok0 = valid & warp_ok & A_ok
    scale = 1.0 / (1 << slevel.long()).float()
    if has_edgelets and ftype is not None:
        is_edge = ftype == 1
        d_cur = (A @ grad_dir[..., None])[..., 0]
        res = align_mixed_atlas(
            cur_atlas, cur_x_off, cur_sizes, ref_patch, ref_dx, ref_dy,
            uv_cur_init * scale[:, None], d_cur, is_edge, slevel, ok0,
            patch_size=patch_size, n_iter=n_iter, seq=seq)
    else:
        # without edgelets every row refines 2-D in its own 18x18 window
        res = align2d_atlas(
            cur_atlas, cur_x_off, cur_sizes, ref_patch, ref_dx, ref_dy,
            uv_cur_init * scale[:, None], slevel, ok0,
            patch_size=patch_size, n_iter=n_iter, seq=seq)
    return MatchResult(uv=res.uv / scale[:, None], level=slevel,
                       ok=res.converged & ok0)


def _bilinear_batched(imgs, pos, idx=None):
    """Bilinear sample of per-row images at pos (N,T,2): row n reads
    imgs[n] of imgs (N,h,w), or with idx (N,) imgs[idx[n]]."""
    N = pos.shape[0]
    fu, fv, uc, vc, valid = bilinear_taps(pos, *imgs.shape[-2:], 0)
    n = (torch.arange(N, device=imgs.device) if idx is None
         else idx.long())[:, None]
    t00 = imgs[n, vc, uc]
    t01 = imgs[n, vc, uc + 1]
    t10 = imgs[n, vc + 1, uc]
    t11 = imgs[n, vc + 1, uc + 1]
    val = ((1.0 - fu) * (1.0 - fv) * t00 + fu * (1.0 - fv) * t01
           + (1.0 - fu) * fv * t10 + fu * fv * t11)
    return torch.where(valid, val, torch.zeros_like(val)), valid


def epipolar_search_sliding_atlas(cur_atlas, x_off, sizes, ref_patch_border,
                                  f_A, f_B, search_level, valid, fx, fy, cx,
                                  cy, *, patch_size: int = 8,
                                  n_steps: int = 48,
                                  threshold_factor: float = 2000.0,
                                  seq=None) -> EpipolarResult:
    """Sliding-window epipolar ZMSSD: the band is sampled once as a
    (n_steps+P) x P window in epipolar-aligned coordinates; step s's patch
    is rows s..s+P-1 of it. The reference patch is resampled at the rotated
    offsets from its bordered axis-aligned warp. With `seq` (N,), cur_atlas
    is a batch (B, H, W_total) and row n searches atlas seq[n]."""
    N = ref_patch_border.shape[0]
    P = patch_size
    PP = P * P
    dev = ref_patch_border.device
    uvA0 = torch.stack([fx * f_A[:, 0] / f_A[:, 2] + cx,
                        fy * f_A[:, 1] / f_A[:, 2] + cy], -1)
    uvB0 = torch.stack([fx * f_B[:, 0] / f_B[:, 2] + cx,
                        fy * f_B[:, 1] / f_B[:, 2] + cy], -1)
    scale = 1.0 / (1 << search_level.long()).float()
    uvA = uvA0 * scale[:, None]
    uvB = uvB0 * scale[:, None]
    band = torch.linalg.norm(uvB - uvA, dim=-1)
    d = (uvB - uvA) / band.clamp_min(1e-6)[:, None]
    d = torch.where(band[:, None] > 1e-6, d,
                    torch.tensor([[1.0, 0.0]], device=dev))
    nvec = torch.stack([-d[:, 1], d[:, 0]], -1)
    W_rows = n_steps + P
    ii = torch.arange(W_rows, dtype=torch.float32, device=dev) - (P / 2.0 - 0.5)
    jj = torch.arange(P, dtype=torch.float32, device=dev) - (P / 2.0 - 0.5)
    pos = (uvA[:, None, None, :] + d[:, None, None, :] * ii[None, :, None, None]
           + nvec[:, None, None, :] * jj[None, None, :, None])
    sl = search_level.long()
    h_lvl = sizes[sl, 0].float()
    w_lvl = sizes[sl, 1].float()
    in_lvl = ((pos[..., 0] >= 0) & (pos[..., 1] >= 0)
              & (pos[..., 0] <= w_lvl[:, None, None] - 1)
              & (pos[..., 1] <= h_lvl[:, None, None] - 1))
    wb = W_rows + P + 4
    Hf, Wf = cur_atlas.shape[-2:]
    mid = 0.5 * (uvA + uvB)
    xo = x_off[sl]
    cu = (torch.floor(mid[:, 0]).long() - wb // 2 + xo).clamp(0, max(Wf - wb, 0))
    cv = (torch.floor(mid[:, 1]).long() - wb // 2).clamp(0, max(Hf - wb, 0))
    band_win = gather_windows_raw(cur_atlas, torch.stack([cu, cv], -1), wb,
                                  seq)
    band_corner = torch.stack([(cu - xo).float(), cv.float()], -1)
    vals, ok_w = sample_in_window(band_win, band_corner,
                                  pos.reshape(N, W_rows * P, 2))
    win = torch.where(in_lvl, vals.reshape(N, W_rows, P), torch.zeros(()).to(vals))
    ok = ok_w.reshape(N, W_rows, P) & in_lvl

    B = P + 2
    center = (B - 1) / 2.0
    offs = patch_offsets(P, device=dev)
    rot = d[:, None, :] * offs[None, :, 0:1] + nvec[:, None, :] * offs[None, :, 1:2]
    ref_rot, rok = _bilinear_batched(ref_patch_border.reshape(N, B, B),
                                     rot + center)
    ref_ok = rok.all(-1)

    s_idx = (torch.arange(n_steps, device=dev)[:, None]
             + torch.arange(P, device=dev)[None, :])
    patches = win[:, s_idx, :]
    pok = ok[:, s_idx, :].all(-1).all(-1)
    step_on = (torch.arange(n_steps, dtype=torch.float32, device=dev)[None, :]
               <= band.clamp_min(1.0)[:, None])
    pflat = patches.reshape(N, n_steps, PP)
    cur_zm = pflat - pflat.mean(-1, keepdim=True)
    ref_zm = ref_rot - ref_rot.mean(-1, keepdim=True)
    score = ((ref_zm[:, None, :] - cur_zm) ** 2).sum(-1)
    score = torch.where(pok & step_on, score, torch.full_like(score, float("inf")))
    best, sbest = score.min(-1)
    uv_lvl = uvA + d * sbest.float()[:, None]
    ok_out = valid & ref_ok & (best < threshold_factor * PP) & torch.isfinite(best)
    return EpipolarResult(uv_level=uv_lvl, zmssd=best, ok=ok_out)
