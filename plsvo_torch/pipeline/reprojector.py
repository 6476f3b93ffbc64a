"""Reprojector: map -> frame candidate selection + batched refinement.

Port of `plsvo_tpu/pipeline/reprojector.py`: project all landmarks, keep
the best-quality landmark per grid cell (a line by its midpoint's cell),
refine all winners in one `find_match_direct_atlas` batch, then retry the
per-cell runner-ups where the winner failed. `reproject_combined` refines
points and both endpoints of every selected line in one batch (one K2
launch), and its retry round in one more.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from plsvo_torch.image import FlatAtlas, pack_pyramid_atlas
from plsvo_torch.indexing import scatter_drop, segment_max
from plsvo_torch.ops import matcher as matcher_ops
from plsvo_torch.ops.detection import grid_cells


def masked_compact(mask: torch.Tensor, max_out: int):
    """Stable-compact indices of True entries to the front.
    Returns (src_idx (max_out,), valid (max_out,))."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.long(), 0) - 1
    dest = torch.where(mask, rank, torch.full_like(rank, n))
    inv = scatter_drop(torch.full((n,), n, dtype=torch.long, device=mask.device),
                       dest, torch.arange(n, device=mask.device))
    if n >= max_out:
        src = inv[:max_out]
    else:
        src = torch.cat([inv, torch.full((max_out - n,), n, dtype=torch.long,
                                         device=mask.device)])
    ok = src < n
    return torch.where(ok, src, torch.zeros_like(src)), ok


class RefineInputs(NamedTuple):
    kf_idx: torch.Tensor
    uv_ref: torch.Tensor
    f_ref: torch.Tensor
    depth_ref: torch.Tensor
    level_ref: torch.Tensor
    R_ca: torch.Tensor
    t_ca: torch.Tensor
    uv_init: torch.Tensor
    valid: torch.Tensor
    ftype: torch.Tensor
    grad_dir: torch.Tensor


class ReprojResult(NamedTuple):
    lm_idx: torch.Tensor  # (M,) landmark rows
    selected: torch.Tensor  # (M,)
    uv: torch.Tensor  # (M,2)
    level: torch.Tensor  # (M,)
    matched: torch.Tensor  # (M,)
    n_attempts: torch.Tensor
    n_matches: torch.Tensor


class ReprojSegResult(NamedTuple):
    lm_idx: torch.Tensor  # (M,) line landmark rows
    selected: torch.Tensor  # (M,)
    s_uv: torch.Tensor  # (M,2)
    e_uv: torch.Tensor
    level: torch.Tensor  # (M,) the coarser of the two endpoint levels
    matched: torch.Tensor  # (M,) both endpoints refined
    n_attempts: torch.Tensor
    n_matches: torch.Tensor


class RetryInfo(NamedTuple):
    cell_of_row: torch.Tensor  # (M,)
    second_row: torch.Tensor  # (n_cells,) runner-up landmark row, -1 = none


def _rel_pose_to_anchor(kf_R, kf_t, akf_c, R_cur, t_cur):
    R_a = kf_R[akf_c]
    t_a = kf_t[akf_c]
    R_ca = torch.einsum("ij,mkj->mik", R_cur, R_a)
    t_ca = t_cur[None] - torch.einsum("mij,mj->mi", R_ca, t_a)
    anchor_center = -torch.einsum("mji,mj->mi", R_a, t_a)
    return R_ca, t_ca, anchor_center


def _point_anchor_inputs(lm, valid, uv_init, pt_pos, pt_obs_kf, pt_obs_uv,
                         pt_obs_f, pt_obs_level, pt_anchor_kf, pt_anchor_uv,
                         pt_anchor_f, pt_anchor_level, kf_R, kf_t, R_cur, t_cur,
                         pt_anchor_type=None, pt_anchor_dir=None):
    """Warp anchor per landmark row: the stored observation whose viewing
    direction is closest to the current one (else the creation anchor)."""
    obs_kf_l = pt_obs_kf[lm].long()
    obs_ok = obs_kf_l >= 0
    okf_c = obs_kf_l.clamp_min(0)
    obs_center = -torch.einsum("moji,moj->moi", kf_R[okf_c], kf_t[okf_c])
    cur_center = -torch.einsum("ji,j->i", R_cur, t_cur)
    pos = pt_pos[lm]
    dir_cur = pos - cur_center[None]
    dir_cur = dir_cur / torch.linalg.norm(dir_cur, dim=-1,
                                          keepdim=True).clamp_min(1e-9)
    dir_obs = pos[:, None, :] - obs_center
    dir_obs = dir_obs / torch.linalg.norm(dir_obs, dim=-1,
                                          keepdim=True).clamp_min(1e-9)
    cosang = (dir_obs * dir_cur[:, None, :]).sum(-1)
    cosang = torch.where(obs_ok, cosang, torch.full_like(cosang, -2.0))
    best_o = torch.argmax(cosang, -1)
    mi = torch.arange(lm.shape[0], device=lm.device)
    has_obs = obs_ok[mi, best_o]
    akf = torch.where(has_obs, obs_kf_l[mi, best_o], pt_anchor_kf[lm].long())
    a_uv = torch.where(has_obs[:, None], pt_obs_uv[lm][mi, best_o],
                       pt_anchor_uv[lm])
    a_f = torch.where(has_obs[:, None], pt_obs_f[lm][mi, best_o],
                      pt_anchor_f[lm])
    a_level = torch.where(has_obs, pt_obs_level[lm][mi, best_o].long(),
                          pt_anchor_level[lm].long())
    akf_c = akf.clamp_min(0)
    R_ca, t_ca, anchor_center = _rel_pose_to_anchor(kf_R, kf_t, akf_c,
                                                    R_cur, t_cur)
    depth_ref = torch.linalg.norm(pos - anchor_center, dim=-1)
    M = lm.shape[0]
    ft = (pt_anchor_type[lm] if pt_anchor_type is not None
          else torch.zeros(M, dtype=torch.int32, device=lm.device))
    gd = (pt_anchor_dir[lm] if pt_anchor_dir is not None
          else torch.zeros((M, 2), device=lm.device))
    return RefineInputs(kf_idx=akf_c, uv_ref=a_uv, f_ref=a_f,
                        depth_ref=depth_ref, level_ref=a_level, R_ca=R_ca,
                        t_ca=t_ca, uv_init=uv_init, valid=valid & (akf >= 0),
                        ftype=ft, grad_dir=gd)


def _runner_up_by_cell(key, is_winner, active, cell, n_cells, n_rows):
    """Per-cell runner-up landmark row (winners masked out; lowest row on
    ties). Returns (n_cells,), -1 = none."""
    key2 = torch.where(is_winner, torch.zeros_like(key), key)
    cell_best2 = segment_max(key2, cell, n_cells)
    is_second = active & ~is_winner & (key2 == cell_best2[cell]) & (key2 > 0)
    ar = torch.arange(n_rows, device=key.device)
    rowval = torch.where(is_second, n_rows - ar, torch.zeros_like(ar))
    second_val = segment_max(rowval, cell, n_cells)
    return torch.where(second_val > 0, n_rows - second_val,
                       torch.full_like(second_val, -1))


def _project_uv(pos, R_cur, t_cur, fx, fy, cx, cy):
    xyz = pos @ R_cur.T + t_cur
    ok = xyz[:, 2] > 1e-3
    zs = torch.where(ok, xyz[:, 2], torch.ones_like(xyz[:, 2]))
    return torch.stack([fx * xyz[:, 0] / zs + cx, fy * xyz[:, 1] / zs + cy],
                       -1), ok


def _in_img(uv, W, H, margin):
    return ((uv[:, 0] > margin) & (uv[:, 0] < W - margin)
            & (uv[:, 1] > margin) & (uv[:, 1] < H - margin))


def _select_points(pt_pos, pt_status, pt_anchor_kf, pt_anchor_uv, pt_anchor_f,
                   pt_anchor_level, pt_obs_kf, pt_obs_uv, pt_obs_f,
                   pt_obs_level, kf_R, kf_t, img_shape, R_cur, t_cur, fx, fy,
                   cx, cy, *, cell_size, max_out, patch_size,
                   pt_anchor_type=None, pt_anchor_dir=None):
    P = pt_pos.shape[0]
    H, W = img_shape
    nx, ny, n_cells = grid_cells(W, H, cell_size)
    uv, z_ok = _project_uv(pt_pos, R_cur, t_cur, fx, fy, cx, cy)
    status = pt_status.long()
    active = (status > 0) & z_ok & _in_img(uv, W, H, patch_size)
    cell = ((uv[:, 1] / cell_size).to(torch.int64).clamp(0, ny - 1) * nx
            + (uv[:, 0] / cell_size).to(torch.int64).clamp(0, nx - 1))
    ar = torch.arange(P, device=pt_pos.device)
    key = torch.where(active, status * (P + 1) + (P - ar), torch.zeros_like(ar))
    cell_best = segment_max(key, cell, n_cells)
    is_winner = active & (key == cell_best[cell]) & (key > 0)
    lm, sel = masked_compact(is_winner, max_out)
    ri = _point_anchor_inputs(
        lm, sel, uv[lm], pt_pos, pt_obs_kf, pt_obs_uv, pt_obs_f, pt_obs_level,
        pt_anchor_kf, pt_anchor_uv, pt_anchor_f, pt_anchor_level, kf_R, kf_t,
        R_cur, t_cur, pt_anchor_type, pt_anchor_dir)
    retry = RetryInfo(cell_of_row=cell[lm],
                      second_row=_runner_up_by_cell(key, is_winner, active,
                                                    cell, n_cells, P))
    return lm, sel, ri, retry


def _select_segments(ln_spos, ln_epos, ln_status, ln_anchor_kf, ln_anchor_suv,
                     ln_anchor_euv, ln_anchor_sf, ln_anchor_ef,
                     ln_anchor_level, kf_R, kf_t, img_shape, R_cur, t_cur, fx,
                     fy, cx, cy, *, cell_size, max_out, patch_size):
    """Line landmarks: per-cell dedup on the midpoint's cell; refine inputs
    for both endpoints. Returns (lm, sel, ri_start, ri_end, retry)."""
    L = ln_spos.shape[0]
    H, W = img_shape
    nx, ny, n_cells = grid_cells(W, H, cell_size)
    suv, s_ok = _project_uv(ln_spos, R_cur, t_cur, fx, fy, cx, cy)
    euv, e_ok = _project_uv(ln_epos, R_cur, t_cur, fx, fy, cx, cy)
    status = ln_status.long()
    active = ((status > 0) & s_ok & e_ok & _in_img(suv, W, H, patch_size)
              & _in_img(euv, W, H, patch_size))
    mid = 0.5 * (suv + euv)
    cell = ((mid[:, 1] / cell_size).to(torch.int64).clamp(0, ny - 1) * nx
            + (mid[:, 0] / cell_size).to(torch.int64).clamp(0, nx - 1))
    ar = torch.arange(L, device=ln_spos.device)
    key = torch.where(active, status * (L + 1) + (L - ar), torch.zeros_like(ar))
    cell_best = segment_max(key, cell, n_cells)
    is_winner = active & (key == cell_best[cell]) & (key > 0)
    lm, sel = masked_compact(is_winner, max_out)
    ri_s, ri_e = _segment_anchor_inputs(
        lm, sel, suv[lm], euv[lm], ln_spos, ln_epos, ln_anchor_kf,
        ln_anchor_suv, ln_anchor_euv, ln_anchor_sf, ln_anchor_ef,
        ln_anchor_level, kf_R, kf_t, R_cur, t_cur)
    retry = RetryInfo(cell_of_row=cell[lm],
                      second_row=_runner_up_by_cell(key, is_winner, active,
                                                    cell, n_cells, L))
    return lm, sel, ri_s, ri_e, retry


def _segment_anchor_inputs(lm, valid, suv_init, euv_init, ln_spos, ln_epos,
                           ln_anchor_kf, ln_anchor_suv, ln_anchor_euv,
                           ln_anchor_sf, ln_anchor_ef, ln_anchor_level,
                           kf_R, kf_t, R_cur, t_cur):
    """Refine inputs for both endpoints of a set of line-landmark rows:
    2-D rows (corner type, zero gradient direction) warped from the line's
    anchor keyframe."""
    akf = ln_anchor_kf[lm].long()
    akf_c = akf.clamp_min(0)
    R_ca, t_ca, anchor_center = _rel_pose_to_anchor(kf_R, kf_t, akf_c,
                                                    R_cur, t_cur)
    s_depth = torch.linalg.norm(ln_spos[lm] - anchor_center, dim=-1)
    e_depth = torch.linalg.norm(ln_epos[lm] - anchor_center, dim=-1)
    valid0 = valid & (akf >= 0)
    lvl = ln_anchor_level[lm].long()
    M = lm.shape[0]
    zt = torch.zeros(M, dtype=torch.int32, device=lm.device)
    zd = torch.zeros((M, 2), device=lm.device)
    ri_s = RefineInputs(kf_idx=akf_c, uv_ref=ln_anchor_suv[lm],
                        f_ref=ln_anchor_sf[lm], depth_ref=s_depth,
                        level_ref=lvl, R_ca=R_ca, t_ca=t_ca, uv_init=suv_init,
                        valid=valid0, ftype=zt, grad_dir=zd)
    ri_e = RefineInputs(kf_idx=akf_c, uv_ref=ln_anchor_euv[lm],
                        f_ref=ln_anchor_ef[lm], depth_ref=e_depth,
                        level_ref=lvl, R_ca=R_ca, t_ca=t_ca, uv_init=euv_init,
                        valid=valid0, ftype=zt, grad_dir=zd)
    return ri_s, ri_e


def _retry_rows(retry: RetryInfo, failed, max_retry: int):
    lm2_cand = retry.second_row[retry.cell_of_row]
    src2, ok2 = masked_compact(failed & (lm2_cand >= 0), max_retry)
    return lm2_cand[src2].clamp_min(0), ok2


def _refine(kf_flat: FlatAtlas, cur_pyr, ri: RefineInputs, fx, fy, cx, cy, *,
            patch_size, has_edgelets=False):
    cur_atlas, cxo, cs = pack_pyramid_atlas(cur_pyr)
    return matcher_ops.find_match_direct_atlas(
        kf_flat, cur_atlas, cxo, cs, ri.kf_idx, ri.uv_ref, ri.f_ref,
        ri.depth_ref, ri.level_ref, ri.R_ca, ri.t_ca, ri.uv_init, ri.valid,
        fx, fy, cx, cy, ri.ftype, ri.grad_dir, patch_size=patch_size,
        max_level=len(cur_pyr) - 1, has_edgelets=has_edgelets)


def reproject_points(pt_pos, pt_status, pt_anchor_kf, pt_anchor_uv,
                     pt_anchor_f, pt_anchor_level, pt_obs_kf, pt_obs_uv,
                     pt_obs_f, pt_obs_level, kf_R, kf_t, kf_flat, cur_pyr,
                     R_cur, t_cur, fx, fy, cx, cy, *, cell_size: int = 25,
                     max_out: int = 192, patch_size: int = 8,
                     has_edgelets: bool = False, pt_anchor_type=None,
                     pt_anchor_dir=None, retry: bool = True) -> ReprojResult:
    lm, sel, ri, rinfo = _select_points(
        pt_pos, pt_status, pt_anchor_kf, pt_anchor_uv, pt_anchor_f,
        pt_anchor_level, pt_obs_kf, pt_obs_uv, pt_obs_f, pt_obs_level,
        kf_R, kf_t, tuple(cur_pyr[0].shape), R_cur, t_cur, fx, fy, cx, cy,
        cell_size=cell_size, max_out=max_out, patch_size=patch_size,
        pt_anchor_type=pt_anchor_type, pt_anchor_dir=pt_anchor_dir)
    res = _refine(kf_flat, cur_pyr, ri, fx, fy, cx, cy,
                  patch_size=patch_size, has_edgelets=has_edgelets)
    if retry:
        Mr = max(max_out // 8, 8)
        lm2, sel2 = _retry_rows(rinfo, sel & ~res.ok, Mr)
        uv2, _ = _project_uv(pt_pos[lm2], R_cur, t_cur, fx, fy, cx, cy)
        ri2 = _point_anchor_inputs(
            lm2, sel2, uv2, pt_pos, pt_obs_kf, pt_obs_uv, pt_obs_f,
            pt_obs_level, pt_anchor_kf, pt_anchor_uv, pt_anchor_f,
            pt_anchor_level, kf_R, kf_t, R_cur, t_cur, pt_anchor_type,
            pt_anchor_dir)
        res2 = _refine(kf_flat, cur_pyr, ri2, fx, fy, cx, cy,
                       patch_size=patch_size, has_edgelets=has_edgelets)
        lm = torch.cat([lm, lm2])
        sel = torch.cat([sel, sel2])
        res = matcher_ops.MatchResult(*[torch.cat([a, b])
                                        for a, b in zip(res, res2)])
    matched = res.ok & sel
    return ReprojResult(lm_idx=lm, selected=sel, uv=res.uv, level=res.level,
                        matched=matched,
                        n_attempts=sel.sum().to(torch.int32),
                        n_matches=matched.sum().to(torch.int32))


def _cat(*xs):
    return type(xs[0])(*[torch.cat(cols) for cols in zip(*xs)])


def _rows(t, lo, hi):
    return type(t)(*[a[lo:hi] for a in t])


def reproject_combined(pt_pos, pt_status, pt_anchor_kf, pt_anchor_uv,
                       pt_anchor_f, pt_anchor_level, pt_obs_kf, pt_obs_uv,
                       pt_obs_f, pt_obs_level, ln_spos, ln_epos, ln_status,
                       ln_anchor_kf, ln_anchor_suv, ln_anchor_euv,
                       ln_anchor_sf, ln_anchor_ef, ln_anchor_level, kf_R, kf_t,
                       kf_flat, cur_pyr, R_cur, t_cur, fx, fy, cx, cy, *,
                       cell_size: int = 25, cell_size_segs: int = 25,
                       max_pts_out: int = 192, max_segs_out: int = 96,
                       patch_size: int = 8, has_edgelets: bool = False,
                       pt_anchor_type=None, pt_anchor_dir=None):
    """Points + both segment endpoints refined in ONE batch of
    max_pts_out + 2 * max_segs_out rows; one more batch of an eighth of
    each width refines the per-cell runner-ups where the first candidate
    failed, appended as extra result rows.
    Returns (ReprojResult, ReprojSegResult)."""
    img_shape = tuple(cur_pyr[0].shape)
    pt_tabs = (pt_pos, pt_obs_kf, pt_obs_uv, pt_obs_f, pt_obs_level,
               pt_anchor_kf, pt_anchor_uv, pt_anchor_f, pt_anchor_level)
    lt = (ln_spos, ln_epos)
    at = (ln_anchor_kf, ln_anchor_suv, ln_anchor_euv, ln_anchor_sf,
          ln_anchor_ef, ln_anchor_level)
    lm_p, sel_p, ri_p, rinfo_p = _select_points(
        pt_pos, pt_status, pt_anchor_kf, pt_anchor_uv, pt_anchor_f,
        pt_anchor_level, pt_obs_kf, pt_obs_uv, pt_obs_f, pt_obs_level,
        kf_R, kf_t, img_shape, R_cur, t_cur, fx, fy, cx, cy,
        cell_size=cell_size, max_out=max_pts_out, patch_size=patch_size,
        pt_anchor_type=pt_anchor_type, pt_anchor_dir=pt_anchor_dir)
    lm_s, sel_s, ri_s, ri_e, rinfo_s = _select_segments(
        *lt, ln_status, *at, kf_R, kf_t, img_shape, R_cur, t_cur, fx, fy, cx,
        cy, cell_size=cell_size_segs, max_out=max_segs_out,
        patch_size=patch_size)
    res = _refine(kf_flat, cur_pyr, _cat(ri_p, ri_s, ri_e), fx, fy, cx, cy,
                  patch_size=patch_size, has_edgelets=has_edgelets)
    M, G = max_pts_out, max_segs_out
    r_p, r_s, r_e = (_rows(res, 0, M), _rows(res, M, M + G),
                     _rows(res, M + G, M + 2 * G))
    Mr = max(max_pts_out // 8, 8)
    Gr = max(max_segs_out // 8, 8)
    lm_p2, sel_p2 = _retry_rows(rinfo_p, sel_p & ~r_p.ok, Mr)
    uv_p2, _ = _project_uv(pt_pos[lm_p2], R_cur, t_cur, fx, fy, cx, cy)
    ri_p2 = _point_anchor_inputs(
        lm_p2, sel_p2, uv_p2, *pt_tabs, kf_R, kf_t, R_cur, t_cur,
        pt_anchor_type, pt_anchor_dir)
    lm_s2, sel_s2 = _retry_rows(rinfo_s, sel_s & ~(r_s.ok & r_e.ok), Gr)
    suv2, _ = _project_uv(ln_spos[lm_s2], R_cur, t_cur, fx, fy, cx, cy)
    euv2, _ = _project_uv(ln_epos[lm_s2], R_cur, t_cur, fx, fy, cx, cy)
    ri_s2, ri_e2 = _segment_anchor_inputs(
        lm_s2, sel_s2, suv2, euv2, *lt, *at, kf_R, kf_t, R_cur, t_cur)
    res2 = _refine(kf_flat, cur_pyr, _cat(ri_p2, ri_s2, ri_e2), fx, fy,
                   cx, cy, patch_size=patch_size, has_edgelets=has_edgelets)
    r_p = _cat(r_p, _rows(res2, 0, Mr))
    r_s = _cat(r_s, _rows(res2, Mr, Mr + Gr))
    r_e = _cat(r_e, _rows(res2, Mr + Gr, Mr + 2 * Gr))
    lm_p, sel_p = torch.cat([lm_p, lm_p2]), torch.cat([sel_p, sel_p2])
    lm_s, sel_s = torch.cat([lm_s, lm_s2]), torch.cat([sel_s, sel_s2])
    matched = r_p.ok & sel_p
    both = r_s.ok & r_e.ok & sel_s
    return (ReprojResult(lm_idx=lm_p, selected=sel_p, uv=r_p.uv,
                         level=r_p.level, matched=matched,
                         n_attempts=sel_p.sum().to(torch.int32),
                         n_matches=matched.sum().to(torch.int32)),
            ReprojSegResult(lm_idx=lm_s, selected=sel_s, s_uv=r_s.uv,
                            e_uv=r_e.uv, level=torch.maximum(r_s.level, r_e.level),
                            matched=both, n_attempts=sel_s.sum().to(torch.int32),
                            n_matches=both.sum().to(torch.int32)))
