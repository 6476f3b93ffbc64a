"""Reprojector: map -> frame candidate selection + batched refinement.

Port of `plsvo_tpu/pipeline/reprojector.py`: project all landmarks, keep
the best-quality landmark per grid cell (a line by its midpoint's cell),
refine all winners in one `find_match_direct_atlas` batch, then retry the
per-cell runner-ups where the winner failed (`reproject_points`,
`reproject_segments`). `reproject_combined` refines
points and both endpoints of every selected line in one batch (one K2
launch), and its retry round in one more. Tables, poses and images take a
leading batch axis of B sequences (the JAX package's vmap): selection is
per sequence, refinement one batch over all of them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from plsvo_torch.image import FlatAtlas, pack_pyramid_atlas
from plsvo_torch.indexing import segment_max, seq_of_rows, take
from plsvo_torch.ops import matcher as matcher_ops
from plsvo_torch.ops.detection import grid_cells


def masked_compact(mask: torch.Tensor, max_out: int):
    """Stable-compact indices of True entries to the front, along the last
    axis (any leading batch axes). Returns (src_idx (..., max_out),
    valid (..., max_out))."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask.long(), -1) - 1
    W = max(n, max_out)
    dest = torch.where(mask, rank, torch.full_like(rank, W))
    inv = torch.full(mask.shape[:-1] + (W + 1,), n, dtype=torch.long,
                     device=mask.device)
    # ranks are unique; every False entry goes to the discarded slot W
    inv.scatter_(-1, dest, torch.arange(n, device=mask.device).expand_as(dest))
    src = inv[..., :max_out]
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
    R_a = take(kf_R, akf_c)
    t_a = take(kf_t, akf_c)
    R_ca = torch.einsum("bij,bmkj->bmik", R_cur, R_a)
    t_ca = t_cur[:, None] - torch.einsum("bmij,bmj->bmi", R_ca, t_a)
    anchor_center = -torch.einsum("bmji,bmj->bmi", R_a, t_a)
    return R_ca, t_ca, anchor_center


def _point_anchor_inputs(lm, valid, uv_init, pt_pos, pt_obs_kf, pt_obs_uv,
                         pt_obs_f, pt_obs_level, pt_anchor_kf, pt_anchor_uv,
                         pt_anchor_f, pt_anchor_level, kf_R, kf_t, R_cur, t_cur,
                         pt_anchor_type=None, pt_anchor_dir=None):
    """Warp anchor per landmark row: the stored observation whose viewing
    direction is closest to the current one (else the creation anchor).
    Everything per sequence: lm (B, M) are rows of each sequence's tables."""
    B, M = lm.shape
    obs_kf_l = take(pt_obs_kf, lm).long()
    obs_ok = obs_kf_l >= 0
    okf_c = obs_kf_l.clamp_min(0)
    obs_center = -torch.einsum("bmoji,bmoj->bmoi", take(kf_R, okf_c),
                               take(kf_t, okf_c))
    cur_center = -torch.einsum("bji,bj->bi", R_cur, t_cur)
    pos = take(pt_pos, lm)
    dir_cur = pos - cur_center[:, None]
    dir_cur = dir_cur / torch.linalg.norm(dir_cur, dim=-1,
                                          keepdim=True).clamp_min(1e-9)
    dir_obs = pos[:, :, None, :] - obs_center
    dir_obs = dir_obs / torch.linalg.norm(dir_obs, dim=-1,
                                          keepdim=True).clamp_min(1e-9)
    cosang = (dir_obs * dir_cur[:, :, None, :]).sum(-1)
    cosang = torch.where(obs_ok, cosang, torch.full_like(cosang, -2.0))
    best_o = torch.argmax(cosang, -1)

    def at_best(x):
        i = best_o.view((B, M, 1) + (1,) * (x.dim() - 3))
        return x.gather(2, i.expand((B, M, 1) + x.shape[3:]))[:, :, 0]

    has_obs = at_best(obs_ok)
    akf = torch.where(has_obs, at_best(obs_kf_l), take(pt_anchor_kf, lm).long())
    a_uv = torch.where(has_obs[..., None], at_best(take(pt_obs_uv, lm)),
                       take(pt_anchor_uv, lm))
    a_f = torch.where(has_obs[..., None], at_best(take(pt_obs_f, lm)),
                      take(pt_anchor_f, lm))
    a_level = torch.where(has_obs, at_best(take(pt_obs_level, lm)).long(),
                          take(pt_anchor_level, lm).long())
    akf_c = akf.clamp_min(0)
    R_ca, t_ca, anchor_center = _rel_pose_to_anchor(kf_R, kf_t, akf_c,
                                                    R_cur, t_cur)
    depth_ref = torch.linalg.norm(pos - anchor_center, dim=-1)
    ft = (take(pt_anchor_type, lm) if pt_anchor_type is not None
          else torch.zeros((B, M), dtype=torch.int32, device=lm.device))
    gd = (take(pt_anchor_dir, lm) if pt_anchor_dir is not None
          else torch.zeros((B, M, 2), device=lm.device))
    return RefineInputs(kf_idx=akf_c, uv_ref=a_uv, f_ref=a_f,
                        depth_ref=depth_ref, level_ref=a_level, R_ca=R_ca,
                        t_ca=t_ca, uv_init=uv_init, valid=valid & (akf >= 0),
                        ftype=ft, grad_dir=gd)


def _cells_of(uv, cell_size, nx, ny):
    return ((uv[..., 1] / cell_size).to(torch.int64).clamp(0, ny - 1) * nx
            + (uv[..., 0] / cell_size).to(torch.int64).clamp(0, nx - 1))


def _global_cells(cell, n_cells):
    """(B, n) per-sequence cells as one flat segment space of B * n_cells."""
    B = cell.shape[0]
    return (cell + torch.arange(B, device=cell.device)[:, None]
            * n_cells).reshape(-1)


def _runner_up_by_cell(key, is_winner, active, cell, n_cells, n_rows):
    """Per-cell runner-up landmark row of each sequence (winners masked
    out; lowest row on ties). Returns (B, n_cells), -1 = none."""
    B = key.shape[0]
    cg = _global_cells(cell, n_cells)
    key2 = torch.where(is_winner, torch.zeros_like(key), key)
    cell_best2 = segment_max(key2.reshape(-1), cg, B * n_cells)
    is_second = (active & ~is_winner & (key2 == cell_best2[cg].view(key.shape))
                 & (key2 > 0))
    ar = torch.arange(n_rows, device=key.device)
    rowval = torch.where(is_second, n_rows - ar, torch.zeros_like(key))
    second_val = segment_max(rowval.reshape(-1), cg,
                             B * n_cells).view(B, n_cells)
    return torch.where(second_val > 0, n_rows - second_val,
                       torch.full_like(second_val, -1))


def _project_uv(pos, R_cur, t_cur, fx, fy, cx, cy):
    xyz = pos @ R_cur.transpose(-1, -2) + t_cur[:, None, :]
    ok = xyz[..., 2] > 1e-3
    zs = torch.where(ok, xyz[..., 2], torch.ones_like(xyz[..., 2]))
    return torch.stack([fx * xyz[..., 0] / zs + cx,
                        fy * xyz[..., 1] / zs + cy], -1), ok


def _in_img(uv, W, H, margin):
    return ((uv[..., 0] > margin) & (uv[..., 0] < W - margin)
            & (uv[..., 1] > margin) & (uv[..., 1] < H - margin))


def _winners(status, active, cell, n_cells):
    """Best-status landmark per cell of each sequence (lowest row on ties):
    (key, is_winner), both (B, n)."""
    B, n = status.shape
    cg = _global_cells(cell, n_cells)
    ar = torch.arange(n, device=status.device)
    key = torch.where(active, status * (n + 1) + (n - ar), torch.zeros_like(status))
    cell_best = segment_max(key.reshape(-1), cg, B * n_cells)
    is_winner = active & (key == cell_best[cg].view(B, n)) & (key > 0)
    return key, is_winner


def _select_points(pt_pos, pt_status, pt_anchor_kf, pt_anchor_uv, pt_anchor_f,
                   pt_anchor_level, pt_obs_kf, pt_obs_uv, pt_obs_f,
                   pt_obs_level, kf_R, kf_t, img_shape, R_cur, t_cur, fx, fy,
                   cx, cy, *, cell_size, max_out, patch_size,
                   pt_anchor_type=None, pt_anchor_dir=None):
    P = pt_pos.shape[1]
    H, W = img_shape
    nx, ny, n_cells = grid_cells(W, H, cell_size)
    uv, z_ok = _project_uv(pt_pos, R_cur, t_cur, fx, fy, cx, cy)
    status = pt_status.long()
    active = (status > 0) & z_ok & _in_img(uv, W, H, patch_size)
    cell = _cells_of(uv, cell_size, nx, ny)
    key, is_winner = _winners(status, active, cell, n_cells)
    lm, sel = masked_compact(is_winner, max_out)
    ri = _point_anchor_inputs(
        lm, sel, take(uv, lm), pt_pos, pt_obs_kf, pt_obs_uv, pt_obs_f,
        pt_obs_level, pt_anchor_kf, pt_anchor_uv, pt_anchor_f,
        pt_anchor_level, kf_R, kf_t, R_cur, t_cur, pt_anchor_type,
        pt_anchor_dir)
    retry = RetryInfo(cell_of_row=take(cell, lm),
                      second_row=_runner_up_by_cell(key, is_winner, active,
                                                    cell, n_cells, P))
    return lm, sel, ri, retry


def _select_segments(ln_spos, ln_epos, ln_status, ln_anchor_kf, ln_anchor_suv,
                     ln_anchor_euv, ln_anchor_sf, ln_anchor_ef,
                     ln_anchor_level, kf_R, kf_t, img_shape, R_cur, t_cur, fx,
                     fy, cx, cy, *, cell_size, max_out, patch_size):
    """Line landmarks: per-cell dedup on the midpoint's cell; refine inputs
    for both endpoints. Returns (lm, sel, ri_start, ri_end, retry)."""
    L = ln_spos.shape[1]
    H, W = img_shape
    nx, ny, n_cells = grid_cells(W, H, cell_size)
    suv, s_ok = _project_uv(ln_spos, R_cur, t_cur, fx, fy, cx, cy)
    euv, e_ok = _project_uv(ln_epos, R_cur, t_cur, fx, fy, cx, cy)
    status = ln_status.long()
    active = ((status > 0) & s_ok & e_ok & _in_img(suv, W, H, patch_size)
              & _in_img(euv, W, H, patch_size))
    cell = _cells_of(0.5 * (suv + euv), cell_size, nx, ny)
    key, is_winner = _winners(status, active, cell, n_cells)
    lm, sel = masked_compact(is_winner, max_out)
    ri_s, ri_e = _segment_anchor_inputs(
        lm, sel, take(suv, lm), take(euv, lm), ln_spos, ln_epos, ln_anchor_kf,
        ln_anchor_suv, ln_anchor_euv, ln_anchor_sf, ln_anchor_ef,
        ln_anchor_level, kf_R, kf_t, R_cur, t_cur)
    retry = RetryInfo(cell_of_row=take(cell, lm),
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
    B, M = lm.shape
    akf = take(ln_anchor_kf, lm).long()
    akf_c = akf.clamp_min(0)
    R_ca, t_ca, anchor_center = _rel_pose_to_anchor(kf_R, kf_t, akf_c,
                                                    R_cur, t_cur)
    s_depth = torch.linalg.norm(take(ln_spos, lm) - anchor_center, dim=-1)
    e_depth = torch.linalg.norm(take(ln_epos, lm) - anchor_center, dim=-1)
    valid0 = valid & (akf >= 0)
    lvl = take(ln_anchor_level, lm).long()
    zt = torch.zeros((B, M), dtype=torch.int32, device=lm.device)
    zd = torch.zeros((B, M, 2), device=lm.device)
    ri_s = RefineInputs(kf_idx=akf_c, uv_ref=take(ln_anchor_suv, lm),
                        f_ref=take(ln_anchor_sf, lm), depth_ref=s_depth,
                        level_ref=lvl, R_ca=R_ca, t_ca=t_ca, uv_init=suv_init,
                        valid=valid0, ftype=zt, grad_dir=zd)
    ri_e = RefineInputs(kf_idx=akf_c, uv_ref=take(ln_anchor_euv, lm),
                        f_ref=take(ln_anchor_ef, lm), depth_ref=e_depth,
                        level_ref=lvl, R_ca=R_ca, t_ca=t_ca, uv_init=euv_init,
                        valid=valid0, ftype=zt, grad_dir=zd)
    return ri_s, ri_e


def _retry_rows(retry: RetryInfo, failed, max_retry: int):
    lm2_cand = take(retry.second_row, retry.cell_of_row)
    src2, ok2 = masked_compact(failed & (lm2_cand >= 0), max_retry)
    return take(lm2_cand, src2).clamp_min(0), ok2


def _refine(kf_flat: FlatAtlas, cur_pyr, ri: RefineInputs, fx, fy, cx, cy, *,
            patch_size, has_edgelets=False):
    """All rows of all B sequences in one find_match_direct_atlas batch
    (one K2 launch), each row reading its own sequence's atlases."""
    cur_atlas, cxo, cs = pack_pyramid_atlas(cur_pyr)
    B, M = ri.valid.shape

    def flat(a):
        return a.reshape((B * M,) + a.shape[2:])

    res = matcher_ops.find_match_direct_atlas(
        kf_flat, cur_atlas, cxo, cs, *[flat(a) for a in ri[:9]], fx, fy, cx,
        cy, flat(ri.ftype), flat(ri.grad_dir), patch_size=patch_size,
        max_level=len(cur_pyr) - 1, has_edgelets=has_edgelets,
        seq=seq_of_rows(B, M, ri.valid.device))
    return matcher_ops.MatchResult(*[a.reshape((B, M) + a.shape[1:])
                                     for a in res])


def _as_batch_of_one(x):
    if x is None or isinstance(x, (int, float)):
        return x
    if isinstance(x, FlatAtlas):
        return x._replace(flat=x.flat[None])
    if isinstance(x, (list, tuple)):
        return [p[None] for p in x]
    return x[None]


def _unbatched(fn):
    """fn over unbatched tables and poses runs as a batch of one."""
    def wrapper(*args, **kw):
        if args[0].dim() == 3:  # pt_pos (B, P, 3): batched already
            return fn(*args, **kw)
        kw = {k: _as_batch_of_one(v) for k, v in kw.items()}
        out = fn(*[_as_batch_of_one(a) for a in args], **kw)
        if isinstance(out, tuple) and not hasattr(out, "_fields"):
            return tuple(type(r)(*[a[0] for a in r]) for r in out)
        return type(out)(*[a[0] for a in out])
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


@_unbatched
def reproject_points(pt_pos, pt_status, pt_anchor_kf, pt_anchor_uv,
                     pt_anchor_f, pt_anchor_level, pt_obs_kf, pt_obs_uv,
                     pt_obs_f, pt_obs_level, kf_R, kf_t, kf_flat, cur_pyr,
                     R_cur, t_cur, fx, fy, cx, cy, *, cell_size: int = 25,
                     max_out: int = 192, patch_size: int = 8,
                     has_edgelets: bool = False, pt_anchor_type=None,
                     pt_anchor_dir=None, retry: bool = True) -> ReprojResult:
    """Points only. Tables, poses and images take a leading batch axis of B
    sequences (unbatched: a batch of one); dedup, selection and retry run
    per sequence, and all sequences' rows refine in one batch."""
    lm, sel, ri, rinfo = _select_points(
        pt_pos, pt_status, pt_anchor_kf, pt_anchor_uv, pt_anchor_f,
        pt_anchor_level, pt_obs_kf, pt_obs_uv, pt_obs_f, pt_obs_level,
        kf_R, kf_t, tuple(cur_pyr[0].shape[-2:]), R_cur, t_cur, fx, fy, cx,
        cy, cell_size=cell_size, max_out=max_out, patch_size=patch_size,
        pt_anchor_type=pt_anchor_type, pt_anchor_dir=pt_anchor_dir)
    res = _refine(kf_flat, cur_pyr, ri, fx, fy, cx, cy,
                  patch_size=patch_size, has_edgelets=has_edgelets)
    if retry:
        Mr = max(max_out // 8, 8)
        lm2, sel2 = _retry_rows(rinfo, sel & ~res.ok, Mr)
        uv2, _ = _project_uv(take(pt_pos, lm2), R_cur, t_cur, fx, fy, cx, cy)
        ri2 = _point_anchor_inputs(
            lm2, sel2, uv2, pt_pos, pt_obs_kf, pt_obs_uv, pt_obs_f,
            pt_obs_level, pt_anchor_kf, pt_anchor_uv, pt_anchor_f,
            pt_anchor_level, kf_R, kf_t, R_cur, t_cur, pt_anchor_type,
            pt_anchor_dir)
        res2 = _refine(kf_flat, cur_pyr, ri2, fx, fy, cx, cy,
                       patch_size=patch_size, has_edgelets=has_edgelets)
        lm = torch.cat([lm, lm2], 1)
        sel = torch.cat([sel, sel2], 1)
        res = _cat(res, res2)
    matched = res.ok & sel
    return ReprojResult(lm_idx=lm, selected=sel, uv=res.uv, level=res.level,
                        matched=matched,
                        n_attempts=sel.sum(-1).to(torch.int32),
                        n_matches=matched.sum(-1).to(torch.int32))


@_unbatched
def reproject_segments(ln_spos, ln_epos, ln_status, ln_anchor_kf,
                       ln_anchor_suv, ln_anchor_euv, ln_anchor_sf,
                       ln_anchor_ef, ln_anchor_level, kf_R, kf_t, kf_flat,
                       cur_pyr, R_cur, t_cur, fx, fy, cx, cy, *,
                       cell_size: int = 25, max_out: int = 96,
                       patch_size: int = 8,
                       retry: bool = True) -> ReprojSegResult:
    """Line segments only: the best line per cell of its projected
    midpoint, both endpoints refined in a batch each (2-D rows through
    align2d_atlas, as the JAX function, which passes no edgelet flag);
    with retry, the per-cell runner-ups where either endpoint failed, in
    batches of max(max_out // 8, 8) rows, appended as extra result rows.
    Batched as reproject_points."""
    lt = (ln_spos, ln_epos)
    at = (ln_anchor_kf, ln_anchor_suv, ln_anchor_euv, ln_anchor_sf,
          ln_anchor_ef, ln_anchor_level)
    lm, sel, ri_s, ri_e, rinfo = _select_segments(
        *lt, ln_status, *at, kf_R, kf_t, tuple(cur_pyr[0].shape[-2:]), R_cur,
        t_cur, fx, fy, cx, cy, cell_size=cell_size, max_out=max_out,
        patch_size=patch_size)
    res_s = _refine(kf_flat, cur_pyr, ri_s, fx, fy, cx, cy,
                    patch_size=patch_size)
    res_e = _refine(kf_flat, cur_pyr, ri_e, fx, fy, cx, cy,
                    patch_size=patch_size)
    if retry:
        Gr = max(max_out // 8, 8)
        lm2, sel2 = _retry_rows(rinfo, sel & ~(res_s.ok & res_e.ok), Gr)
        suv2, _ = _project_uv(take(ln_spos, lm2), R_cur, t_cur, fx, fy, cx, cy)
        euv2, _ = _project_uv(take(ln_epos, lm2), R_cur, t_cur, fx, fy, cx, cy)
        ri_s2, ri_e2 = _segment_anchor_inputs(
            lm2, sel2, suv2, euv2, *lt, *at, kf_R, kf_t, R_cur, t_cur)
        res_s = _cat(res_s, _refine(kf_flat, cur_pyr, ri_s2, fx, fy, cx, cy,
                                    patch_size=patch_size))
        res_e = _cat(res_e, _refine(kf_flat, cur_pyr, ri_e2, fx, fy, cx, cy,
                                    patch_size=patch_size))
        lm = torch.cat([lm, lm2], 1)
        sel = torch.cat([sel, sel2], 1)
    both = res_s.ok & res_e.ok & sel
    return ReprojSegResult(
        lm_idx=lm, selected=sel, s_uv=res_s.uv, e_uv=res_e.uv,
        level=torch.maximum(res_s.level, res_e.level), matched=both,
        n_attempts=sel.sum(-1).to(torch.int32),
        n_matches=both.sum(-1).to(torch.int32))


def _cat(*xs):
    return type(xs[0])(*[torch.cat(cols, 1) for cols in zip(*xs)])


def _rows(t, lo, hi):
    return type(t)(*[a[:, lo:hi] for a in t])


@_unbatched
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
    max_pts_out + 2 * max_segs_out rows per sequence; one more batch of an
    eighth of each width refines the per-cell runner-ups where the first
    candidate failed, appended as extra result rows. With a leading batch
    axis of B sequences on the tables, poses and images, each sequence
    selects its own rows and both batches hold all B sequences' rows (one
    K2 launch each). Returns (ReprojResult, ReprojSegResult)."""
    img_shape = tuple(cur_pyr[0].shape[-2:])
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
    uv_p2, _ = _project_uv(take(pt_pos, lm_p2), R_cur, t_cur, fx, fy, cx, cy)
    ri_p2 = _point_anchor_inputs(
        lm_p2, sel_p2, uv_p2, *pt_tabs, kf_R, kf_t, R_cur, t_cur,
        pt_anchor_type, pt_anchor_dir)
    lm_s2, sel_s2 = _retry_rows(rinfo_s, sel_s & ~(r_s.ok & r_e.ok), Gr)
    suv2, _ = _project_uv(take(ln_spos, lm_s2), R_cur, t_cur, fx, fy, cx, cy)
    euv2, _ = _project_uv(take(ln_epos, lm_s2), R_cur, t_cur, fx, fy, cx, cy)
    ri_s2, ri_e2 = _segment_anchor_inputs(
        lm_s2, sel_s2, suv2, euv2, *lt, *at, kf_R, kf_t, R_cur, t_cur)
    res2 = _refine(kf_flat, cur_pyr, _cat(ri_p2, ri_s2, ri_e2), fx, fy,
                   cx, cy, patch_size=patch_size, has_edgelets=has_edgelets)
    r_p = _cat(r_p, _rows(res2, 0, Mr))
    r_s = _cat(r_s, _rows(res2, Mr, Mr + Gr))
    r_e = _cat(r_e, _rows(res2, Mr + Gr, Mr + 2 * Gr))
    lm_p, sel_p = torch.cat([lm_p, lm_p2], 1), torch.cat([sel_p, sel_p2], 1)
    lm_s, sel_s = torch.cat([lm_s, lm_s2], 1), torch.cat([sel_s, sel_s2], 1)
    matched = r_p.ok & sel_p
    both = r_s.ok & r_e.ok & sel_s
    return (ReprojResult(lm_idx=lm_p, selected=sel_p, uv=r_p.uv,
                         level=r_p.level, matched=matched,
                         n_attempts=sel_p.sum(-1).to(torch.int32),
                         n_matches=matched.sum(-1).to(torch.int32)),
            ReprojSegResult(lm_idx=lm_s, selected=sel_s, s_uv=r_s.uv,
                            e_uv=r_e.uv, level=torch.maximum(r_s.level, r_e.level),
                            matched=both, n_attempts=sel_s.sum(-1).to(torch.int32),
                            n_matches=both.sum(-1).to(torch.int32)))
