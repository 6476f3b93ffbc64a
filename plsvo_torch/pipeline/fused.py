"""The tracked-frame device step: sparse alignment -> reprojection -> pose
optimization -> structure optimization -> depth-filter seed update, with
one packed result fetch per frame.

Port of the sync path of `plsvo_tpu/pipeline/fused.py`. With has_ls the
reprojection refines points and both segment endpoints in one batch, pose
optimization takes the segment residuals too, structure optimization
refines the selected lines' endpoints with the points, and the seed update
runs point seeds and both line-seed endpoints through one chain. Without
it the segment tables flow through with every row invalid, so row spaces
match the JAX package either way. The fetch is one device-side
concatenation and one `.cpu()`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from plsvo_torch.indexing import (gather_clamped, nonzero_padded, scatter_drop,
                                  top_k_stable)
from plsvo_torch.ops import pose_opt, sparse_align, struct_opt
from plsvo_torch.pipeline import reprojector

CONV_BUDGET = 64  # converged-seed reports per frame


class LastFrameTables(NamedTuple):
    pt_uv: torch.Tensor
    pt_f: torch.Tensor
    pt_depth: torch.Tensor
    pt_valid: torch.Tensor
    seg_suv: torch.Tensor
    seg_euv: torch.Tensor
    seg_sf: torch.Tensor
    seg_ef: torch.Tensor
    seg_sdepth: torch.Tensor
    seg_edepth: torch.Tensor
    seg_valid: torch.Tensor


class MapTables(NamedTuple):
    pt_pos: torch.Tensor
    pt_status: torch.Tensor
    pt_anchor_kf: torch.Tensor
    pt_anchor_uv: torch.Tensor
    pt_anchor_f: torch.Tensor
    pt_anchor_level: torch.Tensor
    pt_anchor_type: torch.Tensor
    pt_anchor_dir: torch.Tensor
    pt_obs_kf: torch.Tensor
    pt_obs_uv: torch.Tensor
    pt_obs_f: torch.Tensor
    pt_obs_level: torch.Tensor
    ln_spos: torch.Tensor
    ln_epos: torch.Tensor
    ln_status: torch.Tensor
    ln_anchor_kf: torch.Tensor
    ln_anchor_suv: torch.Tensor
    ln_anchor_euv: torch.Tensor
    ln_anchor_sf: torch.Tensor
    ln_anchor_ef: torch.Tensor
    ln_anchor_level: torch.Tensor
    ln_obs_kf: torch.Tensor
    ln_obs_sf: torch.Tensor
    ln_obs_ef: torch.Tensor
    kf_R: torch.Tensor
    kf_t: torch.Tensor


class FusedResult(NamedTuple):
    R_f_w: torch.Tensor
    t_f_w: torch.Tensor
    cov: torch.Tensor
    align_seg_alive: torch.Tensor
    pt: reprojector.ReprojResult
    pt_inlier: torch.Tensor
    seg: reprojector.ReprojSegResult
    seg_inlier: torch.Tensor
    st_pt_lm: torch.Tensor
    st_pt_pos: torch.Tensor
    st_pt_valid: torch.Tensor
    st_ln_lm: torch.Tensor
    st_ln_spos: torch.Tensor
    st_ln_epos: torch.Tensor
    st_ln_valid: torch.Tensor


class FullStepResult(NamedTuple):
    fused: FusedResult
    pt_seeds: object  # PointSeeds (stays on the device)
    ln_seeds: object  # LineSeeds (stays on the device)
    pt_conv: object  # (rows[K], depth[K], n_conv, alive (S,), n_starved) or None
    ln_conv: object  # (rows[K], d_s[K], d_e[K], n_conv, alive, n_starved) or None
    mt: MapTables  # map tables with this frame's structure-opt applied


def pack_blob_host(arrays) -> np.ndarray:
    """Concatenate host arrays into ONE flat f32 buffer (one upload)."""
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])


def unpack_blob(blob: torch.Tensor, specs):
    """Slice a flat f32 blob back into tensors; specs: ((shape, kind), ...)
    with kind in {"f32", "bool", "i32"}."""
    out = []
    off = 0
    for shape, kind in specs:
        n = int(np.prod(shape)) if shape else 1
        a = blob[off:off + n].reshape(shape)
        if kind == "bool":
            a = a > 0.5
        elif kind == "i32":
            a = a.to(torch.int32)
        out.append(a)
        off += n
    return out


def last_blob_specs(F: int, G: int, P: int, L: int):
    return (
        ((F, 2), "f32"), ((F, 3), "f32"), ((F,), "f32"), ((F,), "bool"),
        ((G, 2), "f32"), ((G, 2), "f32"), ((G, 3), "f32"), ((G, 3), "f32"),
        ((G,), "f32"), ((G,), "f32"), ((G,), "bool"),
        ((3, 3), "f32"), ((3,), "f32"), ((P,), "f32"), ((L,), "f32"),
    )


def map_tables_from_state(m) -> MapTables:
    """Device MapTables from the MapState mirror (cached device copies)."""
    return MapTables(
        pt_pos=m.dev("pt_pos"), pt_status=m.dev("pt_status"),
        pt_anchor_kf=m.dev("pt_anchor_kf"), pt_anchor_uv=m.dev("pt_anchor_uv"),
        pt_anchor_f=m.dev("pt_anchor_f"),
        pt_anchor_level=m.dev("pt_anchor_level"),
        pt_anchor_type=m.dev("pt_anchor_type"),
        pt_anchor_dir=m.dev("pt_anchor_dir"),
        pt_obs_kf=m.dev_obs("pt_obs_kf"), pt_obs_uv=m.dev_obs("pt_obs_uv"),
        pt_obs_f=m.dev_obs("pt_obs_f"), pt_obs_level=m.dev_obs("pt_obs_level"),
        ln_spos=m.dev("ln_spos"), ln_epos=m.dev("ln_epos"),
        ln_status=m.dev("ln_status"), ln_anchor_kf=m.dev("ln_anchor_kf"),
        ln_anchor_suv=m.dev("ln_anchor_suv"),
        ln_anchor_euv=m.dev("ln_anchor_euv"),
        ln_anchor_sf=m.dev("ln_anchor_sf"), ln_anchor_ef=m.dev("ln_anchor_ef"),
        ln_anchor_level=m.dev("ln_anchor_level"),
        ln_obs_kf=m.dev_obs("ln_obs_kf"), ln_obs_sf=m.dev_obs("ln_obs_sf"),
        ln_obs_ef=m.dev_obs("ln_obs_ef"),
        kf_R=m.dev("kf_R"), kf_t=m.dev("kf_t"))


def _unproject(uv, fx, fy, cx, cy):
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    f = torch.stack([x, y, torch.ones_like(x)], -1)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def track_frame_core(last_pyr, cur_pyr, kf_flat, last: LastFrameTables,
                     R_last, t_last, mt: MapTables, pt_last_optim,
                     ln_last_optim, fx, fy, cx, cy, *,
                     levels: Tuple[int, ...], n_iter_align: int = 30,
                     patch_align: int = 4, cell_size: int = 25,
                     cell_size_segs: int = 25, max_pts_out: int = 192,
                     max_segs_out: int = 96, n_line_samples: int = 8,
                     poseopt_iters: int = 10, poseopt_iters_ref: int = 0,
                     poseopt_thresh: float = 2.0, n_pyr_use: int = 3,
                     has_ls: bool = False, has_edgelets: bool = False,
                     n_struct_pts: int = 20, n_struct_segs: int = 20,
                     struct_iters: int = 5) -> FusedResult:
    dev = last.pt_uv.device
    # ---- 1. sparse image alignment against the last frame ----
    pts_in = sparse_align.AlignPoints(
        xyz_ref=last.pt_f * last.pt_depth[:, None], uv_ref=last.pt_uv,
        valid=last.pt_valid)
    segs_in = sparse_align.make_align_segments(
        last.seg_suv, last.seg_euv, last.seg_sf, last.seg_ef, last.seg_sdepth,
        last.seg_edepth, last.seg_valid, n_samples=n_line_samples,
        fx=fx, fy=fy, cx=cx, cy=cy)
    ares = sparse_align.sparse_img_align(
        last_pyr, cur_pyr, pts_in, segs_in, torch.eye(3, device=dev),
        torch.zeros(3, device=dev), fx, fy, cx, cy, levels=levels,
        n_iter=n_iter_align, patch_size=patch_align)
    R_cur = ares.R @ R_last
    t_cur = ares.R @ t_last + ares.t

    # ---- 2. reprojection + batched refinement (points, and with lines
    # both segment endpoints in the same batch) ----
    pt_args = (mt.pt_pos, mt.pt_status, mt.pt_anchor_kf, mt.pt_anchor_uv,
               mt.pt_anchor_f, mt.pt_anchor_level, mt.pt_obs_kf,
               mt.pt_obs_uv, mt.pt_obs_f, mt.pt_obs_level)
    rkw = dict(has_edgelets=has_edgelets, pt_anchor_type=mt.pt_anchor_type,
               pt_anchor_dir=mt.pt_anchor_dir)
    M = max_segs_out
    if has_ls:
        pt_res, seg_res = reprojector.reproject_combined(
            *pt_args, mt.ln_spos, mt.ln_epos, mt.ln_status, mt.ln_anchor_kf,
            mt.ln_anchor_suv, mt.ln_anchor_euv, mt.ln_anchor_sf,
            mt.ln_anchor_ef, mt.ln_anchor_level, mt.kf_R, mt.kf_t, kf_flat,
            cur_pyr[:n_pyr_use], R_cur, t_cur, fx, fy, cx, cy,
            cell_size=cell_size, cell_size_segs=cell_size_segs,
            max_pts_out=max_pts_out, max_segs_out=max_segs_out, **rkw)
        seg_line = pose_opt.line_coeffs_from_bearings(
            _unproject(seg_res.s_uv, fx, fy, cx, cy),
            _unproject(seg_res.e_uv, fx, fy, cx, cy))
    else:
        pt_res = reprojector.reproject_points(
            *pt_args, mt.kf_R, mt.kf_t, kf_flat, cur_pyr[:n_pyr_use], R_cur,
            t_cur, fx, fy, cx, cy, cell_size=cell_size, max_out=max_pts_out,
            **rkw)
        z2 = torch.zeros((M, 2), device=dev)
        zi = torch.zeros(M, dtype=torch.int32, device=dev)
        zb = torch.zeros(M, dtype=torch.bool, device=dev)
        seg_res = reprojector.ReprojSegResult(
            lm_idx=zi.long(), selected=zb, s_uv=z2, e_uv=z2, level=zi,
            matched=zb, n_attempts=zi[0], n_matches=zi[0])
        seg_line = torch.zeros((M, 3), device=dev)
    pt_f_cur = _unproject(pt_res.uv, fx, fy, cx, cy)
    seg_lm = seg_res.lm_idx
    seg_matched = seg_res.matched

    # ---- 3. pose optimization on the matched features ----
    inp = pose_opt.PoseOptInputs(
        pt_f=pt_f_cur, pt_level=pt_res.level, pt_pos_w=mt.pt_pos[pt_res.lm_idx],
        pt_valid=pt_res.matched, seg_line=seg_line, seg_level=seg_res.level,
        seg_spos_w=mt.ln_spos[seg_lm], seg_epos_w=mt.ln_epos[seg_lm],
        seg_valid=seg_matched)
    pres = pose_opt.optimize_pose(inp, R_cur, t_cur, fx, n_iter=poseopt_iters,
                                  n_iter_ref=poseopt_iters_ref,
                                  reproj_thresh=poseopt_thresh)

    # ---- 4. structure optimization: the least-recently-optimized matches ----
    ninf = torch.full((), -float("inf"), device=dev)
    key_pt = torch.where(pt_res.matched, -pt_last_optim[pt_res.lm_idx], ninf)
    _, sel_i = top_k_stable(key_pt, n_struct_pts)
    st_pt_lm = pt_res.lm_idx[sel_i]
    st_pt_valid = pt_res.matched[sel_i]
    key_sg = torch.where(seg_matched, -ln_last_optim[seg_lm], ninf)
    _, ssel_i = top_k_stable(key_sg, n_struct_segs)
    st_ln_lm = seg_lm[ssel_i]
    st_ln_valid = seg_matched[ssel_i]

    def obs_of(obs_kf, obs_f, rows):
        okf = obs_kf[rows].long()
        kc = okf.clamp_min(0)
        return struct_opt.StructObs(R_f_w=mt.kf_R[kc], t_f_w=mt.kf_t[kc],
                                    f_obs=obs_f[rows], valid=okf >= 0)

    parts = [obs_of(mt.pt_obs_kf, mt.pt_obs_f, st_pt_lm),
             obs_of(mt.ln_obs_kf, mt.ln_obs_sf, st_ln_lm),
             obs_of(mt.ln_obs_kf, mt.ln_obs_ef, st_ln_lm)]
    all_obs = struct_opt.StructObs(*[torch.cat(xs) for xs in zip(*parts)])
    all_pos = torch.cat([mt.pt_pos[st_pt_lm], mt.ln_spos[st_ln_lm],
                         mt.ln_epos[st_ln_lm]])
    all_valid = torch.cat([st_pt_valid, st_ln_valid, st_ln_valid])
    all_new, all_impr = struct_opt.optimize_points(all_pos, all_obs, all_valid,
                                                   n_iter=struct_iters)
    Kp, Kl = n_struct_pts, n_struct_segs
    return FusedResult(
        R_f_w=pres.R, t_f_w=pres.t, cov=pres.cov,
        align_seg_alive=ares.seg_alive, pt=pt_res, pt_inlier=pres.pt_inlier,
        seg=seg_res, seg_inlier=pres.seg_inlier, st_pt_lm=st_pt_lm,
        st_pt_pos=all_new[:Kp], st_pt_valid=st_pt_valid & all_impr[:Kp],
        st_ln_lm=st_ln_lm, st_ln_spos=all_new[Kp:Kp + Kl],
        st_ln_epos=all_new[Kp + Kl:],
        st_ln_valid=st_ln_valid & all_impr[Kp:Kp + Kl] & all_impr[Kp + Kl:])


def apply_struct_to_mt(mt: MapTables, res: FusedResult) -> MapTables:
    """Scatter this frame's structure-opt refinements into the tables."""
    P = mt.pt_pos.shape[0]
    L = mt.ln_spos.shape[0]
    rp = torch.where(res.st_pt_valid, res.st_pt_lm, torch.full_like(res.st_pt_lm, P))
    rl = torch.where(res.st_ln_valid, res.st_ln_lm, torch.full_like(res.st_ln_lm, L))
    return mt._replace(pt_pos=scatter_drop(mt.pt_pos, rp, res.st_pt_pos),
                       ln_spos=scatter_drop(mt.ln_spos, rl, res.st_ln_spos),
                       ln_epos=scatter_drop(mt.ln_epos, rl, res.st_ln_epos))


def _track_frame_step_impl(last_pyr, cur_pyr, kf_flat, last: LastFrameTables,
                           R_last, t_last, pt_last_optim, ln_last_optim,
                           mt: MapTables, pt_seeds, ln_seeds, batch_counter: int,
                           fx, fy, cx, cy, *, update_pt_seeds: bool,
                           update_ln_seeds: bool = False, max_seed_kfs: int,
                           sigma_conv_factor: float, n_pyr_seed: int,
                           pt_width=None, ln_width=None,
                           seed_search_budget: int = 0, n_epi_steps: int = 64,
                           seed_work_budget: int = 0, **kw) -> FullStepResult:
    from plsvo_torch.ops import depth_filter as df

    res = track_frame_core(last_pyr, cur_pyr, kf_flat, last, R_last, t_last,
                           mt, pt_last_optim, ln_last_optim, fx, fy, cx, cy,
                           **kw)
    R_w_kf = mt.kf_R.transpose(-1, -2)
    t_w_kf = -torch.einsum("kji,kj->ki", mt.kf_R, mt.kf_t)
    R_w_cur = res.R_f_w.T
    t_w_cur = -res.R_f_w.T @ res.t_f_w
    pt_conv = ln_conv = None
    if update_pt_seeds or update_ln_seeds:
        # only the live prefix of each table is processed (free rows are
        # allocated lowest-first); the tail is carried as it is
        Wp = (pt_width or pt_seeds.mu.shape[0]) if update_pt_seeds else 0
        Wl = (ln_width or ln_seeds.mu_s.shape[0]) if update_ln_seeds else 0
        pres, lres = df.update_seeds_combined(
            df.PointSeeds(*[a[:Wp] for a in pt_seeds]) if update_pt_seeds else None,
            df.LineSeeds(*[a[:Wl] for a in ln_seeds]) if update_ln_seeds else None,
            R_w_kf, t_w_kf, kf_flat, cur_pyr[:n_pyr_seed], R_w_cur, t_w_cur,
            fx, fy, cx, cy, batch_counter, has_pt=update_pt_seeds,
            has_ln=update_ln_seeds, max_seed_kfs=max_seed_kfs,
            sigma_conv_factor=sigma_conv_factor, max_search=seed_search_budget,
            n_epi_steps=n_epi_steps, pt_work=seed_work_budget)
        if update_pt_seeds:
            pt_seeds = df.PointSeeds(*[torch.cat([new, old[Wp:]])
                                       for new, old in zip(pres.seeds, pt_seeds)])
            rows = nonzero_padded(pres.converged, CONV_BUDGET, pt_seeds.mu.shape[0])
            pt_conv = (rows, gather_clamped(pres.depth_converged, rows),
                       pres.converged.sum(), pt_seeds.alive, pres.skipped.sum())
        if update_ln_seeds:
            ln_seeds = df.LineSeeds(*[torch.cat([new, old[Wl:]])
                                      for new, old in zip(lres.seeds, ln_seeds)])
            rows = nonzero_padded(lres.converged, CONV_BUDGET,
                                  ln_seeds.mu_s.shape[0])
            ln_conv = (rows, gather_clamped(lres.depth_s, rows),
                       gather_clamped(lres.depth_e, rows), lres.converged.sum(),
                       ln_seeds.alive, lres.skipped.sum())
    return FullStepResult(fused=res, pt_seeds=pt_seeds, ln_seeds=ln_seeds,
                          pt_conv=pt_conv, ln_conv=ln_conv,
                          mt=apply_struct_to_mt(mt, res))


def track_frame_step(last_pyr, cur_pyr, kf_flat, blob: torch.Tensor,
                     mt: MapTables, pt_seeds, ln_seeds, batch_counter: int,
                     fx, fy, cx, cy, *, specs, **kw) -> FullStepResult:
    """The complete tracked-frame device step from one packed host blob
    (layout `last_blob_specs`)."""
    (pt_uv, pt_f, pt_depth, pt_valid, seg_suv, seg_euv, seg_sf, seg_ef,
     seg_sdepth, seg_edepth, seg_valid, R_last, t_last, pt_last_optim,
     ln_last_optim) = unpack_blob(blob, specs)
    last = LastFrameTables(pt_uv, pt_f, pt_depth, pt_valid, seg_suv, seg_euv,
                           seg_sf, seg_ef, seg_sdepth, seg_edepth, seg_valid)
    return _track_frame_step_impl(last_pyr, cur_pyr, kf_flat, last, R_last,
                                  t_last, pt_last_optim, ln_last_optim, mt,
                                  pt_seeds, ln_seeds, batch_counter, fx, fy,
                                  cx, cy, **kw)


def _leaves(tree):
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def _rebuild(tree, it):
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return next(it)
    vals = [_rebuild(t, it) for t in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def fetch(tree):
    """Host numpy copy of a tree (tuples / NamedTuples) of device tensors
    through ONE device-side concatenation and ONE `.cpu()`. Integer and
    bool leaves round-trip exactly (all ints are < 2^24)."""
    leaves = _leaves(tree)
    if not leaves:
        return tree
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in leaves]).cpu().numpy()
    out = []
    off = 0
    for x in leaves:
        n = x.numel()
        a = flat[off:off + n].reshape(tuple(x.shape))
        off += n
        if x.dtype == torch.bool:
            a = a > 0.5
        elif not x.dtype.is_floating_point:
            a = np.rint(a).astype(str(x.dtype).replace("torch.", ""))
        out.append(a)
    return _rebuild(tree, iter(out))
