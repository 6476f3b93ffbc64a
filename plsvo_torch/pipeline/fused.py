"""The tracked-frame device step: sparse alignment -> reprojection -> pose
optimization -> structure optimization -> depth-filter seed update, with
one packed result fetch per frame.

Port of `plsvo_tpu/pipeline/fused.py`. With has_ls the reprojection
refines points and both segment endpoints in one batch, pose optimization
takes the segment residuals too, structure optimization refines the
selected lines' endpoints with the points, and the seed update runs point
seeds and both line-seed endpoints through one chain. Without it the
segment tables flow through with every row invalid, so row spaces match
the JAX package either way.

Pipelined mode chains the steps on the device: each step emits the next
frame's align inputs (`build_next_inputs`) and its map tables as a carry;
the next step (`track_frame_step_tables`) takes a raw image, builds its
pyramid, applies the host's delta blob to the carry (`apply_mt_deltas`)
and runs. A fetch is one device-side concatenation (`flatpack`) and one
asynchronous copy into pinned host memory (`submit_fetch`): one of each per
device when the leaves lie on several.

With a mesh (`parallel/mesh.py`) the batched step lists split the batch
over one of its axes and run once per shard (`_shard_mapped_step`); their
result is the Shards of the per-shard results.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from plsvo_torch.image import build_pyramid, ensure_flat_atlas
from plsvo_torch.indexing import (flat_rows, nonzero_padded, scatter_drop,
                                  take, top_k_stable)
from plsvo_torch.ops import pose_opt, sparse_align, struct_opt
from plsvo_torch.parallel.mesh import Shards, on_device, split_rows
from plsvo_torch.parallel.mesh import leaves as _leaves
from plsvo_torch.parallel.mesh import tree_map as _tree_map
from plsvo_torch.pipeline import reprojector
from plsvo_torch.utils.profiling import span

CONV_BUDGET = 64  # converged-seed reports per frame

# Widths of the carry delta blob (the JAX package's): rows that do not fit
# wait for the next frame's blob, since each entry is a whole-row snapshot.
MT_DELTA_DP = 256  # point rows
MT_DELTA_DL = 96  # line rows
MT_DELTA_OP = 256  # point observations
MT_DELTA_OL = 96  # line observations
MT_DELTA_NE = 16  # evicted keyframe slots (at least; see mt_evict_width)


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
    pt_f_cur: torch.Tensor  # (M, 3) bearings of the matched uvs
    seg: reprojector.ReprojSegResult
    seg_inlier: torch.Tensor
    seg_sf_cur: torch.Tensor
    seg_ef_cur: torch.Tensor
    seg_line_cur: torch.Tensor
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
    # compact seed sync: converged rows and depths in CONV_BUDGET entries,
    # the alive mask packed 16 flags to an f32 word (pack_bits16)
    pt_conv: object  # (rows[K], depth[K], n_conv, alive_packed, n_starved) or None
    ln_conv: object  # (rows[K], d_s[K], d_e[K], n_conv, alive_packed, n_starved) or None
    next: object = None  # NextFrameInputs (pipelined mode) or None
    mt: MapTables = None  # map tables with this frame's structure-opt applied


def pack_blob_host(arrays) -> np.ndarray:
    """Concatenate host arrays into ONE flat f32 buffer (one upload)."""
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])


def unpack_blob(blob: torch.Tensor, specs):
    """Slice a flat f32 blob (or a (B, L) batch of blobs) back into tensors;
    specs: ((shape, kind), ...) with kind in {"f32", "bool", "i32"}."""
    out = []
    off = 0
    for shape, kind in specs:
        n = int(np.prod(shape)) if shape else 1
        a = blob[..., off:off + n].reshape(blob.shape[:-1] + tuple(shape))
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


def map_tables_upload(m) -> MapTables:
    """A fresh upload of the mirror's tables, bypassing its cached device
    copies: what a carry must equal once every queued delta is applied."""
    return MapTables(*[m._to_dev(getattr(m, n)) for n in MapTables._fields])


def _unproject(uv, fx, fy, cx, cy):
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    f = torch.stack([x, y, torch.ones_like(x)], -1)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def _scatter_rows(tab, rows, valid, src):
    """tab (B, n, ...) with tab[b, rows[b, k]] = src[b, k] where valid
    (rows out of [0, n) drop); within a sequence the last write wins."""
    B, n = tab.shape[:2]
    flat = scatter_drop(tab.reshape((B * n,) + tab.shape[2:]),
                        flat_rows(rows, n, valid).reshape(-1),
                        src if not torch.is_tensor(src) or src.dim() == 0
                        else src.reshape((-1,) + tab.shape[2:]))
    return flat.reshape(tab.shape)


def _per_seq(v, like):
    """A per-sequence value (number or (B,) tensor) broadcast over the rows
    of `like` (B, n)."""
    if not torch.is_tensor(v):
        return float(v)
    return v.to(torch.float32)[:, None].expand(like.shape)


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
    """The tracked-frame step of B sequences: every input carries a leading
    batch axis (pyramid levels (B, h, w), tables (B, n, ...), poses
    (B, 3, 3)), and every op serves all B sequences in one pass."""
    dev = last.pt_uv.device
    B = R_last.shape[0]
    # ---- 1. sparse image alignment against the last frame ----
    with span("sparse_img_align"):
        pts_in = sparse_align.make_align_points(last.pt_uv, last.pt_f,
                                                last.pt_depth, last.pt_valid)
        segs_in = sparse_align.make_align_segments(
            last.seg_suv, last.seg_euv, last.seg_sf, last.seg_ef,
            last.seg_sdepth, last.seg_edepth, last.seg_valid,
            n_samples=n_line_samples, fx=fx, fy=fy, cx=cx, cy=cy)
        ares = sparse_align.sparse_img_align(
            last_pyr, cur_pyr, pts_in, segs_in,
            torch.eye(3, device=dev).expand(B, 3, 3),
            torch.zeros((B, 3), device=dev), fx, fy, cx, cy, levels=levels,
            n_iter=n_iter_align, patch_size=patch_align)
        R_cur = ares.R @ R_last
        t_cur = (ares.R @ t_last[..., None])[..., 0] + ares.t

    # ---- 2. reprojection + batched refinement (points, and with lines
    # both segment endpoints in the same batch) ----
    with span("reproject"):
        pt_args = (mt.pt_pos, mt.pt_status, mt.pt_anchor_kf, mt.pt_anchor_uv,
                   mt.pt_anchor_f, mt.pt_anchor_level, mt.pt_obs_kf,
                   mt.pt_obs_uv, mt.pt_obs_f, mt.pt_obs_level)
        rkw = dict(has_edgelets=has_edgelets,
                   pt_anchor_type=mt.pt_anchor_type,
                   pt_anchor_dir=mt.pt_anchor_dir)
        M = max_segs_out
        if has_ls:
            pt_res, seg_res = reprojector.reproject_combined(
                *pt_args, mt.ln_spos, mt.ln_epos, mt.ln_status,
                mt.ln_anchor_kf, mt.ln_anchor_suv, mt.ln_anchor_euv,
                mt.ln_anchor_sf, mt.ln_anchor_ef, mt.ln_anchor_level, mt.kf_R,
                mt.kf_t, kf_flat, cur_pyr[:n_pyr_use], R_cur, t_cur, fx, fy,
                cx, cy, cell_size=cell_size, cell_size_segs=cell_size_segs,
                max_pts_out=max_pts_out, max_segs_out=max_segs_out, **rkw)
            seg_sf_cur = _unproject(seg_res.s_uv, fx, fy, cx, cy)
            seg_ef_cur = _unproject(seg_res.e_uv, fx, fy, cx, cy)
            seg_line = pose_opt.line_coeffs_from_bearings(seg_sf_cur,
                                                          seg_ef_cur)
        else:
            pt_res = reprojector.reproject_points(
                *pt_args, mt.kf_R, mt.kf_t, kf_flat, cur_pyr[:n_pyr_use],
                R_cur, t_cur, fx, fy, cx, cy, cell_size=cell_size,
                max_out=max_pts_out, **rkw)
            z2 = torch.zeros((B, M, 2), device=dev)
            zi = torch.zeros((B, M), dtype=torch.int32, device=dev)
            zb = torch.zeros((B, M), dtype=torch.bool, device=dev)
            seg_res = reprojector.ReprojSegResult(
                lm_idx=zi.long(), selected=zb, s_uv=z2, e_uv=z2, level=zi,
                matched=zb, n_attempts=zi[:, 0], n_matches=zi[:, 0])
            seg_line = seg_sf_cur = seg_ef_cur = torch.zeros((B, M, 3),
                                                             device=dev)
        pt_f_cur = _unproject(pt_res.uv, fx, fy, cx, cy)
        seg_lm = seg_res.lm_idx
        seg_matched = seg_res.matched

    # ---- 3. pose optimization on the matched features ----
    with span("optimize_pose"):
        inp = pose_opt.PoseOptInputs(
            pt_f=pt_f_cur, pt_level=pt_res.level,
            pt_pos_w=take(mt.pt_pos, pt_res.lm_idx), pt_valid=pt_res.matched,
            seg_line=seg_line, seg_level=seg_res.level,
            seg_spos_w=take(mt.ln_spos, seg_lm),
            seg_epos_w=take(mt.ln_epos, seg_lm), seg_valid=seg_matched)
        pres = pose_opt.optimize_pose(inp, R_cur, t_cur, fx,
                                      n_iter=poseopt_iters,
                                      n_iter_ref=poseopt_iters_ref,
                                      reproj_thresh=poseopt_thresh)

    # ---- 4. structure optimization: the least-recently-optimized matches
    # of each sequence, all sequences' landmarks in one solve ----
    with span("optimize_points"):
        ninf = torch.full((), -float("inf"), device=dev)
        key_pt = torch.where(pt_res.matched,
                             -take(pt_last_optim, pt_res.lm_idx), ninf)
        _, sel_i = top_k_stable(key_pt, n_struct_pts)
        st_pt_lm = pt_res.lm_idx.gather(1, sel_i)
        st_pt_valid = pt_res.matched.gather(1, sel_i)
        key_sg = torch.where(seg_matched, -take(ln_last_optim, seg_lm), ninf)
        _, ssel_i = top_k_stable(key_sg, n_struct_segs)
        st_ln_lm = seg_lm.gather(1, ssel_i)
        st_ln_valid = seg_matched.gather(1, ssel_i)

        def obs_of(obs_kf, obs_f, rows):
            okf = take(obs_kf, rows).long()
            kc = okf.clamp_min(0)
            return struct_opt.StructObs(R_f_w=take(mt.kf_R, kc),
                                        t_f_w=take(mt.kf_t, kc),
                                        f_obs=take(obs_f, rows),
                                        valid=okf >= 0)

        def rows_of(*xs):
            a = torch.cat(xs, 1)
            return a.reshape((-1,) + a.shape[2:])

        parts = [obs_of(mt.pt_obs_kf, mt.pt_obs_f, st_pt_lm),
                 obs_of(mt.ln_obs_kf, mt.ln_obs_sf, st_ln_lm),
                 obs_of(mt.ln_obs_kf, mt.ln_obs_ef, st_ln_lm)]
        all_obs = struct_opt.StructObs(*[rows_of(*xs) for xs in zip(*parts)])
        all_pos = rows_of(take(mt.pt_pos, st_pt_lm),
                          take(mt.ln_spos, st_ln_lm),
                          take(mt.ln_epos, st_ln_lm))
        all_valid = rows_of(st_pt_valid, st_ln_valid, st_ln_valid)
        all_new, all_impr = struct_opt.optimize_points(
            all_pos, all_obs, all_valid, n_iter=struct_iters)
        all_new = all_new.reshape(B, -1, 3)
        all_impr = all_impr.reshape(B, -1)
    Kp, Kl = n_struct_pts, n_struct_segs
    return FusedResult(
        R_f_w=pres.R, t_f_w=pres.t, cov=pres.cov,
        align_seg_alive=ares.seg_alive, pt=pt_res, pt_inlier=pres.pt_inlier,
        pt_f_cur=pt_f_cur, seg=seg_res, seg_inlier=pres.seg_inlier,
        seg_sf_cur=seg_sf_cur, seg_ef_cur=seg_ef_cur, seg_line_cur=seg_line,
        st_pt_lm=st_pt_lm,
        st_pt_pos=all_new[:, :Kp], st_pt_valid=st_pt_valid & all_impr[:, :Kp],
        st_ln_lm=st_ln_lm, st_ln_spos=all_new[:, Kp:Kp + Kl],
        st_ln_epos=all_new[:, Kp + Kl:],
        st_ln_valid=(st_ln_valid & all_impr[:, Kp:Kp + Kl]
                     & all_impr[:, Kp + Kl:]))


def apply_struct_to_mt(mt: MapTables, res: FusedResult) -> MapTables:
    """Scatter this frame's structure-opt refinements into the tables (the
    host applies the same values to its mirror when it fetches them); with
    or without a leading batch axis."""
    if mt.kf_R.dim() == 3:
        return _first(apply_struct_to_mt(_one(mt), _one(res)))
    return mt._replace(
        pt_pos=_scatter_rows(mt.pt_pos, res.st_pt_lm, res.st_pt_valid,
                             res.st_pt_pos),
        ln_spos=_scatter_rows(mt.ln_spos, res.st_ln_lm, res.st_ln_valid,
                              res.st_ln_spos),
        ln_epos=_scatter_rows(mt.ln_epos, res.st_ln_lm, res.st_ln_valid,
                              res.st_ln_epos))


# ---------------------------------------------------------------------------
# The map carry (pipelined mode). Host-initiated map changes (harvested
# landmarks, status changes, keyframe installs and evictions, BA
# write-backs) ship as ONE flat f32 blob per frame, built by
# MapState.pack_mt_deltas in the JAX package's layout (ints < 2^24):
#   [NE]                   evicted keyframe slots (-1 = none)
#   [K*9 + K*3]            kf_R, kf_t (a whole copy every frame)
#   point rows (DP wide):  idx, mask, obs_reset, pos(3), status, anchor_kf,
#                          anchor_uv(2), anchor_f(3), anchor_level,
#                          anchor_type, anchor_dir(2)
#   line rows (DL wide):   idx, mask, obs_reset, spos(3), epos(3), status,
#                          anchor_kf, anchor_suv(2), anchor_euv(2),
#                          anchor_sf(3), anchor_ef(3), anchor_level
#   point obs (OP wide):   row, slot, mask, kf, uv(2), f(3), level
#   line obs (OL wide):    row, slot, mask, kf, sf(3), ef(3)
# Applied in this order: eviction sweeps, row deltas (with their obs
# resets), obs writes; a slot evicted and reused between two blobs is
# cleared first and then takes the new keyframe's observations.
# ---------------------------------------------------------------------------


def mt_delta_len(K: int, DP: int = MT_DELTA_DP, DL: int = MT_DELTA_DL,
                 OP: int = MT_DELTA_OP, OL: int = MT_DELTA_OL,
                 NE: int = MT_DELTA_NE) -> int:
    return NE + K * 12 + DP * 17 + DL * 22 + OP * 10 + OL * 10


def mt_evict_width(max_kfs: int, pipeline_depth: int) -> int:
    """Eviction slots of a delta blob. Each finished frame evicts at most
    one keyframe, and between two blobs the host finishes at most two
    drain windows of pipeline_depth frames (flush() bookkeeps the window
    in flight and its own), so the list never spills. Up to depth 8 with
    the default max_kfs this is the JAX package's 16."""
    return max(MT_DELTA_NE, max_kfs, 2 * pipeline_depth)


def _scatter_obs(tab, rows_g, slots, src):
    """tab[b, r, slots[k]] = src[k] for (B, P, O, ...) tab, where rows_g (k,)
    are rows of the tables flattened to (B * P) (B * P: dropped)."""
    B, P, O = tab.shape[:3]
    n = B * P
    flat = torch.where(rows_g < n, rows_g * O + slots,
                       torch.full_like(rows_g, n * O))
    out = scatter_drop(tab.reshape((n * O,) + tab.shape[3:]), flat, src)
    return out.reshape(tab.shape)


def apply_mt_deltas(mt: MapTables, blob: torch.Tensor, *,
                    DP: int = MT_DELTA_DP, DL: int = MT_DELTA_DL,
                    OP: int = MT_DELTA_OP, OL: int = MT_DELTA_OL,
                    NE: int = MT_DELTA_NE) -> MapTables:
    """A host delta blob applied to the device carry, with no host sync;
    rows outside the tables drop, as the JAX package's mode="drop". A
    (B, L) batch of blobs applies to a carry with a leading batch axis,
    each sequence's blob to its own tables, all in one pass."""
    if blob.dim() == 1:
        return MapTables(*[a[0] for a in apply_mt_deltas(
            MapTables(*[a[None] for a in mt]), blob[None], DP=DP, DL=DL,
            OP=OP, OL=OL, NE=NE)])
    B, K = mt.kf_R.shape[:2]
    P = mt.pt_pos.shape[1]
    L = mt.ln_spos.shape[1]
    off = 0

    def take_(n, shape=None):
        nonlocal off
        a = blob[:, off:off + n]
        off += n
        return a if shape is None else a.reshape((B,) + shape)

    def flat(a):
        return a.reshape((-1,) + a.shape[2:])

    evict = take_(NE).to(mt.pt_obs_kf.dtype)
    kf_R = take_(K * 9, (K, 3, 3))
    kf_t = take_(K * 3, (K, 3))

    # 1. eviction sweeps of the observation tables
    def sweep(obs_kf):
        hit = (obs_kf[..., None] == evict[:, None, None, :]).any(-1)
        return torch.where(hit, torch.full_like(obs_kf, -1), obs_kf)

    pt_obs_kf = sweep(mt.pt_obs_kf)
    ln_obs_kf = sweep(mt.ln_obs_kf)

    def row_head(width, cap):
        rows = take_(width).long()
        mask = take_(width) > 0.5
        reset = take_(width) > 0.5
        return (flat_rows(rows, cap, mask).reshape(-1),
                flat_rows(rows, cap, mask & reset).reshape(-1))

    def scatter_flat(tab, rows_g, src):
        n = tab.shape[0] * tab.shape[1]
        out = scatter_drop(tab.reshape((n,) + tab.shape[2:]), rows_g, src)
        return out.reshape(tab.shape)

    # 2. point rows, then their obs resets
    rp, rp_reset = row_head(DP, P)
    new = dict(kf_R=kf_R, kf_t=kf_t)
    for name, width in (("pt_pos", 3), ("pt_status", 1), ("pt_anchor_kf", 1),
                        ("pt_anchor_uv", 2), ("pt_anchor_f", 3),
                        ("pt_anchor_level", 1), ("pt_anchor_type", 1),
                        ("pt_anchor_dir", 2)):
        tab = getattr(mt, name)
        new[name] = scatter_flat(tab, rp, flat(take_(
            DP * width, (DP,) + tab.shape[2:])))
    pt_obs_kf = scatter_flat(pt_obs_kf, rp_reset, -1)
    # 3. line rows, then their obs resets
    rl, rl_reset = row_head(DL, L)
    for name, width in (("ln_spos", 3), ("ln_epos", 3), ("ln_status", 1),
                        ("ln_anchor_kf", 1), ("ln_anchor_suv", 2),
                        ("ln_anchor_euv", 2), ("ln_anchor_sf", 3),
                        ("ln_anchor_ef", 3), ("ln_anchor_level", 1)):
        tab = getattr(mt, name)
        new[name] = scatter_flat(tab, rl, flat(take_(
            DL * width, (DL,) + tab.shape[2:])))
    ln_obs_kf = scatter_flat(ln_obs_kf, rl_reset, -1)

    # 4.-5. observation writes
    def obs_head(width, cap):
        rows = take_(width).long()
        slots = take_(width).long().reshape(-1)
        mask = take_(width) > 0.5
        return flat_rows(rows, cap, mask).reshape(-1), slots

    orp, osp = obs_head(OP, P)
    new["pt_obs_kf"] = _scatter_obs(pt_obs_kf, orp, osp, flat(take_(OP)))
    new["pt_obs_uv"] = _scatter_obs(mt.pt_obs_uv, orp, osp,
                                    flat(take_(OP * 2, (OP, 2))))
    new["pt_obs_f"] = _scatter_obs(mt.pt_obs_f, orp, osp,
                                   flat(take_(OP * 3, (OP, 3))))
    new["pt_obs_level"] = _scatter_obs(mt.pt_obs_level, orp, osp,
                                       flat(take_(OP)))
    orl, osl = obs_head(OL, L)
    new["ln_obs_kf"] = _scatter_obs(ln_obs_kf, orl, osl, flat(take_(OL)))
    new["ln_obs_sf"] = _scatter_obs(mt.ln_obs_sf, orl, osl,
                                    flat(take_(OL * 3, (OL, 3))))
    new["ln_obs_ef"] = _scatter_obs(mt.ln_obs_ef, orl, osl,
                                    flat(take_(OL * 3, (OL, 3))))
    return mt._replace(**new)


def carry_mismatches(carry: MapTables, fresh: MapTables):
    """Names of the carry's tables that differ from a fresh upload of the
    mirror (exact comparison). An observation slot's payload counts only
    where its keyframe id is live: an eviction sweep clears the id and
    leaves the payload, as the mirror's own device copy does."""
    bad = []
    for name in MapTables._fields:
        a, b = getattr(carry, name).cpu(), getattr(fresh, name).cpu()
        if "_obs_" in name and not name.endswith("obs_kf"):
            live = getattr(carry, name.split("_obs_")[0] + "_obs_kf").cpu() >= 0
            a, b = a[live], b[live]
        if a.shape != b.shape or not torch.equal(a, b.to(a.dtype)):
            bad.append(name)
    return bad


def pack_bits16(mask: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (..., ceil(N/16)) f32 words of exact 16-bit
    integers."""
    pad = (-mask.shape[-1]) % 16
    m = torch.cat([mask, mask.new_zeros(mask.shape[:-1] + (pad,))], -1)
    m = m.reshape(mask.shape[:-1] + (-1, 16)).to(torch.int32)
    bits = torch.arange(16, dtype=torch.int32, device=mask.device)
    return (m << bits).sum(-1).to(torch.float32)


def unpack_bits16(words, n: int) -> np.ndarray:
    """Inverse of pack_bits16 on fetched host words."""
    w = np.asarray(words, np.int64)
    bits = (w[:, None] >> np.arange(16)[None, :]) & 1
    return bits.reshape(-1)[:n].astype(bool)


class NextFrameInputs(NamedTuple):
    """The next frame's step inputs, built on the device from this frame's
    results (pipelined mode): its align tables, its reference pose, the
    last-optimized stamps and this frame's pyramid."""

    last: LastFrameTables
    R_last: torch.Tensor  # the optimized pose, Gram-Schmidt stabilised
    t_last: torch.Tensor
    pt_last_optim: torch.Tensor  # (P,) f32, stamped with this frame's
    ln_last_optim: torch.Tensor  # structure-opt selections
    pyr: object = None  # tuple of levels: the next step's last_pyr


def _gram_schmidt(R):
    """Row-wise Gram-Schmidt, the host's drift control in _post_fused."""
    r0, r1 = R[..., 0, :], R[..., 1, :]
    x = r0 / torch.linalg.norm(r0, dim=-1, keepdim=True).clamp_min(1e-12)
    y = r1 - (x * r1).sum(-1, keepdim=True) * x
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.stack([x, y, torch.linalg.cross(x, y)], -2)


def build_next_inputs(res: FusedResult, mt: MapTables, pt_last_optim,
                      ln_last_optim, frame_id, cur_pyr=None) -> NextFrameInputs:
    """The next frame's align inputs from this frame's results, on the
    device, for B sequences (frame_id a number or (B,) tensor). As the
    host's last-frame blob, except that landmark deletions the host decides
    from its counters reach these tables one frame later (a just-deleted
    landmark can take part in one more alignment). Unbatched inputs run as
    a batch of one."""
    if res.R_f_w.dim() == 2:
        return _first(build_next_inputs(
            _one(res), _one(mt), pt_last_optim[None], ln_last_optim[None],
            frame_id, None if cur_pyr is None else _one(list(cur_pyr))))
    R = _gram_schmidt(res.R_f_w)
    t = res.t_f_w
    center = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    lm, slm = res.pt.lm_idx, res.seg.lm_idx  # rows not selected: any value

    def rows(tab, r):
        return take(tab, r.clamp(0, tab.shape[1] - 1))

    def dist(tab, r):
        return torch.linalg.norm(rows(tab, r) - center[:, None], dim=-1)

    pt_valid = res.pt.matched & res.pt_inlier & (rows(mt.pt_status, lm) > 0)
    seg_valid = (res.seg.matched & res.seg_inlier
                 & (rows(mt.ln_status, slm) > 0))
    pt_depth = dist(mt.pt_pos, lm)
    s_depth, e_depth = dist(mt.ln_spos, slm), dist(mt.ln_epos, slm)
    last = LastFrameTables(
        pt_uv=res.pt.uv, pt_f=res.pt_f_cur, pt_depth=pt_depth,
        pt_valid=pt_valid, seg_suv=res.seg.s_uv, seg_euv=res.seg.e_uv,
        seg_sf=res.seg_sf_cur, seg_ef=res.seg_ef_cur, seg_sdepth=s_depth,
        seg_edepth=e_depth, seg_valid=seg_valid)
    plo = _scatter_rows(pt_last_optim, res.st_pt_lm, res.st_pt_valid,
                        _per_seq(frame_id, res.st_pt_lm))
    llo = _scatter_rows(ln_last_optim, res.st_ln_lm, res.st_ln_valid,
                        _per_seq(frame_id, res.st_ln_lm))
    return NextFrameInputs(last=last, R_last=R, t_last=t, pt_last_optim=plo,
                           ln_last_optim=llo,
                           pyr=None if cur_pyr is None else tuple(cur_pyr))


def _track_frame_step_impl(last_pyr, cur_pyr, kf_flat, last: LastFrameTables,
                           R_last, t_last, pt_last_optim, ln_last_optim,
                           mt: MapTables, pt_seeds, ln_seeds, batch_counter,
                           fx, fy, cx, cy, *, update_pt_seeds: bool,
                           update_ln_seeds: bool = False, max_seed_kfs: int,
                           sigma_conv_factor: float, n_pyr_seed: int,
                           emit_next: bool = False, frame_id=None,
                           pt_width=None, ln_width=None,
                           seed_search_budget: int = 0, n_epi_steps: int = 64,
                           seed_work_budget: int = 0, **kw) -> FullStepResult:
    """The complete step of B sequences (every input with a leading batch
    axis; batch_counter and frame_id numbers or (B,) tensors)."""
    from plsvo_torch.ops import depth_filter as df

    res = track_frame_core(last_pyr, cur_pyr, kf_flat, last, R_last, t_last,
                           mt, pt_last_optim, ln_last_optim, fx, fy, cx, cy,
                           **kw)
    with span("update_seeds"):
        R_w_kf = mt.kf_R.transpose(-1, -2)
        t_w_kf = -torch.einsum("bkji,bkj->bki", mt.kf_R, mt.kf_t)
        R_w_cur = res.R_f_w.transpose(-1, -2)
        t_w_cur = -(R_w_cur @ res.t_f_w[..., None])[..., 0]
        pt_conv = ln_conv = None
        if update_pt_seeds or update_ln_seeds:
            # only the live prefix of each table is processed (free rows are
            # allocated lowest-first); the tail is carried as it is
            Wp = (pt_width or pt_seeds.mu.shape[1]) if update_pt_seeds else 0
            Wl = (ln_width or ln_seeds.mu_s.shape[1]) if update_ln_seeds else 0
            pt_in = (df.PointSeeds(*[a[:, :Wp] for a in pt_seeds])
                     if update_pt_seeds else None)
            ln_in = (df.LineSeeds(*[a[:, :Wl] for a in ln_seeds])
                     if update_ln_seeds else None)
            pres, lres = df.update_seeds_combined(
                pt_in, ln_in, R_w_kf, t_w_kf, kf_flat, cur_pyr[:n_pyr_seed],
                R_w_cur, t_w_cur, fx, fy, cx, cy, batch_counter,
                has_pt=update_pt_seeds, has_ln=update_ln_seeds,
                max_seed_kfs=max_seed_kfs,
                sigma_conv_factor=sigma_conv_factor,
                max_search=seed_search_budget, n_epi_steps=n_epi_steps,
                pt_work=seed_work_budget)

            def at(a, r, w):
                return a.gather(1, r.clamp_max(w - 1))

            if update_pt_seeds:
                pt_seeds = df.PointSeeds(*[
                    torch.cat([new, old[:, Wp:]], 1)
                    for new, old in zip(pres.seeds, pt_seeds)])
                rows = nonzero_padded(pres.converged, CONV_BUDGET,
                                      pt_seeds.mu.shape[1])
                pt_conv = (rows, at(pres.depth_converged, rows, Wp),
                           pres.converged.sum(-1),
                           pack_bits16(pt_seeds.alive), pres.skipped.sum(-1))
            if update_ln_seeds:
                ln_seeds = df.LineSeeds(*[
                    torch.cat([new, old[:, Wl:]], 1)
                    for new, old in zip(lres.seeds, ln_seeds)])
                rows = nonzero_padded(lres.converged, CONV_BUDGET,
                                      ln_seeds.mu_s.shape[1])
                ln_conv = (rows, at(lres.depth_s, rows, Wl),
                           at(lres.depth_e, rows, Wl),
                           lres.converged.sum(-1),
                           pack_bits16(ln_seeds.alive),
                           lres.skipped.sum(-1))
    nxt = None
    if emit_next:
        nxt = build_next_inputs(res, mt, pt_last_optim, ln_last_optim,
                                frame_id, cur_pyr=cur_pyr)
    return FullStepResult(fused=res, pt_seeds=pt_seeds, ln_seeds=ln_seeds,
                          pt_conv=pt_conv, ln_conv=ln_conv, next=nxt,
                          mt=apply_struct_to_mt(mt, res))


def stack_trees(trees):
    """One tree whose tensors stack the given same-shaped trees' along a new
    leading axis."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.stack(trees)
    if isinstance(first, (tuple, list)):
        vals = [stack_trees(list(xs)) for xs in zip(*trees)]
        return type(first)(*vals) if hasattr(first, "_fields") else type(first)(vals)
    return first


def _one(tree):
    return _tree_map(lambda a: a[None], tree)


def _one_atlas(kf_flat):
    return kf_flat._replace(flat=kf_flat.flat[None])


def _first(tree):
    return _tree_map(lambda a: a[0], tree)


def track_frame_step(last_pyr, cur_pyr, kf_flat, blob: torch.Tensor,
                     mt: MapTables, pt_seeds, ln_seeds, batch_counter: int,
                     fx, fy, cx, cy, *, specs, **kw) -> FullStepResult:
    """The complete tracked-frame device step of one sequence from one
    packed host blob (layout `last_blob_specs`): the batched step with a
    batch of one. With emit_next=True (and frame_id) it also returns the
    next frame's inputs."""
    return _first(_step_from_blob(
        _one(list(last_pyr)), _one(list(cur_pyr)), _one_atlas(kf_flat),
        blob[None],
        _one(mt), _one(pt_seeds), _one(ln_seeds), batch_counter, fx, fy, cx,
        cy, specs=specs, **kw))


def _last_from_blob(blob, specs):
    """(LastFrameTables, R_last, t_last, pt_last_optim, ln_last_optim) of a
    blob in the last_blob_specs layout."""
    parts = unpack_blob(blob, specs)
    return (LastFrameTables(*parts[:11]),) + tuple(parts[11:])


def _step_from_blob(last_pyr, cur_pyr, kf_flat, blob, mt, pt_seeds, ln_seeds,
                    batch_counter, fx, fy, cx, cy, *, specs, **kw):
    last, R_last, t_last, plo, llo = _last_from_blob(blob, specs)
    return _track_frame_step_impl(last_pyr, cur_pyr, kf_flat, last, R_last,
                                  t_last, plo, llo, mt, pt_seeds, ln_seeds,
                                  batch_counter, fx, fy, cx, cy, **kw)


def track_frame_core_blob(last_pyr, cur_pyr, kf_pyr, blob: torch.Tensor,
                          mt: MapTables, fx, fy, cx, cy, *, specs,
                          **kw) -> FusedResult:
    """track_frame_core of one sequence with the per-frame host tables
    delivered as ONE packed upload (`pack_blob_host` in the
    `last_blob_specs` layout). kf_pyr is a FlatAtlas or a list of
    (K, h, w) keyframe pyramid levels; the rest as track_frame_core's,
    without the batch axis."""
    last, R_last, t_last, plo, llo = _last_from_blob(blob[None], specs)
    return _first(track_frame_core(
        _one(list(last_pyr)), _one(list(cur_pyr)),
        _one_atlas(ensure_flat_atlas(kf_pyr)), last, R_last, t_last, _one(mt),
        plo, llo, fx, fy, cx, cy, **kw))


def track_frame_step_list(last_pyrs, cur_pyr, kf_flat, blobs, mts,
                          bc_fid: torch.Tensor, pt_seeds, ln_seeds, fx, fy,
                          cx, cy, *, specs, mesh=None, mesh_axis: str = "seq",
                          **kw) -> FullStepResult:
    """The tracked-frame step of B sequences at once (the JAX package's
    vmapped `track_frame_step_list`): the per-sequence last pyramids, blobs
    and map tables are stacked here; cur_pyr is the stacked pyramid of the
    new images (levels (B, h, w)), kf_flat the stacked keyframe atlas
    (flat (B, H, K*Wa)), the seed tables are stacked already (they stay
    stacked across frames), bc_fid (B, 2) holds each sequence's
    [batch_counter, frame_id]. Every result carries the leading B.

    With a mesh the batch splits over `mesh_axis` (`_shard_mapped_step`):
    the result is the Shards of the per-shard results, and the seed tables
    may be the previous sharded step's Shards."""
    last_pyr = [torch.stack([p[lv] for p in last_pyrs])
                for lv in range(len(cur_pyr))]
    blob, mt = torch.stack(list(blobs)), stack_trees(list(mts))

    def step(last_pyr, cur_pyr, flat, blob, mt, bcf, pt_seeds, ln_seeds,
             atlas):
        return _step_from_blob(
            last_pyr, cur_pyr, atlas._replace(flat=flat), blob, mt, pt_seeds,
            ln_seeds, bcf[:, 0], fx, fy, cx, cy, specs=specs,
            frame_id=bcf[:, 1], **kw)

    host_args = (last_pyr, list(cur_pyr), kf_flat.flat, blob, mt, bc_fid)
    carries = (pt_seeds, ln_seeds)
    if mesh is None:
        return step(*host_args, *carries, kf_flat)
    return _shard_mapped_step(step, mesh, mesh_axis, host_args, carries,
                              kf_flat._replace(flat=None))


def _shard_mapped_step(step, mesh, mesh_axis, host_args, carries, shared):
    """Run the batched step once per shard of `mesh_axis`, with no
    communication (the JAX package's shard_map of the vmapped step).

    - host_args (trees whose tensors carry the leading B: the host uploads
      of this step) are replicated: each shard slices its own rows and
      moves them to its device.
    - carries (the seed tables, and in pipelined mode NextFrameInputs and
      the map carry) are the previous sharded step's Shards, which stay on
      their shards' devices from one step to the next, or stacked trees,
      split like host_args.
    - shared (the keyframe atlas's unbatched layout) goes whole to every
      shard.
    Every GN loop's stop test stays within its shard (a stop test over the
    whole batch would be a cross-device reduction per iteration), and each
    K2 call site launches once per shard. Returns the Shards of the
    per-shard results."""
    host = split_rows(host_args, mesh, mesh_axis)
    carries = [c if isinstance(c, Shards) else split_rows(c, mesh, mesh_axis)
               for c in carries]
    out = Shards()
    for s, dev in enumerate(mesh.local_devices):
        with on_device(dev):
            out.append(step(*host[s], *[c[s] for c in carries],
                            _tree_map(lambda a: a.to(dev), shared)))
    return out


def _step_tables(cur_img, kf_flat, nxt: NextFrameInputs, mt: MapTables,
                 pt_seeds, ln_seeds, batch_counter, fx, fy, cx, cy, *,
                 n_levels: int, frame_id, mt_delta=None,
                 evict_width: int = MT_DELTA_NE, **kw) -> FullStepResult:
    if mt_delta is not None:
        mt = apply_mt_deltas(mt, mt_delta, NE=evict_width)
    cur_pyr = build_pyramid(cur_img.to(torch.float32), n_levels)
    return _track_frame_step_impl(
        nxt.pyr, cur_pyr, kf_flat, nxt.last, nxt.R_last, nxt.t_last,
        nxt.pt_last_optim, nxt.ln_last_optim, mt, pt_seeds, ln_seeds,
        batch_counter, fx, fy, cx, cy, emit_next=True, frame_id=frame_id,
        **kw)


def track_frame_step_tables(cur_img, kf_flat, nxt: NextFrameInputs,
                            mt: MapTables, pt_seeds, ln_seeds,
                            batch_counter: int, fx, fy, cx, cy, *,
                            n_levels: int, frame_id: int, mt_delta=None,
                            evict_width: int = MT_DELTA_NE,
                            **kw) -> FullStepResult:
    """The pipelined step: the align inputs and the last pyramid come from
    the previous step's NextFrameInputs, the map tables from its carry with
    this frame's host delta blob (width evict_width for evictions) applied,
    and the pyramid is built here from the raw image (any dtype). One
    sequence: the batched step with a batch of one."""
    return _first(_step_tables(
        cur_img[None], _one_atlas(kf_flat), _one(nxt), _one(mt), _one(pt_seeds),
        _one(ln_seeds), batch_counter, fx, fy, cx, cy, n_levels=n_levels,
        frame_id=frame_id,
        mt_delta=None if mt_delta is None else mt_delta[None],
        evict_width=evict_width, **kw))


def track_frame_step_tables_list(cur_imgs, kf_flat, bc_fid: torch.Tensor,
                                 nxt: NextFrameInputs, mt: MapTables,
                                 mt_deltas, pt_seeds, ln_seeds, fx, fy, cx,
                                 cy, *, n_levels: int,
                                 evict_width: int = MT_DELTA_NE, mesh=None,
                                 mesh_axis: str = "seq",
                                 **kw) -> FullStepResult:
    """The pipelined step of B sequences at once (the JAX package's
    `track_frame_step_tables_list`): the raw images (B, H, W) as one
    upload, bc_fid (B, 2) [batch_counter, frame_id], the previous batched
    step's NextFrameInputs and map carry, and the (B, L) delta blobs as one
    upload; every leaf carries the leading B. With a mesh, split over
    `mesh_axis` as track_frame_step_list is: the previous sharded step's
    NextFrameInputs, map carry and seed tables stay on their shards."""
    def step(img, flat, bcf, delta, nxt, mt, pt_seeds, ln_seeds, atlas):
        return _step_tables(img, atlas._replace(flat=flat), nxt, mt,
                            pt_seeds, ln_seeds, bcf[:, 0], fx, fy, cx, cy,
                            n_levels=n_levels, frame_id=bcf[:, 1],
                            mt_delta=delta, evict_width=evict_width, **kw)

    host_args = (cur_imgs, kf_flat.flat, bc_fid, mt_deltas)
    carries = (nxt, mt, pt_seeds, ln_seeds)
    if mesh is None:
        return step(*host_args, *carries, kf_flat)
    return _shard_mapped_step(step, mesh, mesh_axis, host_args, carries,
                              kf_flat._replace(flat=None))


# ---------------------------------------------------------------------------
# Fetch: flatpack concatenates every leaf of a result tree into ONE f32
# vector on the device; submit_fetch copies it into pinned host memory
# asynchronously and returns at once; flatunpack splits the host vector
# back into the tree. Integer and bool leaves round-trip exactly (all ints
# are < 2^24). The JAX package hands each fetch to a thread because a fetch
# over its remote TPU link blocks for tens of milliseconds; on a local card
# the copy is queued on the stream behind the work that produces it, so no
# thread is needed.
# ---------------------------------------------------------------------------

_FETCH_DROP = ("pt_f_cur", "seg_sf_cur", "seg_ef_cur", "seg_line_cur")


def fetch_view(res: FusedResult) -> FusedResult:
    """The result without the fields the host recomputes from fetched uvs
    (unprojected bearings and line coefficients); the device copy keeps
    them for build_next_inputs. A batched result keeps its leading axis."""
    return res._replace(**{k: getattr(res, k).new_zeros(
        getattr(res, k).shape[:-2] + (0,)) for k in _FETCH_DROP})


_LEAF = object()


def _rebuild(tree, it):
    if tree is None:
        return None
    if tree is _LEAF or torch.is_tensor(tree):
        return next(it)
    vals = [_rebuild(t, it) for t in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def flatpack(tree):
    """(flat f32 device vector, meta) of a tree (tuples, lists and
    NamedTuples) of tensors. Leaves on several devices (the shards of a
    mesh) pack into one vector per device, in order of first appearance:
    a list of vectors, whose host copies concatenated are what flatunpack
    reads."""
    leaves = _leaves(tree)
    devs = list(dict.fromkeys(x.device for x in leaves))
    order = sorted(range(len(leaves)), key=lambda i: devs.index(
        leaves[i].device)) if len(devs) > 1 else None
    meta = (tuple((tuple(x.shape), x.dtype) for x in leaves),
            _rebuild(tree, iter([_LEAF] * len(leaves))), order)
    if not leaves:
        return torch.zeros(0), meta
    if order is not None:
        return [torch.cat([x.reshape(-1).to(torch.float32) for x in leaves
                           if x.device == d]) for d in devs], meta
    return torch.cat([x.reshape(-1).to(torch.float32) for x in leaves]), meta


class FetchHandle:
    """A fetch in flight; result() waits for its copy and returns numpy.
    Holds the device vectors and the pinned buffers until then (one copy
    per device for flatpack's list of vectors)."""

    def __init__(self, flat):
        self._flats = list(flat) if isinstance(flat, list) else [flat]
        self._bufs, self._events = [], []
        for f in self._flats:
            if f.device.type == "cuda":
                with torch.cuda.device(f.device):
                    buf = torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
                    buf.copy_(f, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                self._events.append(event)
            else:
                buf = f
            self._bufs.append(buf)

    def result(self) -> np.ndarray:
        for event in self._events:
            event.synchronize()
        self._events = self._flats = []
        if len(self._bufs) == 1:
            return self._bufs[0].numpy()
        return np.concatenate([b.numpy() for b in self._bufs])


def submit_fetch(flat) -> FetchHandle:
    return FetchHandle(flat)


def flatunpack(flat_np: np.ndarray, meta):
    """The tree of flatpack's meta with numpy leaves cut from flat_np."""
    specs, skeleton, order = meta
    out = [None] * len(specs)
    off = 0
    for i in order if order is not None else range(len(specs)):
        shape, dtype = specs[i]
        n = int(np.prod(shape)) if shape else 1
        a = flat_np[off:off + n].reshape(shape)
        off += n
        if dtype == torch.bool:
            a = a > 0.5
        elif not dtype.is_floating_point:
            a = np.rint(a).astype(str(dtype).replace("torch.", ""))
        out[i] = a
    return _rebuild(skeleton, iter(out))


def fetch(tree):
    """Host numpy copy of a tree of device tensors: one concatenation, one
    copy, waited for."""
    if not _leaves(tree):
        return tree
    flat, meta = flatpack(tree)
    return flatunpack(submit_fetch(flat).result(), meta)
