"""Bayesian depth filter: vectorized recursive inverse-depth estimation.

Port of `plsvo_tpu/ops/depth_filter.py` (Vogiatzis & Hernandez Gaussian x
Beta model; all seeds update in one batched pass per frame). A line seed is
two endpoint seeds that share their Beta parameters: both endpoints run the
point-seed chain, concatenated with the point seeds into one batch
(`update_seeds_combined`), and update only when both matched. A leading
batch axis of B sequences puts every sequence's seeds through the same
batch (the JAX package's vmap), each row with its own sequence's poses and
images.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from plsvo_torch import lie
from plsvo_torch.batlin import inv2x2
from plsvo_torch.device import resolve_device
from plsvo_torch.image import ensure_flat_atlas
from plsvo_torch.indexing import (flat_rows, scatter_drop, seq_of_rows, take,
                                  to_int32, top_k_stable)
from plsvo_torch.ops import matcher as matcher_ops
from plsvo_torch.ops.feature_align import align_mixed_atlas, ref_patch_gradients


class PointSeeds(NamedTuple):
    kf_idx: torch.Tensor  # (S,) int32 anchor keyframe slot
    uv: torch.Tensor  # (S,2) anchor px (level-0)
    f: torch.Tensor  # (S,3) anchor unit bearing
    level: torch.Tensor  # (S,) int32
    mu: torch.Tensor  # (S,) inverse-depth mean
    sigma2: torch.Tensor  # (S,)
    z_range: torch.Tensor  # (S,)
    a: torch.Tensor  # (S,)
    b: torch.Tensor  # (S,)
    batch_id: torch.Tensor  # (S,) int32
    alive: torch.Tensor  # (S,) bool


class LineSeeds(NamedTuple):
    kf_idx: torch.Tensor  # (S,) int32 anchor keyframe slot
    s_uv: torch.Tensor  # (S,2) start endpoint px (level-0)
    e_uv: torch.Tensor  # (S,2)
    sf: torch.Tensor  # (S,3) start endpoint unit bearing
    ef: torch.Tensor  # (S,3)
    level: torch.Tensor  # (S,) int32
    mu_s: torch.Tensor  # (S,) inverse-depth mean of the start endpoint
    sigma2_s: torch.Tensor
    z_range_s: torch.Tensor
    mu_e: torch.Tensor
    sigma2_e: torch.Tensor
    z_range_e: torch.Tensor
    a: torch.Tensor  # (S,) shared Beta parameters
    b: torch.Tensor
    batch_id: torch.Tensor  # (S,) int32
    alive: torch.Tensor  # (S,) bool


_INT_COLS = ("kf_idx", "level", "batch_id")


def _zeros_table(cls, capacity: int, device, widths):
    device = resolve_device(device)
    out = {}
    for name in cls._fields:
        dtype = (torch.bool if name == "alive" else
                 torch.int32 if name in _INT_COLS else torch.float32)
        out[name] = torch.zeros((capacity,) + widths.get(name, ()),
                                dtype=dtype, device=device)
    return cls(**out)


def empty_line_seeds(capacity: int, device=None) -> LineSeeds:
    return _zeros_table(LineSeeds, capacity, device,
                        {"s_uv": (2,), "e_uv": (2,), "sf": (3,), "ef": (3,)})


def empty_point_seeds(capacity: int, device=None) -> PointSeeds:
    return _zeros_table(PointSeeds, capacity, device, {"uv": (2,), "f": (3,)})


def seed_init_params(depth_mean, depth_min):
    mu = 1.0 / depth_mean
    z_range = 1.0 / depth_min
    return mu, z_range * z_range / 36.0, z_range


def bayes_update(x, tau2, mu, sigma2, a, b, z_range):
    """Gaussian x Beta update, elementwise. Returns (mu', sigma2', a', b', ok)."""
    norm_scale2 = sigma2 + tau2
    s2 = 1.0 / (1.0 / sigma2.clamp_min(1e-20) + 1.0 / tau2.clamp_min(1e-20))
    m = s2 * (mu / sigma2.clamp_min(1e-20) + x / tau2.clamp_min(1e-20))
    ns = norm_scale2.clamp_min(1e-20)
    pdf = torch.exp(-0.5 * (x - mu) ** 2 / ns) / torch.sqrt(2.0 * math.pi * ns)
    C1 = a / (a + b) * pdf
    C2 = b / (a + b) / z_range.clamp_min(1e-20)
    norm = (C1 + C2).clamp_min(1e-30)
    C1 = C1 / norm
    C2 = C2 / norm
    ab1 = a + b + 1.0
    ab2 = a + b + 2.0
    f = C1 * (a + 1.0) / ab1 + C2 * a / ab1
    e = (C1 * (a + 1.0) * (a + 2.0) / (ab1 * ab2)
         + C2 * a * (a + 1.0) / (ab1 * ab2))
    mu_new = C1 * m + C2 * mu
    sigma2_new = C1 * (s2 + m * m) + C2 * (sigma2 + mu * mu) - mu_new * mu_new
    tiny = lambda v: torch.where(v.abs() < 1e-20, torch.full_like(v, 1e-20), v)  # noqa: E731
    denom = f - e / tiny(f)
    a_new = (e - f) / tiny(denom)
    b_new = a_new * (1.0 - f) / tiny(f)
    ok = (torch.isfinite(mu_new) & torch.isfinite(sigma2_new)
          & torch.isfinite(a_new) & torch.isfinite(b_new) & (sigma2_new > 0)
          & (a_new > 0) & (b_new > 0))
    return mu_new, sigma2_new, a_new, b_new, ok


def compute_tau(t_ref_cur, f, z, px_error_angle: float):
    """Depth std-dev from a one-pixel angular error triangle."""
    t_norm = torch.linalg.norm(t_ref_cur, dim=-1)
    a_vec = f * z[..., None] - t_ref_cur
    a_norm = torch.linalg.norm(a_vec, dim=-1)
    dot_ft = (f * t_ref_cur).sum(-1)
    alpha = torch.arccos((dot_ft / t_norm.clamp_min(1e-12)).clamp(-1.0, 1.0))
    dot_at = (a_vec * (-t_ref_cur)).sum(-1)
    beta = torch.arccos((dot_at / (t_norm * a_norm).clamp_min(1e-12))
                        .clamp(-1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma = math.pi - alpha - beta_plus
    z_plus = t_norm * torch.sin(beta_plus) / torch.sin(gamma).clamp_min(1e-12)
    return z_plus - z


class SeedUpdateResult(NamedTuple):
    seeds: PointSeeds
    converged: torch.Tensor  # (S,)
    matched: torch.Tensor  # (S,)
    depth_converged: torch.Tensor  # (S,)
    skipped: torch.Tensor  # (S,) budget-starved this frame


def _rel_pose(seeds, seq, kf_R_w, kf_t_w, R_w_cur, t_w_cur):
    """Per seed row: T_cur_ref from its anchor keyframe of its own sequence
    (seq) to that sequence's current frame."""
    kf = seeds.kf_idx.long()
    R_cw, t_cw = lie.inverse(R_w_cur, t_w_cur)
    R_cw = R_cw[seq]
    R_cr = torch.einsum("sij,sjk->sik", R_cw, kf_R_w[seq, kf])
    t_cr = torch.einsum("sij,sj->si", R_cw, kf_t_w[seq, kf]) + t_cw[seq]
    return R_cr, t_cr


def _mv(R, x):
    return torch.einsum("sij,sj->si", R, x)


def _per_row(batch_counter, seq):
    """A per-sequence scalar (python number, or (B,) tensor) per row."""
    return batch_counter[seq] if torch.is_tensor(batch_counter) else batch_counter


def _flat(table, B: int, S: int):
    return type(table)(*[a.reshape((B * S,) + a.shape[2:]) for a in table])


def _unflat(table, B: int, S: int):
    return type(table)(*[a.reshape((B, S) + a.shape[1:]) for a in table])


def _top_rows(key, k: int):
    """Per sequence, the k rows of (B, S) key with the largest values (ties
    to the lower row), as (values (B, k), rows of the flattened (B * S)
    table (B * k,))."""
    B, S = key.shape
    v, i = top_k_stable(key, k)
    return v, (i + torch.arange(B, device=key.device)[:, None] * S).reshape(-1)


def update_point_seeds(seeds: PointSeeds, kf_R_w, kf_t_w, kf_flat, cur_pyr,
                       R_w_cur, t_w_cur, fx, fy, cx, cy, batch_counter, *,
                       patch_size: int = 8, n_epi_steps: int = 64,
                       max_seed_kfs: int = 3, sigma_conv_factor: float = 200.0,
                       max_search: int = 0) -> SeedUpdateResult:
    """One frame of seed updates, all seeds of all B sequences at once:
    epipolar search in the [mu - sigma, mu + sigma] band (budgeted to each
    sequence's longest `max_search` bands; sub-2px bands align directly),
    mixed 2-D/1-D refinement (one batch, one K2 launch), triangulation and
    the Bayes update. Seed tables (B, S, ...), keyframe poses (B, K, ...),
    images (B, h, w), current poses (B, 3, 3); batch_counter a number or
    (B,) tensor."""
    from plsvo_torch.image import pack_pyramid_atlas

    f32 = torch.float32
    B, S0 = seeds.mu.shape
    dev = seeds.mu.device
    seq = seq_of_rows(B, S0, dev)
    seeds = _flat(seeds, B, S0)
    S = B * S0
    alive = seeds.alive & ((_per_row(batch_counter, seq) - seeds.batch_id)
                           <= max_seed_kfs)
    R_cr, t_cr = _rel_pose(seeds, seq, kf_R_w, kf_t_w, R_w_cur, t_w_cur)
    depth = 1.0 / seeds.mu.clamp_min(1e-10)
    xyz_cur = _mv(R_cr, seeds.f * depth[:, None]) + t_cr
    z_ok = xyz_cur[:, 2] > 0.1
    zc = xyz_cur[:, 2].clamp_min(1e-6)
    uv_cur = torch.stack([fx * xyz_cur[:, 0] / zc + cx,
                          fy * xyz_cur[:, 1] / zc + cy], -1)
    H0, W0 = cur_pyr[0].shape[-2:]
    margin = patch_size
    in_frame = ((uv_cur[:, 0] > margin) & (uv_cur[:, 0] < W0 - margin)
                & (uv_cur[:, 1] > margin) & (uv_cur[:, 1] < H0 - margin))
    visible = alive & z_ok & in_frame

    sigma = torch.sqrt(seeds.sigma2.clamp_min(0.0))
    d_max = 1.0 / (seeds.mu - sigma).clamp_min(1e-7)
    d_min = 1.0 / (seeds.mu + sigma)
    xyz_far = _mv(R_cr, seeds.f * d_max[:, None]) + t_cr
    xyz_near = _mv(R_cr, seeds.f * d_min[:, None]) + t_cr

    A = matcher_ops.get_warp_affine(fx, fy, cx, cy, seeds.uv, seeds.f, depth,
                                    seeds.level, R_cr, t_cr)
    detA = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    A_ok = detA.abs() > 1e-6
    A_inv = inv2x2(torch.where(A_ok[:, None, None], A,
                               torch.eye(2, device=dev)))
    max_level = len(cur_pyr) - 1
    slevel = matcher_ops.best_search_level(A, max_level)

    def _proj0(xyz):
        z = xyz[:, 2].clamp_min(1e-6)
        return torch.stack([fx * xyz[:, 0] / z + cx, fy * xyz[:, 1] / z + cy], -1)

    band0 = torch.linalg.norm(_proj0(xyz_near) - _proj0(xyz_far), dim=-1)
    band_lvl = band0 / (1 << slevel.long()).float()
    extra = torch.ceil(torch.log2((band_lvl / n_epi_steps).clamp_min(1.0)))
    # rows with a non-finite band (dead or empty seeds) get clamped levels;
    # they are masked out of every result below
    slevel = (slevel.long() + to_int32(extra).long()).clamp(0, max_level).to(torch.int32)
    lvl_scale = (1 << slevel.long()).float()
    too_long = band0 / lvl_scale > float(n_epi_steps)
    cur_atlas, cxo, cso = pack_pyramid_atlas(cur_pyr)
    patches_b, warp_ok = matcher_ops.warp_patches_affine_atlas(
        kf_flat, seeds.kf_idx, seeds.uv, seeds.level, A_inv, slevel,
        patch_size=patch_size, seq=seq)
    ref_patch, ref_dx, ref_dy = ref_patch_gradients(patches_b, patch_size)
    search_valid = (visible & warp_ok & A_ok & ~too_long
                    & (xyz_far[:, 2] > 1e-3) & (xyz_near[:, 2] > 1e-3))

    skipped = torch.zeros(S, dtype=torch.bool, device=dev)
    if max_search:
        k_search = min(max_search, S0)
        band = torch.where(search_valid, band0 / lvl_scale,
                           torch.full_like(band0, -1.0))
        is_short = search_valid & (band <= 2.0)
        fail_w = 1.0 + (seeds.b - 10.0).clamp_min(0.0)
        long_key = torch.where(is_short, torch.full_like(band, -1.0),
                               band / fail_w)
        _, idx_long = _top_rows(long_key.reshape(B, S0), k_search)
        sub_valid = search_valid[idx_long] & ~is_short[idx_long]
        epi_sub = matcher_ops.epipolar_search_sliding_atlas(
            cur_atlas, cxo, cso, patches_b[idx_long], xyz_far[idx_long],
            xyz_near[idx_long], slevel[idx_long], sub_valid,
            fx, fy, cx, cy, patch_size=patch_size, n_steps=n_epi_steps,
            seq=seq[idx_long])
        uv_level0 = uv_cur / lvl_scale[:, None]
        epi_uv = scatter_drop(uv_level0, idx_long, torch.where(
            epi_sub.ok[:, None], epi_sub.uv_level, uv_level0[idx_long]))
        zb = torch.zeros(S, dtype=torch.bool, device=dev)
        searched = scatter_drop(zb, idx_long, sub_valid)
        epi_ok = is_short | scatter_drop(zb, idx_long, epi_sub.ok)
        skipped = search_valid & ~is_short & ~searched
        epi_uv_level, epi_okm = epi_uv, epi_ok & ~skipped
    else:
        epi = matcher_ops.epipolar_search_sliding_atlas(
            cur_atlas, cxo, cso, patches_b, xyz_far, xyz_near, slevel,
            search_valid, fx, fy, cx, cy, patch_size=patch_size,
            n_steps=n_epi_steps, seq=seq)
        epi_uv_level, epi_okm = epi.uv_level, epi.ok

    # 1-D patches refine along the epipolar direction; edges parallel to it
    # are rejected (|cos| < 0.7)
    gxx = (ref_dx * ref_dx).sum(-1)
    gxy = (ref_dx * ref_dy).sum(-1)
    gyy = (ref_dy * ref_dy).sum(-1)
    tr = gxx + gyy
    disc = torch.sqrt((tr * tr - 4.0 * (gxx * gyy - gxy * gxy)).clamp_min(0.0))
    eig_max = 0.5 * (tr + disc)
    eig_min = 0.5 * (tr - disc)
    is_1d = eig_min < 0.05 * eig_max.clamp_min(1e-12)
    gdir = torch.stack([gxy, eig_max - gxx], -1)
    alt = torch.stack([eig_max - gyy, gxy], -1)
    use_alt = torch.linalg.norm(gdir, dim=-1) < 1e-8
    gdir = torch.where(use_alt[:, None], alt, gdir)
    gdir = gdir / torch.linalg.norm(gdir, dim=-1, keepdim=True).clamp_min(1e-12)
    d_epi = _proj0(xyz_near) - _proj0(xyz_far)
    d_epi = d_epi / torch.linalg.norm(d_epi, dim=-1, keepdim=True).clamp_min(1e-12)
    cosang = (gdir * d_epi).sum(-1).abs()
    ok_ref = epi_okm & ~(is_1d & (cosang < 0.7))

    res = align_mixed_atlas(cur_atlas, cxo, cso, ref_patch, ref_dx, ref_dy,
                            epi_uv_level, d_epi, is_1d, slevel, ok_ref,
                            patch_size=patch_size, n_iter=10, seq=seq)
    uv0 = res.uv * lvl_scale[:, None]
    matched = ok_ref & res.converged
    x_n = (uv0[:, 0] - cx) / fx
    y_n = (uv0[:, 1] - cy) / fy
    f_cur = torch.stack([x_n, y_n, torch.ones_like(x_n)], -1)
    f_cur = f_cur / torch.linalg.norm(f_cur, dim=-1, keepdim=True)
    d_ref, _, tri_ok = matcher_ops.triangulate_depth(R_cr, t_cr, seeds.f, f_cur)
    matched = matched & tri_ok & (d_ref > 1e-6)

    # in f32 arithmetic, as the JAX package computes it from f32 intrinsics
    px_error_angle = float(torch.atan(
        1.0 / (2.0 * torch.tensor(fx, dtype=f32))) * 2.0)
    t_rc = -torch.einsum("sji,sj->si", R_cr, t_cr)
    tau = compute_tau(t_rc, seeds.f, d_ref, px_error_angle)
    tau_inv = 0.5 * (1.0 / (d_ref - tau).clamp_min(1e-7)
                     - 1.0 / (d_ref + tau).clamp_min(1e-7))
    x_meas = 1.0 / d_ref.clamp_min(1e-10)
    mu_n, s2_n, a_n, b_n, upd_ok = bayes_update(
        x_meas, tau_inv * tau_inv, seeds.mu, seeds.sigma2, seeds.a, seeds.b,
        seeds.z_range)
    do_upd = matched & upd_ok
    mu = torch.where(do_upd, mu_n, seeds.mu)
    sigma2 = torch.where(do_upd, s2_n, seeds.sigma2)
    a_new = torch.where(do_upd, a_n, seeds.a)
    b_new = torch.where(do_upd, b_n,
                        torch.where(visible & ~matched & ~skipped,
                                    seeds.b + 1.0, seeds.b))
    converged = alive & (torch.sqrt(sigma2.clamp_min(0.0))
                         < seeds.z_range / sigma_conv_factor)
    dead = ~torch.isfinite(mu) | ~torch.isfinite(sigma2) | (mu < 0)
    alive_out = alive & ~dead & ~converged
    out = SeedUpdateResult(
        seeds=seeds._replace(mu=mu, sigma2=sigma2, a=a_new, b=b_new,
                             alive=alive_out),
        converged=converged, matched=matched,
        depth_converged=1.0 / mu.clamp_min(1e-10), skipped=skipped)
    return SeedUpdateResult(_unflat(out.seeds, B, S0),
                            *[a.reshape(B, S0) for a in out[1:]])


def _seed_work_priority(seeds: PointSeeds, kf_R_w, kf_t_w, img_shape,
                        max_level, R_w_cur, t_w_cur, fx, fy, cx, cy,
                        batch_counter, *, patch_size, n_epi_steps,
                        max_seed_kfs):
    """Cheap work priority per seed, (B, S) (<= 0: no useful work this
    frame): short-band seeds above long-band ones, rotated by failures."""
    B, S0 = seeds.mu.shape
    seq = seq_of_rows(B, S0, seeds.mu.device)
    seeds = _flat(seeds, B, S0)
    alive = seeds.alive & ((_per_row(batch_counter, seq) - seeds.batch_id)
                           <= max_seed_kfs)
    R_cr, t_cr = _rel_pose(seeds, seq, kf_R_w, kf_t_w, R_w_cur, t_w_cur)
    depth = 1.0 / seeds.mu.clamp_min(1e-10)
    xyz_cur = _mv(R_cr, seeds.f * depth[:, None]) + t_cr
    z_ok = xyz_cur[:, 2] > 0.1
    zc = xyz_cur[:, 2].clamp_min(1e-6)
    uv_cur = torch.stack([fx * xyz_cur[:, 0] / zc + cx,
                          fy * xyz_cur[:, 1] / zc + cy], -1)
    H0, W0 = img_shape
    margin = patch_size
    in_frame = ((uv_cur[:, 0] > margin) & (uv_cur[:, 0] < W0 - margin)
                & (uv_cur[:, 1] > margin) & (uv_cur[:, 1] < H0 - margin))
    visible = alive & z_ok & in_frame
    sigma = torch.sqrt(seeds.sigma2.clamp_min(0.0))
    d_max = 1.0 / (seeds.mu - sigma).clamp_min(1e-7)
    d_min = 1.0 / (seeds.mu + sigma)
    xyz_far = _mv(R_cr, seeds.f * d_max[:, None]) + t_cr
    xyz_near = _mv(R_cr, seeds.f * d_min[:, None]) + t_cr

    def _proj0(xyz):
        z = xyz[:, 2].clamp_min(1e-6)
        return torch.stack([fx * xyz[:, 0] / z + cx, fy * xyz[:, 1] / z + cy], -1)

    band0 = torch.linalg.norm(_proj0(xyz_near) - _proj0(xyz_far), dim=-1)
    lvl = to_int32(torch.ceil(torch.log2((band0 / n_epi_steps).clamp_min(1.0)))
                   ).clamp(0, max_level)
    band = band0 / (1 << lvl.long()).float()
    fail_w = 1.0 + (seeds.b - 10.0).clamp_min(0.0)
    prio = torch.where(band <= 2.0, 1e3 + 1e3 / fail_w, band / fail_w)
    return torch.where(visible, prio, torch.full_like(prio, -1.0)).reshape(B, S0)


def _slice_result(res: SeedUpdateResult, lo: int, hi: int) -> SeedUpdateResult:
    return SeedUpdateResult(PointSeeds(*[a[:, lo:hi] for a in res.seeds]),
                            *[a[:, lo:hi] for a in res[1:]])


def update_seeds_combined(pt_seeds, ln_seeds, kf_R_w, kf_t_w, kf_flat,
                          cur_pyr, R_w_cur, t_w_cur, fx, fy, cx, cy,
                          batch_counter, *, has_pt: bool, has_ln: bool,
                          patch_size: int = 8, n_epi_steps: int = 64,
                          max_seed_kfs: int = 3,
                          sigma_conv_factor: float = 200.0,
                          max_search: int = 0, pt_work: int = 0):
    """Point seeds and both line-seed endpoints through ONE epipolar/align
    batch (one K2 launch). With pt_work > 0 only the pt_work
    highest-priority point seeds run the chain; the rest are carried
    (aging still applies). Returns (SeedUpdateResult | None,
    LineSeedUpdateResult | None) in the row spaces of the inputs.

    With a leading batch axis of B sequences on the tables, keyframe poses,
    images and current poses (batch_counter a (B,) tensor), every
    sequence's seeds go through the same batch, each with its own poses,
    images and budgets. Unbatched inputs run as a batch of one."""
    if R_w_cur.dim() == 2:
        one = lambda t: None if t is None else type(t)(*[a[None] for a in t])  # noqa: E731
        pr, lr = update_seeds_combined(
            one(pt_seeds), one(ln_seeds), kf_R_w[None], kf_t_w[None],
            kf_flat._replace(flat=kf_flat.flat[None]),
            [p[None] for p in cur_pyr], R_w_cur[None], t_w_cur[None], fx, fy,
            cx, cy, batch_counter, has_pt=has_pt, has_ln=has_ln,
            patch_size=patch_size, n_epi_steps=n_epi_steps,
            max_seed_kfs=max_seed_kfs, sigma_conv_factor=sigma_conv_factor,
            max_search=max_search, pt_work=pt_work)
        squeeze = lambda r: None if r is None else type(r)(  # noqa: E731
            type(r.seeds)(*[a[0] for a in r.seeds]), *[a[0] for a in r[1:]])
        return squeeze(pr), squeeze(lr)
    kw = dict(patch_size=patch_size, n_epi_steps=n_epi_steps,
              max_seed_kfs=max_seed_kfs, sigma_conv_factor=sigma_conv_factor,
              max_search=max_search)
    parts = []
    pt_idx = None
    if has_pt:
        B, Wp_full = pt_seeds.mu.shape
        if pt_work and pt_work < Wp_full:
            prio = _seed_work_priority(
                pt_seeds, kf_R_w, kf_t_w, cur_pyr[0].shape[-2:],
                len(cur_pyr) - 1, R_w_cur, t_w_cur, fx, fy, cx, cy,
                batch_counter, patch_size=patch_size, n_epi_steps=n_epi_steps,
                max_seed_kfs=max_seed_kfs)
            p_sel, pt_idx = top_k_stable(prio, pt_work)
            parts.append(PointSeeds(*[take(a, pt_idx) for a in pt_seeds]))
        else:
            parts.append(pt_seeds)
    if has_ln:
        parts.append(_line_endpoint_view(ln_seeds, True))
        parts.append(_line_endpoint_view(ln_seeds, False))
    if not parts:
        return None, None
    combined = PointSeeds(*[torch.cat(xs, 1) for xs in zip(*parts)])
    res = update_point_seeds(combined, kf_R_w, kf_t_w, kf_flat, cur_pyr,
                             R_w_cur, t_w_cur, fx, fy, cx, cy, batch_counter,
                             **kw)
    off = 0
    pt_res = None
    if has_pt:
        off = parts[0].mu.shape[1]
        pt_res = _slice_result(res, 0, off)
        if pt_idx is not None:
            # worked rows scatter back into the full row space; the others
            # are carried with aging, not converged or matched this frame
            bc = (batch_counter[:, None] if torch.is_tensor(batch_counter)
                  else batch_counter)
            aged = (bc - pt_seeds.batch_id) > max_seed_kfs
            base = pt_seeds._replace(alive=pt_seeds.alive & ~aged)
            idx_w = flat_rows(pt_idx, Wp_full, p_sel > 0.0).reshape(-1)
            zb = torch.zeros((B, Wp_full), dtype=torch.bool, device=prio.device)
            zf = torch.zeros((B, Wp_full), dtype=torch.float32,
                             device=prio.device)

            def back(full, new):
                flat = scatter_drop(full.reshape((B * Wp_full,) + full.shape[2:]),
                                    idx_w, new.reshape((-1,) + new.shape[2:]))
                return flat.reshape(full.shape)

            pt_res = SeedUpdateResult(
                seeds=PointSeeds(*[back(full, new)
                                   for full, new in zip(base, pt_res.seeds)]),
                converged=back(zb, pt_res.converged),
                matched=back(zb, pt_res.matched),
                depth_converged=back(zf, pt_res.depth_converged),
                skipped=back(zb, pt_res.skipped))
    ln_res = None
    if has_ln:
        Wl = ln_seeds.mu_s.shape[1]
        ln_res = _combine_line_endpoint_results(
            ln_seeds, _slice_result(res, off, off + Wl),
            _slice_result(res, off + Wl, off + 2 * Wl), batch_counter,
            max_seed_kfs, sigma_conv_factor)
    return pt_res, ln_res


class LineSeedUpdateResult(NamedTuple):
    seeds: LineSeeds
    converged: torch.Tensor  # (S,)
    matched: torch.Tensor  # (S,) both endpoints matched
    depth_s: torch.Tensor  # (S,) 1 / mu_s
    depth_e: torch.Tensor
    skipped: torch.Tensor  # (S,) either endpoint budget-starved


def _line_endpoint_view(seeds: LineSeeds, start: bool) -> PointSeeds:
    return PointSeeds(
        kf_idx=seeds.kf_idx, uv=seeds.s_uv if start else seeds.e_uv,
        f=seeds.sf if start else seeds.ef, level=seeds.level,
        mu=seeds.mu_s if start else seeds.mu_e,
        sigma2=seeds.sigma2_s if start else seeds.sigma2_e,
        z_range=seeds.z_range_s if start else seeds.z_range_e,
        a=seeds.a, b=seeds.b, batch_id=seeds.batch_id, alive=seeds.alive)


def _combine_line_endpoint_results(seeds: LineSeeds, rs: SeedUpdateResult,
                                   re_: SeedUpdateResult, batch_counter,
                                   max_seed_kfs: int,
                                   sigma_conv_factor: float
                                   ) -> LineSeedUpdateResult:
    """Fuse the two endpoint updates: both update only when both matched,
    the Beta parameters fuse as a = max, b = min."""
    both = rs.matched & re_.matched
    mu_s = torch.where(both, rs.seeds.mu, seeds.mu_s)
    s2_s = torch.where(both, rs.seeds.sigma2, seeds.sigma2_s)
    mu_e = torch.where(both, re_.seeds.mu, seeds.mu_e)
    s2_e = torch.where(both, re_.seeds.sigma2, seeds.sigma2_e)
    a = torch.where(both, torch.maximum(rs.seeds.a, re_.seeds.a), seeds.a)
    b = torch.where(both, torch.minimum(rs.seeds.b, re_.seeds.b),
                    torch.where(rs.matched | re_.matched, seeds.b,
                                torch.where(seeds.alive, seeds.b + 1.0,
                                            seeds.b)))
    sig_s = torch.sqrt(s2_s.clamp_min(0.0))
    sig_e = torch.sqrt(s2_e.clamp_min(0.0))
    converged = (seeds.alive & (sig_s < seeds.z_range_s / sigma_conv_factor)
                 & (sig_e < seeds.z_range_e / sigma_conv_factor))
    bc = batch_counter[:, None] if torch.is_tensor(batch_counter) else batch_counter
    aged = (bc - seeds.batch_id) > max_seed_kfs
    dead = (~torch.isfinite(mu_s) | ~torch.isfinite(mu_e) | (mu_s < 0)
            | (mu_e < 0) | aged)
    alive_out = seeds.alive & ~dead & ~converged
    return LineSeedUpdateResult(
        seeds=seeds._replace(mu_s=mu_s, sigma2_s=s2_s, mu_e=mu_e,
                             sigma2_e=s2_e, a=a, b=b, alive=alive_out),
        converged=converged, matched=both,
        depth_s=1.0 / mu_s.clamp_min(1e-10), depth_e=1.0 / mu_e.clamp_min(1e-10),
        skipped=rs.skipped | re_.skipped)


def update_line_seeds(seeds: LineSeeds, kf_R_w, kf_t_w, kf_pyr, cur_pyr,
                      R_w_cur, t_w_cur, fx, fy, cx, cy, batch_counter, *,
                      patch_size: int = 8, n_epi_steps: int = 64,
                      max_seed_kfs: int = 3,
                      sigma_conv_factor: float = 200.0
                      ) -> LineSeedUpdateResult:
    """Line seeds alone: both endpoints through the point-seed chain (one
    batch), updated only when both match; the line-only case of
    update_seeds_combined. kf_pyr is a FlatAtlas or a list of (K, h, w)
    keyframe pyramid levels."""
    return update_seeds_combined(
        None, seeds, kf_R_w, kf_t_w, ensure_flat_atlas(kf_pyr), cur_pyr,
        R_w_cur, t_w_cur, fx, fy, cx, cy, batch_counter, has_pt=False,
        has_ln=True, patch_size=patch_size, n_epi_steps=n_epi_steps,
        max_seed_kfs=max_seed_kfs, sigma_conv_factor=sigma_conv_factor)[1]


def _bucketed(full, rows, pad_alive, update, fields):
    """Run `update` on the bucket view full[rows] (alive only where
    pad_alive), then write `fields` of its seeds back to the rows that are
    not padding (padding rows point past the table and drop). Returns
    (updated full table, the update's result in bucket space)."""
    view = type(full)(*[a[rows.long()] for a in full])
    res = update(view._replace(alive=view.alive & pad_alive))
    r = torch.where(pad_alive, rows.long(),
                    torch.full_like(rows.long(), full.alive.shape[0]))
    return full._replace(**{k: scatter_drop(getattr(full, k), r,
                                            getattr(res.seeds, k))
                            for k in fields}), res


def update_point_seeds_bucketed(full: PointSeeds, rows, pad_alive, kf_R_w,
                                kf_t_w, kf_pyr, cur_pyr, R_w_cur, t_w_cur, fx,
                                fy, cx, cy, batch_counter, *,
                                patch_size: int = 8, n_epi_steps: int = 64,
                                max_seed_kfs: int = 3,
                                sigma_conv_factor: float = 200.0):
    """The point-seed update on a compacted bucket of table rows (rows (B,),
    padded; pad_alive (B,) False on the padding): the view is updated and
    its rows written back into the full table. kf_pyr is a FlatAtlas or a
    list of (K, h, w) keyframe pyramid levels. Returns (updated full
    table, SeedUpdateResult in bucket space)."""
    kf_flat = ensure_flat_atlas(kf_pyr)

    def update(view):
        return update_seeds_combined(
            view, None, kf_R_w, kf_t_w, kf_flat, cur_pyr, R_w_cur, t_w_cur,
            fx, fy, cx, cy, batch_counter, has_pt=True, has_ln=False,
            patch_size=patch_size, n_epi_steps=n_epi_steps,
            max_seed_kfs=max_seed_kfs,
            sigma_conv_factor=sigma_conv_factor)[0]

    return _bucketed(full, rows, pad_alive, update,
                     ("mu", "sigma2", "a", "b", "alive"))


def update_line_seeds_bucketed(full: LineSeeds, rows, pad_alive, kf_R_w,
                               kf_t_w, kf_pyr, cur_pyr, R_w_cur, t_w_cur, fx,
                               fy, cx, cy, batch_counter, *,
                               patch_size: int = 8, n_epi_steps: int = 64,
                               max_seed_kfs: int = 3,
                               sigma_conv_factor: float = 200.0):
    """update_line_seeds on a compacted bucket of rows (see
    update_point_seeds_bucketed). Returns (updated full table,
    LineSeedUpdateResult in bucket space)."""
    kf_flat = ensure_flat_atlas(kf_pyr)

    def update(view):
        return update_line_seeds(
            view, kf_R_w, kf_t_w, kf_flat, cur_pyr, R_w_cur, t_w_cur, fx, fy,
            cx, cy, batch_counter, patch_size=patch_size,
            n_epi_steps=n_epi_steps, max_seed_kfs=max_seed_kfs,
            sigma_conv_factor=sigma_conv_factor)

    return _bucketed(full, rows, pad_alive, update,
                     ("mu_s", "sigma2_s", "mu_e", "sigma2_e", "a", "b",
                      "alive"))


def scatter_new_point_seeds(full: PointSeeds, rows, mask, kf_idx, uv, f, level,
                            mu: float, sigma2: float, z_range: float,
                            batch_id: int) -> PointSeeds:
    """Install new seeds into rows[mask] (other rows dropped)."""
    S = full.mu.shape[0]
    r = torch.where(mask, rows.long(), torch.full_like(rows.long(), S))
    B = rows.shape[0]
    dev = full.mu.device

    def const(v, dtype=torch.float32):
        return torch.full((B,), v, dtype=dtype, device=dev)

    return PointSeeds(
        kf_idx=scatter_drop(full.kf_idx, r, kf_idx),
        uv=scatter_drop(full.uv, r, uv), f=scatter_drop(full.f, r, f),
        level=scatter_drop(full.level, r, level),
        mu=scatter_drop(full.mu, r, const(mu)),
        sigma2=scatter_drop(full.sigma2, r, const(sigma2)),
        z_range=scatter_drop(full.z_range, r, const(z_range)),
        a=scatter_drop(full.a, r, const(10.0)),
        b=scatter_drop(full.b, r, const(10.0)),
        batch_id=scatter_drop(full.batch_id, r, const(batch_id, torch.int32)),
        alive=scatter_drop(full.alive, r, mask))


def _f32_scalars(scalars):
    """(mu, sigma2, z_range, batch_id) rounded through f32."""
    return tuple(float(v) for v in np.asarray(scalars, np.float32))


def scatter_new_point_seeds_blob(full: PointSeeds, blob: torch.Tensor, *,
                                 B: int, scalars) -> PointSeeds:
    """scatter_new_point_seeds from one packed f32 blob: rows(B) mask(B)
    kf(B) uv(B,2) f(B,3) level(B). scalars = (mu, sigma2, z_range,
    batch_id), host values rounded through f32 as the JAX package's blob
    tail rounds them; taking them from the host spares the install a
    device round trip."""
    o = 0

    def take(n):
        nonlocal o
        a = blob[o:o + n]
        o += n
        return a

    rows = take(B).long()
    mask = take(B) > 0.5
    kf_idx = take(B).to(torch.int32)
    uv = take(2 * B).reshape(B, 2)
    f = take(3 * B).reshape(B, 3)
    level = take(B).to(torch.int32)
    mu, sigma2, z_range, batch_id = _f32_scalars(scalars)
    return scatter_new_point_seeds(full, rows, mask, kf_idx, uv, f, level, mu,
                                   sigma2, z_range, int(batch_id))


def scatter_new_line_seeds(full: LineSeeds, rows, mask, kf_idx, s_uv, e_uv, sf,
                           ef, level, mu: float, sigma2: float, z_range: float,
                           batch_id: int) -> LineSeeds:
    """Install new line seeds into rows[mask] (other rows dropped); both
    endpoints take the same inverse-depth prior."""
    S = full.mu_s.shape[0]
    r = torch.where(mask, rows.long(), torch.full_like(rows.long(), S))
    B = rows.shape[0]
    dev = full.mu_s.device

    def const(v, dtype=torch.float32):
        return torch.full((B,), v, dtype=dtype, device=dev)

    return LineSeeds(
        kf_idx=scatter_drop(full.kf_idx, r, kf_idx),
        s_uv=scatter_drop(full.s_uv, r, s_uv),
        e_uv=scatter_drop(full.e_uv, r, e_uv),
        sf=scatter_drop(full.sf, r, sf), ef=scatter_drop(full.ef, r, ef),
        level=scatter_drop(full.level, r, level),
        mu_s=scatter_drop(full.mu_s, r, const(mu)),
        sigma2_s=scatter_drop(full.sigma2_s, r, const(sigma2)),
        z_range_s=scatter_drop(full.z_range_s, r, const(z_range)),
        mu_e=scatter_drop(full.mu_e, r, const(mu)),
        sigma2_e=scatter_drop(full.sigma2_e, r, const(sigma2)),
        z_range_e=scatter_drop(full.z_range_e, r, const(z_range)),
        a=scatter_drop(full.a, r, const(10.0)),
        b=scatter_drop(full.b, r, const(10.0)),
        batch_id=scatter_drop(full.batch_id, r, const(batch_id, torch.int32)),
        alive=scatter_drop(full.alive, r, mask))


def scatter_new_line_seeds_blob(full: LineSeeds, blob: torch.Tensor, *,
                                B: int, scalars) -> LineSeeds:
    """scatter_new_line_seeds from one packed f32 blob: rows(B) mask(B)
    kf(B) s_uv(B,2) e_uv(B,2) sf(B,3) ef(B,3) level(B); scalars as in
    scatter_new_point_seeds_blob."""
    o = 0

    def take(n):
        nonlocal o
        a = blob[o:o + n]
        o += n
        return a

    rows = take(B).long()
    mask = take(B) > 0.5
    kf_idx = take(B).to(torch.int32)
    s_uv = take(2 * B).reshape(B, 2)
    e_uv = take(2 * B).reshape(B, 2)
    sf = take(3 * B).reshape(B, 3)
    ef = take(3 * B).reshape(B, 3)
    level = take(B).to(torch.int32)
    mu, sigma2, z_range, batch_id = _f32_scalars(scalars)
    return scatter_new_line_seeds(full, rows, mask, kf_idx, s_uv, e_uv, sf, ef,
                                  level, mu, sigma2, z_range, int(batch_id))
