"""Line-segment detection: gradient-restricted Hough voting on a compacted
edge list, then one contiguous inlier run per peak with a least-squares
refit.

Port of `plsvo_tpu/ops/lines.py`. Stages: thin edge mask (gradient
non-max along 4 directions), the strongest `max_edge_px` edge pixels,
votes into a (theta, rho) accumulator, 3x3 peak non-max and the top
`n_peaks` peaks, then per peak the longest run of inliers along the line
and a weighted principal-axis refit of its endpoints. `detect_segments`
takes a batch of same-shape images along a leading axis (the tiles of
`detect_segments_tiled` go through one call).

What must match the JAX package bit for bit, and how:
- Every top-k is a stable descending sort, so ties go to the lowest index
  (the Hough peaks are integer vote counts: ties are common).
- Votes scatter-add into the flattened (theta, rho) accumulator. The
  counts are integers below 2^24, so the sums are exact in any order.
- `jnp.mod` is the remainder with the divisor's sign (`_mod`, built on the
  exact `fmod`).
- XLA on the CPU contracts `a * b + c * d` into one fused multiply-add and
  evaluates `hypot` as `x * sqrt(1 + r * r)` with that sum fused too; the
  port rounds those terms the same way (`_fma`, `_hypot`).
- The arctangents and the Hough angle table are computed in f64 and
  rounded to f32, so the card and the CPU give the same tables.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from plsvo_torch.ops.detection import grid_cells


class SegmentTable(NamedTuple):
    """Fixed-capacity detected segments (level-0 pixel coords)."""

    sp: torch.Tensor  # (S, 2) start point
    ep: torch.Tensor  # (S, 2) end point
    length: torch.Tensor  # (S,)
    angle: torch.Tensor  # (S,) radians in [-pi/2, pi/2)
    response: torch.Tensor  # (S,) points in the supporting run
    valid: torch.Tensor  # (S,) bool


def _fma(a, b, c):
    """f32 fused multiply-add a * b + c, rounded once (the product of two
    f32 values is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _hypot(x, y):
    """`jnp.hypot` as XLA evaluates it on the CPU."""
    x, y = x.abs(), y.abs()
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    r = lo / torch.where(hi == 0, torch.ones_like(hi), hi)
    return torch.where(hi == 0, hi, hi * torch.sqrt(_fma(r, r, torch.ones_like(r))))


def _atan2(y, x):
    return torch.atan2(y.double(), x.double()).float()


def _mod(x, y: float):
    """`jnp.mod`: the remainder with the sign of the divisor."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _edge_field(img: torch.Tensor, grad_threshold: float, margin: int = 8):
    """Thin edge mask + gradient angle and magnitude of (B, H, W) images;
    `margin` px around the border hold no edge."""
    gx = 0.5 * (torch.roll(img, -1, -1) - torch.roll(img, 1, -1))
    gy = 0.5 * (torch.roll(img, -1, -2) - torch.roll(img, 1, -2))
    mag = _hypot(gx, gy)
    H, W = img.shape[-2:]
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inner = (yy >= margin) & (yy < H - margin) & (xx >= margin) & (xx < W - margin)
    ang = _atan2(gy, gx)  # gradient (normal) direction
    a = _mod(ang, math.pi)
    bins = torch.remainder(
        torch.floor((a + math.pi / 8) / (math.pi / 4)).to(torch.int32), 4)
    nms = torch.zeros_like(mag, dtype=torch.bool)
    for b, (dy, dx) in enumerate(((0, 1), (1, 1), (1, 0), (1, -1))):
        m1 = torch.roll(mag, (-dy, -dx), (-2, -1))
        m2 = torch.roll(mag, (dy, dx), (-2, -1))
        nms = nms | ((bins == b) & (mag >= m1) & (mag > m2))
    return nms & (mag > grad_threshold) & inner, mag, ang


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    to the lower index (`jax.lax.top_k`)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def detect_segments(imgs: torch.Tensor, *, n_peaks: int = 64,
                    n_theta: int = 128, rho_res: float = 1.0,
                    run_gap_px: float = 6.0, grad_threshold: float = 5.3,
                    angle_tol: float = 0.3927, dist_tol: float = 1.8,
                    max_edge_px: int = 4096,
                    min_run_count: int = 6) -> SegmentTable:
    """Up to n_peaks segments per image. imgs: (H, W) or a (B, H, W) batch
    of same-shape images; the table has the same leading axis."""
    if imgs.dim() == 2:
        return SegmentTable(*[a[0] for a in detect_segments(
            imgs[None], n_peaks=n_peaks, n_theta=n_theta, rho_res=rho_res,
            run_gap_px=run_gap_px, grad_threshold=grad_threshold,
            angle_tol=angle_tol, dist_tol=dist_tol, max_edge_px=max_edge_px,
            min_run_count=min_run_count)])
    B, H, W = imgs.shape
    dev = imgs.device
    f32 = torch.float32
    E = max_edge_px
    edge, mag, grad_ang = _edge_field(imgs, grad_threshold)
    phi = _mod(grad_ang, math.pi)

    # ---- the strongest E edge pixels (ties to the lower pixel index) ----
    w_flat = torch.where(edge, mag, torch.zeros_like(mag)).reshape(B, H * W)
    top_w, top_i = _top_k(w_flat, E)
    e_ok = top_w > 0.0
    ex = (top_i % W).to(f32)
    ey = (top_i // W).to(f32)
    e_phi = torch.gather(phi.reshape(B, H * W), 1, top_i)

    # ---- gradient-restricted Hough voting: each edge pixel votes at its
    # own normal direction and the two neighbouring angle bins ----
    diag = math.hypot(H, W)
    n_rho = int(math.ceil(2.0 * diag / rho_res))
    rho0 = -diag
    dtheta = math.pi / n_theta
    theta_tab = (torch.arange(n_theta, dtype=f32) * dtheta).double()
    cos_tab = torch.cos(theta_tab).float().to(dev)
    sin_tab = torch.sin(theta_tab).float().to(dev)
    base_bin = torch.round(e_phi / dtheta).to(torch.int32)
    vote = e_ok.to(f32)
    acc = torch.zeros(B * n_theta * n_rho, dtype=f32, device=dev)
    boff = (torch.arange(B, device=dev) * (n_theta * n_rho))[:, None]
    for db in (-1, 0, 1):
        tb = torch.remainder(base_bin + db, n_theta).long()
        rho = _fma(ex, cos_tab[tb], ey * sin_tab[tb])
        rb = ((rho - rho0) / rho_res).to(torch.int32).clamp(0, n_rho - 1)
        acc.index_add_(0, (boff + tb * n_rho + rb).reshape(-1), vote.reshape(-1))
    acc = acc.reshape(B, n_theta, n_rho)

    # ---- peak non-max (3x3, wrapping in theta and rho) and the top peaks
    neigh = torch.stack([torch.roll(acc, (dt, dr), (1, 2))
                         for dt in (-1, 0, 1) for dr in (-1, 0, 1)
                         if (dt, dr) != (0, 0)])
    is_peak = acc >= neigh.amax(0)
    peak_vals = torch.where(is_peak, acc, torch.zeros_like(acc)).reshape(B, -1)
    top_vals, top_idx = _top_k(peak_vals, n_peaks)
    t_bin = top_idx // n_rho
    p_theta = t_bin.to(f32) * dtheta  # (B, P)
    p_rho = _fma((top_idx % n_rho).to(f32), torch.full_like(p_theta, rho_res),
                 torch.full_like(p_theta, rho0))

    # ---- endpoints: the longest run of inliers along each peak's line ----
    c = cos_tab[t_bin][..., None]  # (B, P, 1)
    s = sin_tab[t_bin][..., None]
    exb, eyb = ex[:, None, :], ey[:, None, :]  # (B, 1, E)
    dist = (_fma(exb, c, eyb * s) - p_rho[..., None]).abs()
    dphi = (_mod(e_phi[:, None, :] - p_theta[..., None] + math.pi / 2, math.pi)
            - math.pi / 2).abs()
    inlier = e_ok[:, None, :] & (dist < dist_tol) & (dphi < angle_tol)
    t = _fma(eyb, c, -exb * s)  # projection along the line direction
    inf = torch.full_like(t, float("inf"))
    t_s, _ = torch.sort(torch.where(inlier, t, inf), dim=-1)
    finite = torch.isfinite(t_s)
    iarr = torch.arange(E, device=dev)
    prev = torch.cat([torch.full_like(t_s[..., :1], -float("inf")),
                      t_s[..., :-1]], -1)
    new_run = (t_s - prev > run_gap_px) | ~torch.isfinite(prev)
    start_t = torch.cummax(torch.where(new_run, t_s, -inf), -1).values
    start_i = torch.cummax(torch.where(new_run, iarr, torch.full_like(iarr, -1)),
                           -1).values
    extent = t_s - start_t
    count = iarr - start_i + 1
    score = torch.where(finite, extent, torch.full_like(extent, -1.0))
    score = torch.where(torch.isfinite(score), score, torch.full_like(score, -1.0))
    best = torch.argmax(score, -1, keepdim=True)  # first maximum, as JAX
    t_end = torch.gather(t_s, -1, best)[..., 0]
    t_start = torch.gather(start_t, -1, best)[..., 0]
    cnt = torch.gather(count, -1, best)[..., 0]
    run_ok = ((top_vals > 0.0) & (cnt >= min_run_count) & torch.isfinite(t_end)
              & torch.isfinite(t_start) & (t_end - t_start > 1.0))

    # ---- refit over the winning run's pixels: principal axis of the 2x2
    # scatter matrix ----
    zero = torch.zeros_like(t_start)
    t_start = torch.where(run_ok, t_start, zero)
    t_end = torch.where(run_ok, t_end, zero)
    run_m = (inlier & (t >= t_start[..., None] - 0.5)
             & (t <= t_end[..., None] + 0.5))
    wgt = torch.where(run_m, vote[:, None, :], torch.zeros_like(t))
    wsum = wgt.sum(-1).clamp_min(1e-12)
    mx = (wgt * exb).sum(-1) / wsum
    my = (wgt * eyb).sum(-1) / wsum
    dxc = exb - mx[..., None]
    dyc = eyb - my[..., None]
    sxx = (wgt * dxc * dxc).sum(-1)
    sxy = (wgt * dxc * dyc).sum(-1)
    syy = (wgt * dyc * dyc).sum(-1)
    half_ang = (0.5 * torch.atan2(2.0 * sxy.double(), (sxx - syy).double()))
    dirx = torch.cos(half_ang).float()
    diry = torch.sin(half_ang).float()
    degenerate = (sxx + syy) < 1e-6
    dirx = torch.where(degenerate, -s[..., 0], dirx)
    diry = torch.where(degenerate, c[..., 0], diry)
    tproj = dxc * dirx[..., None] + dyc * diry[..., None]
    tmin = torch.where(run_m, tproj, inf).amin(-1)
    tmax = torch.where(run_m, tproj, -inf).amax(-1)
    tmin = torch.where(torch.isfinite(tmin), tmin, zero)
    tmax = torch.where(torch.isfinite(tmax), tmax, zero)
    lim = torch.tensor([W - 1.0, H - 1.0], dtype=f32, device=dev)
    sp = torch.minimum(torch.stack([mx + tmin * dirx, my + tmin * diry], -1)
                       .clamp_min(0.0), lim)
    ep = torch.minimum(torch.stack([mx + tmax * dirx, my + tmax * diry], -1)
                       .clamp_min(0.0), lim)
    seg_len = torch.linalg.norm(ep - sp, dim=-1)
    resp = cnt.to(f32) * run_ok
    line_angle = _atan2(ep[..., 1] - sp[..., 1], ep[..., 0] - sp[..., 0])
    line_angle = _mod(line_angle + math.pi / 2, math.pi) - math.pi / 2
    return SegmentTable(sp=sp, ep=ep, length=seg_len, angle=line_angle,
                        response=resp, valid=run_ok)


def detect_segments_tiled(img: torch.Tensor, *, n_peaks: int = 64,
                          tiles: Tuple[int, int] = None, n_peaks_tile: int = 24,
                          max_edge_px: int = None, max_edge_px_tile: int = None,
                          **kw) -> SegmentTable:
    """Global + per-tile detection, concatenated into one table (global
    rows first, then the tiles in row-major order). A single global
    accumulator surfaces only the dominant lines; per tile every segment is
    locally dominant. Default layout: ~150x170 px tiles, edge budgets ~5%
    of the pixels globally and ~12% per tile. img: (H, W) or a (R, H, W)
    batch of same-shape images (one pass for all; the table gains the
    leading axis)."""
    if img.dim() == 2:
        return SegmentTable(*[a[0] for a in detect_segments_tiled(
            img[None], n_peaks=n_peaks, tiles=tiles, n_peaks_tile=n_peaks_tile,
            max_edge_px=max_edge_px, max_edge_px_tile=max_edge_px_tile, **kw)])
    R, H, W = img.shape
    if tiles is None:
        tiles = (max(2, round(H / 150)), max(2, round(W / 170)))
    if max_edge_px is None:
        max_edge_px = int(min(16384, max(2048, (H * W) // 20)))
    if max_edge_px_tile is None:
        ta = (H // tiles[0]) * (W // tiles[1])
        max_edge_px_tile = int(min(3584, max(512, ta // 8)))
    ty, tx = tiles
    th, tw = H // ty, W // tx
    g = detect_segments(img, n_peaks=n_peaks, max_edge_px=max_edge_px, **kw)
    crops = (img[:, : ty * th, : tx * tw].reshape(R, ty, th, tx, tw)
             .permute(0, 1, 3, 2, 4).reshape(R * ty * tx, th, tw))
    det_t = detect_segments(crops, n_peaks=n_peaks_tile,
                            max_edge_px=max_edge_px_tile, **kw)
    k = torch.arange(ty * tx, device=img.device).repeat(R)
    off = torch.stack([(k % tx).to(img.dtype) * tw,
                       (k // tx).to(img.dtype) * th], -1)[:, None, :]
    det_t = det_t._replace(sp=det_t.sp + off, ep=det_t.ep + off)

    def per_image(a):
        return a.reshape((R, -1) + a.shape[2:])

    return SegmentTable(*[torch.cat([a, per_image(b)], 1)
                          for a, b in zip(g, det_t)])


def _grid_walk(segs, *, width, height, cell_size, min_length, occupied,
               limit):
    """The length-sorted greedy occupancy walk on the host: accept a
    segment only if none of its start, mid and end cells is occupied, then
    mark its start and end cells. Stops after `limit` acceptances (None:
    walks every candidate). Returns the table as numpy arrays, the accepted
    rows in order and the occupancy."""
    nx, ny, n_cells = grid_cells(width, height, cell_size)
    occ = (np.zeros(n_cells, bool) if occupied is None
           else np.array(_to_np(occupied), bool))
    tab = SegmentTable(*[_to_np(a) for a in segs])
    valid = tab.valid & (tab.length > min_length)
    order = np.argsort(-np.where(valid, tab.length, -1.0), kind="stable")

    def cell_of(p):
        return (np.clip((p[..., 1] / cell_size).astype(np.int32), 0, ny - 1)
                * nx
                + np.clip((p[..., 0] / cell_size).astype(np.int32), 0,
                          nx - 1))

    mid = 0.5 * (tab.sp + tab.ep)
    c_s, c_m, c_e = cell_of(tab.sp), cell_of(mid), cell_of(tab.ep)
    keep = []
    for i in order:
        if not valid[i] or len(keep) == limit:
            break  # sorted: the rest are invalid
        if occ[c_s[i]] or occ[c_m[i]] or occ[c_e[i]]:
            continue
        occ[c_s[i]] = occ[c_e[i]] = True
        keep.append(i)
    return tab, keep, occ


def _to_np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _compact(tab: SegmentTable, keep, max_segs: int) -> SegmentTable:
    """The rows `keep` (in order) at the front of a table of capacity
    max_segs, zeros after them."""
    out = SegmentTable(
        sp=np.zeros((max_segs, 2), np.float32),
        ep=np.zeros((max_segs, 2), np.float32),
        length=np.zeros(max_segs, np.float32),
        angle=np.zeros(max_segs, np.float32),
        response=np.zeros(max_segs, np.float32),
        valid=np.zeros(max_segs, bool))
    idx = np.asarray(keep[:max_segs], np.int64)
    k = len(idx)
    if k:
        out.sp[:k] = tab.sp[idx]
        out.ep[:k] = tab.ep[idx]
        out.length[:k] = tab.length[idx]
        out.angle[:k] = tab.angle[idx]
        out.response[:k] = tab.response[idx]
        out.valid[:k] = True
    return out


def dedup_segments_grid_np(segs, *, width, height, cell_size, max_segs,
                           min_length, occupied=None) -> SegmentTable:
    """Length-sorted greedy grid dedup of a fetched candidate table, on the
    host in numpy: accept a segment only if none of its start, mid and end
    cells is occupied, then mark its start and end cells. Returns a
    SegmentTable of numpy arrays, capacity max_segs."""
    tab, keep, _ = _grid_walk(segs, width=width, height=height,
                              cell_size=cell_size, min_length=min_length,
                              occupied=occupied, limit=max_segs)
    return _compact(tab, keep, max_segs)


def dedup_segments_grid(segs: SegmentTable, *, width, height, cell_size,
                        max_segs, min_length, occupied=None):
    """The JAX package's device dedup (`plsvo_tpu/ops/lines.py:370`, a scan
    over the length-sorted candidates): the accepted segments at the front
    of a table of capacity max_segs, and the occupancy with every accepted
    segment's start and end cells marked (those past max_segs too). The
    greedy walk is sequential; it runs on the host after one fetch of the
    table, and the results go back to the table's device. No pipeline path
    calls it (the handler dedups fetched tables with
    dedup_segments_grid_np)."""
    tab, keep, occ = _grid_walk(segs, width=width, height=height,
                                cell_size=cell_size, min_length=min_length,
                                occupied=occupied, limit=None)
    dev = segs.sp.device
    out = SegmentTable(*[torch.as_tensor(a, device=dev)
                         for a in _compact(tab, keep, max_segs)])
    return out, torch.as_tensor(occ, device=dev)
