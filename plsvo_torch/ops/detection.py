"""Grid-bucketed FAST-10 corner detection and edgelet detection.

Port of `plsvo_tpu/ops/detection.py`. `detect_fast_grid` scores all
pyramid levels through `ops.fast_score.fast_score_levels` (one CUDA
kernel launch for a CUDA pyramid). Wrap-around is semantics here: the
ring, the gradients and the 3x3 non-max use `torch.roll`, as the JAX
package rolls.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from plsvo_torch.indexing import segment_max, segment_min

_FAST_RING = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_I32_MAX = torch.iinfo(torch.int32).max


class CornerGrid(NamedTuple):
    uv: torch.Tensor  # (C, 2) level-0 px
    level: torch.Tensor  # (C,) int32
    score: torch.Tensor  # (C,)
    valid: torch.Tensor  # (C,) bool


def _inner(H, W, b, device):
    yy = torch.arange(H, device=device)[:, None]
    xx = torch.arange(W, device=device)[None, :]
    return (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)


def fast_corner_mask(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-10 mask (H, W): >= 10 contiguous ring pixels all brighter
    than centre+thr or all darker than centre-thr; 3-px border cleared."""
    ring = torch.stack([torch.roll(img, (-dy, -dx), (0, 1))
                        for dx, dy in _FAST_RING])
    bright = ring > img[None] + threshold
    dark = ring < img[None] - threshold

    def has_run10(m):
        acc = torch.zeros_like(m[0])
        for i in range(16):
            run = m[i]
            for k in range(1, 10):
                run = run & m[(i + k) % 16]
            acc = acc | run
        return acc

    H, W = img.shape
    return (has_run10(bright) | has_run10(dark)) & _inner(H, W, 3, img.device)


def _nonmax_3x3(score: torch.Tensor) -> torch.Tensor:
    """True where score is >= every (wrapped) 3x3 neighbour."""
    neigh = [torch.roll(score, (-dy, -dx), (0, 1))
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dx or dy]
    return score >= torch.stack(neigh).amax(0)


def grid_cells(width: int, height: int, cell_size: int):
    nx = -(-width // cell_size)
    ny = -(-height // cell_size)
    return nx, ny, nx * ny


def _tile_argmax(s: torch.Tensor, T: int, hy: int, wx: int):
    """Per (T x T) tile of the -inf-padded map s: (max, flat index of the
    lowest-index pixel holding it, int32-max where the tile is empty)."""
    h, w = s.shape
    sp = F.pad(s, (0, wx * T - w, 0, hy * T - h), value=-float("inf"))
    tiles = sp.reshape(hy, T, wx, T)
    tmax = tiles.amax(dim=(1, 3))
    idx = torch.arange(hy * T * wx * T, device=s.device,
                       dtype=torch.int64).reshape(hy, T, wx, T)
    is_w = (tiles == tmax[:, None, :, None]) & torch.isfinite(tiles)
    widx = torch.where(is_w, idx, torch.full_like(idx, _I32_MAX)).amin(dim=(1, 3))
    return tmax, widx


def detect_fast_grid(
    pyramid: Sequence[torch.Tensor],
    *,
    cell_size: int = 25,
    fast_threshold: float = 10.0,
    score_threshold: float = 20.0,
    occupied: torch.Tensor | None = None,
    scored=None,
) -> CornerGrid:
    """Best corner per level-0 grid cell across all pyramid levels (half-
    cell tile winners per level, then a per-cell max over all tiles).
    `scored`: the levels' [(mask, score)] when the caller scored them
    already (several pyramids in one K1 launch)."""
    from plsvo_torch.ops.fast_score import fast_score_levels

    H, W = pyramid[0].shape
    dev = pyramid[0].device
    nx, ny, n_cells = grid_cells(W, H, cell_size)
    cand_u, cand_v, cand_s, cand_l = [], [], [], []
    if scored is None:
        scored = fast_score_levels(list(pyramid), fast_threshold)
    for level, (corner, score) in enumerate(scored):
        h, w = corner.shape
        scale = float(1 << level)
        masked = torch.where(corner, score, torch.full_like(score, -float("inf")))
        keep = _nonmax_3x3(masked) & corner & (score > score_threshold)
        s = torch.where(keep, score, torch.full_like(score, -float("inf")))
        T = max(2, int(round(cell_size / (1 << level) / 4)))
        hy = -(-h // T)
        wx = -(-w // T)
        tmax, widx = _tile_argmax(s, T, hy, wx)
        has = torch.isfinite(tmax)
        wi = torch.where(has, widx, torch.zeros_like(widx))
        cand_u.append(((wi % (wx * T)).float() * scale).reshape(-1))
        cand_v.append(((wi // (wx * T)).float() * scale).reshape(-1))
        cand_s.append(torch.where(has, tmax, torch.full_like(tmax, -float("inf")))
                      .reshape(-1))
        cand_l.append(torch.full((hy * wx,), level, dtype=torch.int32, device=dev))
    cu = torch.cat(cand_u)
    cv = torch.cat(cand_v)
    cs = torch.cat(cand_s)
    cl = torch.cat(cand_l)
    cell = ((cv / cell_size).to(torch.int64).clamp(0, ny - 1) * nx
            + (cu / cell_size).to(torch.int64).clamp(0, nx - 1))
    cell_max = segment_max(cs, cell, n_cells)
    ci = torch.arange(cu.shape[0], device=dev, dtype=torch.int64)
    is_winner = (cs == cell_max[cell]) & torch.isfinite(cs)
    win = segment_min(torch.where(is_winner, ci, torch.full_like(ci, _I32_MAX)),
                      cell, n_cells)
    has_c = win < _I32_MAX
    wc = torch.where(has_c, win, torch.zeros_like(win))
    best_score = torch.where(has_c, cell_max,
                             torch.full_like(cell_max, -float("inf")))
    valid = torch.isfinite(best_score) & (best_score > score_threshold)
    if occupied is not None:
        valid = valid & ~occupied
    return CornerGrid(
        uv=torch.stack([cu[wc], cv[wc]], -1), level=cl[wc],
        score=torch.where(valid, best_score, torch.zeros_like(best_score)),
        valid=valid)


class EdgeletGrid(NamedTuple):
    uv: torch.Tensor  # (C, 2) level-0 px
    level: torch.Tensor  # (C,) int32 (always 0)
    grad_dir: torch.Tensor  # (C, 2) unit gradient direction
    mag: torch.Tensor  # (C,)
    valid: torch.Tensor  # (C,) bool


def detect_edgelets_grid(img: torch.Tensor, *, cell_size: int = 25,
                         mag_threshold: float = 30.0) -> EdgeletGrid:
    """Best edgelet per grid cell: the max-|grad I| pixel away from the
    border and from invalid (~0) pixels, with its unit gradient direction."""
    from plsvo_torch.image import gradient

    H, W = img.shape
    nx, ny, n_cells = grid_cells(W, H, cell_size)
    dx, dy = gradient(img)
    mag = dx * dx + dy * dy
    inner = _inner(H, W, 4, img.device)
    vmin = img
    for ax in (0, 1):
        m1 = vmin
        for s in range(1, 5):
            m1 = torch.minimum(m1, torch.roll(vmin, s, ax))
            m1 = torch.minimum(m1, torch.roll(vmin, -s, ax))
        vmin = m1
    inner = inner & (vmin > 0.5)
    m = torch.where(inner, mag, torch.full_like(mag, -float("inf")))
    T = cell_size
    tmax, widx = _tile_argmax(m, T, ny, nx)
    has = torch.isfinite(tmax) & (tmax > mag_threshold * mag_threshold)
    wi = torch.where(has, widx, torch.zeros_like(widx)).reshape(-1)
    u = (wi % (nx * T)).float()
    v = (wi // (nx * T)).float()
    vi = v.long().clamp(0, H - 1)
    ui = u.long().clamp(0, W - 1)
    g = torch.stack([dx[vi, ui], dy[vi, ui]], -1)
    g = g / torch.linalg.norm(g, dim=-1, keepdim=True).clamp_min(1e-8)
    return EdgeletGrid(
        uv=torch.stack([u, v], -1),
        level=torch.zeros(n_cells, dtype=torch.int32, device=img.device),
        grad_dir=g, mag=torch.sqrt(tmax.reshape(-1).clamp_min(0.0)),
        valid=has.reshape(-1))


def occupancy_from_positions(uv, valid, width: int, height: int,
                             cell_size: int) -> torch.Tensor:
    """Mark grid cells containing existing features (level-0 coords)."""
    nx, ny, n_cells = grid_cells(width, height, cell_size)
    cell = ((uv[..., 1] / cell_size).to(torch.int64).clamp(0, ny - 1) * nx
            + (uv[..., 0] / cell_size).to(torch.int64).clamp(0, nx - 1))
    occ = torch.zeros(n_cells, dtype=torch.int32, device=uv.device)
    occ = occ.scatter_reduce(0, torch.where(valid, cell, torch.zeros_like(cell)),
                             valid.to(torch.int32), reduce="amax",
                             include_self=True)
    return occ > 0
