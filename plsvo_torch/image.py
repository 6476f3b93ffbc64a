"""Image pyramid + sampling primitives.

Port of `plsvo_tpu/image.py`. Images are (H, W) float32 tensors in
[0, 255]; pixel coordinate (u, v) = (col, row), integer coordinates are
pixel centres. The JAX package extracts windows and taps with one-hot
matrix products and packed 4-tap textures (TPU tricks); each of those
computes an exact gather, so the port gathers directly.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F


def half_sample(img: torch.Tensor) -> torch.Tensor:
    """2x2 box-filter downsample; odd trailing rows/cols are dropped. The
    four taps are summed in row-major order, then divided by 4: the order
    XLA's mean uses, so pyramids are bit-identical to the JAX package's."""
    H, W = img.shape[-2], img.shape[-1]
    h2, w2 = H // 2, W // 2
    x = img[..., : h2 * 2, : w2 * 2]
    x = x.reshape(x.shape[:-2] + (h2, 2, w2, 2))
    return (((x[..., 0, :, 0] + x[..., 0, :, 1]) + x[..., 1, :, 0])
            + x[..., 1, :, 1]) / 4


def build_pyramid(img: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """List of n_levels images, level 0 = full resolution."""
    pyr = [img.to(torch.float32)]
    for _ in range(1, n_levels):
        pyr.append(half_sample(pyr[-1]))
    return pyr


class LazyPyr:
    """List-like view of ONE sequence's pyramid inside a batch-stacked
    pyramid (levels with a leading batch axis): level i is sliced on first
    read and cached. A torch slice is a view, so this only saves the
    repeated indexing; it keeps the JAX package's interface."""

    def __init__(self, stacked_levels, k: int):
        self._s = list(stacked_levels)
        self._k = k
        self._cache = {}

    def __len__(self):
        return len(self._s)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self._s)))]
        if i not in self._cache:
            self._cache[i] = self._s[i][self._k]
        return self._cache[i]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def pack_bilinear(img: torch.Tensor) -> torch.Tensor:
    """The 4 bilinear taps of every pixel on the last axis (wrapping at the
    far edges): packed[v, u] = [I(v,u), I(v,u+1), I(v+1,u), I(v+1,u+1)]."""
    i01 = torch.roll(img, -1, -1)
    i10 = torch.roll(img, -1, -2)
    i11 = torch.roll(i10, -1, -1)
    return torch.stack([img, i01, i10, i11], -1)


def pack_bilinear_multi(channels) -> torch.Tensor:
    """pack_bilinear of C same-shape channels: (H, W, 4, C)."""
    return torch.stack([pack_bilinear(c) for c in channels], -1)


def bilinear_taps(uv, H: int, W: int, lo: int):
    """(fu, fv, u0, v0, valid) of bilinear taps at uv (..., 2) in an
    (H, W) image: the fractions, the top-left tap clamped into the image,
    and valid iff the 2x2 support lies in [lo, W-1-lo] x [lo, H-1-lo]."""
    u0 = torch.floor(uv[..., 0])
    v0 = torch.floor(uv[..., 1])
    fu = uv[..., 0] - u0
    fv = uv[..., 1] - v0
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)
    valid = ((u0i >= lo) & (v0i >= lo) & (u0i + 1 <= W - 1 - lo)
             & (v0i + 1 <= H - 1 - lo))
    return fu, fv, u0i.clamp(0, W - 2), v0i.clamp(0, H - 2), valid


def bilinear_sample_multi(packed: torch.Tensor, uv: torch.Tensor):
    """Bilinear interpolation of an (H, W, 4, C) packed texture
    (pack_bilinear_multi) at uv (..., 2). Returns (values (..., C), valid).
    A channel holding a dense gradient map is zero on the outermost ring,
    so valid requires the 2x2 support 1 px inside the image."""
    H, W = packed.shape[0], packed.shape[1]
    fu, fv, u0c, v0c, valid = bilinear_taps(uv, H, W, 1)
    taps = packed[v0c, u0c]  # (..., 4, C)
    w = torch.stack([(1.0 - fu) * (1.0 - fv), fu * (1.0 - fv),
                     (1.0 - fu) * fv, fu * fv], -1)
    val = (w[..., None] * taps).sum(-2)
    return torch.where(valid[..., None], val, torch.zeros_like(val)), valid


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor, *, oob_value: float = 0.0):
    """Bilinear interpolation of an (H, W) image, or of its (H, W, 4)
    pack_bilinear taps, at uv (..., 2) = (u, v). Returns (values, valid)
    with valid iff the full 2x2 support is inside."""
    packed = img.dim() == 3
    H, W = img.shape[:2] if packed else img.shape[-2:]
    fu, fv, u0c, v0c, valid = bilinear_taps(uv, H, W, 0)
    if packed:
        t00, t01, t10, t11 = img[v0c, u0c].unbind(-1)
    else:
        t00 = img[v0c, u0c]
        t01 = img[v0c, u0c + 1]
        t10 = img[v0c + 1, u0c]
        t11 = img[v0c + 1, u0c + 1]
    w00 = (1.0 - fu) * (1.0 - fv)
    w01 = fu * (1.0 - fv)
    w10 = (1.0 - fu) * fv
    w11 = fu * fv
    val = w00 * t00 + w01 * t01 + w10 * t10 + w11 * t11
    return torch.where(valid, val, torch.full_like(val, oob_value)), valid


def patch_offsets(patch_size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(patch_size**2, 2) (x, y) offsets of pixel centres about the patch
    centre, row-major over (y, x)."""
    r = torch.arange(patch_size, dtype=dtype, device=device) - patch_size / 2.0 + 0.5
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)


def extract_patches(img: torch.Tensor, centers: torch.Tensor, patch_size: int):
    """(N, patch_size**2) bilinear patches at subpixel centres (N, 2), in
    patch_offsets order. Returns (patches, valid (N,)): valid iff every
    tap had full bilinear support."""
    offs = patch_offsets(patch_size, centers.dtype, centers.device)
    vals, ok = bilinear_sample(img, centers[..., None, :] + offs)
    return vals, ok.all(-1)


def gradient(img: torch.Tensor):
    """Central-difference gradients (dx, dy) with the wrap-around border
    columns/rows zeroed."""
    dx = 0.5 * (torch.roll(img, -1, 1) - torch.roll(img, 1, 1))
    dy = 0.5 * (torch.roll(img, -1, 0) - torch.roll(img, 1, 0))
    dx[:, 0] = 0.0
    dx[:, -1] = 0.0
    dy[0, :] = 0.0
    dy[-1, :] = 0.0
    return dx, dy


def _box_sum(x: torch.Tensor, halfbox: int) -> torch.Tensor:
    """(2*halfbox)^2 box sum by the cumsum trick, zero-padded back to the
    input's (..., H, W) with the result centred (offsets -halfbox..halfbox-1)."""
    k = 2 * halfbox
    cs = torch.cumsum(x, dim=-2)
    cs = torch.cat([torch.zeros_like(cs[..., :1, :]), cs], -2)
    xs = cs[..., k:, :] - cs[..., :-k, :]
    c = torch.cumsum(xs, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :, :1]), c], -1)
    out = c[..., :, k:] - c[..., :, :-k]
    H, W = x.shape[-2], x.shape[-1]
    return F.pad(out, (halfbox, W - out.shape[-1] - halfbox,
                       halfbox, H - out.shape[-2] - halfbox))


def shi_tomasi_score(img: torch.Tensor, halfbox: int = 4) -> torch.Tensor:
    """Dense Shi-Tomasi min-eigenvalue map over an 8x8 box of wrapped
    central differences, / (2 * box area). Works on (..., H, W)."""
    dx = 0.5 * (torch.roll(img, -1, -1) - torch.roll(img, 1, -1))
    dy = 0.5 * (torch.roll(img, -1, -2) - torch.roll(img, 1, -2))
    sxx = _box_sum(dx * dx, halfbox)
    syy = _box_sum(dy * dy, halfbox)
    sxy = _box_sum(dx * dy, halfbox)
    n = (2.0 * halfbox) ** 2
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt((tr * tr * 0.25 - det).clamp_min(0.0))
    return (0.5 * tr - disc) / (2.0 * n)


# ---------------------------------------------------------------------------
# Pyramid atlas: all levels side by side in ONE image, separated by a
# 2-column gap of zeros; sampling validity is checked against the level
# bounds, so the gap never bleeds into a tap.
# ---------------------------------------------------------------------------

_ATLAS_GAP = 2


def atlas_layout(shapes):
    """shapes: list of (h_l, w_l). Returns (x_offsets, H, W_total)."""
    offs = []
    x = 0
    H = shapes[0][0]
    for (h, w) in shapes:
        offs.append(x)
        x += w + _ATLAS_GAP
    return offs, H, x


def pack_pyramid_atlas(pyr):
    """Pack a pyramid (list of (..., h_l, w_l)) into (..., H0, W_total).
    Returns (atlas, x_offsets int64 (L,), sizes int64 (L,2) as (h_l, w_l))."""
    shapes = [tuple(p.shape[-2:]) for p in pyr]
    offs, H, _ = atlas_layout(shapes)
    parts = [F.pad(p, (0, _ATLAS_GAP, 0, H - h)) for p, (h, w) in zip(pyr, shapes)]
    dev = pyr[0].device
    return (torch.cat(parts, -1), torch.tensor(offs, dtype=torch.int64, device=dev),
            torch.tensor(shapes, dtype=torch.int64, device=dev))


class FlatAtlas(NamedTuple):
    """K per-image atlases side by side: image k's level-l pixel (u, v)
    lives at column k*Wa + x_off[l] + u of `flat` (H0, K*Wa)."""

    flat: torch.Tensor
    x_off: torch.Tensor
    sizes: torch.Tensor
    width: torch.Tensor  # () float32 Wa


def pack_pyramid_atlas_flat(pyr_stack) -> FlatAtlas:
    """Pack a (K, h_l, w_l) level list into a FlatAtlas."""
    atlas, x_off, sizes = pack_pyramid_atlas(list(pyr_stack))
    K, H, Wa = atlas.shape
    flat = atlas.transpose(0, 1).reshape(H, K * Wa)
    return FlatAtlas(flat=flat, x_off=x_off, sizes=sizes,
                     width=torch.tensor(float(Wa), dtype=torch.float32,
                                        device=flat.device))


def ensure_flat_atlas(kf) -> FlatAtlas:
    """A FlatAtlas as it is, or a list of (K, h, w) pyramid level stacks
    packed into one."""
    if isinstance(kf, FlatAtlas):
        return kf
    return pack_pyramid_atlas_flat(kf)


# ---------------------------------------------------------------------------
# Patch windows: gather a (wp x wp) window per feature once; the GN loops
# then resample patches inside the window.
# ---------------------------------------------------------------------------


def gather_windows_raw(img, corner_i, wp: int, seq=None):
    """(N, wp, wp) raw windows at integer corners (N, 2) (u, v), already
    clipped to [0, max(dim - wp, 0)]; images smaller than wp are zero-padded.
    With `seq` (N,), img is a batch (B, H, W) and row n reads image
    seq[n]."""
    H, W = img.shape[-2:]
    if H < wp or W < wp:
        img = F.pad(img, (0, max(wp - W, 0), 0, max(wp - H, 0)))
    d = torch.arange(wp, device=img.device)
    rows = corner_i[:, 1:2].long() + d[None]  # (N, wp)
    cols = corner_i[:, 0:1].long() + d[None]
    if seq is None:
        return img[rows[:, :, None], cols[:, None, :]]
    return img[seq.long()[:, None, None], rows[:, :, None], cols[:, None, :]]


def gather_patch_windows(img, uv_center, wp: int, seq=None):
    """(win, corner): windows centred at uv_center; the corner is clamped
    into the image, so a window near the border shifts. `seq` as in
    gather_windows_raw."""
    H, W = img.shape[-2:]
    ci = torch.floor(uv_center - (wp / 2.0 - 1.0)).to(torch.int64)
    cu = ci[:, 0].clamp(0, max(W - wp, 0))
    cv = ci[:, 1].clamp(0, max(H - wp, 0))
    c = torch.stack([cu, cv], -1)
    return gather_windows_raw(img, c, wp, seq), c.to(uv_center.dtype)


def gather_patch_windows_atlas(atlas, x_offsets, uv_center, level, wp: int,
                               seq=None):
    """gather_patch_windows through a pyramid atlas: uv_center is in each
    feature's own level coords; corner is returned in level coords. With
    `seq`, atlas is a batch (B, H, W_total) and row n reads atlas seq[n]."""
    H, Wt = atlas.shape[-2:]
    ci = torch.floor(uv_center - (wp / 2.0 - 1.0)).to(torch.int64)
    xo = x_offsets[level]
    cu_flat = (ci[:, 0] + xo).clamp(0, max(Wt - wp, 0))
    cv = ci[:, 1].clamp(0, max(H - wp, 0))
    win = gather_windows_raw(atlas, torch.stack([cu_flat, cv], -1), wp, seq)
    return win, torch.stack([cu_flat - xo, cv], -1).to(uv_center.dtype)


def sample_in_window(win, corner, pos):
    """Bilinear-sample per-tap positions pos (N, T, 2) from windows
    (N, wp, wp) with corners (N, 2). Returns (vals, ok) (N, T); ok iff the
    tap's 2x2 support lies inside the window. Rows are interpolated first,
    then columns, the order the JAX contraction sums in."""
    N, wp, _ = win.shape
    local = pos - corner[:, None, :]
    lu = local[..., 0]
    lv = local[..., 1]
    iu = torch.floor(lu)
    iv = torch.floor(lv)
    fu = lu - iu
    fv = lv - iv
    ok = (iu >= 0) & (iv >= 0) & (iu <= wp - 2) & (iv <= wp - 2)
    iuc = iu.clamp(0, wp - 2).long()
    ivc = iv.clamp(0, wp - 2).long()
    n = torch.arange(N, device=win.device)[:, None]
    r0u0 = win[n, ivc, iuc]
    r1u0 = win[n, ivc + 1, iuc]
    r0u1 = win[n, ivc, iuc + 1]
    r1u1 = win[n, ivc + 1, iuc + 1]
    z0 = (1.0 - fv) * r0u0 + fv * r1u0
    z1 = (1.0 - fv) * r0u1 + fv * r1u1
    vals = z0 * (1.0 - fu) + z1 * fu
    return torch.where(ok, vals, torch.zeros_like(vals)), ok


def sample_patch_windows(win, corner, uv, patch_size: int, wh=None):
    """Bilinear (P x P) patches from windows; uv (N, 2) are patch centres in
    the window's frame. wh: optional per-feature (w, h) bounds. Returns
    (vals (N, P*P) in patch_offsets order, ok (N,))."""
    N, wp, _ = win.shape
    P = patch_size
    S = wp - P
    first = uv - (P / 2.0 - 0.5)
    t0 = first - corner
    i0 = torch.floor(t0)
    f = t0 - i0
    iu = i0[:, 0]
    iv = i0[:, 1]
    ok = (iu >= 0) & (iv >= 0) & (iu <= S - 1) & (iv <= S - 1)
    iuc = iu.clamp(0, S - 1).long()
    ivc = iv.clamp(0, S - 1).long()
    d = torch.arange(P + 1, device=win.device)
    n = torch.arange(N, device=win.device)
    rows_i = ivc[:, None] + d[None]  # (N, P+1)
    cols_i = iuc[:, None] + d[None]
    sel = win[n[:, None, None], rows_i[:, :, None], cols_i[:, None, :]]  # (N,P+1,P+1)
    fv = f[:, 1][:, None, None]
    fu = f[:, 0][:, None, None]
    rows = (1 - fv) * sel[:, :P, :] + fv * sel[:, 1:, :]
    patch = (1 - fu) * rows[:, :, :P] + fu * rows[:, :, 1:]
    if wh is not None:
        w, h = wh
        au0 = torch.floor(first[:, 0])
        av0 = torch.floor(first[:, 1])
        ok = ok & (au0 >= 0) & (av0 >= 0) & (au0 + P <= w - 1) & (av0 + P <= h - 1)
    return patch.reshape(N, P * P), ok


def bilinear_sample_atlas(atlas, x_offsets, sizes, uv_level, level):
    """Sample level-`level` coords through the atlas; validity against the
    level bounds."""
    h = sizes[level, 0].to(uv_level.dtype)
    w = sizes[level, 1].to(uv_level.dtype)
    u = uv_level[..., 0]
    v = uv_level[..., 1]
    valid = (u >= 0) & (v >= 0) & (u <= w - 1) & (v <= h - 1)
    ua = u + x_offsets[level].to(uv_level.dtype)
    vals, ok = bilinear_sample(atlas, torch.stack([ua, v], -1))
    return torch.where(valid, vals, torch.zeros_like(vals)), valid & ok
