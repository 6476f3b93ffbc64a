"""Sparse image alignment: batched inverse-compositional Gauss-Newton on
SE(3) over point patches and line-segment samples.

Port of `plsvo_tpu/ops/sparse_align.py`, with a leading batch axis in
place of the JAX package's `vmap` (`parallel/batched.py`). The GN loop
keeps the early exit (chi2-increase rollback, small-update stop).
`sparse_img_align` dispatches on the device: a CPU tensor takes the plain
twin `sparse_img_align_plain` (a stopped sequence's carry is frozen, and
the loop reads on the host whether any sequence is still running), any
other tensor launches the CUDA kernel `csrc/sparse_align.cu` (every level
and iteration in one launch, each sequence leaving its loop on its own,
no host sync) or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from plsvo_torch import _build, lie
from plsvo_torch.batlin import solve_psd
from plsvo_torch.image import gather_patch_windows, sample_patch_windows
from plsvo_torch.indexing import seq_of_rows
from plsvo_torch.utils.profiling import count


class AlignPoints(NamedTuple):
    xyz_ref: torch.Tensor  # (N, 3) ref-camera points (= bearing * range)
    uv_ref: torch.Tensor  # (N, 2) level-0 px
    valid: torch.Tensor  # (N,) bool


class AlignSegments(NamedTuple):
    xyz_ref: torch.Tensor  # (M, K, 3)
    uv_ref: torch.Tensor  # (M, K, 2)
    valid: torch.Tensor  # (M,) bool
    p_ref: torch.Tensor = None  # (M, 3)
    q_ref: torch.Tensor = None  # (M, 3)


class AlignResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    n_tracked_pts: torch.Tensor
    n_tracked_segs: torch.Tensor
    seg_alive: torch.Tensor
    chi2: torch.Tensor
    iters: torch.Tensor  # (B, n_levels) int32: GN iterations run per level


launches = 0  # kernel launches (incremented only where the kernel launches)
capture = None  # optional callable(args, kwargs) run before each launch
MAX_LEVELS = 8  # pyramid levels per launch (the kernel's argument table)
MAX_SAMPLES = 32  # samples per segment: one warp's lanes
ROW_WORDS = 49  # the kernel's scratch words per row: 3 x 16 taps + a corner


def jacobian_xyz2uv(xyz: torch.Tensor) -> torch.Tensor:
    """d(unit-plane u,v)/d(twist [v,w]), (..., 3) -> (..., 2, 6)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    zi = 1.0 / torch.where(z.abs() < 1e-10, torch.full_like(z, 1e-10), z)
    zi2 = zi * zi
    o = torch.zeros_like(x)
    row0 = torch.stack([-zi, o, x * zi2, x * y * zi2, -(1.0 + x * x * zi2),
                        y * zi], -1)
    row1 = torch.stack([o, -zi, y * zi2, 1.0 + y * y * zi2, -x * y * zi2,
                        -x * zi], -1)
    return torch.stack([row0, row1], -2)


def _patch_and_grad(img, centers, patch_size: int, seq=None):
    """Bilinear patch + central-difference gradient of the interpolated
    image at every patch tap, from one window per feature (row n of a
    batch (B, H, W) reads image seq[n])."""
    H, W = img.shape[-2:]
    P = patch_size
    wp = P + 6
    wp += wp % 2
    win, corner = gather_patch_windows(img, centers, wp, seq)
    z1 = torch.zeros_like(win[:, :, :1])
    dxw = torch.cat([z1, 0.5 * (win[:, :, 2:] - win[:, :, :-2]), z1], 2)
    z2 = torch.zeros_like(win[:, :1, :])
    dyw = torch.cat([z2, 0.5 * (win[:, 2:, :] - win[:, :-2, :]), z2], 1)
    I, ok_w = sample_patch_windows(win, corner, centers, P)
    dx, _ = sample_patch_windows(dxw, corner, centers, P)
    dy, _ = sample_patch_windows(dyw, corner, centers, P)
    first = centers - (P / 2.0 - 0.5)
    au0 = torch.floor(first[..., 0])
    av0 = torch.floor(first[..., 1])
    valid = (ok_w & (au0 >= 1) & (av0 >= 1)
             & (au0 + P <= W - 2) & (av0 + P <= H - 2))
    return I, dx, dy, valid


def _warp_project(R, t, xyz, fx, fy, cx, cy, scale):
    """Rows xyz (B, n, 3) through each sequence's pose (B, 3, 3), (B, 3)."""
    xyz_cur = xyz @ R.transpose(-1, -2) + t[:, None, :]
    z = xyz_cur[..., 2]
    zs = torch.where(z.abs() < 1e-10, torch.full_like(z, 1e-10), z)
    u = (fx * xyz_cur[..., 0] / zs + cx) * scale
    v = (fy * xyz_cur[..., 1] / zs + cy) * scale
    return xyz_cur, torch.stack([u, v], -1)


def _batched(x):
    return None if x is None else x[None]


def sparse_img_align(pyr_ref: Sequence[torch.Tensor],
                     pyr_cur: Sequence[torch.Tensor], pts: AlignPoints,
                     segs: AlignSegments, R_init, t_init, fx, fy, cx, cy, *,
                     levels: Tuple[int, ...] = (4, 3, 2), n_iter: int = 30,
                     patch_size: int = 4) -> AlignResult:
    """Refine T_cur_from_ref over the pyramid levels (coarse to fine).

    A leading batch axis on every input (levels (B, h, w), tables
    (B, N, ...), R_init (B, 3, 3)) aligns B sequences in one pass: each
    sequence sums its own rows into its own 6x6 system, and gets exactly
    the result it gets alone. Unbatched inputs run as a batch of one. CPU
    tensors take the plain twin, any other tensor the CUDA kernel."""
    if R_init.dim() == 2:
        res = sparse_img_align(
            [p[None] for p in pyr_ref], [p[None] for p in pyr_cur],
            AlignPoints(*map(_batched, pts)),
            AlignSegments(*map(_batched, segs)), R_init[None], t_init[None],
            fx, fy, cx, cy, levels=levels, n_iter=n_iter,
            patch_size=patch_size)
        return AlignResult(*[a[0] for a in res])
    args = (pyr_ref, pyr_cur, pts, segs, R_init, t_init, fx, fy, cx, cy)
    kw = dict(levels=levels, n_iter=n_iter, patch_size=patch_size)
    if pts.xyz_ref.device.type == "cpu":
        return sparse_img_align_plain(*args, **kw)
    return sparse_img_align_cuda(*args, **kw)[0]


def sparse_img_align_plain(pyr_ref: Sequence[torch.Tensor],
                           pyr_cur: Sequence[torch.Tensor], pts: AlignPoints,
                           segs: AlignSegments, R_init, t_init, fx, fy, cx,
                           cy, *, levels: Tuple[int, ...] = (4, 3, 2),
                           n_iter: int = 30,
                           patch_size: int = 4) -> AlignResult:
    """The plain twin on batched inputs: a sequence whose loop has stopped
    keeps its carry frozen while the others iterate, as a vmapped
    `lax.while_loop` does; one host read per iteration on a card."""
    P = patch_size * patch_size
    f32 = torch.float32
    dev = pts.xyz_ref.device
    B, N = pts.xyz_ref.shape[:2]
    M, K = segs.xyz_ref.shape[1], segs.xyz_ref.shape[2]
    NA = N + M * K
    seq_all = seq_of_rows(B, NA, dev)
    R, t = R_init.to(f32), t_init.to(f32)
    seg_alive = segs.valid
    n_pts_vis = torch.zeros(B, dtype=torch.int32, device=dev)
    n_seg_vis = torch.zeros(B, dtype=torch.int32, device=dev)
    chi2_out = torch.zeros(B, dtype=f32, device=dev)
    Jpt_frame = jacobian_xyz2uv(pts.xyz_ref)
    iters = []
    adaptive = segs.p_ref is not None

    def _proj0(xyz):
        z = xyz[..., 2]
        z = torch.where(z.abs() < 1e-10, torch.full_like(z, 1e-10), z)
        return torch.stack([fx * xyz[..., 0] / z + cx,
                            fy * xyz[..., 1] / z + cy], -1)

    for level in levels:
        ref_img = pyr_ref[level]
        cur_img = pyr_cur[level]
        scale = float(1.0 / (1 << level))
        focal_scale = float(torch.tensor(fx * scale, dtype=f32))
        if adaptive:
            length = torch.linalg.norm(_proj0(segs.q_ref) * scale
                                       - _proj0(segs.p_ref) * scale, dim=-1)
            n_act = ((length / patch_size).to(torch.int32) + 1).clamp(2, K)
            jidx = torch.arange(K, dtype=f32, device=dev)
            denom = (n_act - 1).clamp_min(1).to(f32)
            alpha = torch.minimum(jidx / denom[..., None],
                                  torch.ones((), device=dev))
            dpq = (segs.q_ref - segs.p_ref)[..., None, :]
            xyz_sg = segs.p_ref[..., None, :] + alpha[..., None] * dpq
            uv_sg = _proj0(xyz_sg)
            smask = jidx < n_act.to(f32)[..., None]
        else:
            xyz_sg = segs.xyz_ref
            uv_sg = segs.uv_ref
            smask = torch.ones((B, M, K), dtype=torch.bool, device=dev)
            n_act = torch.full((B, M), K, dtype=torch.int32, device=dev)
        Jseg_frame = jacobian_xyz2uv(xyz_sg)
        xyz_all = torch.cat([pts.xyz_ref, xyz_sg.reshape(B, M * K, 3)], 1)
        uv_all_ref = torch.cat([pts.uv_ref, uv_sg.reshape(B, M * K, 2)], 1)
        I_ref_all, dx_all, dy_all, vis_all = (
            a.reshape((B, NA) + a.shape[1:]) for a in _patch_and_grad(
                ref_img, (uv_all_ref * scale).reshape(B * NA, 2), patch_size,
                seq_all))
        I_ref_pt, dx_pt, dy_pt = I_ref_all[:, :N], dx_all[:, :N], dy_all[:, :N]
        vis_pt = vis_all[:, :N] & pts.valid
        Jpt = (dx_pt[..., None] * Jpt_frame[:, :, None, 0, :]
               + dy_pt[..., None] * Jpt_frame[:, :, None, 1, :]) * focal_scale
        I_ref_sg = I_ref_all[:, N:].reshape(B, M, K, P)
        dx_sg = dx_all[:, N:].reshape(B, M, K, P)
        dy_sg = dy_all[:, N:].reshape(B, M, K, P)
        vis_sg = (vis_all[:, N:].reshape(B, M, K) | ~smask).all(-1) & seg_alive
        Jsg = ((dx_sg[..., None] * Jseg_frame[..., None, 0, :]
                + dy_sg[..., None] * Jseg_frame[..., None, 1, :])
               * focal_scale * smask[..., None, None])

        wp_win = patch_size + 1 + 2 * 3
        wp_win += wp_win % 2
        _, uv0_all = _warp_project(R, t, xyz_all, fx, fy, cx, cy, scale)
        win_all, corner_all = gather_patch_windows(
            cur_img, uv0_all.reshape(B * NA, 2), wp_win, seq_all)
        wh_lvl = (torch.full((B * NA,), float(cur_img.shape[-1]), device=dev),
                  torch.full((B * NA,), float(cur_img.shape[-2]), device=dev))
        Jf_pt = Jpt.reshape(B, N * P, 6)
        Jf_sg = Jsg.reshape(B, M, K * P, 6)

        R_prev, t_prev = R, t
        chi2_prev = torch.full((B,), float("inf"), device=dev)
        alive = seg_alive
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        n_run = torch.zeros(B, dtype=torch.int32, device=dev)
        it = -1  # the loop runs it + 1 iterations
        for it in range(n_iter):
            _, uv_cur_all = _warp_project(R, t, xyz_all, fx, fy, cx, cy, scale)
            I_cur_all, in_all = sample_patch_windows(
                win_all, corner_all, uv_cur_all.reshape(B * NA, 2),
                patch_size, wh=wh_lvl)
            I_cur_all = I_cur_all.reshape(B, NA, P)
            in_all = in_all.reshape(B, NA)
            ok_pt = (vis_pt & in_all[:, :N])[..., None]
            r_pt = I_cur_all[:, :N] - I_ref_pt
            w_pt = 1.0 / (1.0 + r_pt.abs())
            wm_pt = torch.where(ok_pt, w_pt, torch.zeros_like(w_pt))
            wr_pt = (wm_pt * r_pt).reshape(B, N * P, 1)
            JfT = Jf_pt.transpose(-1, -2)
            H_pt = JfT @ (Jf_pt * wm_pt.reshape(B, N * P, 1))
            b_pt = -(JfT @ wr_pt)[..., 0]
            chi2_pt = (wm_pt * r_pt * r_pt).sum((1, 2))

            I_cur_sg = I_cur_all[:, N:].reshape(B, M, K, P)
            in_sg = in_all[:, N:].reshape(B, M, K)
            ok_line = vis_sg & (in_sg | ~smask).all(-1) & alive
            r_sg = I_cur_sg - I_ref_sg
            mean_abs = ((r_sg.abs() * smask[..., None]).sum((2, 3))
                        / (n_act.to(f32) * P).clamp_min(1.0))
            alive_new = alive & torch.where(ok_line, mean_abs < 200.0,
                                            torch.ones_like(ok_line))
            use_line = ok_line & (mean_abs < 200.0)
            w_line = torch.where(use_line, 1.0 / (1.0 + mean_abs),
                                 torch.zeros_like(mean_abs))
            r_sgf = r_sg.reshape(B, M, K * P)
            H_sg = torch.einsum("bmpi,bmpj,bm->bij", Jf_sg, Jf_sg, w_line)
            b_sg = -torch.einsum("bmpi,bmp,bm->bi", Jf_sg, r_sgf, w_line)
            chi2_sg = (w_line * mean_abs * mean_abs).sum(-1)

            H = H_pt + H_sg
            b = b_pt + b_sg
            n_meas = (ok_pt.sum((1, 2)) * P
                      + torch.where(use_line, n_act,
                                    torch.zeros_like(n_act)).sum(-1) * P)
            chi2 = (chi2_pt + chi2_sg) / n_meas.to(f32).clamp_min(1.0)
            x = solve_psd(H, b, 1e-8)
            bad = torch.isnan(x).any(-1)
            worse = (chi2 > chi2_prev) if it > 0 else torch.zeros_like(bad)
            stop = worse | bad | (x.abs().amax(-1) < 1e-8)
            dR, dt = lie.se3_exp(-x)
            R_new, t_new = lie.compose(R, t, dR, dt)
            R_out = torch.where(worse[:, None, None], R_prev,
                                torch.where(bad[:, None, None], R, R_new))
            t_out = torch.where(worse[:, None], t_prev,
                                torch.where(bad[:, None], t, t_new))
            # a stopped sequence's carry stays frozen
            R_prev = torch.where(done[:, None, None], R_prev, R)
            t_prev = torch.where(done[:, None], t_prev, t)
            R = torch.where(done[:, None, None], R, R_out)
            t = torch.where(done[:, None], t, t_out)
            chi2_prev = torch.where(done | worse, chi2_prev, chi2)
            alive = torch.where(done[:, None], alive, alive_new)
            n_run = n_run + ~done
            done = done | stop
            if not bool((~done).any()):  # host sync: every sequence stopped
                break
        count("align_iters", it + 1)
        iters.append(n_run)
        chi2_out = chi2_prev
        seg_alive = alive
        n_pts_vis = vis_pt.sum(-1).to(torch.int32)
        n_seg_vis = (vis_sg & seg_alive).sum(-1).to(torch.int32)

    iters = (torch.stack(iters, -1) if iters
             else torch.zeros((B, 0), dtype=torch.int32, device=dev))
    return AlignResult(R=R, t=t, n_tracked_pts=n_pts_vis,
                       n_tracked_segs=n_seg_vis, seg_alive=seg_alive,
                       chi2=chi2_out, iters=iters)


def sparse_img_align_cuda(pyr_ref: Sequence[torch.Tensor],
                          pyr_cur: Sequence[torch.Tensor], pts: AlignPoints,
                          segs: AlignSegments, R_init, t_init, fx, fy, cx,
                          cy, *, levels: Tuple[int, ...] = (4, 3, 2),
                          n_iter: int = 30, patch_size: int = 4):
    """Launch the CUDA kernel once on batched CUDA inputs: every level and
    iteration of every sequence. Returns (AlignResult, trace), trace
    (B, n_levels, n_iter, 2) each iteration's chi2 and max |x| (the rows
    past a level's `iters` unwritten), for the card's parity checks. The
    iteration counts reach the monitor's `align_iters` without a host
    sync: the longest-running sequence's, summed over the levels."""
    global launches
    dev = pts.xyz_ref.device
    if dev.type != "cuda":
        raise ValueError(f"sparse_img_align_cuda needs CUDA tensors, got {dev}")
    if patch_size != 4:
        raise ValueError("the kernel is built for 4x4 patches")
    lib = _build.load_library()

    def _on(x, dt, dev):
        return _build.as_input(x, dt, dev, "sparse_img_align_cuda")

    levels = tuple(int(lv) for lv in levels)
    B, N = pts.xyz_ref.shape[:2]
    M, K = segs.xyz_ref.shape[1], segs.xyz_ref.shape[2]
    L = len(levels)
    if L > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels per launch, got {L}")
    if M > 0 and not 1 <= K <= MAX_SAMPLES:
        raise ValueError(f"1 to {MAX_SAMPLES} samples per segment, got {K}")
    f32, b8 = torch.float32, torch.bool
    refs = [_on(pyr_ref[lv], f32, dev) for lv in levels]
    curs = [_on(pyr_cur[lv], f32, dev) for lv in levels]
    for im in refs + curs:
        if im.dim() != 3 or im.shape[0] != B:
            raise ValueError(f"expected (B={B}, h, w) levels, got "
                             f"{tuple(im.shape)}")
    adaptive = segs.p_ref is not None
    ins = [_on(pts.xyz_ref, f32, dev), _on(pts.uv_ref, f32, dev),
           _on(pts.valid, b8, dev), _on(segs.xyz_ref, f32, dev),
           _on(segs.uv_ref, f32, dev), _on(segs.valid, b8, dev),
           _on(segs.p_ref, f32, dev) if adaptive else None,
           _on(segs.q_ref, f32, dev) if adaptive else None,
           _on(R_init, f32, dev), _on(t_init, f32, dev)]
    # one allocation: R (B, 9) | t (B, 3) | chi2 (B,) | trace (B, L, n_iter,
    # 2) f32, then iters (B, L) | n_pts (B,) | n_segs (B,) int32, then
    # seg_alive (B, M) bool
    n_iter = int(n_iter)
    nf = B * (13 + 2 * L * n_iter)
    ni = B * (L + 2)
    out = torch.empty(4 * (nf + ni) + B * M, dtype=torch.uint8, device=dev)
    fl = out[:4 * nf].view(f32)
    it32 = out[4 * nf:4 * (nf + ni)].view(torch.int32)
    R, t = fl[:9 * B].view(B, 3, 3), fl[9 * B:12 * B].view(B, 3)
    chi2, trace = fl[12 * B:13 * B], fl[13 * B:].view(B, L, n_iter, 2)
    iters = it32[:B * L].view(B, L)
    n_pts, n_segs = it32[B * L:B * (L + 1)], it32[B * (L + 1):]
    alive = out[4 * (nf + ni):].view(b8).view(B, M)
    # per-sequence tap scratch, used when the rows do not fit in shared memory
    scratch = torch.empty(B * (N + M * K) * ROW_WORDS, dtype=f32, device=dev)
    hw, scales = [], []
    for lv, r, c in zip(levels, refs, curs):
        scale = 1.0 / (1 << lv)
        hw += [*r.shape[1:], *c.shape[1:]]
        scales += [scale, float(np.float32(float(fx) * scale))]
    if capture is not None:
        capture((pyr_ref, pyr_cur, pts, segs, R_init, t_init, fx, fy, cx, cy),
                dict(levels=levels, n_iter=n_iter, patch_size=patch_size))
    ptr = [0 if x is None else x.data_ptr() for x in ins]
    # the C entry launches on the thread's current device: make it the
    # inputs' (a mesh may hold shards on several cards)
    with torch.cuda.device(dev):
        _build.check(lib.plsvo_sparse_align(
            _build.table(ctypes.c_void_p, [x.data_ptr() for x in refs]),
            _build.table(ctypes.c_void_p, [x.data_ptr() for x in curs]),
            _build.table(ctypes.c_int, hw),
            _build.table(ctypes.c_float, scales), L,
            *ptr, R.data_ptr(), t.data_ptr(), chi2.data_ptr(),
            trace.data_ptr(), iters.data_ptr(), n_pts.data_ptr(),
            n_segs.data_ptr(), alive.data_ptr(), scratch.data_ptr(), B, N, M,
            K, n_iter, float(fx), float(fy), float(cx), float(cy),
            torch.cuda.current_stream(dev).cuda_stream), "plsvo_sparse_align")
        launches += 1
        if B:
            count("align_iters", iters[0] if B == 1 else iters.amax(0))
    return AlignResult(R=R, t=t, n_tracked_pts=n_pts, n_tracked_segs=n_segs,
                       seg_alive=alive, chi2=chi2, iters=iters), trace

def make_align_points(uv, bearings, depths, valid) -> AlignPoints:
    """Point units: xyz_ref = bearing * depth, the distance-normalised
    bearing times the range (not the z-depth)."""
    return AlignPoints(xyz_ref=bearings * depths[..., None], uv_ref=uv,
                       valid=valid)


def make_align_segments(sp_uv, ep_uv, s_bearing, e_bearing, s_depth, e_depth,
                        valid, n_samples: int, fx, fy, cx, cy) -> AlignSegments:
    """Fixed-count samples along each 3-D segment, uv the exact projection
    of each sample."""
    p_ref = s_bearing * s_depth[..., None]
    q_ref = e_bearing * e_depth[..., None]
    alpha = torch.linspace(0.0, 1.0, n_samples, dtype=sp_uv.dtype,
                           device=sp_uv.device)
    xyz = (p_ref[..., None, :] + alpha[:, None] * (q_ref - p_ref)[..., None, :])
    z = torch.where(xyz[..., 2].abs() < 1e-10,
                    torch.full_like(xyz[..., 2], 1e-10), xyz[..., 2])
    uv = torch.stack([fx * xyz[..., 0] / z + cx, fy * xyz[..., 1] / z + cy], -1)
    return AlignSegments(xyz_ref=xyz, uv_ref=uv, valid=valid, p_ref=p_ref,
                         q_ref=q_ref)
