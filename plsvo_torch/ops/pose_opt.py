"""Motion-only pose optimization (6-DoF GN on reprojection errors).

Port of `plsvo_tpu/ops/pose_opt.py`, with its two deliberate fixes of the
reference kept: the exact line Jacobian rows [l^T J_s; l^T J_e] (the
reference scales both by ds/||e||), and the sign of the line term (the
reference omits the flip). A leading batch axis optimizes the poses of B
sequences at once. The GN loop keeps the JAX package's early exit.
`optimize_pose` dispatches on the device: a CPU tensor takes the plain
twin `optimize_pose_plain` (a stopped sequence's carry is frozen, and the
loop reads on the host whether any sequence still runs), any other tensor
launches the CUDA kernel `csrc/pose_opt.cu` (both GN passes, the MAD
scales, both strips and the covariance in one launch, each sequence
leaving its loop on its own, no host sync) or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plsvo_torch import _build, lie
from plsvo_torch.batlin import solve_psd
from plsvo_torch.indexing import gather_clamped
from plsvo_torch.ops.sparse_align import jacobian_xyz2uv
from plsvo_torch.utils.profiling import count

_TUKEY_B = 4.6851
launches = 0  # kernel launches (incremented only where the kernel launches)
capture = None  # optional callable(args, kwargs) run before each launch


def tukey_weight(x_norm: torch.Tensor) -> torch.Tensor:
    u = x_norm / _TUKEY_B
    w = 1.0 - u * u
    return torch.where(u.abs() < 1.0, w * w, torch.zeros_like(w))


def tukey_rho(x_norm: torch.Tensor) -> torch.Tensor:
    u2 = (x_norm / _TUKEY_B) ** 2
    c = _TUKEY_B * _TUKEY_B / 6.0
    v = 1.0 - u2.clamp_max(1.0)
    return c * (1.0 - v * v * v)


def _nanmedian(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """`jnp.nanmedian` of x[valid] along the last axis: linear interpolation
    between the two middle order statistics with the same weights (NaN
    when empty), without a host sync."""
    n = valid.sum(-1)
    N = x.shape[-1]
    s, _ = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf"))),
                      dim=-1)
    q = 0.5 * (n.to(x.dtype) - 1.0)
    lo_f = torch.floor(q)
    hi_f = torch.ceil(q)
    hw = q - lo_f
    lw = 1.0 - hw

    def at(i):
        return s.gather(-1, i.long().clamp(0, N - 1)[..., None])[..., 0]

    med = at(lo_f) * lw + at(hi_f) * hw
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def mad_scale(errors: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """1.48 * median(|e|) over valid entries (along the last axis)."""
    med = _nanmedian(errors, valid)
    med = torch.where(torch.isnan(med), torch.ones_like(med), med)
    return (1.48 * med).clamp_min(1e-6)


class PoseOptInputs(NamedTuple):
    pt_f: torch.Tensor  # (N,3) observed unit bearings
    pt_level: torch.Tensor  # (N,)
    pt_pos_w: torch.Tensor  # (N,3)
    pt_valid: torch.Tensor  # (N,)
    seg_line: torch.Tensor  # (M,3)
    seg_level: torch.Tensor  # (M,)
    seg_spos_w: torch.Tensor  # (M,3)
    seg_epos_w: torch.Tensor  # (M,3)
    seg_valid: torch.Tensor  # (M,)


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    cov: torch.Tensor
    pt_inlier: torch.Tensor
    seg_inlier: torch.Tensor
    n_obs_pt: torch.Tensor
    n_obs_seg: torch.Tensor
    scale_pt: torch.Tensor
    scale_seg: torch.Tensor
    chi2: torch.Tensor


def _safe_z(z):
    return torch.where(z.abs() < 1e-10, torch.full_like(z, 1e-10), z)


def _pt_errors(R, t, inp: PoseOptInputs):
    xyz_f = inp.pt_pos_w @ R.transpose(-1, -2) + t[..., None, :]
    proj = xyz_f[..., :2] / _safe_z(xyz_f[..., 2])[..., None]
    obs = inp.pt_f[..., :2] / _safe_z(inp.pt_f[..., 2:3])
    sic = 1.0 / (1 << inp.pt_level.long()).float()
    return xyz_f, (obs - proj) * sic[..., None], sic


def _seg_errors(R, t, inp: PoseOptInputs):
    def endpoint(pos_w):
        xyz = pos_w @ R.transpose(-1, -2) + t[..., None, :]
        z = _safe_z(xyz[..., 2])
        return xyz, torch.stack([xyz[..., 0] / z, xyz[..., 1] / z,
                                 torch.ones_like(z)], -1)

    xyz_s, s_proj = endpoint(inp.seg_spos_w)
    xyz_e, e_proj = endpoint(inp.seg_epos_w)
    ds = (inp.seg_line * s_proj).sum(-1)
    de = (inp.seg_line * e_proj).sum(-1)
    sic = 1.0 / (1 << inp.seg_level.long()).float()
    return xyz_s, xyz_e, torch.stack([ds, de], -1) * sic[..., None], sic


def optimize_pose(inp: PoseOptInputs, R_init, t_init, focal: float, *,
                  n_iter: int = 10, n_iter_ref: int = 0,
                  reproj_thresh: float = 2.0) -> PoseOptResult:
    """Tukey-weighted GN on the pose, then the inlier strip (and n_iter_ref
    refinement iterations on the inliers).

    A leading batch axis on every input (tables (B, N, ...), R_init
    (B, 3, 3)) optimizes B poses at once, each from its own rows, with its
    own MAD scales, and gets exactly the result it gets alone. Unbatched
    inputs run as a batch of one. CPU tensors take the plain twin, any
    other tensor the CUDA kernel."""
    kw = dict(n_iter=n_iter, n_iter_ref=n_iter_ref, reproj_thresh=reproj_thresh)
    if inp.pt_f.device.type == "cpu":
        return optimize_pose_plain(inp, R_init, t_init, focal, **kw)
    return optimize_pose_cuda(inp, R_init, t_init, focal, **kw)[0]


def optimize_pose_plain(inp: PoseOptInputs, R_init, t_init, focal: float, *,
                        n_iter: int = 10, n_iter_ref: int = 0,
                        reproj_thresh: float = 2.0) -> PoseOptResult:
    """The plain twin: a sequence whose loop has stopped keeps its carry
    frozen while the others iterate, as under vmap; one host read per
    iteration on a card."""
    if R_init.dim() == 2:
        res = optimize_pose_plain(
            PoseOptInputs(*[a[None] for a in inp]), R_init[None],
            t_init[None], focal, n_iter=n_iter, n_iter_ref=n_iter_ref,
            reproj_thresh=reproj_thresh)
        return PoseOptResult(*[a[0] for a in res])
    f32 = torch.float32
    dev = inp.pt_f.device
    B = R_init.shape[0]
    R0, t0 = R_init.to(f32), t_init.to(f32)
    _, e_pt0, _ = _pt_errors(R0, t0, inp)
    scale_pt0 = mad_scale(torch.linalg.norm(e_pt0, dim=-1), inp.pt_valid)
    _, _, e_sg0, _ = _seg_errors(R0, t0, inp)
    scale_sg0 = torch.where(
        inp.seg_valid.any(-1),
        mad_scale(torch.linalg.norm(e_sg0, dim=-1), inp.seg_valid),
        torch.ones((), device=dev))
    scale_pt, scale_sg = scale_pt0[:, None], scale_sg0[:, None]

    def system(R, t, pt_valid, seg_valid):
        xyz_pt, e_pt, sic_pt = _pt_errors(R, t, inp)
        en_pt = torch.linalg.norm(e_pt, dim=-1)
        J_pt = jacobian_xyz2uv(xyz_pt) * sic_pt[..., None, None]
        w_pt = tukey_weight(en_pt / scale_pt) * pt_valid
        xyz_s, xyz_e, e_sg, sic_sg = _seg_errors(R, t, inp)
        l_aux = inp.seg_line[..., :2]
        Js = jacobian_xyz2uv(xyz_s) * sic_sg[..., None, None]
        Je = jacobian_xyz2uv(xyz_e) * sic_sg[..., None, None]
        row_s = -torch.einsum("bmi,bmik->bmk", l_aux, Js)
        row_e = -torch.einsum("bmi,bmik->bmk", l_aux, Je)
        J_sg = torch.stack([row_s, row_e], 2)
        en_sg = torch.linalg.norm(e_sg, dim=-1)
        w_sg = tukey_weight(en_sg / scale_sg) * seg_valid
        A = (torch.einsum("bnik,bnil,bn->bkl", J_pt, J_pt, w_pt)
             + torch.einsum("bmik,bmil,bm->bkl", J_sg, J_sg, w_sg))
        b = -(torch.einsum("bnik,bni,bn->bk", J_pt, e_pt, w_pt)
              + torch.einsum("bmik,bmi,bm->bk", J_sg, e_sg, w_sg))
        zero = torch.zeros((), device=dev)
        chi2 = (torch.where(pt_valid, tukey_rho(en_pt / scale_pt), zero).sum(-1)
                + torch.where(seg_valid, tukey_rho(en_sg / scale_sg),
                              zero).sum(-1))
        return A, b, chi2

    def run_gn(R, t, pt_valid, seg_valid, iters):
        R_old, t_old = R, t
        chi2_prev = torch.full((B,), float("inf"), device=dev)
        A_last = torch.eye(6, dtype=f32, device=dev).expand(B, 6, 6)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        it = -1  # the loop runs it + 1 iterations
        for it in range(iters):
            A, b, chi2 = system(R, t, pt_valid, seg_valid)
            dT = solve_psd(A, b, 1e-10)
            bad = torch.isnan(dT).any(-1)
            worse = (chi2 > chi2_prev) if it > 0 else torch.zeros_like(bad)
            stop = worse | bad | (dT.abs().amax(-1) < 1e-10)
            dR, dt = lie.se3_exp(dT)
            R_new, t_new = lie.compose(dR, dt, R, t)
            wb3, wb1 = (worse | bad)[:, None, None], (worse | bad)[:, None]
            R_next = torch.where(wb3, R_old, R_new)
            t_next = torch.where(wb1, t_old, t_new)
            A_next = torch.where(worse[:, None, None], A_last, A)
            # a stopped sequence's carry stays frozen
            d3, d1 = done[:, None, None], done[:, None]
            R_old = torch.where(d3, R_old, R)
            t_old = torch.where(d1, t_old, t)
            R = torch.where(d3, R, R_next)
            t = torch.where(d1, t, t_next)
            chi2_prev = torch.where(done | worse, chi2_prev, chi2)
            A_last = torch.where(d3, A_last, A_next)
            done = done | stop
            if not bool((~done).any()):  # host sync: every sequence stopped
                break
        count("pose_iters", it + 1)
        return R, t, chi2_prev, A_last

    R, t, chi2, A_fin = run_gn(R0, t0, inp.pt_valid, inp.seg_valid, n_iter)
    thresh_pt = reproj_thresh / focal
    thresh_sg = (thresh_pt * scale_sg0 / scale_pt0)[:, None]

    def strip(R, t):
        _, e_pt, _ = _pt_errors(R, t, inp)
        pt_in = inp.pt_valid & (torch.linalg.norm(e_pt, dim=-1) <= thresh_pt)
        _, _, e_sg, _ = _seg_errors(R, t, inp)
        seg_in = inp.seg_valid & (torch.linalg.norm(e_sg, dim=-1) <= thresh_sg)
        return pt_in, seg_in

    pt_in, seg_in = strip(R, t)
    if n_iter_ref > 0:
        R, t, chi2, A_fin = run_gn(R, t, pt_in, seg_in, n_iter_ref)
        pt_in, seg_in = strip(R, t)
    cov = torch.linalg.inv(A_fin * focal * focal
                           + 1e-12 * torch.eye(6, dtype=f32, device=dev))
    return PoseOptResult(
        R=R, t=t, cov=cov, pt_inlier=pt_in, seg_inlier=seg_in,
        n_obs_pt=inp.pt_valid.sum(-1).to(torch.int32),
        n_obs_seg=inp.seg_valid.sum(-1).to(torch.int32),
        scale_pt=scale_pt0, scale_seg=scale_sg0, chi2=chi2)


def count_iterations(iters: torch.Tensor):
    """The `pose_iters` counter of a launch's (B, 2) iterations per pass:
    per pass the longest-running sequence's, summed over the passes, as the
    plain loop counts them. A card tensor reaches the monitor without a
    host sync."""
    if iters.shape[0]:
        count("pose_iters", iters[0] if iters.shape[0] == 1 else iters.amax(0))


def optimize_pose_cuda(inp: PoseOptInputs, R_init, t_init, focal: float, *,
                       n_iter: int = 10, n_iter_ref: int = 0,
                       reproj_thresh: float = 2.0):
    """Launch the CUDA kernel once on CUDA inputs: both GN passes of every
    sequence, the MAD scales, both strips and the covariance. Returns
    (PoseOptResult, iters, trace): iters (B, 2) int32 each sequence's
    iterations per pass, trace (B, 2, max(n_iter, n_iter_ref, 1)) each
    iteration's chi2 (the entries past a pass's `iters` unwritten), for the
    card's parity checks. Unbatched inputs run as a batch of one."""
    global launches
    dev = inp.pt_f.device
    if dev.type != "cuda":
        raise ValueError(f"optimize_pose_cuda needs CUDA tensors, got {dev}")
    kw = dict(n_iter=int(n_iter), n_iter_ref=int(n_iter_ref),
              reproj_thresh=reproj_thresh)
    if R_init.dim() == 2:
        res, iters, trace = optimize_pose_cuda(
            PoseOptInputs(*[a[None] for a in inp]), R_init[None],
            t_init[None], focal, **kw)
        return PoseOptResult(*[a[0] for a in res]), iters[0], trace[0]
    lib = _build.load_library()
    B, N = inp.pt_f.shape[:2]
    M = inp.seg_line.shape[1]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    ins = [_build.as_input(x, dt, dev, "optimize_pose_cuda") for x, dt in zip(
        (*inp, R_init, t_init), (f32, i32, f32, b8, f32, i32, f32, f32, b8,
                                 f32, f32))]
    n_iter, n_iter_ref = kw["n_iter"], kw["n_iter_ref"]
    T = max(n_iter, n_iter_ref, 1)
    # one allocation: R (B, 9) | t (B, 3) | cov (B, 36) | scale_pt | scale_seg
    # | chi2 | trace (B, 2, T) f32, then n_obs_pt | n_obs_seg | iters (B, 2)
    # int32, then pt_inlier (B, N) | seg_inlier (B, M) bool
    nf = B * (51 + 2 * T)
    out = torch.empty(4 * (nf + 4 * B) + B * (N + M), dtype=torch.uint8,
                      device=dev)
    fl = out[:4 * nf].view(f32)
    it32 = out[4 * nf:4 * (nf + 4 * B)].view(i32)
    bl = out[4 * (nf + 4 * B):].view(b8)
    R, t = fl[:9 * B].view(B, 3, 3), fl[9 * B:12 * B].view(B, 3)
    cov = fl[12 * B:48 * B].view(B, 6, 6)
    scale_pt, scale_sg = fl[48 * B:49 * B], fl[49 * B:50 * B]
    chi2, trace = fl[50 * B:51 * B], fl[51 * B:].view(B, 2, T)
    n_pt, n_sg, iters = it32[:B], it32[B:2 * B], it32[2 * B:].view(B, 2)
    pt_in, seg_in = bl[:B * N].view(B, N), bl[B * N:].view(B, M)
    if capture is not None:
        capture((inp, R_init, t_init, focal), dict(kw))
    outs = (R, t, cov, pt_in, seg_in, n_pt, n_sg, scale_pt, scale_sg, chi2,
            iters, trace)
    # the C entry launches on the thread's current device: make it the
    # inputs' (a mesh may hold shards on several cards)
    with torch.cuda.device(dev):
        _build.check(lib.plsvo_pose_opt(
            *[x.data_ptr() for x in ins + list(outs)], B, N, M, n_iter,
            n_iter_ref, float(np.float32(focal)),
            float(np.float32(reproj_thresh / focal)),
            torch.cuda.current_stream(dev).cuda_stream), "plsvo_pose_opt")
        launches += 1
        count("pose_opt.launches", 1)
        count_iterations(iters)
    return PoseOptResult(
        R=R, t=t, cov=cov, pt_inlier=pt_in, seg_inlier=seg_in, n_obs_pt=n_pt,
        n_obs_seg=n_sg, scale_pt=scale_pt, scale_seg=scale_sg,
        chi2=chi2), iters, trace


def line_coeffs_from_bearings(sf: torch.Tensor, ef: torch.Tensor) -> torch.Tensor:
    """Observed 2-D infinite-line coefficients on the unit plane from the two
    endpoint bearings, scaled so that (l0, l1) is a unit normal."""
    sp = torch.cat([sf[..., :2] / _safe_z(sf[..., 2:3]), torch.ones_like(sf[..., :1])], -1)
    ep = torch.cat([ef[..., :2] / _safe_z(ef[..., 2:3]), torch.ones_like(ef[..., :1])], -1)
    line = torch.linalg.cross(sp, ep)
    n = torch.linalg.norm(line[..., :2], dim=-1, keepdim=True)
    return line / n.clamp_min(1e-12)
