"""Bundle adjustment over points and line-segment endpoints with a Schur
complement, on one device.

Port of the single-device part of `plsvo_tpu/parallel/ba.py`:

- residuals: unit-plane reprojection of each landmark in each observing
  keyframe, Huber-weighted. Line-endpoint rows (nonzero `obs_line`) use
  the signed distance of the projected endpoint to the OBSERVED infinite
  line instead, packed as a 2-residual with a zero second row, so the
  endpoints never slide along their segment.
- landmark-marginalised Schur: per-landmark 3x3 inverses, and the pose-pair
  blocks of every landmark scatter-added into the reduced camera system S
  (6K x 6K, K keyframe slots), solved with gauge rows pinned.
- `bundle_adjust` runs a fixed number of damped GN iterations as a Python
  loop. The accept gate is a `torch.where` on 0-d tensors and the solve is
  `torch.linalg.solve_ex`, so the loop never waits for the device.
- Map-scale problems (more than F64_SLOTS observation slots) solve in f64
  and return f32; smaller ones (the local BA windows) in f32, as the JAX
  package does. A landmark's depth is weakly observed over short
  baselines, so its 3x3 block is near-singular and the Schur terms built
  from its inverse cancel against the pose blocks: in f32 their rounding
  swamps the gradient of a map-scale problem, and whether the solve
  converges is luck (tests/test_ba_scale.py's K=96, L=50176 problem, seeds
  0-2, `tests/ba_scale_precision.py`: the f32 rounding error of the
  gradient is ~100x the gradient in both packages; in f32 the JAX package
  misses that test's bars for seed 2, the port for seed 0; in f64 each
  seed converges to chi2 < 1e-9).

The scatter-adds sum in order on the CPU and with atomics on the card, so
a card result differs from a CPU result (and from another card run) in
the last bits: compare them with a tolerance.

The host-side builders (`problem_from_map`, `problem_from_window`) and the
write-backs are the JAX package's numpy code; the builders return numpy
leaves, `problem_to` moves a problem onto a device. The solver takes a
leading problem axis (`bundle_adjust_blob_batched`: R same-shape windows of
several sequences in one solve).

`bundle_adjust_sharded` splits the landmark rows (and their observations)
over an axis of a device mesh (`parallel/mesh.py`), poses replicated: each
shard assembles its partial reduced system on its own device, `Mesh.psum`
sums S, b and chi2, the small solve runs once on the first device and is
copied to every shard, and back-substitution stays on each shard.
`parallel/distributed.py` runs the same loop with a two-stage reduction.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from plsvo_torch import lie
from plsvo_torch.batlin import inv3x3
from plsvo_torch.device import resolve_device
from plsvo_torch.indexing import take
from plsvo_torch.parallel.mesh import Shards, on_device


class BAProblem(NamedTuple):
    """Fixed-shape BA problem.

    K keyframes, L landmarks (points and/or line endpoints), O obs slots."""

    kf_R: torch.Tensor  # (K,3,3) T_f_w
    kf_t: torch.Tensor  # (K,3)
    kf_fixed: torch.Tensor  # (K,) bool: gauge-fixed poses
    lm_pos: torch.Tensor  # (L,3)
    lm_valid: torch.Tensor  # (L,) bool
    obs_kf: torch.Tensor  # (L,O) keyframe index (-1 = empty)
    obs_f: torch.Tensor  # (L,O,3) observed unit bearings
    obs_valid: torch.Tensor  # (L,O) bool
    # observed 2D line coefficients on the unit plane, normalised over the
    # first two components; nonzero only for line-endpoint rows. None: a
    # pure point problem
    obs_line: Optional[torch.Tensor] = None  # (L,O,3)
    # unit 3-D segment direction of line-endpoint rows (zeros for points):
    # the along-segment axis is stiffened in the landmark blocks
    lm_dir: Optional[torch.Tensor] = None  # (L,3)


class BAStats(NamedTuple):
    chi2: torch.Tensor
    n_obs: torch.Tensor


_BOOL_LEAVES = ("kf_fixed", "lm_valid", "obs_valid")


def problem_to(prob: BAProblem, device=None) -> BAProblem:
    """The problem's leaves (numpy arrays or tensors) as tensors on
    `device` (None: the card): f32 values, int64 keyframe indices, bool
    masks."""
    device = resolve_device(device)

    def conv(name, a):
        if a is None:
            return None
        t = a if torch.is_tensor(a) else torch.tensor(np.asarray(a))
        if name in _BOOL_LEAVES:
            t = t.bool()
        elif name == "obs_kf":
            t = t.long()
        else:
            t = t.float()
        return t.to(device)

    return BAProblem(*[conv(n, a) for n, a in zip(BAProblem._fields, prob)])


# observation slots (L x O) above which a problem solves in f64
F64_SLOTS = 1 << 16


def _solve_dtype(n_slots: int):
    return torch.float64 if n_slots > F64_SLOTS else torch.float32


def _cast(prob: BAProblem, dtype) -> BAProblem:
    """The problem with its float leaves in `dtype`."""
    return BAProblem(*[a if a is None or not a.is_floating_point()
                       else a.to(dtype) for a in prob])


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _problems(fn):
    """fn of a problem with a leading axis R, also taking one unbatched
    problem (run as R = 1; its tensor results lose the axis)."""
    def wrapper(prob, *args, **kw):
        if prob.kf_R.dim() == 4:
            return fn(prob, *args, **kw)

        def one(x):
            if not isinstance(x, BAProblem):
                return x
            return BAProblem(*[None if a is None else a[None] for a in x])

        out = fn(one(prob), *[one(a) for a in args], **kw)
        return tuple(a[0] if torch.is_tensor(a) else a for a in out)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _residuals_jacobians(prob: BAProblem, huber: float):
    """Per-observation residuals e (R,L,O,2), pose jacobians Jc (R,L,O,2,6),
    landmark jacobians Jp (R,L,O,2,3), robust weights w (R,L,O), chi2 (R,),
    n_obs (R,), for R problems with a leading axis."""
    obs_kf = prob.obs_kf.long()
    kf = obs_kf.clamp_min(0)
    R = take(prob.kf_R, kf)  # (R,L,O,3,3)
    t = take(prob.kf_t, kf)
    xyz = torch.einsum("rloij,rlj->rloi", R, prob.lm_pos) + t
    zc = xyz[..., 2]
    z = torch.where(zc.abs() < 1e-8, torch.full_like(zc, 1e-8), zc)
    proj = xyz[..., :2] / z[..., None]
    fz = prob.obs_f[..., 2:3]
    obs = prob.obs_f[..., :2] / torch.where(fz.abs() < 1e-8,
                                            torch.full_like(fz, 1e-8), fz)
    e = obs - proj  # (R,L,O,2)

    x, y = xyz[..., 0], xyz[..., 1]
    zi = 1.0 / z
    zi2 = zi * zi
    o = torch.zeros_like(x)
    # d e / d twist (left-compose convention) = jacobian_xyz2uv(xyz)
    row0 = torch.stack([-zi, o, x * zi2, x * y * zi2, -(1 + x * x * zi2),
                        y * zi], -1)
    row1 = torch.stack([o, -zi, y * zi2, 1 + y * y * zi2, -x * y * zi2,
                        -x * zi], -1)
    Jc = torch.stack([row0, row1], -2)  # (R,L,O,2,6)
    # d e / d pos_w = -dproj/dxyz @ R
    dpx = torch.stack([zi, o, -x * zi2], -1)
    dpy = torch.stack([o, zi, -y * zi2], -1)
    dproj = torch.stack([dpx, dpy], -2)  # (R,L,O,2,3)
    Jp = -torch.einsum("rloik,rlokj->rloij", dproj, R)

    if prob.obs_line is not None:
        # line-endpoint rows: the signed distance of the projected endpoint
        # to the observed line l, Jacobian (l1, l2) chained through the
        # endpoint's; zero second row, so the assembly is the points'
        l12 = prob.obs_line[..., :2]  # (R,L,O,2)
        is_line = torch.linalg.norm(l12, dim=-1) > 0.5  # normalised or zero
        e_line = -((l12 * proj).sum(-1) + prob.obs_line[..., 2])
        Jc_line = torch.einsum("rloi,rloik->rlok", l12, Jc)  # (R,L,O,6)
        Jp_line = torch.einsum("rloi,rloik->rlok", l12, Jp)  # (R,L,O,3)
        e = torch.where(is_line[..., None],
                        torch.stack([e_line, torch.zeros_like(e_line)], -1), e)
        m = is_line[..., None, None]
        Jc = torch.where(m, torch.stack([Jc_line, torch.zeros_like(Jc_line)],
                                        -2), Jc)
        Jp = torch.where(m, torch.stack([Jp_line, torch.zeros_like(Jp_line)],
                                        -2), Jp)

    valid = (prob.obs_valid & (obs_kf >= 0) & prob.lm_valid[..., None]
             & (zc > 1e-6))
    en = torch.linalg.norm(e, dim=-1)
    w_huber = torch.where(en <= huber, torch.ones_like(en),
                          huber / en.clamp_min(1e-12))
    w = torch.where(valid, w_huber, torch.zeros_like(en))
    chi2 = (w * en * en).sum((1, 2))
    return e, Jc, Jp, w, chi2, valid.sum((1, 2))


@_problems
def _assemble_shard_direct(prob: BAProblem, huber: float, lm_damp: float):
    """Reduced camera system of all rows of R problems at once. Returns
    (S (R,6K,6K), b (R,6K), Hpp_inv (R,L,3,3), b_p (R,L,3), W (R,L,O,6,3),
    chi2 (R,), n_obs (R,))."""
    Rn, K = prob.kf_R.shape[:2]
    e, Jc, Jp, w, chi2, n_obs = _residuals_jacobians(prob, huber)

    # per-landmark blocks. Line-endpoint rows get two stabilisers, point
    # rows neither: an along-segment stiffness (kappa * tr * d d^T), which
    # keeps noisy observed planes from sliding both endpoints toward their
    # least-squares intersection, and a trace-relative damping of the weak
    # perpendicular direction
    Hpp = torch.einsum("rloik,rloim,rlo->rlkm", Jp, Jp, w)  # (R,L,3,3)
    if prob.obs_line is not None:
        row_is_line = (torch.linalg.norm(prob.obs_line[..., :2], dim=-1)
                       > 0.5).any(dim=2)
        tr = Hpp[..., 0, 0] + Hpp[..., 1, 1] + Hpp[..., 2, 2]
        damp = lm_damp + torch.where(row_is_line, 1e-4, 0.0) * tr / 3.0
        Hpp = Hpp + damp[..., None, None] * _eye3(Hpp)
        if prob.lm_dir is not None:
            stiff = torch.where(row_is_line, 10.0, 0.0) * tr
            Hpp = Hpp + stiff[..., None, None] * (
                prob.lm_dir[..., :, None] * prob.lm_dir[..., None, :])
    else:
        Hpp = Hpp + lm_damp * _eye3(Hpp)
    Hpp_inv = inv3x3(Hpp)
    b_p = -torch.einsum("rloik,rloi,rlo->rlk", Jp, e, w)  # (R,L,3)

    # pose blocks per observation
    Hcc_blk = torch.einsum("rloik,rloim,rlo->rlokm", Jc, Jc, w)
    b_c_blk = -torch.einsum("rloik,rloi,rlo->rlok", Jc, e, w)
    W = torch.einsum("rloik,rloim,rlo->rlokm", Jc, Jp, w)  # (R,L,O,6,3)

    obs_kf = prob.obs_kf.long()
    kf = obs_kf.clamp_min(0)
    obs_on = prob.obs_valid & (obs_kf >= 0) & prob.lm_valid[..., None]
    zero = torch.zeros((), dtype=Hcc_blk.dtype, device=Hcc_blk.device)
    # problem r's blocks live at rows [r*K*K, (r+1)*K*K) of one table
    r = torch.arange(Rn, device=kf.device)
    off_S = (r * K * K).view(Rn, 1, 1)
    off_b = (r * K).view(Rn, 1, 1)

    # pose diagonal blocks and gradient, scattered into the (K*K) block
    # table by flat index kf_a * K + kf_b
    S = torch.zeros((Rn * K * K, 6, 6), dtype=Hcc_blk.dtype,
                    device=Hcc_blk.device)
    b_c = torch.zeros((Rn * K, 6), dtype=Hcc_blk.dtype, device=Hcc_blk.device)
    S.index_add_(0, (kf * (K + 1) + off_S).reshape(-1),
                 torch.where(obs_on[..., None, None], Hcc_blk, zero)
                 .reshape(-1, 6, 6))
    b_c.index_add_(0, (kf + off_b).reshape(-1),
                   torch.where(obs_on[..., None], b_c_blk, zero).reshape(-1, 6))

    # Schur: subtract W Hpp^-1 W^T for every pose pair sharing a landmark,
    # and W Hpp^-1 b_p from the gradient
    WHinv = torch.einsum("rlokm,rlmn->rlokn", W, Hpp_inv)  # (R,L,O,6,3)
    pair = torch.einsum("rloin,rlpjn->rlopij", WHinv, W)  # (R,L,O,O,6,6)
    pair_on = obs_on[..., :, None] & obs_on[..., None, :]
    S.index_add_(0, (kf[..., :, None] * K + kf[..., None, :]
                     + off_S[..., None]).reshape(-1),
                 torch.where(pair_on[..., None, None], -pair, zero)
                 .reshape(-1, 6, 6))
    grad_fix = torch.einsum("rloin,rln->rloi", WHinv, b_p)  # (R,L,O,6)
    b_c.index_add_(0, (kf + off_b).reshape(-1),
                   torch.where(obs_on[..., None], -grad_fix, zero)
                   .reshape(-1, 6))

    S_flat = (S.reshape(Rn, K, K, 6, 6).permute(0, 1, 3, 2, 4)
              .reshape(Rn, 6 * K, 6 * K))
    return S_flat, b_c.reshape(Rn, 6 * K), Hpp_inv, b_p, W, chi2, n_obs


@_problems
def _assemble_shard(prob: BAProblem, huber: float, lm_damp: float,
                    chunk: int = 16384):
    """_assemble_shard_direct over landmark slabs of `chunk` rows when the
    problem is larger: the (L,O,O,6,6) pair tensor takes ~10 KB per
    landmark, so S and b accumulate slab by slab."""
    L = prob.lm_pos.shape[1]
    if L <= chunk:
        return _assemble_shard_direct(prob, huber, lm_damp)
    row_leaves = ("lm_pos", "lm_valid", "obs_kf", "obs_f", "obs_valid",
                  "obs_line", "lm_dir")
    S = b = chi2 = n_obs = None
    parts = []
    for lo in range(0, L, chunk):
        sl = prob._replace(**{k: getattr(prob, k)[:, lo:lo + chunk]
                              for k in row_leaves
                              if getattr(prob, k) is not None})
        S_s, b_s, Hpp_inv, b_p, W, c2, n = _assemble_shard_direct(
            sl, huber, lm_damp)
        if S is None:
            S, b, chi2, n_obs = S_s, b_s, c2, n
        else:
            S, b, chi2, n_obs = S + S_s, b + b_s, chi2 + c2, n_obs + n
        parts.append((Hpp_inv, b_p, W))
    Hpp_inv, b_p, W = (torch.cat(xs, 1) for xs in zip(*parts))
    return S, b, Hpp_inv, b_p, W, chi2, n_obs


def _precond_solve(S, b, damping, kf_fixed=None):
    """Damped, Jacobi-preconditioned solve of the reduced camera systems
    (R, 6K, 6K): Levenberg-style multiplicative damping (damping *
    diag(S)) and the symmetric preconditioner D S D with D = diag(S)^-1/2.
    Gauge-fixed poses are pinned inside the solve (rows and columns
    zeroed, unit diagonal), so the system is not gauge-deficient and their
    step is exactly 0. `solve_ex` (LU, no check of the factorisation's
    info) keeps the host from waiting on the device."""
    if kf_fixed is not None:
        free = (~kf_fixed).repeat_interleave(6, dim=-1).to(S.dtype)
        S = (S * free[..., :, None] * free[..., None, :]
             + torch.diag_embed(1.0 - free))
        b = b * free
    d = torch.diagonal(S, dim1=-2, dim2=-1)
    S = S + damping * torch.diag_embed(d.clamp_min(1e-12))
    d2 = torch.diagonal(S, dim1=-2, dim2=-1)
    Dinv = torch.rsqrt(d2.clamp_min(1e-20))
    Sp = S * Dinv[..., :, None] * Dinv[..., None, :]
    y = torch.linalg.solve_ex(Sp, (b * Dinv)[..., None]).result[..., 0]
    return y * Dinv


def _apply_updates(prob: BAProblem, dc: torch.Tensor, Hpp_inv, b_p, W):
    """Back-substitute landmark updates and apply pose updates."""
    Rn, K = prob.kf_R.shape[:2]
    obs_kf = prob.obs_kf.long()
    kf = obs_kf.clamp_min(0)
    obs_on = prob.obs_valid & (obs_kf >= 0) & prob.lm_valid[..., None]
    dc_blocks = dc.reshape(Rn, K, 6)
    # dx_p = Hpp^-1 (b_p - sum_o W_o^T dc_{k(o)})
    Wt_dc = torch.einsum("rloij,rloi->rloj", W, torch.where(
        obs_on[..., None], take(dc_blocks, kf),
        torch.zeros((), device=dc.device)))
    dx = torch.einsum("rlij,rlj->rli", Hpp_inv, b_p - Wt_dc.sum(2))
    lm_new = torch.where(prob.lm_valid[..., None], prob.lm_pos + dx,
                         prob.lm_pos)

    # pose update: T <- exp(dc) * T, gauge-fixed poses frozen
    upd = torch.where(prob.kf_fixed[..., None], torch.zeros_like(dc_blocks),
                      dc_blocks)
    dR, dt = lie.se3_exp(upd)
    R_new, t_new = lie.compose(dR, dt, prob.kf_R, prob.kf_t)
    return prob._replace(kf_R=R_new, kf_t=t_new, lm_pos=lm_new)


@_problems
def _pose_prior_terms(p: BAProblem, prob0: BAProblem, pose_prior: float):
    """Quadratic prior anchoring free poses to their input (tracked)
    estimates, cost (pose_prior/2)|log(T T_input^-1)|^2 per free keyframe:
    it pins the directions a weakly constrained window (planar scene, short
    baselines) barely sees. Returns (S diagonal scalar, b term (R,6K))."""
    xi = lie.se3_log(*lie.compose(p.kf_R, p.kf_t,
                                  *lie.inverse(prob0.kf_R, prob0.kf_t)))
    xi = torch.where(p.kf_fixed[..., None], torch.zeros_like(xi), xi)
    return pose_prior, -pose_prior * xi.reshape(xi.shape[0], -1)


def bundle_adjust(prob: BAProblem, *, n_iter: int = 10,
                  huber: float = 1.0 / 250.0, damping: float = 1e-4,
                  lm_damp: float = 1e-8, pose_prior: float = 0.0,
                  accept_gate: bool = True):
    """GN-with-damping BA on the device the problem's tensors are on.
    Returns (problem, stats).

    accept_gate=False drops the chi2 rollback check, halving the
    assemblies per iteration (the per-keyframe window uses it, with the
    pose prior keeping the steps conservative). The final chi2 and n_obs
    take one closing assembly.

    A leading axis on every leaf (kf_R (R, K, 3, 3), ...) solves R
    same-shape problems at once: each problem's blocks scatter into its
    own rows, and the R reduced systems solve as one batch."""
    if prob.kf_R.dim() == 3:
        p, st = bundle_adjust(
            BAProblem(*[None if a is None else a[None] for a in prob]),
            n_iter=n_iter, huber=huber, damping=damping, lm_damp=lm_damp,
            pose_prior=pose_prior, accept_gate=accept_gate)
        return (BAProblem(*[None if a is None else a[0] for a in p]),
                BAStats(*[a[0] for a in st]))
    K = prob.kf_R.shape[1]
    p = p0 = _cast(prob, _solve_dtype(prob.obs_valid[0].numel()))
    eye = torch.eye(6 * K, dtype=p.kf_R.dtype, device=p.kf_R.device)
    for _ in range(n_iter):
        S, b, Hpp_inv, b_p, W, chi2, _ = _assemble_shard(p, huber, lm_damp)
        if pose_prior > 0.0:
            s_add, b_add = _pose_prior_terms(p, p0, pose_prior)
            S = S + s_add * eye
            b = b + b_add
        dc = _precond_solve(S, b, damping, p.kf_fixed)
        p_new = _apply_updates(p, dc, Hpp_inv, b_p, W)
        if not accept_gate:
            p = p_new
            continue
        # keep the update only if chi2 did not blow up
        chi2_new = _assemble_shard(p_new, huber, lm_damp)[5]
        accept = chi2_new <= chi2 * 1.001
        p = BAProblem(*[None if a is None else torch.where(
            accept.view((-1,) + (1,) * (a.dim() - 1)), a, b_)
            for a, b_ in zip(p_new, p)])
    _, _, _, _, _, chi2, n_obs = _assemble_shard(p, huber, lm_damp)
    return (_cast(p, prob.kf_R.dtype),
            BAStats(chi2=chi2.to(prob.kf_R.dtype), n_obs=n_obs))


_ROW_LEAVES = ("lm_pos", "lm_valid", "obs_kf", "obs_f", "obs_valid",
               "obs_line", "lm_dir")


def shard_problem(prob: BAProblem, mesh, axes) -> Shards:
    """The problem over the local shards of `mesh`: landmark rows and their
    observations split over `axes`, poses on every shard, each part on its
    shard's device. `prob` holds the rows of this process's blocks in block
    order (every row, in a single process); their count must divide evenly
    over the local shards."""
    mesh.check_spans(axes)
    n = len(mesh.local_devices)
    L = len(prob.lm_pos)
    if L % n:
        raise ValueError(f"{L} landmark rows over {n} shards: pad landmarks "
                         "to a multiple of the mesh size")
    Ls = L // n
    first = min(mesh.index(s, axes) for s in range(n))
    parts = []
    for s, dev in enumerate(mesh.local_devices):
        lo = (mesh.index(s, axes) - first) * Ls
        parts.append(problem_to(prob._replace(**{
            k: getattr(prob, k)[lo:lo + Ls] for k in _ROW_LEAVES
            if getattr(prob, k) is not None}), dev))
    return Shards(parts)


def global_slots(parts, mesh) -> int:
    """Observation slots of the whole problem the local shards hold a
    part of (every process holds as many rows)."""
    n_local = sum(q.obs_valid.numel() for q in parts)
    return n_local * mesh.size // len(mesh.local_devices)


def join_problem(parts) -> BAProblem:
    """The shards' landmark rows concatenated in shard order and the first
    shard's poses, on the first shard's device."""
    dev = parts[0].kf_R.device
    return parts[0]._replace(**{
        k: torch.cat([getattr(p, k).to(dev) for p in parts])
        for k in _ROW_LEAVES if getattr(parts[0], k) is not None})


def _bundle_adjust_parts(parts, reduce, n_slots, *, n_iter, huber, damping,
                         lm_damp, pose_prior, solve_each=False):
    """bundle_adjust over per-shard problems whose partial S, b, chi2 and
    n_obs `reduce` sums (a list in, one sum per shard out), at the
    precision of a problem of n_slots observation slots. The solve runs
    once, on the first shard's device, and its step is copied to every
    shard; each shard applies it and back-substitutes its own rows. With
    solve_each every shard solves its own reduced system instead (where
    `reduce` does not give every shard the same sums)."""
    dtype = parts[0].kf_R.dtype
    p = [_cast(BAProblem(*[None if a is None else a[None] for a in q]),
               _solve_dtype(n_slots)) for q in parts]
    p0 = p
    K = p[0].kf_R.shape[1]
    for _ in range(n_iter):
        asm = []
        for q in p:
            with on_device(q.kf_R.device):
                asm.append(_assemble_shard(q, huber, lm_damp))
        S, b, chi2 = (reduce([a[i] for a in asm]) for i in (0, 1, 5))
        dcs = []
        for s in range(len(p) if solve_each else 1):
            Ss, bs = S[s], b[s]
            with on_device(Ss.device):
                if pose_prior > 0.0:
                    s_add, b_add = _pose_prior_terms(p[s], p0[s], pose_prior)
                    Ss = Ss + s_add * torch.eye(6 * K, dtype=Ss.dtype,
                                                device=Ss.device)
                    bs = bs + b_add
                dcs.append(_precond_solve(Ss, bs, damping, p[s].kf_fixed))
        p_new, c2n = [], []
        for s, (q, a) in enumerate(zip(p, asm)):
            dc = dcs[s if solve_each else 0].to(q.kf_R.device)
            with on_device(q.kf_R.device):
                p_new.append(_apply_updates(q, dc, *a[2:5]))
                c2n.append(_assemble_shard(p_new[-1], huber, lm_damp)[5])
        c2n = reduce(c2n)
        # keep the update only if chi2 did not blow up (the same verdict
        # on every shard: the sums are the same)
        p = [BAProblem(*[None if x is None else torch.where(
            (c <= c2 * 1.001).view((-1,) + (1,) * (x.dim() - 1)), x, y)
            for x, y in zip(qn, q)]) for qn, q, c, c2 in zip(p_new, p, c2n, chi2)]
    fin = []
    for q in p:
        with on_device(q.kf_R.device):
            fin.append(_assemble_shard(q, huber, lm_damp))
    chi2, n_obs = (reduce([a[i] for a in fin]) for i in (5, 6))
    return ([_cast(BAProblem(*[None if a is None else a[0] for a in q]), dtype)
             for q in p], BAStats(chi2=chi2[0][0].to(dtype), n_obs=n_obs[0][0]))


def bundle_adjust_sharded(prob: BAProblem, mesh, axis: str = "ba", *,
                          n_iter: int = 10, huber: float = 1.0 / 250.0,
                          damping: float = 1e-4, lm_damp: float = 1e-8,
                          pose_prior: float = 0.0,
                          comm_identity: bool = False):
    """Distributed BA: landmark rows (and their observations) split over
    `axis` of `mesh`, poses replicated. Each shard assembles its partial
    reduced system on its device, one `Mesh.psum` gives every shard the
    global S, b and chi2, the solve is replicated and back-substitution is
    local. L must be divisible by the axis size. `prob` is a whole problem
    (numpy leaves or tensors) or `shard_problem`'s Shards; returns
    (problem, stats) with every landmark row, on the mesh's first device.

    comm_identity=True replaces every psum with a local `x * n_dev`
    (numerically wrong, for timing only; each shard then solves its own
    system, as the JAX package's shards do): the wall-clock difference
    from the real reduction isolates its cost."""
    n = mesh.axis_size(axis)
    parts = prob if isinstance(prob, Shards) else shard_problem(prob, mesh, axis)
    if comm_identity:
        def reduce(xs):
            return [x * n for x in xs]
    else:
        def reduce(xs):
            return mesh.psum(xs, axis)
    out, stats = _bundle_adjust_parts(
        parts, reduce, global_slots(parts, mesh), n_iter=n_iter, huber=huber,
        damping=damping, lm_damp=lm_damp, pose_prior=pose_prior,
        solve_each=comm_identity)
    return join_problem(out), stats


def _obs_line_coeffs(sf, ef):
    """Observed unit-plane line coefficients from per-observation endpoint
    bearings: l = s x e normalised over (l1,l2). Zeros when degenerate;
    those rows keep the endpoint-reprojection residual."""
    zs = np.where(np.abs(sf[..., 2:3]) < 1e-10, 1e-10, sf[..., 2:3])
    ze = np.where(np.abs(ef[..., 2:3]) < 1e-10, 1e-10, ef[..., 2:3])
    sp = np.concatenate([sf[..., :2] / zs, np.ones_like(zs)], -1)
    ep = np.concatenate([ef[..., :2] / ze, np.ones_like(ze)], -1)
    line = np.cross(sp, ep)
    n = np.linalg.norm(line[..., :2], axis=-1, keepdims=True)
    return np.where(n > 1e-8, line / np.maximum(n, 1e-12),
                    0.0).astype(np.float32)


def problem_from_map(map_state, cfg):
    """BAProblem (numpy leaves) over the whole live map: point landmarks
    plus line endpoints, each endpoint a landmark row with the
    point-to-line observation model. Returns (problem, meta)."""
    m = map_state
    P_rows = np.where(m.pt_status >= 2)[0]
    L_rows = np.where(m.ln_status >= 2)[0]
    O = cfg.caps.max_obs_per_landmark

    pos = [m.pt_pos[P_rows]]
    obs_kf = [m.pt_obs_kf[P_rows]]
    obs_f = [m.pt_obs_f[P_rows]]
    obs_line = [np.zeros((len(P_rows), O, 3), np.float32)]
    ln_l = _obs_line_coeffs(m.ln_obs_sf[L_rows], m.ln_obs_ef[L_rows])
    pos += [m.ln_spos[L_rows], m.ln_epos[L_rows]]
    obs_kf += [m.ln_obs_kf[L_rows], m.ln_obs_kf[L_rows]]
    obs_f += [m.ln_obs_sf[L_rows], m.ln_obs_ef[L_rows]]
    obs_line += [ln_l, ln_l]
    seg_d = (m.ln_epos[L_rows] - m.ln_spos[L_rows]).astype(np.float32)
    seg_d /= np.maximum(np.linalg.norm(seg_d, axis=-1, keepdims=True), 1e-12)
    lm_dir = [np.zeros((len(P_rows), 3), np.float32), seg_d, seg_d]

    pos = np.concatenate(pos, 0) if len(P_rows) + len(L_rows) else np.zeros((0, 3))
    obs_kf = np.concatenate(obs_kf, 0) if len(pos) else np.zeros((0, O), np.int32)
    obs_f = np.concatenate(obs_f, 0) if len(pos) else np.zeros((0, O, 3))
    obs_line = (np.concatenate(obs_line, 0) if len(pos)
                else np.zeros((0, O, 3), np.float32))
    lm_dir = (np.concatenate(lm_dir, 0) if len(pos)
              else np.zeros((0, 3), np.float32))
    n = len(pos)
    occ = m.kf_occupied
    # gauge: fix the oldest occupied keyframe
    fixed = np.zeros(len(occ), bool)
    occ_idx = np.where(occ)[0]
    if len(occ_idx):
        fixed[occ_idx[np.argmin(m.kf_frame_id[occ_idx])]] = True
    ov = (obs_kf >= 0) & occ[np.maximum(obs_kf, 0)]
    meta = {"n_points": len(P_rows), "n_lines": len(L_rows),
            "pt_rows": P_rows, "ln_rows": L_rows}
    return BAProblem(
        kf_R=m.kf_R.copy(), kf_t=m.kf_t.copy(), kf_fixed=fixed,
        lm_pos=np.asarray(pos, np.float32), lm_valid=np.ones(n, bool),
        obs_kf=np.asarray(obs_kf, np.int32),
        obs_f=np.asarray(obs_f, np.float32), obs_valid=ov,
        obs_line=np.asarray(obs_line, np.float32),
        lm_dir=np.asarray(lm_dir, np.float32)), meta


def problem_blob(prob: BAProblem):
    """Pack a host-built BAProblem into one flat f32 array (one upload) and
    the static shape spec for bundle_adjust_blob. Integer leaves ride as
    f32 (all < 2^24); bools as 0/1."""
    leaves = [prob.kf_R, prob.kf_t, prob.kf_fixed, prob.lm_pos,
              prob.lm_valid, prob.obs_kf, prob.obs_f, prob.obs_valid]
    has_line = prob.obs_line is not None
    if has_line:
        leaves += [prob.obs_line, prob.lm_dir]
    blob = np.concatenate([_host(a).astype(np.float32).ravel()
                           for a in leaves])
    K = _host(prob.kf_R).shape[0]
    L, O = _host(prob.obs_kf).shape
    return blob, (K, L, O, has_line)


def _problem_from_blob(blob: torch.Tensor, spec) -> BAProblem:
    """Unpack the problem_blob layout (on the blob's device); a (R, n)
    stack of blobs gives a problem with a leading axis R."""
    K, L, O, has_line = spec
    sizes = [K * 9, K * 3, K, L * 3, L, L * O, L * O * 3, L * O]
    shapes = [(K, 3, 3), (K, 3), (K,), (L, 3), (L,), (L, O), (L, O, 3),
              (L, O)]
    if has_line:
        sizes += [L * O * 3, L * 3]
        shapes += [(L, O, 3), (L, 3)]
    lead = blob.shape[:-1]
    parts = [p.reshape(lead + s)
             for p, s in zip(torch.split(blob, sizes, dim=-1), shapes)]
    (kf_R, kf_t, kf_fixed, lm_pos, lm_valid, obs_kf, obs_f,
     obs_valid) = parts[:8]
    return BAProblem(
        kf_R=kf_R, kf_t=kf_t, kf_fixed=kf_fixed > 0.5,
        lm_pos=lm_pos, lm_valid=lm_valid > 0.5, obs_kf=obs_kf.long(),
        obs_f=obs_f, obs_valid=obs_valid > 0.5,
        obs_line=parts[8] if has_line else None,
        lm_dir=parts[9] if has_line else None)


def bundle_adjust_blob(blob: torch.Tensor, *, spec, n_iter: int = 10,
                       huber: float = 1.0 / 250.0, damping: float = 1e-4,
                       lm_damp: float = 1e-8, pose_prior: float = 0.0,
                       accept_gate: bool = True):
    """bundle_adjust with the problem delivered as one packed f32 tensor
    (problem_blob), on the blob's device. R same-spec problems stacked as
    (R, n) blobs are solved at once, every leaf of the returned problem and
    stats carrying the leading R (the JAX package's vmapped
    `bundle_adjust_blob_batched`, the same function here)."""
    return bundle_adjust(_problem_from_blob(blob, spec), n_iter=n_iter,
                         huber=huber, damping=damping, lm_damp=lm_damp,
                         pose_prior=pose_prior, accept_gate=accept_gate)


bundle_adjust_blob_batched = bundle_adjust_blob


def problem_from_window(map_state, cfg, core_slots, pad_bucket: int = 256):
    """Windowed local BA problem (numpy leaves): core keyframes free,
    covisible neighbours contribute observations but stay fixed, landmarks
    restricted to those a core keyframe observes. The row count is padded
    to a multiple of `pad_bucket`. Returns (problem, meta); meta carries
    the snapshots for the guarded write-back."""
    m = map_state
    core = np.zeros(len(m.kf_occupied), bool)
    core[np.asarray(core_slots, int)] = True
    core &= m.kf_occupied

    def window_rows(status, obs_kf):
        alive = status >= 2
        seen = core[np.maximum(obs_kf, 0)] & (obs_kf >= 0)
        return np.where(alive & seen.any(axis=1))[0]

    P_rows = window_rows(m.pt_status, m.pt_obs_kf)
    L_rows = window_rows(m.ln_status, m.ln_obs_kf)
    # keep each landmark's 8 most recent observations (by write stamp): the
    # cost scales with the column count and the dropped tail is the oldest
    O = min(cfg.caps.max_obs_per_landmark, 8)

    def compact(kf_rows, stamp_rows, f_list):
        key = np.where(kf_rows >= 0, -stamp_rows, np.iinfo(np.int64).max)
        order = np.argsort(key, axis=1)[:, :O]
        kf_c = np.take_along_axis(kf_rows, order, 1)
        return kf_c, [np.take_along_axis(f, order[..., None], 1)
                      for f in f_list]

    pt_kf_c, (pt_f_c,) = compact(m.pt_obs_kf[P_rows],
                                 m.pt_obs_stamp[P_rows],
                                 [m.pt_obs_f[P_rows]])
    ln_kf_c, (ln_sf_c, ln_ef_c) = compact(
        m.ln_obs_kf[L_rows], m.ln_obs_stamp[L_rows],
        [m.ln_obs_sf[L_rows], m.ln_obs_ef[L_rows]])
    ln_l_c = _obs_line_coeffs(ln_sf_c, ln_ef_c)
    pos = [m.pt_pos[P_rows], m.ln_spos[L_rows], m.ln_epos[L_rows]]
    obs_kf = [pt_kf_c, ln_kf_c, ln_kf_c]
    obs_f = [pt_f_c, ln_sf_c, ln_ef_c]
    obs_line = [np.zeros((len(P_rows), O, 3), np.float32), ln_l_c, ln_l_c]
    seg_d = (m.ln_epos[L_rows] - m.ln_spos[L_rows]).astype(np.float32)
    seg_d /= np.maximum(np.linalg.norm(seg_d, axis=-1, keepdims=True), 1e-12)
    lm_dir = np.concatenate(
        [np.zeros((len(P_rows), 3), np.float32), seg_d, seg_d], 0)
    pos = np.concatenate(pos, 0).astype(np.float32)
    obs_kf = np.concatenate(obs_kf, 0).astype(np.int32)
    obs_f = np.concatenate(obs_f, 0).astype(np.float32)
    obs_line = np.concatenate(obs_line, 0).astype(np.float32)
    n = len(pos)
    n_pad = (-n) % pad_bucket if n else pad_bucket
    pos = np.concatenate([pos, np.zeros((n_pad, 3), np.float32)])
    obs_kf = np.concatenate([obs_kf, np.full((n_pad, O), -1, np.int32)])
    obs_f = np.concatenate([obs_f, np.zeros((n_pad, O, 3), np.float32)])
    obs_line = np.concatenate([obs_line,
                               np.zeros((n_pad, O, 3), np.float32)])
    lm_dir = np.concatenate([lm_dir, np.zeros((n_pad, 3), np.float32)])
    valid = np.zeros(n + n_pad, bool)
    valid[:n] = True

    occ = m.kf_occupied
    fixed = occ & ~core  # covisible neighbours frozen
    if not fixed.any():
        # the whole map is core: gauge-fix the oldest keyframe
        occ_idx = np.where(occ)[0]
        if len(occ_idx):
            fixed[occ_idx[np.argmin(m.kf_frame_id[occ_idx])]] = True
    fixed |= ~occ  # empty slots never move
    ov = (obs_kf >= 0) & occ[np.maximum(obs_kf, 0)]
    meta = {
        "n_points": len(P_rows), "n_lines": len(L_rows),
        "pt_rows": P_rows, "ln_rows": L_rows,
        "kf_free": np.where(occ & ~fixed)[0],
        "kf_frame_id": m.kf_frame_id.copy(),
        "pt_anchor": m.pt_anchor_kf[P_rows].copy(),
        "ln_anchor": m.ln_anchor_kf[L_rows].copy(),
    }
    return BAProblem(
        kf_R=m.kf_R.copy(), kf_t=m.kf_t.copy(), kf_fixed=fixed,
        lm_pos=pos, lm_valid=valid, obs_kf=obs_kf, obs_f=obs_f,
        obs_valid=ov & valid[:, None], obs_line=obs_line,
        lm_dir=lm_dir), meta


def write_back_window(map_state, kf_R, kf_t, lm_pos, meta):
    """Guarded write-back of windowed BA results (in pipelined mode fetched
    a drain window after the solve): only keyframes and landmark rows that
    still denote the same entity (same keyframe frame id; alive with an
    unchanged anchor) are written. Clears the map's cached device copies
    and queues the written rows for the carry (keyframe poses ride every
    delta blob). Returns (keyframes written, landmarks written)."""
    m = map_state
    kf_R, kf_t, lm_pos = (_host(a) for a in (kf_R, kf_t, lm_pos))
    ok_kf = [k for k in meta["kf_free"]
             if m.kf_occupied[k] and m.kf_frame_id[k] == meta["kf_frame_id"][k]]
    if ok_kf:
        m.kf_R[ok_kf] = kf_R[ok_kf]
        m.kf_t[ok_kf] = kf_t[ok_kf]
    npts, nln = meta["n_points"], meta["n_lines"]
    pr = meta["pt_rows"]
    ok_pt = (m.pt_status[pr] >= 2) & (m.pt_anchor_kf[pr] == meta["pt_anchor"])
    if ok_pt.any():
        m.pt_pos[pr[ok_pt]] = lm_pos[:npts][ok_pt]
    lr = meta["ln_rows"]
    ok_ln = (m.ln_status[lr] >= 2) & (m.ln_anchor_kf[lr] == meta["ln_anchor"])
    if ok_ln.any():
        m.ln_spos[lr[ok_ln]] = lm_pos[npts:npts + nln][ok_ln]
        m.ln_epos[lr[ok_ln]] = lm_pos[npts + nln:npts + 2 * nln][ok_ln]
    m.invalidate()
    m.mark_mt_dirty("pt", pr[ok_pt])
    m.mark_mt_dirty("ln", lr[ok_ln])
    return len(ok_kf), int(ok_pt.sum()) + int(ok_ln.sum())


def write_back_to_map(map_state, prob: BAProblem, meta):
    """Scatter optimised poses and landmarks (of a problem_from_map
    problem) back into the MapState."""
    m = map_state
    m.kf_R[...] = _host(prob.kf_R)
    m.kf_t[...] = _host(prob.kf_t)
    np_pos = _host(prob.lm_pos)
    npts = meta["n_points"]
    nln = meta["n_lines"]
    m.pt_pos[meta["pt_rows"]] = np_pos[:npts]
    m.ln_spos[meta["ln_rows"]] = np_pos[npts: npts + nln]
    m.ln_epos[meta["ln_rows"]] = np_pos[npts + nln: npts + 2 * nln]
    m.invalidate()
    m.mark_mt_dirty("pt", meta["pt_rows"])
    m.mark_mt_dirty("ln", meta["ln_rows"])
