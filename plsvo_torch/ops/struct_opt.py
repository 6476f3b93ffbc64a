"""Structure-only optimization: refine 3-D landmarks with poses fixed.

Port of `plsvo_tpu/ops/struct_opt.py`: `optimize_points` (per-landmark 3x3
GN with chi2 rollback, a fixed number of iterations: no host sync) and
`optimize_segments` (the two endpoints of each line solved as points).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from plsvo_torch.batlin import solve3x3


class StructObs(NamedTuple):
    R_f_w: torch.Tensor  # (L, O, 3, 3)
    t_f_w: torch.Tensor  # (L, O, 3)
    f_obs: torch.Tensor  # (L, O, 3)
    valid: torch.Tensor  # (L, O) bool


def _safe(z):
    return torch.where(z.abs() < 1e-10, torch.full_like(z, 1e-10), z)


def _residuals(pos_w, obs: StructObs):
    xyz = torch.einsum("loij,lj->loi", obs.R_f_w, pos_w) + obs.t_f_w
    z = _safe(xyz[..., 2])
    proj = xyz[..., :2] / z[..., None]
    obs_uv = obs.f_obs[..., :2] / _safe(obs.f_obs[..., 2:3])
    e = obs_uv - proj
    zi = 1.0 / z
    x, y = xyz[..., 0], xyz[..., 1]
    o = torch.zeros_like(x)
    dproj = torch.stack([torch.stack([zi, o, -x * zi * zi], -1),
                         torch.stack([o, zi, -y * zi * zi], -1)], -2)
    J = -torch.einsum("loik,lokj->loij", dproj, obs.R_f_w)
    return e, J


def optimize_points(pos_w, obs: StructObs, valid, *, n_iter: int = 5):
    """Returns (new_pos (L,3), improved (L,))."""
    m = obs.valid[..., None]

    def chi2_of(p):
        e, _ = _residuals(p, obs)
        return torch.where(m, e * e, torch.zeros_like(e)).sum((1, 2))

    w = obs.valid.float()
    p = pos_w.float()
    chi2_init = chi2_of(pos_w)
    best = chi2_init
    for _ in range(n_iter):
        e, J = _residuals(p, obs)
        A = torch.einsum("loik,loim,lo->lkm", J, J, w)
        b = -torch.einsum("loik,loi,lo->lk", J, e, w)
        dp = solve3x3(A, b, 1e-10)
        p_new = p + dp
        chi2_new = chi2_of(p_new)
        improved = (chi2_new < best) & valid & ~torch.isnan(dp).any(-1)
        p = torch.where(improved[:, None], p_new, p)
        best = torch.where(improved, chi2_new, best)
    return p, best < chi2_init


def optimize_segments(spos_w, epos_w, s_obs: StructObs, e_obs: StructObs,
                      valid, *, n_iter: int = 5):
    """Two independent endpoint solves. Returns (new_spos, new_epos,
    start_improved, end_improved)."""
    sp, s_ok = optimize_points(spos_w, s_obs, valid, n_iter=n_iter)
    ep, e_ok = optimize_points(epos_w, e_obs, valid, n_iter=n_iter)
    return sp, ep, s_ok, e_ok
