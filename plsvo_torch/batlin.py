"""Closed-form batched small-matrix linear algebra.

Port of `plsvo_tpu/batlin.py`: adjugate 2x2/3x3 inverses and an unrolled
Cholesky solve for one small SPD system. All functions broadcast over
leading batch dims.
"""
from __future__ import annotations

import torch


def _nonzero_det(det):
    return torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)


def inv2x2(A: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Adjugate inverse of (..., 2, 2) (+ eps ridge on the diagonal)."""
    a = A[..., 0, 0] + eps
    b = A[..., 0, 1]
    c = A[..., 1, 0]
    d = A[..., 1, 1] + eps
    det = _nonzero_det(a * d - b * c)
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def inv3x3(A: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Adjugate inverse of (..., 3, 3) (+ eps ridge on the diagonal)."""
    a = A[..., 0, 0] + eps
    b = A[..., 0, 1]
    c = A[..., 0, 2]
    d = A[..., 1, 0]
    e = A[..., 1, 1] + eps
    f = A[..., 1, 2]
    g = A[..., 2, 0]
    h = A[..., 2, 1]
    i = A[..., 2, 2] + eps
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = _nonzero_det(a * A00 + b * A10 + c * A20)
    adj = torch.stack([
        torch.stack([A00, A01, A02], -1),
        torch.stack([A10, A11, A12], -1),
        torch.stack([A20, A21, A22], -1),
    ], -2)
    return adj / det[..., None, None]


def solve3x3(A: torch.Tensor, b: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return (inv3x3(A, eps) @ b[..., None])[..., 0]


def solve_psd(A: torch.Tensor, b: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """x = (A + eps*I)^-1 b for small SPD systems (..., n, n) via unrolled
    Cholesky, one per leading index. Returns NaNs when A is not PD (callers
    treat NaN steps as bad)."""
    n = A.shape[-1]
    a = [[A[..., i, j] + (eps if i == j else 0.0) for j in range(n)]
         for i in range(n)]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)
