"""Trajectory IO (TUM format) and ATE evaluation.

Copy of `plsvo_tpu/utils/trajectory.py` (numpy only): a TUM line is
`timestamp tx ty tz qx qy qz qw`, the camera's pose in the world; the
evaluation is Umeyama similarity alignment + RMSE.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = np.argmax(np.diag(R))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            qx = 0.25 * s
            qy = (R[0, 1] + R[1, 0]) / s
            qz = (R[0, 2] + R[2, 0]) / s
            qw = (R[2, 1] - R[1, 2]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            qx = (R[0, 1] + R[1, 0]) / s
            qy = 0.25 * s
            qz = (R[1, 2] + R[2, 1]) / s
            qw = (R[0, 2] - R[2, 0]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            qx = (R[0, 2] + R[2, 0]) / s
            qy = (R[1, 2] + R[2, 1]) / s
            qz = 0.25 * s
            qw = (R[1, 0] - R[0, 1]) / s
    return np.asarray([qx, qy, qz, qw])


def quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def write_tum(path: str, entries: Sequence[Tuple[float, np.ndarray, np.ndarray]]):
    """entries: (timestamp, R_f_w, t_f_w), written as T_w_f (the camera in
    the world)."""
    with open(path, "w") as fh:
        for ts, R_f_w, t_f_w in entries:
            R_w_f = R_f_w.T
            t_w_f = -R_f_w.T @ t_f_w
            q = rotation_to_quaternion(R_w_f)
            fh.write(
                f"{ts:.6f} {t_w_f[0]:.6f} {t_w_f[1]:.6f} {t_w_f[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def read_tum(path: str):
    """[(timestamp, position (3,), quaternion (qx, qy, qz, qw))]."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            v = [float(x) for x in line.split()]
            out.append((v[0], np.asarray(v[1:4]), np.asarray(v[4:8])))
    return out


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Similarity transform aligning src -> dst (both (N,3)).
    Returns (s, R, t) with dst ~= s * R @ src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error after similarity alignment (monocular needs
    scale alignment)."""
    s, R, t = umeyama_alignment(est_positions, gt_positions, with_scale)
    aligned = (s * (est_positions @ R.T)) + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt_positions) ** 2, -1))))
