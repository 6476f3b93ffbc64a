"""Visualization: annotated tracking frames and a 3-D map plot.

Port of `plsvo_tpu/utils/viz.py`. Headless: `draw_tracks` annotates a
frame in numpy (the debug_img analogue), `save_frame_png` writes it with
the port's own PNG encoder (no image library needed), and `save_map_plot`
renders landmarks and the trajectory with matplotlib, imported when called.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from plsvo_torch.utils import imageio


def draw_tracks(img: np.ndarray, pt_uv: np.ndarray, pt_valid: np.ndarray,
                seg_suv: Optional[np.ndarray] = None,
                seg_euv: Optional[np.ndarray] = None,
                seg_valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Annotate a grayscale frame with tracked points (squares) and line
    segments — the debug_img analogue. Returns an (H,W,3) uint8 image."""
    H, W = img.shape
    out = np.stack([img] * 3, -1).astype(np.uint8)

    def mark_px(y, x, color):
        if 0 <= y < H and 0 <= x < W:
            out[y, x] = color

    green = np.asarray([0, 255, 0], np.uint8)
    red = np.asarray([255, 60, 60], np.uint8)
    for (u, v), ok in zip(np.asarray(pt_uv), np.asarray(pt_valid)):
        if not ok:
            continue
        ui, vi = int(round(u)), int(round(v))
        for d in range(-3, 4):
            mark_px(vi - 3, ui + d, green)
            mark_px(vi + 3, ui + d, green)
            mark_px(vi + d, ui - 3, green)
            mark_px(vi + d, ui + 3, green)
    if seg_suv is not None:
        for sp, ep, ok in zip(np.asarray(seg_suv), np.asarray(seg_euv),
                              np.asarray(seg_valid)):
            if not ok:
                continue
            n = int(max(abs(ep[0] - sp[0]), abs(ep[1] - sp[1]))) + 1
            for a in np.linspace(0.0, 1.0, n):
                p = sp + a * (ep - sp)
                mark_px(int(round(p[1])), int(round(p[0])), red)
    return out


def save_map_plot(path: str, map_state, trajectory: Sequence[np.ndarray],
                  gt_trajectory: Optional[Sequence[np.ndarray]] = None):
    """3D scatter of landmarks + camera trajectory (sceneRepresentation
    analogue, saved to PNG)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    pts = map_state.pt_pos[map_state.pt_status > 0]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=2, c="steelblue",
                   label=f"points ({len(pts)})")
    act = map_state.ln_status > 0
    for sp, ep in zip(map_state.ln_spos[act], map_state.ln_epos[act]):
        ax.plot([sp[0], ep[0]], [sp[1], ep[1]], [sp[2], ep[2]],
                c="indianred", lw=1)
    if len(trajectory):
        tr = np.stack(trajectory)
        ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], c="black", lw=2, label="estimate")
    if gt_trajectory is not None and len(gt_trajectory):
        g = np.stack(gt_trajectory)
        ax.plot(g[:, 0], g[:, 1], g[:, 2], c="green", lw=1, ls="--", label="GT")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.legend(loc="upper left", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_frame_png(path: str, annotated: np.ndarray):
    """Write an (H, W, 3) uint8 frame as an RGB PNG."""
    imageio.write_png(path, annotated)
