"""The one traffic generator: a camera circling above the textured plane.

A traffic mix (`traffic/<mix>.json`) gives the orbit's radius, the
travel per frame, the depth of the plane, the wobbles of yaw and height
(whole cycles per period, so that the orbit closes), the texture and the
per-stream phase step. One period of P frames is rendered and replayed
cyclically: stream k's frame i is the orbit's frame (i + seed + k * phase)
mod P. The texture is the mix's own (`texture_seed`), the same for every
seed.
"""
from __future__ import annotations

import json
import math

import numpy as np


def load(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def period(mix: dict) -> int:
    """Frames in one closed orbit."""
    return int(round(2 * math.pi * mix["radius_m"] / mix["step_m"]))


def poses(mix: dict):
    """Camera-to-world poses of one period: (R_w_c (P, 3, 3), t_w_c (P, 3))
    in float64. The camera looks down the world's +z axis at the plane
    z = 0 from z = -depth; it yaws about its optical axis."""
    P = period(mix)
    ph = 2 * math.pi * np.arange(P) / P
    r = mix["radius_m"]
    yaw = mix["yaw_wobble_rad"] * np.sin(mix["yaw_wobble_cycles"] * ph)
    z = -(mix["depth_m"] + mix["height_wobble_m"]
          * np.sin(mix["height_wobble_cycles"] * ph))
    t = np.stack([r * np.cos(ph), r * np.sin(ph), z], -1)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros((P, 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
    R[:, 2, 2] = 1.0
    return R, t


def stream_offsets(mix: dict, n_streams: int, seed: int):
    """First orbit frame of each stream: the seed picks where on the
    orbit stream 0 starts, so that every seed replays the same frames in
    another order."""
    P = period(mix)
    return [(seed + int(round(k * mix["stream_phase_step"] * P))) % P
            for k in range(n_streams)]


def view_half_diagonal(mix: dict, cam: dict) -> float:
    """Half-diagonal (m) of the camera's footprint on the plane at the
    orbit's greatest depth."""
    d = mix["depth_m"] + mix["height_wobble_m"]
    hx = d * max(cam["cx"], cam["width"] - cam["cx"]) / cam["fx"]
    hy = d * max(cam["cy"], cam["height"] - cam["cy"]) / cam["fy"]
    return math.hypot(hx, hy)
