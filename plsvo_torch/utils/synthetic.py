"""Synthetic textured-plane scenes with exact ground truth.

Port of the plane-scene part of `plsvo_tpu/utils/synthetic.py`: the
texture generator is the same numpy code (same rng stream); rendering is
torch (ray-plane intersection + bilinear texture lookup), on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plsvo_torch.camera import PinholeCamera
from plsvo_torch.device import resolve_device
from plsvo_torch.image import half_sample


class PlaneScene(NamedTuple):
    texture: np.ndarray  # (TH, TW) float32 intensities 0..255
    texel_size: float
    plane_z: float
    origin: np.ndarray  # (2,) world-xy of texel (0, 0)


def make_texture(rng: np.random.Generator, size: int = 1024, n_blobs: int = 180,
                 n_rects: int = 40, blur: int = 2) -> np.ndarray:
    """Procedural texture rich in corners and straight edges."""
    tex = rng.uniform(90.0, 160.0, size=(size, size)).astype(np.float32)
    for _ in range(n_blobs):
        cx, cy = rng.uniform(0, size, 2)
        r = rng.uniform(3, 14)
        amp = rng.uniform(-70, 70)
        w = int(4 * r) + 1
        x0, x1 = max(0, int(cx) - w), min(size, int(cx) + w + 1)
        y0, y1 = max(0, int(cy) - w), min(size, int(cy) + w + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        tex[y0:y1, x0:x1] += (amp * np.exp(-d2 / (2 * r * r))).astype(np.float32)
    for _ in range(n_rects):
        w = int(rng.uniform(30, 160))
        h = int(rng.uniform(12, 80))
        x0 = int(rng.uniform(0, size - w))
        y0 = int(rng.uniform(0, size - h))
        amp = float(rng.uniform(-80, 80))
        tex[y0: y0 + h, x0: x0 + w] += amp
    for _ in range(blur):
        tex = 0.25 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                      + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
    return np.clip(tex, 0.0, 255.0).astype(np.float32)


def make_scene(rng: np.random.Generator, size: int = 1024,
               texel_size: float = 0.004, **tex_kw) -> PlaneScene:
    if "n_blobs" not in tex_kw:
        tex_kw["n_blobs"] = int(180 * (size / 1024) ** 2)
    if "n_rects" not in tex_kw:
        tex_kw["n_rects"] = int(40 * (size / 1024) ** 2)
    tex = make_texture(rng, size=size, **tex_kw)
    origin = -0.5 * size * texel_size * np.ones(2, np.float32)
    return PlaneScene(texture=tex, texel_size=float(texel_size), plane_z=0.0,
                      origin=origin)


def _render(scene: PlaneScene, cam: PinholeCamera, R_w_c, t_w_c, device):
    """(H, W) image of the plane through the camera (0 where the ray misses
    the plane or the texture)."""
    f32 = torch.float32
    H, W = cam.height, cam.width
    tex = torch.as_tensor(scene.texture, device=device)
    origin = torch.as_tensor(np.asarray(scene.origin, np.float32), device=device)
    R = torch.as_tensor(np.asarray(R_w_c, np.float32), device=device)
    t = torch.as_tensor(np.asarray(t_w_c, np.float32), device=device)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=f32, device=device),
                            torch.arange(W, dtype=f32, device=device),
                            indexing="ij")
    uv = torch.stack([xx, yy], -1).reshape(-1, 2)
    rays_w = cam.unproject(uv, undistort=False) @ R.T
    denom = rays_w[:, 2]
    tval = (scene.plane_z - t[2]) / torch.where(denom.abs() < 1e-9,
                                                torch.full_like(denom, 1e-9), denom)
    pw = t[None, :] + tval[:, None] * rays_w
    txy = (pw[:, :2] - origin[None, :]) / scene.texel_size
    TH, TW = tex.shape
    x = txy[:, 0].clamp(0.0, TW - 1.001)
    y = txy[:, 1].clamp(0.0, TH - 1.001)
    in_tex = ((txy[:, 0] >= 0) & (txy[:, 0] <= TW - 1) & (txy[:, 1] >= 0)
              & (txy[:, 1] <= TH - 1))
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    x1 = (x0 + 1).clamp_max(TW - 1)
    y1 = (y0 + 1).clamp_max(TH - 1)
    val = ((1 - fx) * (1 - fy) * tex[y0, x0] + fx * (1 - fy) * tex[y0, x1]
           + (1 - fx) * fy * tex[y1, x0] + fx * fy * tex[y1, x1])
    ok = (tval > 1e-6) & in_tex
    return torch.where(ok, val, torch.zeros_like(val)).reshape(H, W)


def _supersampled(cam: PinholeCamera, ss: int) -> PinholeCamera:
    # pixel-centre convention: the centre of an ss x ss block maps to the
    # original pixel centre
    return PinholeCamera.create(cam.width * ss, cam.height * ss, cam.fx * ss,
                                cam.fy * ss, cam.cx * ss + (ss - 1) / 2.0,
                                cam.cy * ss + (ss - 1) / 2.0, cam.dist)


def render_aa(scene: PlaneScene, cam: PinholeCamera, R_w_c, t_w_c, ss: int = 2,
              device=None) -> torch.Tensor:
    """Antialiased render: supersample ss x and box-downsample."""
    assert ss in (1, 2, 4)
    img = _render(scene, _supersampled(cam, ss) if ss > 1 else cam, R_w_c,
                  t_w_c, resolve_device(device))
    while ss > 1:
        img = half_sample(img)
        ss //= 2
    return img


def render_batch_aa(scene: PlaneScene, cam: PinholeCamera, Rs, ts, ss: int = 2,
                    device=None) -> torch.Tensor:
    """Render many poses: Rs (B,3,3) cam->world, ts (B,3) -> (B,H,W)."""
    device = resolve_device(device)
    return torch.stack([render_aa(scene, cam, R, t, ss=ss, device=device)
                        for R, t in zip(Rs, ts)])
