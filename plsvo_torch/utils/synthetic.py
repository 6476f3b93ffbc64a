"""Synthetic scenes with exact ground truth.

Port of `plsvo_tpu/utils/synthetic.py`: textured planes (procedural or a
photograph), planes with textured boxes standing on them, and camera
trajectories. The texture generator is the same numpy code (same rng
stream); rendering is torch (ray casting + bilinear texture lookup), on
any device, through any camera model of `plsvo_torch.camera`. The
renderers return the image only (the JAX package's also return depth;
`depth_at` gives ground-truth depth at given pixels).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plsvo_torch.camera import ATANCamera, PinholeCamera
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


def _pixel_rays(cam, R, undistort: bool):
    """World-frame rays (H*W, 3) through every pixel centre, row-major."""
    f32 = torch.float32
    yy, xx = torch.meshgrid(torch.arange(cam.height, dtype=f32, device=R.device),
                            torch.arange(cam.width, dtype=f32, device=R.device),
                            indexing="ij")
    uv = torch.stack([xx, yy], -1).reshape(-1, 2)
    return cam.unproject(uv, undistort=undistort) @ R.T


def _pose(R_w_c, t_w_c, device):
    return (torch.as_tensor(np.asarray(R_w_c, np.float32), device=device),
            torch.as_tensor(np.asarray(t_w_c, np.float32), device=device))


def _render(scene: PlaneScene, cam, R_w_c, t_w_c, device, undistort: bool,
            with_depth: bool = False):
    """(H, W) image of the plane through the camera (0 where the ray misses
    the plane or the texture). undistort: cast the rays of the distorted
    pixels (a camera with distortion renders distorted images). With
    with_depth, (image, depth along the camera's z axis, inf where the ray
    misses)."""
    H, W = cam.height, cam.width
    tex = torch.as_tensor(scene.texture, device=device)
    origin = torch.as_tensor(np.asarray(scene.origin, np.float32), device=device)
    R, t = _pose(R_w_c, t_w_c, device)
    rays_w = _pixel_rays(cam, R, undistort)
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
    img = torch.where(ok, val, torch.zeros_like(val)).reshape(H, W)
    if not with_depth:
        return img
    z = ((pw - t[None, :]) @ R)[:, 2]
    depth = torch.where(ok, z, torch.full_like(z, float("inf")))
    return img, depth.reshape(H, W)


def render(scene: PlaneScene, cam, R_w_c, t_w_c, device=None):
    """Point-sampled render of the plane through the camera (R_w_c, t_w_c
    cam->world): (image (H, W), depth along the camera's z axis (H, W)),
    0 and inf where the ray misses the plane or the texture."""
    return _render(scene, cam, R_w_c, t_w_c, resolve_device(device),
                   cam.has_distortion, with_depth=True)


def _supersampled(cam, ss: int):
    # pixel-centre convention: the centre of an ss x ss block maps to the
    # original pixel centre; an ATAN camera keeps its FOV parameter
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    if isinstance(cam, ATANCamera):
        return ATANCamera(fx=f32(cam.fx * ss), fy=f32(cam.fy * ss),
                          cx=f32(cam.cx * ss + (ss - 1) / 2.0),
                          cy=f32(cam.cy * ss + (ss - 1) / 2.0), w=cam.w,
                          width=cam.width * ss, height=cam.height * ss)
    return PinholeCamera.create(cam.width * ss, cam.height * ss, cam.fx * ss,
                                cam.fy * ss, cam.cx * ss + (ss - 1) / 2.0,
                                cam.cy * ss + (ss - 1) / 2.0, cam.dist)


def _downsampled(img: torch.Tensor, ss: int) -> torch.Tensor:
    while ss > 1:
        img = half_sample(img)
        ss //= 2
    return img


def render_aa(scene: PlaneScene, cam, R_w_c, t_w_c, ss: int = 2,
              device=None, undistort=None) -> torch.Tensor:
    """Antialiased render: supersample ss x and box-downsample. A camera
    with distortion renders distorted images (undistort=None: as
    cam.has_distortion says)."""
    assert ss in (1, 2, 4)
    if undistort is None:
        undistort = cam.has_distortion
    img = _render(scene, _supersampled(cam, ss) if ss > 1 else cam, R_w_c,
                  t_w_c, resolve_device(device), undistort)
    return _downsampled(img, ss)


def render_batch_aa(scene: PlaneScene, cam: PinholeCamera, Rs, ts, ss: int = 2,
                    device=None) -> torch.Tensor:
    """Render many poses: Rs (B,3,3) cam->world, ts (B,3) -> (B,H,W). Casts
    the undistorted rays whatever the camera's distortion, as the JAX
    package's render_batch_aa does."""
    assert ss in (1, 2)
    device = resolve_device(device)
    return torch.stack([render_aa(scene, cam, R, t, ss=ss, device=device,
                                  undistort=False) for R, t in zip(Rs, ts)])


def orbit_trajectory(n_frames: int, radius: float = 0.25, height: float = -2.0,
                     advance: float = 0.012):
    """Smooth sideways + forward camera sweep above the plane, looking down
    the +z axis (world plane at z = 0, camera at z ~ -2). Returns a list of
    (R_w_c, t_w_c) numpy arrays."""
    poses = []
    for i in range(n_frames):
        ang = 0.04 * np.sin(0.25 * i)
        R = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                      [np.sin(ang), np.cos(ang), 0.0],
                      [0.0, 0.0, 1.0]], np.float32)
        t = np.array([radius * np.sin(0.08 * i), 0.35 * radius * np.sin(0.05 * i),
                      height + advance * i], np.float32)
        poses.append((R, t))
    return poses


def depth_at(scene: PlaneScene, cam, R_w_c, t_w_c, uv, device=None):
    """Ground-truth depth (camera-frame z) of the plane at pixels uv
    (..., 2)."""
    device = resolve_device(device)
    R, t = _pose(R_w_c, t_w_c, device)
    uv = torch.as_tensor(np.asarray(uv, np.float32) if not torch.is_tensor(uv)
                         else uv, device=device)
    rays_c = cam.unproject(uv, undistort=cam.has_distortion)
    denom = (rays_c @ R.T)[..., 2]
    tval = (scene.plane_z - t[2]) / torch.where(
        denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    return tval * rays_c[..., 2]


class BoxScene(NamedTuple):
    """Non-planar scene: the textured ground plane of PlaneScene plus B
    axis-aligned textured boxes standing on it (several depth layers,
    occlusions and true 3-D line segments)."""

    texture: np.ndarray  # (TH, TW) shared by ground and faces
    texel_size: float
    plane_z: float
    origin: np.ndarray  # (2,)
    box_min: np.ndarray  # (B, 3) world min corner (z in [-h, 0])
    box_max: np.ndarray  # (B, 3)


def make_box_scene(rng: np.random.Generator, size: int = 1024,
                   texel_size: float = 0.004, n_boxes: int = 10,
                   height_range=(0.15, 0.45), extent: float = 1.6,
                   texture: np.ndarray = None) -> BoxScene:
    """Boxes of 15-45 cm height on the z = 0 plane (the same rng stream as
    the JAX package's)."""
    if texture is None:
        plane = make_scene(rng, size=size, texel_size=texel_size)
        tex, origin = plane.texture, plane.origin
    else:
        tex = texture.astype(np.float32)
        h, w = texture.shape
        origin = np.asarray([-0.5 * w * texel_size, -0.5 * h * texel_size],
                            np.float32)
    bmin, bmax = [], []
    for _ in range(n_boxes):
        cx, cy = rng.uniform(-extent / 2, extent / 2, 2)
        wx, wy = rng.uniform(0.12, 0.4, 2)
        h = rng.uniform(*height_range)
        bmin.append([cx - wx / 2, cy - wy / 2, -h])
        bmax.append([cx + wx / 2, cy + wy / 2, 0.0])
    return BoxScene(texture=tex, texel_size=float(texel_size), plane_z=0.0,
                    origin=origin, box_min=np.asarray(bmin, np.float32),
                    box_max=np.asarray(bmax, np.float32))


def _tex_lookup(tex, origin, texel_size, px, py):
    """Bilinear texture fetch at planar coords (meters), wrapped (boxes may
    map slightly outside the ground footprint)."""
    TH, TW = tex.shape
    tx = torch.remainder((px - origin[0]) / texel_size, TW - 1.001)
    ty = torch.remainder((py - origin[1]) / texel_size, TH - 1.001)
    x0 = torch.floor(tx).long()
    y0 = torch.floor(ty).long()
    fx = tx - x0
    fy = ty - y0
    x1 = (x0 + 1).clamp_max(TW - 1)
    y1 = (y0 + 1).clamp_max(TH - 1)
    return ((1 - fx) * (1 - fy) * tex[y0, x0] + fx * (1 - fy) * tex[y0, x1]
            + (1 - fx) * fy * tex[y1, x0] + fx * fy * tex[y1, x1])


def _render_boxes(scene: BoxScene, cam, R_w_c, t_w_c, device):
    """Ray-cast the ground plane and the boxes (slab test), nearest hit
    wins; faces textured by the hit face's axis."""
    H, W = cam.height, cam.width
    tex = torch.as_tensor(scene.texture, device=device)
    origin = torch.as_tensor(np.asarray(scene.origin, np.float32), device=device)
    bmin = torch.as_tensor(scene.box_min, device=device)
    bmax = torch.as_tensor(scene.box_max, device=device)
    R, o = _pose(R_w_c, t_w_c, device)
    rays_w = _pixel_rays(cam, R, False)
    inf = torch.tensor(float("inf"), device=device)

    def safe(x):
        return torch.where(x.abs() < 1e-9, torch.full_like(x, 1e-9), x)

    t_pl = (scene.plane_z - o[2]) / safe(rays_w[:, 2])
    t_pl = torch.where(t_pl > 1e-6, t_pl, inf)
    inv_d = 1.0 / safe(rays_w[:, None, :])  # (N, 1, 3)
    t1 = (bmin[None] - o[None, None]) * inv_d  # (N, B, 3)
    t2 = (bmax[None] - o[None, None]) * inv_d
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    tnear = tmin.max(-1).values
    tfar = tmax.min(-1).values
    hit_b = (tnear <= tfar) & (tnear > 1e-6)
    tnear = torch.where(hit_b, tnear, inf)
    axis_b = torch.argmax(tmin, -1)  # entry face axis
    b_best = torch.argmin(tnear, -1)
    t_bx = torch.gather(tnear, 1, b_best[:, None])[:, 0]
    ax_bx = torch.gather(axis_b, 1, b_best[:, None])[:, 0]
    use_box = t_bx < t_pl
    t_hit = torch.where(use_box, t_bx, t_pl)
    valid = torch.isfinite(t_hit)
    pw = o[None] + t_hit[:, None] * rays_w
    # the plane counts as a z-face; a per-box texel offset decorrelates
    # faces that share world coordinates
    off = (37.0 * scene.texel_size) * b_best.to(torch.float32)
    axis = torch.where(use_box, ax_bx, torch.full_like(ax_bx, 2))
    px = torch.where(axis == 0, pw[:, 1] + off,
                     torch.where(axis == 1, pw[:, 0] + off, pw[:, 0]))
    py = torch.where(axis == 2, pw[:, 1], pw[:, 2] * 2.0 + off)
    val = _tex_lookup(tex, origin, scene.texel_size, px, py)
    return torch.where(valid, val, torch.zeros_like(val)).reshape(H, W)


def render_boxes_aa(scene: BoxScene, cam: PinholeCamera, R_w_c, t_w_c,
                    ss: int = 2, device=None) -> torch.Tensor:
    """Antialiased box-scene render (the supersampling of render_aa)."""
    assert ss in (1, 2)
    img = _render_boxes(scene, _supersampled(cam, ss) if ss > 1 else cam,
                        R_w_c, t_w_c, resolve_device(device))
    return _downsampled(img, ss)


def make_photo_scene(texel_size: float = 0.003, tiles: int = 2) -> PlaneScene:
    """A plane textured with a photograph (matplotlib's bundled
    grace_hopper.jpg, read through PIL), mirror-tiled tiles x tiles so the
    seams stay continuous. Needs matplotlib and Pillow."""
    from matplotlib import cbook
    from PIL import Image

    with cbook.get_sample_data("grace_hopper.jpg") as f:
        img = np.asarray(Image.open(f).convert("L"), np.float32)
    rows = []
    for ty in range(tiles):
        row = []
        for tx in range(tiles):
            t = img
            if tx % 2 == 1:
                t = t[:, ::-1]
            if ty % 2 == 1:
                t = t[::-1, :]
            row.append(t)
        rows.append(np.concatenate(row, axis=1))
    tex = np.ascontiguousarray(np.concatenate(rows, axis=0))
    h, w = tex.shape
    origin = np.asarray([-0.5 * w * texel_size, -0.5 * h * texel_size],
                        np.float32)
    return PlaneScene(texture=tex, texel_size=float(texel_size), plane_z=0.0,
                      origin=origin)
