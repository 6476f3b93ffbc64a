"""The benchmark's frames: a textured plane rendered from known poses.

The technique of the port's synthetic renderer (procedural texture of
blobs and rectangles, pinhole ray casting onto the plane z = 0, bilinear
texture lookup, 2x supersampling and a 2x2 box downsample), written
here so that the frames and their ground truth belong to the benchmark
and not to the program under test. Frames are rendered on the device in
batches of poses and handed out as uint8 images.
"""
from __future__ import annotations

import numpy as np
import torch


def make_texture(rng: np.random.Generator, size: int, n_blobs: int,
                 n_rects: int, blur: int = 2) -> np.ndarray:
    """Intensities 0..255 of a (size, size) texture rich in corners and
    straight edges, drawn from rng."""
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
        tex[y0: y0 + h, x0: x0 + w] += float(rng.uniform(-80, 80))
    for _ in range(blur):
        tex = 0.25 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                      + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
    return np.clip(tex, 0.0, 255.0).astype(np.float32)


class Plane:
    """The textured plane z = 0, centred on the world origin."""

    def __init__(self, seed: int, size: int, texel_size: float,
                 n_blobs=None, n_rects=None):
        scale = (size / 1024) ** 2
        n_blobs = int(180 * scale) if n_blobs is None else n_blobs
        n_rects = int(40 * scale) if n_rects is None else n_rects
        self.texture = make_texture(np.random.default_rng(seed), size,
                                    n_blobs, n_rects)
        self.texel_size = float(texel_size)
        self.half_extent = 0.5 * size * self.texel_size
        self.origin = np.full(2, -self.half_extent, np.float32)


def _half_sample(img: torch.Tensor) -> torch.Tensor:
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    x = img[..., : h2 * 2, : w2 * 2].reshape(img.shape[:-2] + (h2, 2, w2, 2))
    return (((x[..., 0, :, 0] + x[..., 0, :, 1]) + x[..., 1, :, 0])
            + x[..., 1, :, 1]) / 4


def render(plane: Plane, cam: dict, R_w_c: np.ndarray, t_w_c: np.ndarray,
           device, ss: int = 2, chunk: int = 8) -> torch.Tensor:
    """uint8 frames (N, H, W) on `device` of the plane seen from the N
    camera-to-world poses (R_w_c (N, 3, 3), t_w_c (N, 3)); 0 where a ray
    misses the plane or the texture."""
    W, H = cam["width"] * ss, cam["height"] * ss
    fx, fy = cam["fx"] * ss, cam["fy"] * ss
    cx = cam["cx"] * ss + (ss - 1) / 2.0
    cy = cam["cy"] * ss + (ss - 1) / 2.0
    f32 = torch.float32
    tex = torch.as_tensor(plane.texture, device=device)
    TH, TW = tex.shape
    origin = torch.as_tensor(plane.origin, device=device)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=f32, device=device),
                            torch.arange(W, dtype=f32, device=device),
                            indexing="ij")
    rays_c = torch.stack([(xx - cx) / fx, (yy - cy) / fy,
                          torch.ones_like(xx)], -1).reshape(-1, 3)
    out = []
    for a in range(0, len(R_w_c), chunk):
        R = torch.as_tensor(np.asarray(R_w_c[a:a + chunk], np.float32),
                            device=device)
        t = torch.as_tensor(np.asarray(t_w_c[a:a + chunk], np.float32),
                            device=device)
        rays = torch.einsum("pk,njk->npj", rays_c, R)  # (n, P, 3) world
        dz = rays[..., 2]
        dz = torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
        tval = -t[:, None, 2] / dz
        pw = t[:, None, :2] + tval[..., None] * rays[..., :2]
        txy = (pw - origin) / plane.texel_size
        x = txy[..., 0].clamp(0.0, TW - 1.001)
        y = txy[..., 1].clamp(0.0, TH - 1.001)
        inside = ((txy[..., 0] >= 0) & (txy[..., 0] <= TW - 1)
                  & (txy[..., 1] >= 0) & (txy[..., 1] <= TH - 1))
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        u, v = x - x0, y - y0
        x1, y1 = (x0 + 1).clamp_max(TW - 1), (y0 + 1).clamp_max(TH - 1)
        val = ((1 - u) * (1 - v) * tex[y0, x0] + u * (1 - v) * tex[y0, x1]
               + (1 - u) * v * tex[y1, x0] + u * v * tex[y1, x1])
        img = torch.where((tval > 1e-6) & inside, val, torch.zeros_like(val))
        img = img.reshape(-1, H, W)
        for _ in range(ss.bit_length() - 1):
            img = _half_sample(img)
        out.append(img.round().clamp(0, 255).to(torch.uint8))
    return torch.cat(out)
