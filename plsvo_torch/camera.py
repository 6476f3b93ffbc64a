"""Camera models with batched project/unproject.

Port of `plsvo_tpu/camera.py`: the pinhole with radial-tangential
distortion and the ATAN (FOV) model. Intrinsics are Python floats rounded
through f32 (the device code folds them in as scalars); width/height are
ints. All methods broadcast over leading batch dims and compute on the
device of the tensors they are given. The pipeline tracks on a pinhole
camera; a distorted camera's images are undistorted once on ingest
(`utils.dataset`) and tracked with `cam.ideal()`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class PinholeCamera:
    """Pinhole + radial-tangential distortion [k1, k2, p1, p2, k3]."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: Tuple[float, float, float, float, float] = (0.0,) * 5
    width: int = 752
    height: int = 480

    @classmethod
    def create(cls, width, height, fx, fy, cx, cy, dist=None):
        d = [0.0] * 5 if dist is None else [float(x) for x in np.asarray(dist).ravel()]
        d = tuple((d + [0.0] * 5)[:5])
        # round through f32 so the arithmetic matches a camera whose
        # intrinsics are f32 arrays
        return cls(fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
                   dist=tuple(_f32(x) for x in d),
                   width=int(width), height=int(height))

    @property
    def has_distortion(self) -> bool:
        return any(abs(d) > 1e-12 for d in self.dist)

    def focal(self):
        return self.fx

    def distort(self, uv_n: torch.Tensor) -> torch.Tensor:
        x, y = uv_n[..., 0], uv_n[..., 1]
        k1, k2, p1, p2, k3 = self.dist
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return torch.stack([xd, yd], -1)

    def undistort(self, uv_n: torch.Tensor, iters: int = 8) -> torch.Tensor:
        cur = uv_n
        for _ in range(iters):
            cur = uv_n - (self.distort(cur) - cur)
        return cur

    def project(self, xyz: torch.Tensor, distort: bool = True) -> torch.Tensor:
        """Camera-frame 3D points (...,3) -> pixel coords (...,2)."""
        z = xyz[..., 2]
        zs = torch.where(z.abs() < 1e-10, torch.full_like(z, 1e-10), z)
        uv_n = xyz[..., :2] / zs[..., None]
        if distort:
            uv_n = self.distort(uv_n)
        return torch.stack([self.fx * uv_n[..., 0] + self.cx,
                            self.fy * uv_n[..., 1] + self.cy], -1)

    def unproject(self, uv: torch.Tensor, undistort: bool = True) -> torch.Tensor:
        """Pixels (...,2) -> unit bearing vectors (...,3)."""
        uv_n = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                            (uv[..., 1] - self.cy) / self.fy], -1)
        if undistort:
            uv_n = self.undistort(uv_n)
        f = torch.cat([uv_n, torch.ones_like(uv_n[..., :1])], -1)
        return f / torch.linalg.norm(f, dim=-1, keepdim=True)

    def is_in_frame(self, uv: torch.Tensor, border: float = 0.0,
                    level: int = 0) -> torch.Tensor:
        """vk::AbstractCamera::isInFrame analogue, at a pyramid level."""
        return _in_frame(uv, self.width, self.height, border, level)

    def ideal(self) -> "PinholeCamera":
        """The distortion-free copy the VO tracks with."""
        return dataclasses.replace(self, dist=(0.0,) * 5)


def _f32(x) -> float:
    return float(np.float32(x))


def _in_frame(uv, width, height, border, level):
    scale = 1.0 / (1 << level)
    return ((uv[..., 0] >= border) & (uv[..., 1] >= border)
            & (uv[..., 0] < width * scale - border)
            & (uv[..., 1] < height * scale - border))


@dataclass(frozen=True)
class ATANCamera:
    """FOV / ATAN camera (Devernay-Faugeras), vk::ATANCamera analogue.
    fx, fy, cx, cy are in pixels; `create` takes them normalized, as the
    reference's dataset YAML gives them."""

    fx: float
    fy: float
    cx: float
    cy: float
    w: float  # FOV distortion parameter
    width: int = 752
    height: int = 480

    @classmethod
    def create(cls, width, height, fx, fy, cx, cy, w):
        return cls(fx=_f32(fx * width), fy=_f32(fy * height),
                   cx=_f32(cx * width - 0.5), cy=_f32(cy * height - 0.5),
                   w=_f32(w), width=int(width), height=int(height))

    @property
    def has_distortion(self) -> bool:
        return abs(self.w) > 1e-8

    def focal(self):
        return self.fx

    @property
    def _tan_half(self) -> float:
        # tan(w / 2) in f32, as the JAX package evaluates it
        return float(np.tan(np.float32(self.w) * np.float32(0.5)))

    def _rd_factor(self, r: torch.Tensor) -> torch.Tensor:
        """rd / r for the FOV model: rd = atan(2 r tan(w/2)) / w."""
        th = self._tan_half
        safe_r = torch.where(r < 1e-8, torch.full_like(r, 1e-8), r)
        factor = torch.atan(2.0 * safe_r * th) / (self.w * safe_r)
        return torch.where(r < 1e-8, torch.full_like(r, 2.0 * th / self.w),
                           factor)

    def distort(self, uv_n: torch.Tensor) -> torch.Tensor:
        """Unit-plane ideal -> distorted normalized coords."""
        r = torch.linalg.norm(uv_n, dim=-1)
        return uv_n * self._rd_factor(r)[..., None]

    def project(self, xyz: torch.Tensor, distort: bool = True) -> torch.Tensor:
        z = xyz[..., 2]
        zs = torch.where(z.abs() < 1e-10, torch.full_like(z, 1e-10), z)
        uv_n = xyz[..., :2] / zs[..., None]
        if distort:
            uv_n = self.distort(uv_n)
        return torch.stack([self.fx * uv_n[..., 0] + self.cx,
                            self.fy * uv_n[..., 1] + self.cy], -1)

    def unproject(self, uv: torch.Tensor, undistort: bool = True) -> torch.Tensor:
        uv_n = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                            (uv[..., 1] - self.cy) / self.fy], -1)
        if undistort:
            rd = torch.linalg.norm(uv_n, dim=-1)
            safe_rd = torch.where(rd < 1e-8, torch.full_like(rd, 1e-8), rd)
            r = torch.tan(safe_rd * self.w) / (2.0 * self._tan_half)
            factor = torch.where(rd < 1e-8, torch.ones_like(rd), r / safe_rd)
            uv_n = uv_n * factor[..., None]
        f = torch.cat([uv_n, torch.ones_like(uv_n[..., :1])], -1)
        return f / torch.linalg.norm(f, dim=-1, keepdim=True)

    def is_in_frame(self, uv: torch.Tensor, border: float = 0.0,
                    level: int = 0) -> torch.Tensor:
        return _in_frame(uv, self.width, self.height, border, level)

    def ideal(self) -> PinholeCamera:
        """The undistorted pinhole the VO runs on after undistort-once: the
        same fx, fy, cx, cy."""
        return PinholeCamera.create(self.width, self.height, self.fx, self.fy,
                                    self.cx, self.cy)



def project2d(xyz: torch.Tensor) -> torch.Tensor:
    """vk::project2d analogue: (..., 3) -> (..., 2) on the unit plane (a
    depth within 1e-10 of zero divides by 1e-10)."""
    z = xyz[..., 2:3]
    return xyz[..., :2] / torch.where(z.abs() < 1e-10,
                                      torch.full_like(z, 1e-10), z)


def unproject2d(uv: torch.Tensor) -> torch.Tensor:
    """vk::unproject2d analogue: (..., 2) -> (..., 3) with z = 1."""
    return torch.cat([uv, torch.ones_like(uv[..., :1])], -1)
