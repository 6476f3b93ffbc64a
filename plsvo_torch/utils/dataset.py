"""Datasets: image-folder replay with a `dataset_params.yaml` camera.

Port of `plsvo_tpu/utils/dataset.py`. The reference's YAML schema is
accepted (a `cam0:` mapping of cam_model / cam_width / ... / cam_d3, and
images_subfolder), read by a parser of the port's own. Undistortion follows
the reference: images are undistorted once on the host with the calibrated
camera, and the VO tracks with the ideal pinhole (`ideal_camera`).

Images are decoded on the host by the first reader that works: the port's
native loader (`plsvo_torch.native.loader`), cv2, PIL, then the numpy
PNG/PGM decoder of `utils.imageio`; `last_decoder` names the one that
served the last image.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from plsvo_torch.camera import ATANCamera, PinholeCamera
from plsvo_torch.device import resolve_device
from plsvo_torch.utils import imageio

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".pgm", ".ppm", ".bmp", ".tif", ".tiff")

last_decoder: Optional[str] = None  # "native", "cv2", "PIL" or "numpy"

# YAML 1.1 scalars as yaml.safe_load resolves them (the decimal forms)
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_BOOL = {"yes": True, "no": False, "true": True, "false": False, "on": True,
         "off": False}


def _yaml_scalar(text: str):
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s.lower() in _BOOL and s in (s.lower(), s.capitalize(), s.upper()):
        return _BOOL[s.lower()]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        return float(v.replace(".", "") if v[-3:] in ("inf", "nan") else v)
    return s


def parse_yaml(text: str) -> dict:
    """The block mappings of a dataset YAML: top-level `key: value` lines and
    `key:` lines opening a mapping of indented `key: value` lines, with
    comments and blank lines. Anything else raises ValueError."""
    out, cur, indent = {}, None, None
    for n, line in enumerate(text.splitlines(), 1):
        body = re.sub(r"(^|\s)#.*$", "", line).rstrip()
        if not body.strip() or body.strip() == "---":
            continue
        depth = len(body) - len(body.lstrip(" "))
        key, sep, val = body.strip().partition(":")
        if not sep or (val and not val.startswith(" ")):
            raise ValueError(f"line {n}: not a `key: value` line: {line!r}")
        key = _yaml_scalar(key)
        if depth == 0:
            cur = None
            if val.strip():
                out[key] = _yaml_scalar(val)
            else:
                out[key] = cur = {}
                indent = None
        elif cur is not None and (indent is None or depth == indent):
            indent = depth
            if not val.strip():
                raise ValueError(f"line {n}: nested mappings are not read")
            cur[key] = _yaml_scalar(val)
        else:
            raise ValueError(f"line {n}: unexpected indentation: {line!r}")
    return out


def load_dataset_params(path: str):
    """Parse the reference's dataset_params.yaml. Returns (camera,
    images subfolder)."""
    with open(path) as fh:
        d = parse_yaml(fh.read())
    cam = d["cam0"]
    model = cam.get("cam_model", "Pinhole")
    if model == "Pinhole":
        dist = [cam.get(f"cam_d{i}", 0.0) for i in range(4)] + [0.0]
        camera = PinholeCamera.create(
            cam["cam_width"], cam["cam_height"], cam["cam_fx"], cam["cam_fy"],
            cam["cam_cx"], cam["cam_cy"], dist)
    elif model == "ATAN":
        camera = ATANCamera.create(
            cam["cam_width"], cam["cam_height"], cam["cam_fx"], cam["cam_fy"],
            cam["cam_cx"], cam["cam_cy"], cam.get("cam_d0", 0.0))
    else:
        raise ValueError(f"unknown cam_model {model}")
    return camera, d.get("images_subfolder", "images/")


def list_images(folder: str, offset: int = 0, step: int = 1,
                limit: Optional[int] = None) -> List[str]:
    """Sorted image file list with offset / stride / limit."""
    names = sorted(f for f in os.listdir(folder)
                   if f.lower().endswith(IMAGE_EXTS))
    names = names[offset::step]
    if limit is not None:
        names = names[:limit]
    return [os.path.join(folder, f) for f in names]


def _native(path):
    from plsvo_torch.native import loader

    return loader.load_gray(path)


def _cv2(path):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    return None if img is None else img.astype(np.float32)


def _pil(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.float32)


def load_gray(path: str) -> np.ndarray:
    """Greyscale float32 image in [0, 255], from the first decoder that
    reads it (native, cv2, PIL, numpy); sets `last_decoder`."""
    global last_decoder
    for name, read in (("native", _native), ("cv2", _cv2), ("PIL", _pil)):
        try:
            img = read(path)
        except ImportError:
            continue
        if img is not None:
            last_decoder = name
            return img
    img = imageio.read_gray(path)
    last_decoder = "numpy"
    return img


def undistort_maps(cam) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear sample maps for undistortion: for each ideal pixel, the
    distorted source position. Any camera with `.distort` (unit-plane
    ideal -> distorted normalized coords): the radtan pinhole and ATAN."""
    H, W = cam.height, cam.width
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    x_n = (xx - cam.cx) / cam.fx
    y_n = (yy - cam.cy) / cam.fy
    uv_n = torch.from_numpy(np.stack([x_n, y_n], -1).reshape(-1, 2))
    uv_d = cam.distort(uv_n).numpy().reshape(H, W, 2)
    map_x = uv_d[..., 0] * cam.fx + cam.cx
    map_y = uv_d[..., 1] * cam.fy + cam.cy
    return map_x.astype(np.float32), map_y.astype(np.float32)


def undistort_image(img: np.ndarray, maps: Tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    map_x, map_y = maps
    H, W = img.shape
    x0 = np.clip(np.floor(map_x).astype(np.int32), 0, W - 2)
    y0 = np.clip(np.floor(map_y).astype(np.int32), 0, H - 2)
    fx = np.clip(map_x - x0, 0.0, 1.0)
    fy = np.clip(map_y - y0, 0.0, 1.0)
    v = ((1 - fx) * (1 - fy) * img[y0, x0] + fx * (1 - fy) * img[y0, x0 + 1]
         + (1 - fx) * fy * img[y0 + 1, x0] + fx * fy * img[y0 + 1, x0 + 1])
    inside = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    return np.where(inside, v, 0.0).astype(np.float32)


@dataclass
class ImageFolderDataset:
    """Replay dataset: (timestamp, image) in file-name order, undistorted
    once on the host when the camera has distortion."""

    folder: str
    camera: object  # PinholeCamera or ATANCamera
    fps: float = 30.0
    offset: int = 0
    step: int = 1
    limit: Optional[int] = None

    def __post_init__(self):
        self.paths = list_images(self.folder, self.offset, self.step, self.limit)
        self._maps = (undistort_maps(self.camera)
                      if self.camera.has_distortion else None)

    def __len__(self):
        return len(self.paths)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        for i, p in enumerate(self.paths):
            img = load_gray(p)
            if self._maps is not None:
                img = undistort_image(img, self._maps)
            yield i / self.fps, img

    def ideal_camera(self) -> PinholeCamera:
        """The pinhole the VO tracks with after undistort-once (for the
        ATAN model too: its fx, fy, cx, cy are the ideal intrinsics)."""
        return self.camera.ideal()


def dataset_yaml(width: int, height: int, fx: float, fy: float, cx: float,
                 cy: float) -> str:
    """The dataset_params.yaml text of write_synthetic_dataset (a
    distortion-free pinhole)."""
    return ("cam0:\n"
            f"  cam_model: Pinhole\n  cam_width: {width}\n  cam_height: {height}\n"
            f"  cam_fx: {fx}\n  cam_fy: {fy}\n  cam_cx: {cx}\n  cam_cy: {cy}\n"
            "  cam_d0: 0.0\n  cam_d1: 0.0\n  cam_d2: 0.0\n  cam_d3: 0.0\n"
            "images_subfolder: images/\n")


def write_synthetic_dataset(out_dir: str, n_frames: int = 60, seed: int = 0,
                            width: int = 752, height: int = 480, device=None):
    """Render a synthetic dataset folder (images/ of PNGs, groundtruth.txt
    and dataset_params.yaml) on the device, so the CLI runs
    self-contained. The frames, trajectory and YAML are the JAX package's."""
    from plsvo_torch.utils import synthetic, trajectory

    device = resolve_device(device)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    # intrinsics and texture scale with the resolution so the scene's
    # texels per pixel match the 752x480, fx = 460 configuration
    fx = fy = 460.0 * width / 752.0
    cam = PinholeCamera.create(width, height, fx, fy, width / 2, height / 2)
    scene = synthetic.make_scene(np.random.default_rng(seed), size=2048,
                                 texel_size=0.003 * 752.0 / width)
    entries = []
    for i in range(n_frames):
        ang = 0.002 * i
        R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.asarray([0.03 * i, 0.008 * np.sin(0.3 * i), -2.0], np.float32)
        img = synthetic.render_aa(scene, cam, R, t, device=device)
        imageio.write_png(os.path.join(out_dir, "images", f"frame_{i:06d}.png"),
                          img.cpu().numpy().astype(np.uint8))
        # ground truth stored as T_f_w: R_f_w = R^T, t_f_w = -R^T t
        entries.append((i / 30.0, R.T.copy(), -R.T @ t))
    trajectory.write_tum(os.path.join(out_dir, "groundtruth.txt"), entries)
    with open(os.path.join(out_dir, "dataset_params.yaml"), "w") as fh:
        fh.write(dataset_yaml(width, height, fx, fy, width / 2, height / 2))
    return out_dir
