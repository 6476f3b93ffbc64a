"""Checkpoint and resume: the whole handler state in one npz file.

Port of `plsvo_tpu/utils/checkpoint.py`, in the JAX package's file format,
so a checkpoint crosses between the packages both ways: the same npz keys
(`map.*`, `map.kf_pyr.<l>`, `ptseed.*`, `lnseed.*`, `seedhost.*`,
`lnseedhost.*`, `seed_alive`, `lnseed_alive`, `frame.*`, `meta_json`) and
the same meta JSON. State only the port has goes under keys prefixed
`port.`, which the JAX loader ignores: the bootstrap RANSAC generator's
state and the seed install frames.

A pipelined handler is saved after `flush()` (nothing may be in flight);
the loaded handler rebuilds its map carry from a full upload at its next
step.
"""
from __future__ import annotations

import json

import numpy as np
import torch

_PORT_ARRAYS = ("_seed_install_frame", "_lnseed_install_frame")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_state(vo, path: str):
    """Serialize a FrameHandlerMono (map, seeds, stage, last frame)."""
    if vo._pipe_q or vo._fetch_q or vo._ready or vo._pending_ba \
            or vo._pending_seed_init:
        raise ValueError("frames are in flight: call flush() before save_state")
    m = vo.map
    arrays = {f"map.{name}": val for name, val in vars(m).items()
              if isinstance(val, np.ndarray)}
    for lvl, p in enumerate(m.kf_pyr):
        arrays[f"map.kf_pyr.{lvl}"] = _np(p)
    for name, val in vo.pt_seeds._asdict().items():
        arrays[f"ptseed.{name}"] = _np(val)
    for name, val in vo.ln_seeds._asdict().items():
        arrays[f"lnseed.{name}"] = _np(val)
    for name, val in vo._seed_host.items():
        arrays[f"seedhost.{name}"] = val
    for name, val in vo._lnseed_host.items():
        arrays[f"lnseedhost.{name}"] = val
    arrays["seed_alive"] = vo._seed_alive
    arrays["lnseed_alive"] = vo._lnseed_alive
    lf = vo.last_frame
    if lf is not None:
        for name, val in vars(lf).items():
            if isinstance(val, np.ndarray):
                arrays[f"frame.{name}"] = val
        for lvl, p in enumerate(lf.pyr):
            arrays[f"frame.pyr.{lvl}"] = _np(p)
        arrays["frame.meta"] = np.asarray(
            [lf.frame_id, lf.timestamp, float(lf.is_keyframe)])
    for name in _PORT_ARRAYS:
        arrays[f"port.{name.lstrip('_')}"] = getattr(vo, name)
    arrays["port.generator"] = vo.generator.get_state().numpy()
    meta = {
        "stage": vo.stage,
        "frame_id": vo.frame_id,
        "batch_counter": vo.batch_counter,
        "n_levels": vo.n_levels,
        "config": vo.cfg.to_json(),
        "cam": {"width": vo.cam.width, "height": vo.cam.height,
                "fx": vo.cam.fx, "fy": vo.cam.fy, "cx": vo.cam.cx,
                "cy": vo.cam.cy, "dist": list(vo.cam.dist)},
        "has_last_frame": lf is not None,
        # the JAX handler's flag: line seeds were installed since the reset
        "any_line_seeds": bool(vo._lnseed_alive.any()
                               or (vo._lnseed_install_frame >= 0).any()),
    }
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, device=None, **handler_kw):
    """Rebuild a FrameHandlerMono from a checkpoint of either package, on
    `device` (None: the card). handler_kw go to FrameHandlerMono (e.g.
    ransac_draws)."""
    from plsvo_torch.camera import PinholeCamera
    from plsvo_torch.config import Config
    from plsvo_torch.pipeline.frame_handler import FrameHandlerMono
    from plsvo_torch.device import resolve_device
    from plsvo_torch.pipeline.state import FrameState

    device = resolve_device(device)
    with np.load(path) as z:
        z = {k: z[k] for k in z.files}
    meta = json.loads(bytes(z["meta_json"]).decode())
    c = meta["cam"]
    cam = PinholeCamera.create(c["width"], c["height"], c["fx"], c["fy"],
                               c["cx"], c["cy"], c["dist"])
    cfg = Config.from_json(meta["config"])
    vo = FrameHandlerMono(cam, cfg, device=device, **handler_kw)
    dev = vo.device
    vo.stage = meta["stage"]
    vo.frame_id = meta["frame_id"]
    vo.batch_counter = meta["batch_counter"]

    m = vo.map
    for key, val in z.items():
        if key.startswith("map.kf_pyr."):
            lvl = int(key.split(".")[-1])
            m.kf_pyr[lvl] = torch.as_tensor(val, dtype=torch.float32, device=dev)
        elif key.startswith("map."):
            getattr(m, key[4:])[...] = val
    m.invalidate()

    def table(cur, prefix):
        return type(cur)(**{
            n: torch.as_tensor(z[f"{prefix}.{n}"]).to(dtype=t.dtype, device=dev)
            for n, t in cur._asdict().items()})

    vo.pt_seeds = table(vo.pt_seeds, "ptseed")
    vo.ln_seeds = table(vo.ln_seeds, "lnseed")
    for host, prefix in ((vo._seed_host, "seedhost"),
                         (vo._lnseed_host, "lnseedhost")):
        for name in host:
            if f"{prefix}.{name}" in z:
                host[name][...] = z[f"{prefix}.{name}"]
    if "seed_alive" in z:
        vo._seed_alive[...] = z["seed_alive"]
        vo._lnseed_alive[...] = z["lnseed_alive"]
    for name in _PORT_ARRAYS:
        if f"port.{name.lstrip('_')}" in z:
            getattr(vo, name)[...] = z[f"port.{name.lstrip('_')}"]
    if "port.generator" in z:
        vo.generator.set_state(torch.from_numpy(z["port.generator"]))

    if meta["has_last_frame"]:
        fid, ts, is_kf = z["frame.meta"]
        pyr = [torch.as_tensor(z[f"frame.pyr.{lvl}"], dtype=torch.float32,
                               device=dev) for lvl in range(meta["n_levels"])]
        fr = FrameState.empty(cfg, int(fid), float(ts), pyr, z["frame.R_f_w"],
                              z["frame.t_f_w"])
        for key, val in z.items():
            name = key[6:]
            if key.startswith("frame.") and not key.startswith("frame.pyr") \
                    and key != "frame.meta" \
                    and isinstance(getattr(fr, name, None), np.ndarray):
                getattr(fr, name)[...] = val
        fr.is_keyframe = bool(is_kf)
        vo.last_frame = fr
    return vo
