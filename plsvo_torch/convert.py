"""Carry configuration and state across from numpy dicts.

VO has no weights: what crosses between implementations is the config,
the camera and the state tables. These helpers take plain dicts of numpy
arrays (for example `dataclasses.asdict` of another implementation's
config, its host tables, and `np.asarray` of its device tables) and
return this package's objects on a given device.
"""
from __future__ import annotations

import numpy as np
import torch

from plsvo_torch.config import CapacityConfig, Config, MeshConfig, PipelineConfig
from plsvo_torch.device import resolve_device
from plsvo_torch.ops.depth_filter import LineSeeds, PointSeeds
from plsvo_torch.pipeline.state import FrameState, MapState


def config_from_dict(d: dict) -> Config:
    return Config(pipeline=PipelineConfig(**d.get("pipeline", {})),
                  caps=CapacityConfig(**d.get("caps", {})),
                  mesh=MeshConfig(**d.get("mesh", {})))


def _t(a, device):
    return torch.tensor(np.asarray(a), device=device)


def frame_state_from_numpy(d: dict, device=None) -> FrameState:
    """FrameState from a dict of its fields; `pyr` is a list of (h, w)
    arrays (uploaded to `device`), every other table stays host numpy."""
    device = resolve_device(device)
    fields = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
              for k, v in d.items() if k != "pyr"}
    return FrameState(pyr=[_t(np.asarray(p, np.float32), device)
                           for p in d["pyr"]], **fields)


def map_state_from_numpy(d: dict, cfg: Config, n_levels: int, img_shape,
                         intrinsics, device=None) -> MapState:
    """MapState with every host table in `d` copied in; `kf_pyr` (a list of
    (K, h, w) arrays) is uploaded to `device`."""
    device = resolve_device(device)
    m = MapState(cfg, n_levels, tuple(img_shape), intrinsics=tuple(intrinsics),
                 device=device)
    for k, v in d.items():
        if k == "kf_pyr":
            m.kf_pyr = [_t(np.asarray(p, np.float32), device) for p in v]
        elif hasattr(m, k) and isinstance(getattr(m, k), np.ndarray):
            cur = getattr(m, k)
            setattr(m, k, np.asarray(v).astype(cur.dtype).reshape(cur.shape))
    m.invalidate()
    return m


def _seed_table(cls, d: dict, device):
    device = resolve_device(device)
    dt = {"kf_idx": torch.int32, "level": torch.int32, "batch_id": torch.int32,
          "alive": torch.bool}
    return cls(**{k: _t(d[k], device).to(dt.get(k, torch.float32))
                  for k in cls._fields})


def point_seeds_from_numpy(d: dict, device=None) -> PointSeeds:
    """PointSeeds from a dict of its columns."""
    return _seed_table(PointSeeds, d, device)


def line_seeds_from_numpy(d: dict, device=None) -> LineSeeds:
    """LineSeeds from a dict of its columns."""
    return _seed_table(LineSeeds, d, device)
