"""Drives the program under test: one stream through
`FrameHandlerMono.add_image` or B streams through `BatchedVO.add_images`,
as the configuration's `mode` says, on host uint8 frames.

Also taps the program's two hand-written kernels at their entry points
(`ops.fast_score.fast_score_levels`, `ops.mixed_align.mixed_align`): in
the measured window a sample of calls drawn from the seed keeps its
inputs and outputs for the reference, and in a traced slice every call
keeps what its roofline count needs.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

DEFAULT = "default"
INSUFFICIENT = "insufficient"


def make_config(spec: dict):
    from plsvo_torch.config import CapacityConfig, Config, PipelineConfig

    c = spec.get("config", {})
    return Config(pipeline=PipelineConfig(**c.get("pipeline", {})),
                  caps=CapacityConfig(**c.get("caps", {})))


def make_camera(cam: dict):
    from plsvo_torch.camera import PinholeCamera

    return PinholeCamera.create(cam["width"], cam["height"], cam["fx"],
                                cam["fy"], cam["cx"], cam["cy"])


class Streams:
    """The program's entry for one configuration, with what it delivered:
    per stream the frame ids, stages, qualities, keyframe flags and
    world-to-camera poses of every result."""

    def __init__(self, spec: dict, device):
        cam = make_camera(spec["camera"])
        cfg = make_config(spec)
        self.mode = spec["mode"]
        self.n = int(spec["streams"])
        if self.mode == "single":
            from plsvo_torch.pipeline.frame_handler import FrameHandlerMono

            if self.n != 1:
                raise ValueError("mode 'single' drives one stream")
            self.vo = FrameHandlerMono(cam, cfg, device=device)
            self.handlers = [self.vo]
        elif self.mode == "batched":
            from plsvo_torch.parallel.multi_vo import BatchedVO

            self.vo = BatchedVO(cam, cfg, self.n, mode=spec["batch_mode"],
                                device=device)
            self.handlers = list(self.vo.vos)
        else:
            raise ValueError(f"mode {self.mode!r}: 'single' or 'batched'")
        self.delivered = [[] for _ in range(self.n)]

    def _take(self, results):
        for k, r in enumerate(results):
            if r is not None:
                self.delivered[k].append(
                    (r.frame_id, r.stage, r.quality, bool(r.is_keyframe),
                     np.asarray(r.R_f_w, np.float64),
                     np.asarray(r.t_f_w, np.float64)))

    def call(self, frames, i: int, offsets, ts: float):
        """Submit call i: each stream's frame of the orbit."""
        P = len(frames)
        if self.mode == "single":
            self._take([self.vo.add_image(frames[(i + offsets[0]) % P], ts)])
        else:
            self._take(self.vo.add_images(
                [frames[(i + offsets[k]) % P] for k in range(self.n)], ts))

    def flush(self):
        if self.mode == "single":
            self._take(self.vo.flush())
        else:
            for rs in self.vo.flush():
                self._take(rs)

    def stages(self):
        return [h.stage for h in self.handlers]

    def n_ok(self, start):
        """Results delivered in DEFAULT with a usable pose after the
        per-stream positions `start`."""
        return sum(1 for k in range(self.n) for r in self.delivered[k][start[k]:]
                   if r[1] == DEFAULT and r[2] != INSUFFICIENT)

    def positions(self):
        return [len(d) for d in self.delivered]

    def map_arrays(self):
        """Each stream's live keyframes and landmarks, copied out of the
        program's host tables."""
        out = []
        for h in self.handlers:
            m = h.map
            occ = np.where(m.kf_occupied)[0]
            pts = m.pt_pos[m.pt_status > 0]
            ln = m.ln_status > 0
            out.append({
                "kf_fids": m.kf_frame_id[occ].astype(np.int64),
                "kf_R": m.kf_R[occ].astype(np.float64),
                "kf_t": m.kf_t[occ].astype(np.float64),
                "landmarks": np.concatenate(
                    [pts, m.ln_spos[ln], m.ln_epos[ln]]).astype(np.float64)})
        return out


class KernelTap:
    """Wraps the K1 and K2 entry points. mode "off" passes through;
    "window" keeps a seeded sample of calls (inputs and outputs cloned)
    for the reference; "slice" keeps every call's inputs for the
    roofline counts of a traced slice."""

    def __init__(self, seed: int, k1_max: int, k2_every: int, k2_max: int):
        self.mode = "off"
        self.rng = np.random.default_rng([seed % 2 ** 63, 2])
        self.k1_max, self.k2_every, self.k2_max = k1_max, k2_every, k2_max
        self.k1, self.k2 = [], []  # window samples
        self.k1_slice, self.k2_slice = [], []  # the current slice's calls
        self._orig = None

    def install(self):
        from plsvo_torch.ops import fast_score, mixed_align

        f1, f2 = fast_score.fast_score_levels, mixed_align.mixed_align
        defaults = {k: p.default for k, p in inspect.signature(
            mixed_align.mixed_align_plain).parameters.items()
            if p.kind is p.KEYWORD_ONLY}
        self._orig = (f1, f2)

        def k1(imgs, threshold=10.0):
            outs = f1(imgs, threshold)
            if self.mode == "window" and len(self.k1) < self.k1_max:
                self.k1.append(([im.clone() for im in imgs],
                                [(m.clone(), s.clone()) for m, s in outs],
                                float(threshold)))
            elif self.mode == "slice":
                self.k1_slice.append([tuple(im.shape) for im in imgs])
            return outs

        def k2(*args, **kw):
            out = f2(*args, **kw)
            full = dict(defaults, **kw)
            if self.mode == "window":
                if (len(self.k2) < self.k2_max
                        and self.rng.random() < 1.0 / self.k2_every):
                    self.k2.append(([a.clone() for a in args], full,
                                    tuple(o.clone() for o in out)))
            elif self.mode == "slice":
                self.k2_slice.append(([a.clone() for a in args], full))
            return out

        fast_score.fast_score_levels = k1
        mixed_align.mixed_align = k2

    def uninstall(self):
        from plsvo_torch.ops import fast_score, mixed_align

        if self._orig is not None:
            fast_score.fast_score_levels, mixed_align.mixed_align = self._orig
            self._orig = None


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
