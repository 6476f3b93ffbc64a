"""Profiling plane: named stage timers + per-frame metric records.

Replacement of the reference trace plane — vk::PerformanceMonitor
with SVO_START_TIMER/SVO_LOG channels (reference: include/plsvo/global.h:102-117,
registration src/frame_handler_base.cpp:58-86: timers `pyramid_creation`,
`sparse_img_align`, `reproject`, `feature_align`, `pose_optimizer`,
`point_optimizer`, `local_ba`, `tot_time`; log channels
`img_align_n_tracked`, `sfba_*`, `n_candidates`, `dropout`). The reference
compiles its tracing out (SVO_TRACE never defined, SURVEY §5.1); here it is
always available and cheap.

Kernel-level device profiling is `device_trace` (torch.profiler) around a
run; the timers here are host wall clock.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class PerformanceMonitor:
    """Per-frame stage timers + scalar log channels (vk::PerformanceMonitor
    analogue). Call new_frame() per iteration; timers accumulate within the
    frame; dump writes JSONL traces (Config::traceDir analogue)."""

    timers: Dict[str, float] = field(default_factory=dict)
    logs: Dict[str, float] = field(default_factory=dict)
    frames: List[dict] = field(default_factory=list)
    _starts: Dict[str, float] = field(default_factory=dict)
    # the frame the timers and logs belong to: -1 until new_frame, so a
    # log before the first frame (a harvest right after a checkpoint load)
    # is recorded rather than failing (the JAX package's class has no
    # default here)
    _frame_id: int = -1

    def new_frame(self, frame_id: int):
        if self.timers or self.logs:
            self.frames.append(
                {"frame": self._frame_id, **{f"t_{k}": v for k, v in self.timers.items()},
                 **self.logs})
        self.timers = {}
        self.logs = {}
        self._frame_id = frame_id

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name] = self.timers.get(name, 0.0) + (
                time.perf_counter() - t0)

    def log(self, name: str, value):
        self.logs[name] = float(value)

    def finish(self):
        self.new_frame(-1)

    def dump(self, path: str):
        self.finish()
        with open(path, "w") as fh:
            for rec in self.frames:
                fh.write(json.dumps(rec) + "\n")

    def summary(self) -> Dict[str, float]:
        """Mean per-stage milliseconds over recorded frames."""
        acc = defaultdict(list)
        for rec in self.frames:
            for k, v in rec.items():
                if k.startswith("t_"):
                    acc[k].append(v)
        return {k: 1000.0 * sum(v) / len(v) for k, v in acc.items() if v}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the block (CPU activity, and the
    card's where CUDA is available) and write it into log_dir as a Chrome
    trace, viewable in Perfetto or chrome://tracing: the counterpart of
    the JAX package's jax.profiler trace. Yields the profiler; the file's
    path is its `trace_path` once the block has ended."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.trace_path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)
