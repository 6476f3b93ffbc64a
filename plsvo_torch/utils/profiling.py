"""Profiling plane: named spans and counters in per-frame records.

Replacement of the reference trace plane — vk::PerformanceMonitor
with SVO_START_TIMER/SVO_LOG channels (reference: include/plsvo/global.h:102-117,
registration src/frame_handler_base.cpp:58-86: timers `pyramid_creation`,
`sparse_img_align`, `reproject`, `feature_align`, `pose_optimizer`,
`point_optimizer`, `local_ba`, `tot_time`; log channels
`img_align_n_tracked`, `sfba_*`, `n_candidates`, `dropout`). The reference
compiles its tracing out (SVO_TRACE never defined, SURVEY §5.1); here it is
always available and cheap.

A span (`PerformanceMonitor.timer`, or the module's `span` in code that
has no handler) sums its host wall time per frame. While a torch profiler
is active it also opens a profiler range named `plsvo.<name>`,
so the spans sit on the device trace's clock and the kernels they launch
can be attributed to them. `count` sums integers per frame; a count
given as a device tensor reaches the frame's record without a host sync.

Kernel-level device profiling is `device_trace` (torch.profiler) around a
run.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

RANGE_PREFIX = "plsvo."
_NO_SPAN = contextlib.nullcontext()


def _range(name: str):
    """A profiler range for the span, or a no-op when no profiler records.
    The C-side flag is the one to test: a profiler started through
    torch.autograd._enable_profiler leaves the Python-side flag False.
    The range is a function-scope record, on the host alone: a user-scope
    one (torch.profiler.record_function) is mirrored on the card as a
    `gpu_user_annotation` event from its first kernel to its last, which
    a reader of the device's activity would count as busy time."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(RANGE_PREFIX + name)
    return _NO_SPAN


@dataclass
class PerformanceMonitor:
    """Per-frame spans, counters and scalar log channels
    (vk::PerformanceMonitor analogue). Call new_frame() per iteration;
    spans and counters accumulate within the frame, and each finished
    frame's record (`frames`) holds them as `t_<span>` (seconds),
    `n_<counter>` and the log channels by name."""

    timers: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    logs: Dict[str, float] = field(default_factory=dict)
    frames: List[dict] = field(default_factory=list)
    # the frame the timers and logs belong to: -1 until new_frame, so a
    # log before the first frame (a harvest right after a checkpoint load)
    # is recorded rather than failing (the JAX package's class has no
    # default here)
    _frame_id: int = -1
    # the frame's tensor counts, (name, host copy, event or None), and the
    # finished frames' records still waiting for theirs
    _pending: list = field(default_factory=list)
    _unresolved: list = field(default_factory=list)

    def new_frame(self, frame_id: int):
        if self.timers or self.counts or self.logs or self._pending:
            rec = {"frame": self._frame_id,
                   **{f"t_{k}": v for k, v in self.timers.items()},
                   **{f"n_{k}": v for k, v in self.counts.items()},
                   **self.logs}
            self.frames.append(rec)
            if self._pending:
                self._unresolved.append((rec, self._pending))
        self.timers = {}
        self.counts = {}
        self.logs = {}
        self._pending = []
        self._frame_id = frame_id
        self._resolve(wait=False)

    def _resolve(self, wait: bool):
        """Add the tensor counts whose copies have landed (all of them,
        waiting, when `wait`) to their frames' records."""
        keep = []
        for rec, pend in self._unresolved:
            if not wait and not all(ev is None or ev.query()
                                    for _, _, ev in pend):
                keep.append((rec, pend))
                continue
            for name, host, ev in pend:
                if wait and ev is not None:
                    ev.synchronize()
                key = f"n_{name}"
                rec[key] = rec.get(key, 0) + int(host.sum())
        self._unresolved = keep

    @contextlib.contextmanager
    def timer(self, name: str):
        """The span `name`: its host wall time is added to the frame's
        `t_<name>`."""
        with _range(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.timers[name] = self.timers.get(name, 0.0) + (
                    time.perf_counter() - t0)

    def count(self, name: str, n):
        """Add n to the frame's counter `name`: an int, or a tensor whose
        values sum to the count. A tensor on a card is copied to pinned
        host memory without waiting; the frame's record gets its value once
        the copy has landed (at a later new_frame, in the sync path the
        next one, after the frame's fetch has waited on the card; or at
        finish, which waits)."""
        if torch.is_tensor(n):
            self._pending.append((name, *_host_copy(n)))
            return
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def log(self, name: str, value):
        self.logs[name] = float(value)

    def finish(self):
        self.new_frame(-1)
        self._resolve(wait=True)

    @contextlib.contextmanager
    def installed(self):
        """Make this the monitor that the module's `span` and `count`
        record into, for the duration of the block."""
        token = _current.set(self)
        try:
            yield
        finally:
            _current.reset(token)


def _host_copy(t: torch.Tensor):
    """(host tensor, event or None): t's values, from a card copied into
    pinned memory on the current stream without waiting, with the event
    recorded after the copy."""
    if t.device.type != "cuda":
        return t.detach().clone(), None
    with torch.cuda.device(t.device):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
    return host, ev


# the monitor of the frame being processed (FrameHandlerMono.add_image
# installs its own), for code that has no handler: the fused step and ops.
# A context variable, so that threads do not see each other's
_current: contextvars.ContextVar[Optional[PerformanceMonitor]] = (
    contextvars.ContextVar("plsvo_monitor", default=None))


def span(name: str):
    """The current monitor's span `name`; without a monitor, only the
    profiler's range (nothing at all when no profiler records)."""
    m = _current.get()
    return m.timer(name) if m is not None else _range(name)


def count(name: str, n):
    """Add n (an int or a tensor, as PerformanceMonitor.count) to the
    current monitor's counter `name` (nothing without one)."""
    m = _current.get()
    if m is not None:
        m.count(name, n)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the block (CPU activity, and the
    card's where CUDA is available) and write it into log_dir as a Chrome
    trace, viewable in Perfetto or chrome://tracing: the counterpart of
    the JAX package's jax.profiler trace. Yields the profiler; the file's
    path is its `trace_path` once the block has ended."""
    import os

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
