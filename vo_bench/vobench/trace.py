"""Reading one profiled slice of a traced run: the profiler over a fixed
number of calls, ending in a synchronisation.

The slice is recorded through torch's Kineto profiler and its raw events
are read directly (no event tree is built, which for the ~15-30 thousand
launches of a frame would take a minute per slice). From a slice it keeps
the wall time, the device's busy time (the union of its kernels' and
copies' intervals), the kernel launches and host syncs (as the repo's
smoke test counts them), the K1 and K2 kernels' durations in launch
order, the device operations by total time, and the device's idle gaps
labelled by the outermost torch operation the host was inside (or "host
python" between operations).
"""
from __future__ import annotations

import bisect
import time
from collections import Counter, defaultdict

import torch

LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")
SYNC_NAME = "aten::_local_scalar_dense"
OP_NAME_CHARS = 120  # device operations are listed by their names' start
KERNEL_NAMES = {"fast_score": "fast_score_kernel",
                "mixed_align": "mixed_align_kernel"}
# tiny launches queued after the slice (and left out of it): the profiler
# may lose the last device records of a session
PAD_LAUNCHES = 256


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _record(fn, device):
    """fn() under the profiler: (raw events, wall seconds, the slice's end
    on the events' clock in ns)."""
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)
    from torch.autograd.profiler import _ExperimentalConfig

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    sync()
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    try:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
        end_ns = time.time_ns()
        pad = torch.zeros(1, device=device)
        for _ in range(PAD_LAUNCHES):
            pad.add_(1.0)
        sync()
    finally:
        res = _disable_profiler()
    return res.events(), wall, end_ns


def profile_slice(fn, device) -> dict:
    """fn() under the profiler; the slice's record."""
    from torch.autograd import DeviceType

    events, wall, end_ns = _record(fn, device)
    dev, ops_host = [], []
    ops = defaultdict(float)
    kernels = {k: [] for k in KERNEL_NAMES}
    launches = syncs = 0
    for e in events:
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if a > end_ns:
                continue
            dev.append((a, b))
            ops[name[:OP_NAME_CHARS]] += (b - a) * 1e-9
            for k, kname in KERNEL_NAMES.items():
                if kname in name:
                    kernels[k].append((a, (b - a) * 1e-9))
        elif a <= end_ns:
            if name in LAUNCH_NAMES:
                launches += 1
            elif name.startswith("aten::"):
                syncs += name == SYNC_NAME
                ops_host.append((a, b, name, e.start_thread_id()))
    busy = _merge(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    # the outermost operations of the main thread
    main = Counter(t for *_, t in ops_host).most_common(1)
    top = []
    for a, b, name, t in sorted(ops_host):
        if main and t == main[0][0] and (not top or a >= top[-1][1]):
            top.append((a, b, name))
    starts = [a for a, _, _ in top]
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        j = bisect.bisect_right(starts, mid) - 1
        label = top[j][2] if j >= 0 and top[j][1] >= mid else "host python"
        gaps[label] += (s1 - e0) * 1e-9
    return {"wall_s": wall, "busy_s": min(busy_s, wall),
            "launches": launches, "syncs": syncs,
            "kernels": {k: [d for _, d in sorted(v)] for k, v in kernels.items()},
            "ops": dict(ops), "gaps": dict(gaps)}


def top(d: dict, n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
