"""The program's spans in a profiled slice: which stage of the program
launched each kernel, waited for the device, or left it idle.

While a profiler records, the program opens a range `plsvo.<name>` around
each of its spans (`plsvo_torch.utils.profiling`). Among a slice's raw
events these ranges carry the clock and the thread id of the torch
operations. `attribute` gives each kernel launch and each host sync to
the innermost span around it, each device kernel to the span of its
launch (through the correlation id), and each idle gap of the device to
the innermost span around its midpoint. `slice_record` reads those from
the raw events that `trace._record` returns; `trace.profile_slice` does
not call it yet.
"""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict

from vobench.trace import LAUNCH_NAMES, SYNC_NAME, _merge

PREFIX = "plsvo."
OUTSIDE = "outside every span"


def _owners(spans):
    """(times, owners): from times[j] on, until times[j + 1], the
    innermost open span is spans[owners[j]] (None: no span is open).
    Spans of one thread nest; a span that starts where another ends comes
    after it, and of spans that start together the longest is outermost."""
    marks = sorted([(a, 1, -b, i) for i, (a, b, _) in enumerate(spans)]
                   + [(b, 0, 0, i) for i, (_, b, _) in enumerate(spans)])
    times, owners, stack = [], [], []
    for t, opening, _, i in marks:
        if opening:
            stack.append(i)
        else:
            stack.remove(i)
        owner = stack[-1] if stack else None
        if times and times[-1] == t:
            owners[-1] = owner
        else:
            times.append(t)
            owners.append(owner)
    return times, owners


def attribute(spans, launches, syncs, kernels, busy):
    """The slice's numbers by span name.

    spans: (start, end, name) of one thread; launches: (time, correlation
    id) of the kernel launches; syncs: their times; kernels: (start, end,
    correlation id) on the device; busy: the merged intervals of every
    device activity, in order. Returns span_calls, span_wall_s (the
    ranges' own lengths, children included), span_launches, span_syncs and
    span_busy_s (the union of the kernels launched in the span, nested
    spans excluded), and span_gaps: the idle time between busy intervals
    by the innermost span around its midpoint, as `plsvo.<name>`, else
    OUTSIDE. Launches, syncs and kernels outside every span are left out
    of the span_ dictionaries. Times in ns, results in s."""
    times, owners = _owners(spans)

    def owner(t):
        j = bisect.bisect_right(times, t) - 1
        i = owners[j] if j >= 0 else None
        return None if i is None else spans[i][2]

    calls, wall = Counter(), defaultdict(float)
    for a, b, name in spans:
        calls[name] += 1
        wall[name] += (b - a) * 1e-9
    n_launch, n_sync, by_corr = Counter(), Counter(), {}
    for t, corr in launches:
        name = owner(t)
        by_corr[corr] = name
        if name is not None:
            n_launch[name] += 1
    for t in syncs:
        name = owner(t)
        if name is not None:
            n_sync[name] += 1
    ran = defaultdict(list)
    for a, b, corr in kernels:
        name = by_corr.get(corr)
        if name is not None:
            ran[name].append((a, b))
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        name = owner(0.5 * (e0 + s1))
        gaps[OUTSIDE if name is None else PREFIX + name] += (s1 - e0) * 1e-9
    return {"span_calls": dict(calls), "span_wall_s": dict(wall),
            "span_launches": dict(n_launch), "span_syncs": dict(n_sync),
            "span_busy_s": {k: sum(b - a for a, b in _merge(v)) * 1e-9
                            for k, v in ran.items()},
            "span_gaps": dict(gaps)}


def slice_record(events, end_ns) -> dict:
    """`attribute` over a slice's raw profiler events (as `trace._record`
    returns them, with the slice's end), on the thread of the program's
    spans. A kernel is matched to its launch by its correlation id, else
    by its linked correlation id."""
    from torch.autograd import DeviceType

    spans, launches, syncs, kernels, dev = [], [], [], [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if a <= end_ns:
                dev.append((a, b))
                kernels.append((a, b, (e.correlation_id(),
                                       e.linked_correlation_id())))
        elif a <= end_ns:
            name = e.name()
            if name.startswith(PREFIX):
                spans.append((a, b, name[len(PREFIX):], e.start_thread_id()))
            elif name in LAUNCH_NAMES:
                launches.append((a, e.correlation_id(), e.start_thread_id()))
            elif name == SYNC_NAME:
                syncs.append((a, e.start_thread_id()))
    main = Counter(s[3] for s in spans).most_common(1)
    tid = main[0][0] if main else None
    ids = {c for _, c, t in launches if t == tid}
    return attribute(
        [s[:3] for s in spans if s[3] == tid],
        [(a, c) for a, c, t in launches if t == tid],
        [a for a, t in syncs if t == tid],
        [(a, b, c if c in ids else lc) for a, b, (c, lc) in kernels],
        _merge(dev))
