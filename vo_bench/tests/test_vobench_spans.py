"""CPU tests of the readers of the program's spans and counters
(`metrics/*_ms.single.py`, `metrics/*_iters.single.py`) on hand-worked
frame records, and of the attribution of a slice's launches, syncs,
kernels and idle gaps to the program's spans (`vobench/spans.py`).

    python -m pytest vo_bench/tests -q
"""
import sys
from pathlib import Path

import pytest
import torch

VB = Path(__file__).resolve().parent.parent
ROOT = VB.parent
sys.path[:0] = [str(VB), str(ROOT)]

import run  # noqa: E402
from vobench import spans, trace  # noqa: E402

from plsvo_torch.utils import profiling  # noqa: E402


def read(name, permon):
    rec = {"mode": "single", "setup_s": 1.0, "window_s": 1.0, "ok_frames": 1,
           "call_s": [], "permon": permon, "slices": [], "kernel_pairs": {}}
    return run.load_module("metrics", name).read(rec)


# two tracked frames, the second a keyframe, and a bootstrap frame
FRAMES = [
    {"t_device_step": 0.30, "t_sparse_img_align": 0.12, "t_reproject": 0.02,
     "t_optimize_pose": 0.05, "t_optimize_points": 0.01,
     "t_update_seeds": 0.08, "t_post_fused": 0.004, "n_align_iters": 40,
     "n_pose_iters": 6},
    {"t_device_step": 0.34, "t_sparse_img_align": 0.16, "t_reproject": 0.04,
     "t_optimize_pose": 0.03, "t_optimize_points": 0.01,
     "t_update_seeds": 0.06, "t_post_fused": 0.096, "t_keyframe_path": 0.09,
     "n_align_iters": 20, "n_pose_iters": 9},
    {"t_pyramid_creation": 0.01, "n_align_iters": 30},
]


@pytest.mark.parametrize("name,value", [
    ("align_ms.single", 140.0), ("reproject_ms.single", 30.0),
    ("pose_ms.single", 40.0), ("seeds_ms.single", 70.0),
    # self time: 4 ms, and 96 - 90 ms on the keyframe
    ("post_ms.single", 5.0),
    # the bootstrap frame's alignment is not a tracked frame's
    ("align_iters.single", 30.0), ("pose_iters.single", 7.5),
])
def test_span_and_counter_readers(name, value):
    assert read(name, FRAMES) == pytest.approx(value)
    # a program without the span or counter: no number, no error
    assert read(name, [{"t_device_step": 0.3, "t_fetch": 0.01}]) is None


def test_attribution_hand_worked():
    """tot_time [0, 100] holds device_step [10, 60], which holds align
    [10, 40] and reproject [40, 50]; post_fused [70, 90] follows. A launch
    at 95 is tot_time's own; the launch at 130 and the gap [98, 131] lie
    outside every span."""
    sp = [(0, 100, "tot_time"), (10, 60, "device_step"),
          (10, 40, "sparse_img_align"), (40, 50, "reproject"),
          (70, 90, "post_fused")]
    launches = [(5, 1), (12, 2), (15, 3), (40, 4), (55, 5), (95, 6),
                (130, 7)]
    syncs = [20, 30, 45, 80]
    kernels = [(13, 16, 2), (16, 19, 3), (41, 45, 4), (57, 58, 5),
               (96, 98, 6), (131, 132, 7), (200, 201, 99)]
    busy = [[13, 19], [41, 45], [57, 58], [96, 98], [131, 132]]
    r = spans.attribute(sp, launches, syncs, kernels, busy)
    assert r["span_calls"] == {"tot_time": 1, "device_step": 1,
                               "sparse_img_align": 1, "reproject": 1,
                               "post_fused": 1}
    assert r["span_wall_s"]["device_step"] == pytest.approx(50e-9)
    # the innermost span: the launch at 40 is reproject's (it starts
    # there), 55 device_step's own, 5 and 95 tot_time's; 130 none
    assert r["span_launches"] == {"tot_time": 2, "sparse_img_align": 2,
                                  "reproject": 1, "device_step": 1}
    assert r["span_syncs"] == {"sparse_img_align": 2, "reproject": 1,
                               "post_fused": 1}
    # kernels by their launch's span; two back-to-back kernels are one
    # busy interval; a kernel with no known launch is nobody's
    assert r["span_busy_s"] == pytest.approx(
        {"sparse_img_align": 6e-9, "reproject": 4e-9, "device_step": 1e-9,
         "tot_time": 2e-9})
    # gaps by their midpoints: 30 (align), 51 (device_step), 77 (post),
    # 114.5 (none)
    assert r["span_gaps"] == pytest.approx(
        {"plsvo.sparse_img_align": 22e-9, "plsvo.device_step": 12e-9,
         "plsvo.post_fused": 38e-9, spans.OUTSIDE: 33e-9})


def test_spans_that_touch_and_spans_that_start_together():
    sp = [(0, 10, "a"), (10, 20, "b"), (10, 15, "c")]
    r = spans.attribute(sp, [(10, 1), (14, 2), (15, 3), (20, 4)], [], [],
                        [])
    # at 10 b has begun (a ended) and c, the shorter, is innermost; at 15
    # c has ended; at 20 b has ended
    assert r["span_launches"] == {"c": 2, "b": 1}


def test_slice_record_of_the_programs_ranges_on_cpu():
    """The program's spans under the benchmark's recorder, with no monitor
    installed: the ranges alone, function-scope (a user-scope range would
    be mirrored on a card as device activity) and nested, syncs by span,
    no launch without a card."""
    def work():
        x = torch.randn(16, 16)
        with profiling.span("outer"):
            float(x.sum())
            for _ in range(3):
                with profiling.span("inner"):
                    float((x @ x).sum())

    events, _, end_ns = trace._record(work, "cpu")
    ranges = {}
    for e in events:
        if e.name().startswith(spans.PREFIX):
            assert not e.is_user_annotation()
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    (outer,) = ranges["plsvo.outer"]
    assert len(ranges["plsvo.inner"]) == 3
    assert all(outer[0] <= a and b <= outer[1]
               for a, b in ranges["plsvo.inner"])
    r = spans.slice_record(events, end_ns)
    assert r["span_calls"] == {"outer": 1, "inner": 3}
    assert r["span_syncs"] == {"outer": 1, "inner": 3}
    assert r["span_launches"] == {} and r["span_busy_s"] == {}
    assert r["span_wall_s"]["inner"] <= r["span_wall_s"]["outer"]
