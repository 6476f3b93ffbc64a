"""CPU tests of what the pipelined cell and the seed-install metric add
to the harness: the readers of the pipelined path's spans and counters
(`metrics/*.pipe.py`, `metrics/seed_install_ms.py`) on hand-worked frame
records, and a run of the pipelined cell on the CPU at its own frame size
that is `correct`, while the planted pipelined fault of `control_pipe.py`
(the device map carry never receives its delta blobs) is not.

    python -m pytest vo_bench/tests -q
"""
import copy
import sys
from pathlib import Path

import pytest
import torch

VB = Path(__file__).resolve().parent.parent
ROOT = VB.parent
sys.path[:0] = [str(VB), str(ROOT)]

import control_pipe  # noqa: E402
import run  # noqa: E402

MAN = run.load_manifest()
PIPE_CELLS = [w["name"] for w in MAN["workloads"]
              if run.cell(MAN, w["name"])[1]["config"]["pipeline"].get(
                  "pipelined")]


def read(name, permon):
    rec = {"mode": "single", "setup_s": 1.0, "window_s": 1.0, "ok_frames": 1,
           "call_s": [], "permon": permon, "slices": [], "kernel_pairs": {}}
    return run.load_module("metrics", name).read(rec)


# four pipelined calls of a window: a chain's first dispatch (full upload,
# nothing drained yet), a chained call that drains, a chained call whose
# drain installs a keyframe's seeds and writes back a local BA, and a
# restart after a transform, whose drain finishes two windows
PIPE = [
    {"t_device_step": 0.05, "n_mt_resync": 1, "n_inflight": 1},
    {"t_device_step": 0.05, "t_mt_delta": 0.002, "n_mt_resync": 0,
     "t_fetch": 0.011, "t_drain_submit": 0.001, "t_drain_wait": 0.008,
     "n_drained_frames": 1, "n_ba_writebacks": 0, "n_inflight": 2},
    {"t_device_step": 0.06, "t_mt_delta": 0.004, "n_mt_resync": 0,
     "t_fetch": 0.03, "t_drain_submit": 0.002, "t_drain_wait": 0.024,
     "t_seed_install": 0.007, "n_drained_frames": 1, "n_ba_writebacks": 1,
     "n_inflight": 2},
    {"t_device_step": 0.05, "n_mt_resync": 1, "t_fetch": 0.02,
     "t_drain_submit": 0.001, "t_drain_wait": 0.016, "n_drained_frames": 2,
     "n_ba_writebacks": 0, "n_inflight": 1},
]
# sync calls: a tracked frame and a keyframe
SYNC = [
    {"t_device_step": 0.1, "t_fetch": 0.02},
    {"t_device_step": 0.1, "t_fetch": 0.02, "t_keyframe_path": 0.09,
     "t_kf_init_seeds": 0.04, "t_kf_detect": 0.03, "t_seed_install": 0.005},
]


def test_drain_wait_per_pipelined_call():
    # (0 + 8 + 24 + 16) ms over the 4 calls; sync calls are not counted
    assert read("drain_wait_ms.pipe", PIPE + SYNC) == pytest.approx(12.0)
    assert read("drain_wait_ms.pipe", SYNC) is None


def test_mt_delta_per_chained_dispatch():
    # (2 + 4) ms over the 2 chained dispatches
    assert read("mt_delta_ms.pipe", PIPE) == pytest.approx(3.0)
    assert read("mt_delta_ms.pipe", SYNC) is None


def test_resyncs_per_100_dispatches():
    # 2 full uploads in 4 dispatches
    assert read("resyncs_per_100.pipe", PIPE + SYNC) == pytest.approx(50.0)
    assert read("resyncs_per_100.pipe", SYNC) is None


def test_seed_install_per_installing_call():
    # 7 ms (pipelined, in a drain) and 5 ms (sync, in kf_init_seeds)
    assert read("seed_install_ms", PIPE + SYNC) == pytest.approx(6.0)
    assert read("seed_install_ms", SYNC) == pytest.approx(5.0)
    assert read("seed_install_ms", PIPE[:2]) is None


def test_pipelined_cell_is_one_stream_at_depth_1():
    assert PIPE_CELLS
    for cell in PIPE_CELLS:
        spec = run.cell(MAN, cell)[1]
        assert spec["streams"] == 1
        assert spec["config"]["pipeline"] == {"pipelined": True,
                                              "pipeline_depth": 1}
        names = {m["name"] for m in run.metrics_of(MAN, cell, True)}
        assert {"drain_wait_ms.pipe", "mt_delta_ms.pipe",
                "resyncs_per_100.pipe", "seed_install_ms"} <= names


def _cpu_run(workload, fault=None, seconds=4.0):
    """A run on the CPU at the cell's frame size, with the keyframe map
    limited to 4, judged by the cell's own limits; with `fault` (a
    function that plants it and returns its undo) from the first frame."""
    torch.set_num_threads(4)
    spec = copy.deepcopy(run.cell(MAN, workload)[1])
    spec["config"]["pipeline"]["max_n_kfs"] = 4
    undo = fault() if fault else None
    try:
        return run.run_cell(MAN, workload, 2 ** 33 + 17, seconds, False,
                            "cpu", spec=spec)
    finally:
        if undo:
            undo()


@pytest.fixture(scope="module")
def pipe_run():
    return _cpu_run(PIPE_CELLS[0])


def test_cpu_pipelined_run_is_correct(pipe_run):
    res, got = pipe_run
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"fps", "setup_s"}


def test_cpu_pipelined_run_fails_a_carry_without_deltas():
    """The fault over a window as long as the fault runs of
    control_pipe.py: the chained steps track against the map of the
    window's first upload until tracking is lost (a 4 s window does not
    get that far)."""
    res, got = _cpu_run(PIPE_CELLS[0], fault=control_pipe.carry_without_deltas,
                        seconds=control_pipe.FAULT_SECONDS)
    assert not res["correct"], res["checks"]
