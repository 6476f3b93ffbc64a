"""The port's profiling plane on the CPU: the spans and counters of the
tracked-frame step in the handler's per-frame records, their nesting, the
GN iteration counters, that ops called with no monitor installed record
nothing and compute the same, and that the spans reach the raw events of
a profiler started as `torch.autograd._enable_profiler` starts it (which
leaves the Python-side flag False) as `plsvo.<name>` ranges. The scene
is tests/test_torch_api_handler.py's 320x240 fast_config() plane,
rendered by the port."""
import numpy as np
import pytest
import torch

from plsvo_torch.camera import PinholeCamera
from plsvo_torch.config import fast_config
from plsvo_torch.ops import pose_opt, sparse_align
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.utils import profiling, synthetic
from plsvo_torch.utils.threefry import reference_ransac_draws

torch.set_num_threads(1)

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
N_RUN = 16  # bootstrap at frame 9, a keyframe at frame 14
STAGES = ("sparse_img_align", "reproject", "optimize_pose", "optimize_points",
          "update_seeds")


def _raw_events(fn):
    """fn() under the Kineto profiler on the CPU, started through
    torch.autograd._enable_profiler: its raw events."""
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)
    from torch.autograd.profiler import _ExperimentalConfig

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    try:
        assert not torch.autograd.profiler._is_profiler_enabled
        fn()
    finally:
        res = _disable_profiler()
    return res.events()


def _image(scene, i):
    return synthetic.render_aa(scene, CAM, torch.eye(3),
                               torch.tensor([0.025 * i, 0.0, -2.0]),
                               device="cpu").numpy()


@pytest.fixture(scope="module")
def run():
    """N_RUN frames of a handler, the inputs of the last tracked frame's
    alignment and pose optimisation, and the raw profiler events of one
    more frame."""
    scene = synthetic.make_scene(np.random.default_rng(0), size=1024,
                                 texel_size=0.004)
    vo = tfh.FrameHandlerMono(CAM, fast_config(), device="cpu",
                              ransac_draws=reference_ransac_draws)
    calls = {}

    def keep(name, fn):
        def wrapped(*a, **kw):
            calls[name] = (a, kw)
            return fn(*a, **kw)
        return wrapped

    saved = sparse_align.sparse_img_align, pose_opt.optimize_pose
    sparse_align.sparse_img_align = keep("align", saved[0])
    pose_opt.optimize_pose = keep("pose", saved[1])
    try:
        for i in range(N_RUN):
            vo.add_image(_image(scene, i), i / 30.0)
    finally:
        sparse_align.sparse_img_align, pose_opt.optimize_pose = saved
    assert vo.stage == tfh.STAGE_DEFAULT
    img = _image(scene, N_RUN)
    events = _raw_events(lambda: vo.add_image(img, N_RUN / 30.0))
    vo.permon.finish()
    return dict(vo=vo, frames=vo.permon.frames, calls=calls, events=events)


def _tracked(frames):
    return [f for f in frames if "t_device_step" in f]


def test_tracked_frames_hold_stage_spans_and_counters(run):
    tracked = _tracked(run["frames"])
    assert len(tracked) >= 5
    kw = run["calls"]["align"][1]
    n_lv = len(kw["levels"])
    for f in tracked:
        for name in STAGES + ("post_fused", "upload", "tot_time"):
            assert f[f"t_{name}"] > 0.0, (f["frame"], name)
        # at least one iteration on each level, at most n_iter
        assert n_lv <= f["n_align_iters"] <= n_lv * kw["n_iter"]
        assert f["n_pose_iters"] >= 1
    assert any("t_keyframe_path" in f for f in tracked)
    # the bootstrap frames build their pyramid where the image is uploaded
    assert "t_upload" not in run["frames"][0]
    assert run["frames"][0]["t_pyramid_creation"] > 0.0


def test_child_spans_lie_within_their_parents(run):
    for f in _tracked(run["frames"]):
        step = f["t_device_step"]
        assert all(f[f"t_{s}"] <= step for s in STAGES)
        assert sum(f[f"t_{s}"] for s in STAGES) <= step
        assert f.get("t_keyframe_path", 0.0) <= f["t_post_fused"]
        assert step + f["t_post_fused"] <= f["t_tot_time"]


def test_align_counts_one_iteration_per_level(run):
    a, kw = run["calls"]["align"]
    kw = dict(kw, n_iter=1)
    mon = profiling.PerformanceMonitor()
    with mon.installed():
        sparse_align.sparse_img_align(*a, **kw)
    levels = kw["levels"]
    assert mon.counts == {"align_iters": len(levels)}


def test_ops_without_a_monitor_record_nothing_and_compute_the_same(run):
    assert profiling._current.get() is None
    for name, fn, key in (("align", sparse_align.sparse_img_align,
                           "align_iters"),
                          ("pose", pose_opt.optimize_pose, "pose_iters")):
        mon = profiling.PerformanceMonitor()
        a, kw = run["calls"][name]
        bare = fn(*a, **kw)
        assert not (mon.timers or mon.counts or mon.frames)
        with mon.installed():
            traced = fn(*a, **kw)
        assert mon.counts[key] >= 1
        for x, y in zip(bare, traced):
            assert torch.equal(x, y), name


def test_spans_reach_the_benchmark_profilers_raw_events(run):
    spans = {}
    for e in run["events"]:
        if e.name().startswith(profiling.RANGE_PREFIX):
            # not a user annotation, which the card would mirror as
            # device activity
            assert not e.is_user_annotation()
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    (step,) = spans["plsvo.device_step"]
    (align,) = spans["plsvo.sparse_img_align"]
    (tot,) = spans["plsvo.tot_time"]
    assert step[0] <= align[0] and align[1] <= step[1]
    assert tot[0] <= step[0] and step[1] <= tot[1]
    assert "plsvo.post_fused" in spans and "plsvo.update_seeds" in spans


def test_monitor_sums_spans_and_counters_per_frame():
    mon = profiling.PerformanceMonitor()
    mon.new_frame(0)
    with mon.installed():
        for _ in range(2):
            with profiling.span("a"):
                profiling.count("c", 3)
        inner = profiling.PerformanceMonitor()
        with inner.installed():
            profiling.count("c", 5)
        profiling.count("c", 1)  # the outer monitor again
    profiling.count("c", 100)  # no monitor installed: nothing
    with profiling.span("a"):
        pass
    mon.finish()
    (rec,) = mon.frames
    assert rec["frame"] == 0 and rec["n_c"] == 7 and rec["t_a"] > 0.0
    assert set(rec) == {"frame", "t_a", "n_c"} and inner.counts == {"c": 5}
    assert profiling._current.get() is None


def test_sync_records_seed_install_on_keyframes_only(run):
    """The sync path installs seeds after each detection (the bootstrap's
    second frame and every keyframe), a keyframe's inside kf_init_seeds,
    and records none of the pipelined path's names."""
    pipe = {"t_mt_delta", "t_drain_submit", "t_drain_wait", "n_mt_resync",
            "n_drained_frames", "n_inflight", "n_ba_writebacks"}
    kfs = 0
    for f in run["frames"]:
        assert not pipe & set(f), f["frame"]
        assert ("t_seed_install" in f) == ("t_kf_detect" in f), f["frame"]
        if "t_keyframe_path" in f:
            kfs += 1
            assert 0.0 < f["t_seed_install"]
            assert f["t_kf_detect"] + f["t_seed_install"] <= f["t_kf_init_seeds"]
    assert kfs >= 1
