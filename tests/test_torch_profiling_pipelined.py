"""The pipelined path's spans and counters on the CPU, depth 1: the map
carry's delta upload (`mt_delta`) and restarts (`mt_resync`), a drain's
submit and wait inside `fetch`, the frames each call's drains bookkeep,
the frames in flight, the local-BA write-backs and the seed installs; that
they reach a profiler's raw events as `plsvo.<name>` ranges; and that the
poses are the same with the spans and counters recorded under a profiler
and with the monitor doing nothing. The scene is
tests/test_torch_profiling.py's 320x240 fast_config() plane. Each run
flushes mid-sequence and transforms the map between two dispatches, so
that the chain restarts twice before the end."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from plsvo_torch.config import fast_config
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.utils import profiling, synthetic
from plsvo_torch.utils.threefry import reference_ransac_draws

from test_torch_profiling import CAM, _image, _raw_events

torch.set_num_threads(1)

N_RUN = 22  # bootstrap at frame 9, keyframes at frames 14 and 20
FLUSH_AT = 14  # flush() after this many add_image calls
TRANSFORM_AT = 18  # MapState.transform (and its inverse) before this call
# frames dispatched and not yet bookkept when a call returns, at depth 1:
# the frame just dispatched, and the one before it, whose drain window is
# copied while the host bookkeeps the window before that
INFLIGHT_BOUND = 2
PIPE_NAMES = {"t_mt_delta", "t_drain_submit", "t_drain_wait", "n_mt_resync",
              "n_drained_frames", "n_inflight", "n_ba_writebacks"}


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _drive(vo, imgs):
    """Every frame through add_image, with a flush() after FLUSH_AT calls
    and the map transformed and back before call TRANSFORM_AT. Returns
    the results in delivery order and, per call, the results it returned
    (flush()'s counted with the call before it)."""
    out, per_call = [], []
    for i, im in enumerate(imgs):
        if i == TRANSFORM_AT:
            R, t, s = _rot_z(0.02), np.asarray([0.01, -0.02, 0.005]), 1.01
            vo.map.transform(R, t, s)
            vo.map.transform(R.T, -(R.T @ t) / s, 1.0 / s)
        r = vo.add_image(im, i / 30.0)
        got = [] if r is None else [r]
        if i + 1 == FLUSH_AT:
            got += vo.flush()
        out += got
        per_call.append(len(got))
    last = vo.flush()
    per_call[-1] += len(last)
    vo.permon.finish()
    return out + last, per_call


def _handler():
    cfg = fast_config()
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, pipelined=True, pipeline_depth=1))
    return tfh.FrameHandlerMono(CAM, cfg, device="cpu",
                                ransac_draws=reference_ransac_draws)


@pytest.fixture(scope="module")
def runs():
    """The sequence twice: traced (spans and counters recorded, every call
    under the profiler) and untraced (the monitor's spans and counters
    replaced by no-ops)."""
    scene = synthetic.make_scene(np.random.default_rng(0), size=1024,
                                 texel_size=0.004)
    imgs = [_image(scene, i) for i in range(N_RUN)]
    on = _handler()
    holder = {}
    events = _raw_events(lambda: holder.update(r=_drive(on, imgs)))
    off = _handler()
    off.permon.timer = lambda name: contextlib.nullcontext()
    off.permon.count = lambda name, n: None
    res_off, _ = _drive(off, imgs)
    res_on, per_call = holder["r"]
    return dict(frames=on.permon.frames, results=res_on, per_call=per_call,
                events=events, results_off=res_off,
                off_frames=off.permon.frames)


def _pipelined(frames):
    return [f for f in frames if "n_inflight" in f]


def test_every_frame_delivered_once_in_default(runs):
    res = runs["results"]
    assert [r.frame_id for r in res] == list(range(N_RUN))
    assert all(r.stage == tfh.STAGE_DEFAULT for r in res[-8:])
    assert sum(runs["per_call"]) == N_RUN


def test_resync_on_chain_restarts_only(runs):
    """mt_resync is 1 on the first dispatch, the first after flush() and
    the first after the transform (mt_needs_resync), 0 on every other
    dispatch; the delta span is recorded exactly on the chained ones."""
    frames = runs["frames"]
    pipe = _pipelined(frames)
    first = pipe[0]["frame"]
    restarts = [f["frame"] for f in pipe if f["n_mt_resync"]]
    assert first < FLUSH_AT - 2
    assert restarts == [first, FLUSH_AT, TRANSFORM_AT]
    for f in pipe:
        assert ("t_mt_delta" in f) == (f["n_mt_resync"] == 0), f["frame"]
        if "t_mt_delta" in f:
            assert 0.0 < f["t_mt_delta"] <= f["t_device_step"]


def test_drained_frames_sum_to_the_frames_returned(runs):
    """Every frame the pipelined calls (and the flushes counted with them)
    returned was bookkept in one of their drains; the bootstrap calls
    return their own frame."""
    frames, per_call = runs["frames"], runs["per_call"]
    assert len(frames) == N_RUN == len(per_call)
    piped = [n for f, n in zip(frames, per_call) if "n_inflight" in f]
    boot = [n for f, n in zip(frames, per_call) if "n_inflight" not in f]
    assert all(n == 1 for n in boot)
    assert sum(f.get("n_drained_frames", 0) for f in frames) == sum(piped)
    assert sum(piped) == N_RUN - len(boot)


def test_inflight_bound_at_depth_1(runs):
    pipe = _pipelined(runs["frames"])
    inflight = [f["n_inflight"] for f in pipe]
    assert max(inflight) == INFLIGHT_BOUND and min(inflight) >= 1
    # a chain's first dispatch has nothing before it in flight; later
    # ones keep two
    for f in pipe:
        want = 1 if f["n_mt_resync"] else INFLIGHT_BOUND
        assert f["n_inflight"] == want, f["frame"]


def test_drain_spans_nest_in_fetch(runs):
    """A drain's submit and wait lie inside the call's fetch; a call that
    bookkeeps frames waited for their window. A chain's first two calls
    submit at most one window and bookkeep none."""
    pipe = _pipelined(runs["frames"])
    for f in pipe:
        inner = f.get("t_drain_submit", 0.0) + f.get("t_drain_wait", 0.0)
        assert inner <= f.get("t_fetch", 0.0)
        assert ("t_drain_wait" in f) == ("n_drained_frames" in f), f["frame"]
    waits = [f["frame"] for f in pipe if "t_drain_wait" in f]
    assert len(waits) >= len(pipe) - 2 * 3


def test_keyframe_seeds_and_ba_land_in_drains(runs):
    """Each deferred seed install and local-BA write-back is recorded by a
    call whose drain (or the flush after it) fetched it."""
    frames = runs["frames"]
    kf = [f for f in frames if "t_keyframe_path" in f and "n_inflight" in f]
    installs = [f for f in frames if "t_seed_install" in f]
    assert len(kf) >= 2 and len(installs) >= len(kf)
    for f in installs:
        if "n_inflight" in f:
            assert "t_drain_wait" in f and f["t_seed_install"] > 0.0
    assert sum(f.get("n_ba_writebacks", 0) for f in frames) >= 1
    for f in frames:
        if f.get("n_ba_writebacks", 0):
            assert "t_drain_wait" in f


def test_spans_reach_the_profilers_raw_events(runs):
    spans = {}
    for e in runs["events"]:
        if e.name().startswith(profiling.RANGE_PREFIX):
            spans.setdefault(e.name()[len(profiling.RANGE_PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in ("mt_delta", "drain_submit", "drain_wait", "seed_install"):
        assert spans.get(name), name
    for a, b in spans["drain_wait"] + spans["drain_submit"]:
        assert any(p <= a and b <= q for p, q in spans["fetch"])
    for a, b in spans["mt_delta"]:
        assert any(p <= a and b <= q for p, q in spans["device_step"])


def test_poses_equal_with_tracing_on_and_off(runs):
    on, off = runs["results"], runs["results_off"]
    assert [r.frame_id for r in on] == [r.frame_id for r in off]
    for a, b in zip(on, off):
        assert (a.stage, a.quality, a.is_keyframe) == (
            b.stage, b.quality, b.is_keyframe)
        np.testing.assert_array_equal(a.R_f_w, b.R_f_w)
        np.testing.assert_array_equal(a.t_f_w, b.t_f_w)
    assert not any(PIPE_NAMES & set(f) for f in runs["off_frames"])
