"""On-card smoke test of the PyTorch port (plsvo_torch) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one CUDA
card and nvcc; it imports nothing of JAX. Phases, each fatal on failure:

  1. device  — card name and power limit
  2. build   — compile csrc/*.cu for sm_90a (or load the cached build)
  3. K1      — FAST+Shi-Tomasi kernel vs its plain twin: one launch over
               the three 752x480 pyramid levels of the bench scene (the
               main path's call), and one single-image launch on 100x300;
               detect_fast_grid kernel vs plain cell winners
  4. lines   — detect_segments_tiled (the keyframe line detector) on the
               card vs the same code on the CPU, on bench frame 0: valid
               masks and responses equal, endpoints within 1e-2 px
  5. runs    — FrameHandlerMono on the 752x480 plane sequence, default
               capacities, sync path, three runs: points + lines on 40
               frames at half the bench's speed (RUN_STEP) with
               default_config() unmodified, local BA at every keyframe
               (the main path); points only (has_ls=False) on 24 frames
               at the bench's own speed, BA on; line-only (has_pt=False)
               on LINEONLY_FRAMES frames of a line-rich texture
               (LINEONLY_TEX), BA on. Each run first in an untimed pass
               that captures every K2 launch's inputs (tagged by call
               site) and every local BA problem, then timed, with the
               launch counts set to 0 just before the timed run and read
               just after it. Gates: DEFAULT reached and kept, ATE < 1% of
               the path, at least one local BA solve where BA is on; with
               points one K1 launch per keyframe detection, in line-only
               mode no K1 launch, align2d_atlas in every tracked frame and
               K2 only in the seed update; with lines line seeds installed
               at keyframes and at least one line landmark made from a
               converged seed; in the lines run a median segment match
               count > 0 after the first line landmark
  6. pipelined — default_config() with pipelined=True, pipeline_depth=12
               (bench.py's configuration) on the lines run's 40 frames and
               then PIPE_DEPTH more under torch.profiler, flush() at the
               end: an untimed capture pass, then the timed run with the
               launch counts set to 0 before its 40 frames and read after
               them. Gates: every frame delivered exactly once, DEFAULT
               reached and kept, ATE < 1% of the path, DEFAULT coverage of
               the 40 frames within max(2, n // 10) of the sync lines run,
               a deferred keyframe seed detection (one K1 launch each) and
               a deferred local BA write-back, and after flush() the carry,
               once synced, equal to a fresh upload of the mirror. Report:
               bench.py's per-frame statistic (mean and p90 over the last
               half of the DEFAULT add_image calls) for this run and the
               sync lines run; launches, host syncs and device idle share
               per frame of the profiled window
  7. K2      — the mixed-align GN kernel vs its plain twin on the inputs of
               every launch of the four capture passes: verdicts equal, uv
               within 2e-3 px and mean_diff within 2e-2; at most
               K2_APART_MAX rows of a launch may instead stop one update
               apart, where the step at which the two sides part lies at
               the convergence threshold and each side's result is the
               plain twin's iterate at its own stop (k2_compare)
  8. BA      — every local BA problem of the lines run solved on the card
               and on the CPU: finite, poses and landmarks within
               BA_POSE_ATOL / BA_LM_RTOL, every guarded write-back
               complete; the largest window's time and kernel launches
               per solve
  9. profile — 5 more frames of the lines run with each stage (local BA
               included) timed between two synchronisations, then 5 under
               torch.profiler: device busy share, kernel launches (per
               frame and per stage), host syncs, top device ops
  10. timing  — K1's three-level launch (device time, per-call time, bound)
               and each level alone; K2 at the reprojection's N=384 launch
               with the most valid rows (device, per-call, bound) and its
               device time at every call site and N of the three runs;
               detect_fast_grid's, detect_segments_tiled's,
               align_mixed_atlas's and align2d_atlas's per-call times
  11. report — one JSON line per the kernel report format, the card line,
               and as the last line {"ok": true, "device": {...}}

Exits non-zero, with no result line, when any phase fails or no CUDA
device is present.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s, FP32
# (non-tensor-core) 67 TFLOP/s. Bounds are computed against these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K1's least work per pixel: 34 FAST ops (2 threshold adds + 32 ring
# compares), 7 gradient/product ops, 3 x 4 box ops (a running-sum box, as
# the plain twin's cumsum filter: one add and one subtract per axis), ~10
# for the eigenvalue
K1_OPS_PER_PX = 34 + 7 + 12 + 10
K1_BYTES_PER_PX = 4 + 1 + 4  # read f32 image, write bool mask + f32 score
# K2 work per active row-iteration: 64 taps x (9 bilinear + 2 residual +
# 7 for the four weighted sums) + ~30 for locate/solve/update
K2_OPS_PER_ROW_ITER = 64 * 18 + 30
# Sideways travel per frame of the lines run's sequence: half of bench.py's
# 0.03 m. A line seed ages out 3 keyframes after its own and updates only
# in frames where both endpoints match; at the bench's speed keyframes
# come every few frames and line seeds rarely converge before they age
# out. At half the speed line landmarks form within the 40 frames.
# tests/lines_at_bench_speed.py runs both packages on the CPU at either
# speed: at 0.03 m they make the same single line landmark and the same
# per-frame segment matches (median 0 after it), so the gates below could
# not tell a working port from a broken one there.
RUN_STEP = 0.015
# The line-only run: the bench scene's plane and camera, its texture with
# the rectangle/blob mix of the line-rich scene of tests/test_pipeline.py
# (420 rectangles and 40 blobs on 1024^2 texels) scaled to its 2048^2
# texels, LINEONLY_FRAMES frames at LINEONLY_STEP m per frame.
# `tests/lines_at_bench_speed.py --frames 28 --step 0.02 --ba --no-pt
# --n-rects 1680 --n-blobs 160` runs both packages on the CPU on these
# frames (rendered by JAX): both bootstrap at frame 9, make 8 line
# landmarks (the first at frame 20) and match 8 segments in each frame
# after it.
LINEONLY_TEX = dict(n_rects=1680, n_blobs=160)
LINEONLY_STEP = 0.02
LINEONLY_FRAMES = 28
# The pipelined run: bench.py's PipelineConfig(pipelined=True,
# pipeline_depth=12); its profiled window is one drain window long
PIPE_DEPTH = 12
# Local BA, card against CPU on the same packed problem (see phase_ba)
BA_POSE_ATOL = 1e-4
BA_LM_RTOL = 1e-3
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, reps=30, inner=20, warmup=5):
    """Median over reps of the CUDA-event time of `inner` back-to-back calls,
    divided by inner: the time a call holds the stream, launch gaps
    included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def _device_records(calls, kernel_name, pad=32):
    """Durations (us) of the kernel named kernel_name, as torch.profiler
    records it on the card, for each call of `calls` in order. The last
    call is run `pad` more times at the end, because the profiler can lose
    the last few device records of a session; returns the records of
    `calls` only, or fewer when more were lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in calls:
            f()
        for _ in range(pad):
            calls[-1]()
        torch.cuda.synchronize()
    d = [d for _, d in sorted(
        (e.time_range.start, e.time_range.elapsed_us())
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and kernel_name in e.name)]
    return d[:len(calls)]


def kernel_device_ms(fn, kernel_name, n=50):
    """Median device duration of the kernel named kernel_name over n calls
    of fn, as torch.profiler records it on the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        d = _device_records([fn] * n, kernel_name)
        if len(d) >= n // 2:
            return float(np.median(d)) / 1e3
    fail(f"the profiler saw {len(d)} of {n} launches of {kernel_name}")


def calls_device_ms(calls, kernel_name, reps=10):
    """Device time of each call of `calls` (the median of `reps` runs, one
    call after the other), as torch.profiler records it, from one
    session."""
    import torch

    for f in calls:
        f()
    torch.cuda.synchronize()
    runs = [f for f in calls for _ in range(reps)]
    for _ in range(3):
        d = _device_records(runs, kernel_name)
        # every record is needed to tell the calls apart: else again
        if len(d) == len(runs):
            us = np.asarray(d).reshape(len(calls), reps)
            return [float(x) / 1e3 for x in np.median(us, axis=1)]
    # records lost inside the session: one session per call
    return [kernel_device_ms(f, kernel_name, n=2 * reps) for f in calls]


def bench_sequence(n_frames, device, step=0.03, **tex_kw):
    """The bench.py plane sequence (step m of sideways travel per frame),
    rendered by the port; tex_kw overrides the texture's counts."""
    from plsvo_torch.camera import PinholeCamera
    from plsvo_torch.utils import synthetic

    W, H = 752, 480
    cam = PinholeCamera.create(W, H, 460.0, 460.0, W / 2, H / 2)
    scene = synthetic.make_scene(np.random.default_rng(3), size=2048,
                                 texel_size=0.003, **tex_kw)
    Rs, ts = [], []
    for i in range(n_frames):
        ang = 0.002 * i
        Rs.append(np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                              [-np.sin(ang), 0, np.cos(ang)]], np.float32))
        ts.append(np.asarray([step * i, 0.008 * np.sin(0.3 * i), -2.0],
                             np.float32))
    imgs = synthetic.render_batch_aa(scene, cam, Rs, ts, ss=2, device=device)
    return cam, imgs, np.stack(ts)


def phase_k1(imgs0, device):
    import torch

    from plsvo_torch.image import build_pyramid
    from plsvo_torch.ops import detection
    from plsvo_torch.ops import fast_score as fs

    pyr = build_pyramid(imgs0, 3)
    rng = np.random.default_rng(0)
    odd = torch.tensor(rng.uniform(0, 255, (100, 300)).astype(np.float32),
                       device=device)
    before = fs.launches
    outs = fs.fast_score_levels_cuda(pyr, 10.0)  # the main path's launch
    if fs.launches != before + 1:
        fail(f"K1's three levels took {fs.launches - before} launches, not 1")
    outs.append(fs.fast_score_cuda(odd, 10.0))
    worst_abs = 0.0
    worst_rel = 0.0
    for img, (m_k, s_k) in zip(list(pyr) + [odd], outs):
        m_p, s_p = fs.fast_score_plain(img, 10.0)
        torch.cuda.synchronize()
        if not bool((m_k == m_p).all()):
            fail(f"K1 mask differs from the plain twin at {tuple(img.shape)}: "
                 f"{int((m_k != m_p).sum())} pixels")
        err = (s_k - s_p).abs()
        rel = float((err / s_p.abs().clamp_min(1.0)).max())
        print(f"K1 {tuple(img.shape)}: mask equal ({int(m_k.sum())} corners), "
              f"score max abs err {float(err.max()):.3e}, max rel err {rel:.3e}",
              flush=True)
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel, rel)
    # the kernel sums each 8x8 box as two pairwise trees (8 rows per column,
    # then 8 columns across lanes); the plain twin differences f32 cumsums:
    # the roundings differ by ~1e-4 relative
    if worst_rel > 1e-3:
        fail(f"K1 score relative error {worst_rel} > 1e-3")
    g_k = detection.detect_fast_grid(pyr, cell_size=25, score_threshold=20.0)
    g_p = detection.detect_fast_grid([p.cpu() for p in pyr], cell_size=25,
                                     score_threshold=20.0)
    vk, vp = g_k.valid.cpu(), g_p.valid
    same = ((vk == vp) & (~vk | ((g_k.uv.cpu() == g_p.uv).all(-1)
                                 & (g_k.level.cpu() == g_p.level))))
    frac = float(same.float().mean())
    print(f"K1 detect_fast_grid: kernel and plain winners agree in "
          f"{frac * 100:.2f}% of {len(same)} cells ({int(vk.sum())} valid)",
          flush=True)
    if frac < 0.99:
        fail(f"K1 grid winners agree in only {frac:.4f} of cells")
    return pyr, worst_abs, worst_rel


def run_config(kind):
    """The configuration of each run, from default_config(): "lines"
    unmodified (points, edgelets and lines, local BA at every keyframe,
    sync), "points" with lines off, "lineonly" with points off, "pipelined"
    as bench.py runs it."""
    from plsvo_torch.config import default_config

    cfg = default_config()
    over = {"lines": {}, "points": dict(has_ls=False, init_ls=False),
            "lineonly": dict(has_pt=False),
            "pipelined": dict(pipelined=True, pipeline_depth=PIPE_DEPTH)}[kind]
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **over))


def _call_sites():
    """(owner, attribute, site) of the main path's K2 call sites."""
    from plsvo_torch.ops import depth_filter
    from plsvo_torch.pipeline import reprojector

    return [(reprojector, "reproject_combined", "reproject"),
            (reprojector, "reproject_points", "reproject"),
            (depth_filter, "update_seeds_combined", "seeds")]


def _patched(patches):
    """Set (owner, attribute, value) patches; returns the undo function."""
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    for o, a, v in patches:
        setattr(o, a, v)

    def undo():
        for o, a, v in saved:
            setattr(o, a, v)
    return undo


def capture_pass(cam, imgs, device, n_main, cfg):
    """The run's frames through a handler of its own, untimed, capturing
    the inputs of every K2 launch (tagged by call site), of the first
    reprojection call of align_mixed_atlas and of align2d_atlas, of every
    local BA solve, and the counts of every guarded BA write-back."""
    import torch

    from plsvo_torch.ops import depth_filter, matcher
    from plsvo_torch.ops import mixed_align as ma
    from plsvo_torch.parallel import ba
    from plsvo_torch.pipeline.frame_handler import FrameHandlerMono

    out = dict(k2=[], atlas={}, ba=[], write_backs=[])
    site = ["other"]

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def k2_capture(args, kwargs):
        out["k2"].append(([a.clone() for a in args], dict(kwargs), site[0]))

    def first_reproject_call(name, orig):
        def wrapped(*a, **k):
            if site[0] == "reproject" and name not in out["atlas"]:
                out["atlas"][name] = ([clone(x) for x in a], dict(k))
            return orig(*a, **k)
        return wrapped

    def at_site(orig, label):
        def wrapped(*a, **k):
            site[0] = label
            try:
                return orig(*a, **k)
            finally:
                site[0] = "other"
        return wrapped

    def ba_capture(orig):
        def wrapped(blob, **k):
            out["ba"].append((blob.detach().cpu().clone(), dict(k)))
            return orig(blob, **k)
        return wrapped

    def write_back_capture(orig):
        def wrapped(m, kf_R, kf_t, lm_pos, meta):
            got = orig(m, kf_R, kf_t, lm_pos, meta)
            # in the sync path nothing changes between the solve and its
            # write-back, so every free keyframe and landmark row is written
            out["write_backs"].append(
                (got, (len(meta["kf_free"]),
                       meta["n_points"] + meta["n_lines"])))
            return got
        return wrapped

    patches = [(matcher, "align_mixed_atlas",
                first_reproject_call("align_mixed_atlas",
                                     matcher.align_mixed_atlas)),
               (matcher, "align2d_atlas",
                first_reproject_call("align2d_atlas", matcher.align2d_atlas)),
               (ba, "bundle_adjust_blob", ba_capture(ba.bundle_adjust_blob)),
               (ba, "write_back_window",
                write_back_capture(ba.write_back_window)),
               (ma, "capture", k2_capture)]
    patches += [(o, a, at_site(getattr(o, a), label))
                for o, a, label in _call_sites()]
    undo = _patched(patches)
    try:
        vo = FrameHandlerMono(cam, cfg, device=device)
        for i in range(n_main):
            vo.add_image(imgs[i], i / 30.0)
        vo.flush()
    finally:
        undo()
    return out


def phase_run(kind, cam, imgs, gt_centers, device, n_main):
    """One run: an untimed capture pass, then the timed run with fresh
    launch counts."""
    import torch

    from plsvo_torch.ops import fast_score as fs
    from plsvo_torch.ops import matcher
    from plsvo_torch.ops import mixed_align as ma
    from plsvo_torch.pipeline.frame_handler import (STAGE_DEFAULT,
                                                    FrameHandlerMono)
    from plsvo_torch.pipeline.state import MapState
    from plsvo_torch.utils import trajectory

    cfg = run_config(kind)
    cap = capture_pass(cam, imgs, device, n_main, cfg)

    created = []  # frame of every line landmark made from a converged seed
    a2d_frames = []  # frame of every align2d_atlas call
    frame_now = [-1]

    def counting_new_line(self, *a, **k):
        r = orig_new_line(self, *a, **k)
        if r >= 0:
            created.append(frame_now[0])
        return r

    def counting_align2d(*a, **k):
        a2d_frames.append(frame_now[0])
        return orig_align2d(*a, **k)

    orig_new_line, orig_align2d = MapState.new_line, matcher.align2d_atlas
    vo = FrameHandlerMono(cam, cfg, device=device)
    results, ms = [], []
    k1_at_kf, ln_installs = [], []
    undo = _patched([(MapState, "new_line", counting_new_line),
                     (matcher, "align2d_atlas", counting_align2d)])
    fs.launches = 0
    ma.launches = 0
    try:
        for i in range(n_main):
            k1_before = fs.launches
            frame_now[0] = i
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = vo.add_image(imgs[i], i / 30.0)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            results.append(r)
            if r.is_keyframe:
                ln_installs.append(int((vo._lnseed_install_frame == i).sum()))
            if r.stage == STAGE_DEFAULT and r.is_keyframe:
                k1_at_kf.append(fs.launches - k1_before)
        launches = {"fast_score": fs.launches, "mixed_align": ma.launches}
    finally:
        undo()
    gt_centers = gt_centers[:n_main]
    stages = [r.stage for r in results]
    print(f"{kind} stages:", " ".join(s[0] for s in stages), flush=True)
    if STAGE_DEFAULT not in stages:
        fail(f"{kind}: never reached STAGE_DEFAULT")
    fd = stages.index(STAGE_DEFAULT)
    if any(s != STAGE_DEFAULT for s in stages[fd:]):
        fail(f"{kind}: tracking left STAGE_DEFAULT after frame {fd}: {stages[fd:]}")
    if len(stages) - fd < 10:
        fail(f"{kind}: only {len(stages) - fd} DEFAULT frames")
    est = np.stack([-r.R_f_w.T @ r.t_f_w for r in results[fd:]])
    gt = gt_centers[fd:]
    if not np.isfinite(est).all():
        fail(f"{kind}: non-finite camera centres")
    ate = trajectory.ate_rmse(est.astype(np.float64), gt.astype(np.float64))
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=-1).sum())
    n_kf = sum(r.is_keyframe for r in results)
    tail = list(range(fd + 5, n_main))
    kf_tail = [ms[i] for i in tail if results[i].is_keyframe]
    plain_tail = [ms[i] for i in tail if not results[i].is_keyframe]
    ms_tail = [ms[i] for i in tail]
    print(f"{kind}: DEFAULT from frame {fd}, {len(results) - fd} tracked frames, "
          f"{n_kf} keyframes, {vo.map.n_keyframes()} in the map, "
          f"{int((vo.map.pt_status > 0).sum())} point landmarks, median point "
          f"matches {np.median([r.n_pt_matches for r in results[fd:]]):.0f}",
          flush=True)
    print(f"{kind}: Sim3 ATE {ate:.6f} m over a {path:.3f} m path "
          f"({100 * ate / path:.3f}%)", flush=True)
    print(f"{kind}: per-frame ms (DEFAULT frames after the first 5, "
          f"n={len(ms_tail)}): median {np.median(ms_tail):.2f}, p90 "
          f"{np.percentile(ms_tail, 90):.2f}; keyframe frames (n="
          f"{len(kf_tail)}) median "
          + (f"{np.median(kf_tail):.2f} p90 {np.percentile(kf_tail, 90):.2f}"
             if kf_tail else "none")
          + f"; other frames (n={len(plain_tail)}) median "
          f"{np.median(plain_tail):.2f} p90 {np.percentile(plain_tail, 90):.2f}",
          flush=True)
    print(f"{kind}: launches {launches}; K1 launches at DEFAULT keyframes "
          f"{k1_at_kf}", flush=True)
    if ate >= 0.01 * path:
        fail(f"{kind}: ATE {ate} >= 1% of the path length {path}")
    if launches["mixed_align"] <= 0:
        fail(f"{kind}: K2 never launched: {launches}")
    if kind == "lineonly":
        # no point detector: K1 never runs; every tracked frame refines its
        # points and endpoints through align2d_atlas, so K2 runs only in
        # the seed update
        if launches["fast_score"] != 0:
            fail(f"{kind}: K1 launched {launches['fast_score']} times in "
                 "line-only mode")
        missing = sorted(set(range(fd + 1, n_main)) - set(a2d_frames))
        if missing:
            fail(f"{kind}: align2d_atlas not reached in tracked frames {missing}")
        sites = sorted({s for _, _, s in cap["k2"]})
        if sites != ["seeds"]:
            fail(f"{kind}: K2 launched from {sites}, not only the seed update")
        print(f"{kind}: align2d_atlas calls {len(a2d_frames)} over "
              f"{n_main - fd - 1} tracked frames after the bootstrap; K2 call "
              f"sites {sites}", flush=True)
    else:
        if launches["fast_score"] <= 0:
            fail(f"{kind}: K1 never launched: {launches}")
        if not k1_at_kf or any(k != 1 for k in k1_at_kf):
            fail(f"{kind}: K1 launches per tracked keyframe are {k1_at_kf}, "
                 "not one each")
    seg_med = None
    if kind != "points":
        seg = [r.n_seg_matches for r in results]
        print(f"{kind}: line seeds installed at the keyframes {ln_installs}; "
              f"{len(created)} line landmarks made from converged seeds (first "
              f"at frame {created[0] if created else None}), "
              f"{int((vo.map.ln_status > 0).sum())} live at the end; segment "
              f"matches per frame {seg}", flush=True)
        if not ln_installs or sum(ln_installs[1:]) <= 0:
            fail(f"{kind}: no line seed installed at a tracked keyframe: "
                 f"{ln_installs}")
        if not created:
            fail(f"{kind}: no line landmark was made from a converged seed")
        after = [n for r, n in zip(results, seg)
                 if r.stage == STAGE_DEFAULT and r.frame_id > created[0]]
        seg_med = float(np.median(after)) if after else 0.0
        print(f"{kind}: median segment matches over the {len(after)} tracked "
              f"frames after the first line landmark: {seg_med:.1f} (over all "
              f"tracked frames {np.median(seg[fd:]):.1f})", flush=True)
        if kind == "lines" and seg_med <= 0:
            fail(f"{kind}: median segment matches after the first line "
                 f"landmark is {seg_med}")
    # per-stage host wall time (stage timers of the frame handler) over the
    # same frames as the per-frame ms, and each local BA's stage time
    vo.permon.finish()
    recs = [r for r in vo.permon.frames if r["frame"] >= fd + 5]
    keys = sorted({k for r in recs for k in r if k.startswith("t_")})
    stage_ms = {k[2:]: (1e3 * float(np.median([r.get(k, 0.0) for r in recs])),
                        1e3 * float(np.mean([r.get(k, 0.0) for r in recs])))
                for k in keys}
    print(f"{kind}: per-stage host ms (median, mean): " + ", ".join(
        f"{k} {a:.2f}/{b:.2f}" for k, (a, b) in stage_ms.items()), flush=True)
    ba_recs = [r for r in vo.permon.frames if "local_ba_kfs" in r]
    ba_ms = [1e3 * r["t_local_ba"] for r in ba_recs]
    if cfg.pipeline.loba_enabled:
        print(f"{kind}: {len(ba_recs)} local BA solves (frames "
              f"{[r['frame'] for r in ba_recs]}), stage ms "
              f"{[round(x, 2) for x in ba_ms]}, keyframes / landmarks written "
              f"{[(int(r['local_ba_kfs']), int(r['local_ba_landmarks'])) for r in ba_recs]}",
              flush=True)
        if not ba_recs:
            fail(f"{kind}: local BA never solved a window")
    bench_mean, bench_p90 = bench_stat(stages, ms)
    print(f"{kind}: bench.py's statistic (mean, p90 of the last half of the "
          f"DEFAULT calls): {bench_mean:.2f} / {bench_p90:.2f} ms", flush=True)
    return dict(vo=vo, launches=launches, n_frames=len(results), kind=kind,
                results=results, bench_mean=bench_mean, bench_p90=bench_p90,
                captured=cap["k2"], atlas_calls=cap["atlas"], ba=cap["ba"],
                write_backs=cap["write_backs"], ate=ate, path=path,
                ms_median=float(np.median(ms_tail)),
                ms_p90=float(np.percentile(ms_tail, 90)),
                kf_ms_p90=(float(np.percentile(kf_tail, 90)) if kf_tail
                           else None),
                ba_stage_ms=ba_ms, seg_median=seg_med,
                n_lines_made=len(created))


def bench_stat(stages, ms):
    """bench.py's per-frame statistic (bench.py:204-215): mean and p90 of
    the last half of the DEFAULT-stage calls; the mean because pipelined
    results arrive in bursts (cheap dispatch-only calls, then a drain)."""
    from plsvo_torch.pipeline.frame_handler import STAGE_DEFAULT

    d = [t for st, t in zip(stages, ms) if st == STAGE_DEFAULT]
    steady = d[len(d) // 2:]
    return float(np.mean(steady)), float(np.percentile(steady, 90))


def profile_window(fn):
    """fn() under torch.profiler, ending in a synchronisation: (wall ms,
    device busy ms, kernel launches, host syncs, the profile)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    # device activity: kernels and copies as the card ran them (the stage
    # labels' device-side ranges and the CPU ops' attributed times would
    # count the same work twice)
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("stage:")) / 1e3
    launches = sum(e.count for e in ev if e.key in LAUNCH_NAMES)
    syncs = sum(e.count for e in ev if e.key == "aten::_local_scalar_dense")
    return wall_ms, busy_ms, launches, syncs, prof


def phase_pipelined(cam, imgs, gt_centers, device, n_main, sync_run):
    """The pipelined run (bench.py's configuration) on the lines run's
    frames: an untimed capture pass, the timed run of n_main frames with
    fresh launch counts, PIPE_DEPTH more frames under torch.profiler, then
    flush(). Gates and report as in the module docstring."""
    from plsvo_torch.ops import fast_score as fs
    from plsvo_torch.ops import mixed_align as ma
    from plsvo_torch.pipeline import fused
    from plsvo_torch.pipeline.frame_handler import (STAGE_DEFAULT,
                                                    FrameHandlerMono)
    from plsvo_torch.utils import trajectory

    kind = "pipelined"
    cfg = run_config(kind)
    cap = capture_pass(cam, imgs, device, n_main, cfg)
    vo = FrameHandlerMono(cam, cfg, device=device)
    deferred_k1, installs, solves, write_backs = [], [], [], []
    detect, seed_init = vo._queue_or_dispatch_detection, vo._complete_seed_init
    solve, write_back = vo._solve_local_ba, vo._write_back_ba

    def queue_detection(frame):
        before = fs.launches
        out = detect(frame)
        deferred_k1.append(fs.launches - before)
        return out

    def complete_seed_init(*a):
        if vo.stage == STAGE_DEFAULT:  # the bootstrap's is in SECOND
            installs.append(vo.frame_id)
        return seed_init(*a)

    def solve_local_ba(*a):
        solves.append(vo.frame_id)
        return solve(*a)

    def write_back_ba(*a):
        write_backs.append(vo.frame_id)
        return write_back(*a)

    vo._queue_or_dispatch_detection = queue_detection
    vo._complete_seed_init = complete_seed_init
    vo._solve_local_ba = solve_local_ba
    vo._write_back_ba = write_back_ba
    delivered, stages, ms = [], [], []

    def track(i):
        t0 = time.perf_counter()
        r = vo.add_image(imgs[i], i / 30.0)
        ms.append((time.perf_counter() - t0) * 1e3)
        # bench.py counts a call that returns no result as a DEFAULT call
        stages.append(r.stage if r is not None else STAGE_DEFAULT)
        if r is not None:
            delivered.append(r)

    fs.launches = 0
    ma.launches = 0
    for i in range(n_main):
        track(i)
    launches = {"fast_score": fs.launches, "mixed_align": ma.launches}
    bench_mean, bench_p90 = bench_stat(stages, ms)
    n_all = n_main + PIPE_DEPTH
    wall_ms, busy_ms, n_launch, n_sync, _ = profile_window(
        lambda: [track(i) for i in range(n_main, n_all)])
    delivered += vo.flush()
    ids = [r.frame_id for r in delivered]
    st = [r.stage for r in delivered]
    print(f"{kind} stages:", " ".join(x[0] for x in st), flush=True)
    if ids != list(range(n_all)):
        fail(f"{kind}: delivered frames {ids}, not each of 0..{n_all - 1} once "
             "in order")
    if STAGE_DEFAULT not in st:
        fail(f"{kind}: never reached STAGE_DEFAULT")
    fd = st.index(STAGE_DEFAULT)
    if any(x != STAGE_DEFAULT for x in st[fd:]):
        fail(f"{kind}: tracking left STAGE_DEFAULT after frame {fd}: {st[fd:]}")
    est = np.stack([-r.R_f_w.T @ r.t_f_w for r in delivered[fd:]])
    gt = gt_centers[fd:n_all]
    if not np.isfinite(est).all():
        fail(f"{kind}: non-finite camera centres")
    ate = trajectory.ate_rmse(est.astype(np.float64), gt.astype(np.float64))
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=-1).sum())
    print(f"{kind}: Sim3 ATE {ate:.6f} m over a {path:.3f} m path "
          f"({100 * ate / path:.3f}%)", flush=True)
    if ate >= 0.01 * path:
        fail(f"{kind}: ATE {ate} >= 1% of the path length {path}")
    ids_p = {r.frame_id for r in delivered[:n_main] if r.stage == STAGE_DEFAULT}
    ids_s = {r.frame_id for r in sync_run["results"] if r.stage == STAGE_DEFAULT}
    off = sorted(ids_p ^ ids_s)
    print(f"{kind}: DEFAULT frames of the first {n_main}: {len(ids_p)} (sync "
          f"run {len(ids_s)}), differing {off}", flush=True)
    if len(off) > max(2, len(ids_s) // 10):
        fail(f"{kind}: DEFAULT coverage differs from the sync run in {off}")
    print(f"{kind}: deferred keyframe detections {len(deferred_k1)} (K1 launches "
          f"each {deferred_k1}), seed installs in drains at frames {installs}, "
          f"local BA solves at frames {solves}, write-backs at frames "
          f"{write_backs}", flush=True)
    if not deferred_k1 or any(k != 1 for k in deferred_k1):
        fail(f"{kind}: K1 launches per deferred keyframe detection {deferred_k1}")
    if not installs or not write_backs:
        fail(f"{kind}: no deferred seed install ({installs}) or local BA "
             f"write-back ({write_backs})")
    bad = fused.carry_mismatches(vo.sync_carry(), fused.map_tables_upload(vo.map))
    if bad:
        fail(f"{kind}: after flush() the carry differs from the mirror in {bad}")
    n = PIPE_DEPTH
    print(f"{kind}: launches {launches} over the {n_main} timed frames; the "
          f"carry equals a fresh upload of the mirror after flush()", flush=True)
    print(f"{kind}: bench.py's statistic (mean, p90 of the last half of the "
          f"DEFAULT calls): {bench_mean:.2f} / {bench_p90:.2f} ms (sync lines "
          f"run on the same frames: {sync_run['bench_mean']:.2f} / "
          f"{sync_run['bench_p90']:.2f} ms)", flush=True)
    print(f"profile: pipelined window ({n} frames, one drain window, under "
          f"torch.profiler): wall {wall_ms / n:.2f} ms/frame, device busy "
          + (f"{busy_ms / n:.3f} ms/frame ({100 * busy_ms / n / bench_mean:.2f}% "
             f"of the unprofiled {bench_mean:.2f} ms/frame: idle "
             f"{100 - 100 * busy_ms / n / bench_mean:.2f}%)"
             if busy_ms > 0 else "not measured (the profiler saw no device time)")
          + f"; per frame: {n_launch / n:.0f} kernel launches, {n_sync / n:.1f} "
          "host syncs", flush=True)
    return dict(launches=launches, captured=cap["k2"], ate=ate, path=path,
                bench_mean=bench_mean, bench_p90=bench_p90,
                n_deferred=len(deferred_k1), n_write_backs=len(write_backs))


def launch_count(fn):
    """Kernel launches of one call of fn, as torch.profiler counts them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_NAMES)


def phase_ba(run, device):
    """Every local BA problem of the run's capture pass, solved on the card
    and on the CPU from the same packed blob: finite outputs, poses and
    landmarks within BA_POSE_ATOL / BA_LM_RTOL (the scatter-adds sum with
    atomics on the card and in order on the CPU, so the two differ in the
    last bits, amplified in the near-singular line-endpoint blocks), and
    every guarded write-back of the run complete. Then the per-call time of
    the solve (host clock, synchronised) and its kernel launches."""
    import torch

    from plsvo_torch.parallel import ba
    from plsvo_torch.pipeline import fused

    probs, wbs = run["ba"], run["write_backs"]
    if not probs:
        fail("BA: the lines run solved no local BA window")
    short = [(got, want) for got, want in wbs if got != want]
    if short:
        fail(f"BA: guarded write-backs wrote (keyframes, landmarks) {short} "
             "where the window had more")
    errs = []
    for blob, kw in probs:
        K, L, O, _ = kw["spec"]
        outs = []
        for dev in (device, "cpu"):
            p, st = ba.bundle_adjust_blob(blob.to(dev), **kw)
            outs.append(fused.fetch((p.kf_R, p.kf_t, p.lm_pos, p.lm_valid,
                                     st.chi2, st.n_obs)))
        (Rk, tk, lk, vk, ck, nk), (Rc, tc, lc, _, cc, nc) = outs
        if not all(np.isfinite(a).all() for a in (Rk, tk, lk[vk], ck)):
            fail(f"BA K={K} L={L}: non-finite card output")
        if nk != nc:
            fail(f"BA K={K} L={L}: {nk} observations on the card, {nc} on "
                 "the CPU")
        pose = max(float(np.abs(Rk - Rc).max()), float(np.abs(tk - tc).max()))
        lm = float((np.linalg.norm(lk - lc, axis=-1)
                    / np.maximum(np.linalg.norm(lc, axis=-1), 1e-6))[vk].max())
        errs.append((K, L, int(vk.sum()), pose, lm, float(ck), float(cc)))
        if pose > BA_POSE_ATOL or lm > BA_LM_RTOL:
            fail(f"BA K={K} L={L}: card vs CPU pose err {pose} (atol "
                 f"{BA_POSE_ATOL}), landmark rel err {lm} (rtol {BA_LM_RTOL})")
    for K, L, n, pose, lm, ck, cc in errs:
        print(f"BA K={K} L={L} ({n} landmark rows): card vs CPU pose max abs "
              f"err {pose:.3e}, landmark max rel err {lm:.3e}, chi2 {ck:.6e} "
              f"/ {cc:.6e}", flush=True)
    print(f"BA: {len(probs)} windows, write-backs complete {wbs}", flush=True)
    # the largest window: per-call time and launches of the solve as the
    # frame handler runs it (upload, solve, one fetch)
    blob, kw = max(probs, key=lambda p: p[1]["spec"][1])
    host = blob.numpy()

    def solve():
        p, _ = ba.bundle_adjust_blob(torch.as_tensor(host).to(device), **kw)
        return fused.fetch((p.kf_R, p.kf_t, p.lm_pos))

    solve()
    torch.cuda.synchronize()
    t = []
    for _ in range(10):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        t.append((time.perf_counter() - t0) * 1e3)
    n_launch = launch_count(solve)
    K, L, O, _ = kw["spec"]
    print(f"BA: largest window K={K} L={L} O={O} n_iter={kw['n_iter']}: "
          f"{np.median(t):.2f} ms per solve (median of 10, min "
          f"{min(t):.2f}), {n_launch} kernel launches per solve", flush=True)
    return dict(n=len(probs), ms=float(np.median(t)), launches=n_launch,
                K=K, L=L, O=O, errs=errs)


def phase_lines(img, device):
    """The keyframe line detector on the card against the same code on the
    CPU."""
    import torch

    from plsvo_torch.ops import lines

    kw = dict(n_peaks=64, run_gap_px=3.0, dist_tol=1.2)
    d_k = lines.detect_segments_tiled(img, **kw)
    d_p = lines.detect_segments_tiled(img.cpu(), **kw)
    torch.cuda.synchronize()
    vk, vp = d_k.valid.cpu(), d_p.valid
    if not torch.equal(vk, vp):
        fail(f"detect_segments_tiled: valid masks differ in "
             f"{int((vk != vp).sum())} of {len(vp)} rows")
    if not torch.equal(d_k.response.cpu(), d_p.response):
        fail("detect_segments_tiled: responses differ")
    err = max(float((getattr(d_k, n).cpu() - getattr(d_p, n))[vp].abs().max())
              for n in ("sp", "ep")) if vp.any() else 0.0
    print(f"lines: detect_segments_tiled {tuple(img.shape)} card vs CPU: "
          f"{int(vp.sum())} of {len(vp)} rows valid, masks and responses equal, "
          f"endpoints max abs err {err:.3e} px", flush=True)
    if int(vp.sum()) < 50 or err > 1e-2:
        fail(f"detect_segments_tiled: {int(vp.sum())} valid rows, endpoint "
             f"error {err} (atol 1e-2)")


def k2_active_row_iters(args, kw):
    """Row-iterations the data needs: rows still active before each
    iteration of the early-exit loop."""
    from plsvo_torch.image import sample_patch_windows
    from plsvo_torch.ops import mixed_align as ma

    win, corner, wh, valid = args[0], args[1], args[11], args[12]
    total = 0
    for k in range(kw["n_iter"]):
        uv, conv, _ = ma.mixed_align_plain(*args, **dict(kw, n_iter=k))
        _, ok = sample_patch_windows(win, corner, uv, kw["patch_size"],
                                     wh=(wh[:, 0], wh[:, 1]))
        total += int((valid & ok & ~conv).sum())
    return total


def k2_bound_ms(args, row_iters):
    """(bound in ms, what bounds it) of a K2 launch on args whose data needs
    row_iters active row-iterations. A valid row reads the 16x16 window,
    four 64-tap vectors, H^-1 and the small per-row terms once; an invalid
    row needs only its flag and uv0 (it returns uv0, not converged, mean
    difference 0). Every row writes uv, mean_diff and the verdict once."""
    n = args[0].shape[0]
    n_valid = int(args[12].sum())
    out_bytes = 2 * 4 + 4 + 1
    valid_bytes = (256 * 4 + 4 * 64 * 4 + (9 + 4 + 2 + 2 + 2 + 2) * 4 + 2
                   + out_bytes)
    invalid_bytes = 1 + 2 * 4 + out_bytes
    n_bytes = n_valid * valid_bytes + (n - n_valid) * invalid_bytes
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = row_iters * K2_OPS_PER_ROW_ITER / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


K2_UV_ATOL = 2e-3  # tests/test_pallas_align.py's parity bar
K2_MD_ATOL = 2e-2
# rows of one launch that may stop one update apart from the plain twin
K2_APART_MAX = 2


def k2_iterates(args, kw):
    """The plain twin's path on args: (uv (n_iter+1, N, 2), md (n_iter+1,
    N), stop (N,)). Iterate s is a row's (uv, mean_diff) after s updates
    (convergence off, so a row goes on where the early-exit loop stops);
    stop is the update after which the early-exit loop converged the row,
    0 where it did not."""
    import torch

    from plsvo_torch.ops import mixed_align as ma

    uv, md = [], []
    stop = torch.zeros(args[0].shape[0], dtype=torch.long,
                       device=args[0].device)
    for s in range(kw["n_iter"] + 1):
        u, _, m = ma.mixed_align_plain(*args, **dict(kw, n_iter=s, conv_eps=0.0))
        uv.append(u)
        md.append(m)
        if s:
            conv = ma.mixed_align_plain(*args, **dict(kw, n_iter=s))[1]
            stop = torch.where((stop == 0) & conv, s, stop)
    return torch.stack(uv), torch.stack(md), stop


def k2_compare(args, kw, out_k, out_p, apart_max=K2_APART_MAX):
    """The kernel's (uv, converged, mean_diff) against the plain twin's on
    the same inputs. Converged verdicts must be equal, and uv and
    mean_diff within K2_UV_ATOL / K2_MD_ATOL on every converged row, but
    for one exception: the two sides round the step differently, so a row
    whose step lies at the convergence threshold may stop one update
    earlier or later on the card. Such a row passes only when (a) the
    plain twin's result is its own iterate at its stop update s; (b) the
    kernel's is the iterate at s - 1 or s + 1 (never 0: a row converges
    only after an update); (c) the step of the update at which the two
    sides part lies within K2_UV_ATOL of conv_eps, and, where the kernel
    stopped later, its last step lies below conv_eps + K2_UV_ATOL; and
    (d) at most apart_max rows of the launch do so. Returns (problem or
    None, uv err, mean_diff err, [(row, plain stop, kernel stop, parting
    step)] of the rows that stopped an update apart)."""
    import torch

    uv_k, c_k, md_k = out_k
    uv_p, c_p, md_p = out_p
    n = args[0].shape[0]
    if not bool((c_k == c_p).all()):
        return (f"K2 converged verdicts differ at N={n}: "
                f"{int((c_k != c_p).sum())} rows", 0.0, 0.0, [])
    both = c_k & c_p
    uv_err = float((uv_k - uv_p)[both].abs().max()) if both.any() else 0.0
    md_err = float((md_k - md_p)[both].abs().max()) if both.any() else 0.0

    def near(uv_a, md_a, uv_b, md_b):
        return (((uv_a - uv_b).abs().amax(-1) <= K2_UV_ATOL)
                & ((md_a - md_b).abs() <= K2_MD_ATOL))

    far = torch.nonzero(both & ~near(uv_k, md_k, uv_p, md_p))[:, 0].tolist()
    if not far:
        return None, uv_err, md_err, []
    if len(far) > apart_max:
        return (f"K2 N={n}: {len(far)} converged rows differ by more than uv "
                f"{K2_UV_ATOL} / mean_diff {K2_MD_ATOL} (at most {apart_max} "
                f"may stop an update apart): rows {far[:8]}", uv_err, md_err, [])
    uv_t, md_t, stop = k2_iterates(args, kw)
    eps, n_iter = kw["conv_eps"], kw["n_iter"]
    steps = torch.linalg.norm(uv_t[1:] - uv_t[:-1], dim=-1)  # update s at s-1
    apart = []
    for r in far:
        s_p = int(stop[r])
        if s_p == 0 or not bool(near(uv_p[r], md_p[r], uv_t[s_p, r],
                                     md_t[s_p, r])):
            return (f"K2 N={n} row {r}: the plain twin's result is not its own "
                    f"iterate at its stop update {s_p}", uv_err, md_err, [])
        s_k = [s for s in (s_p - 1, s_p + 1) if 1 <= s <= n_iter
               and bool(near(uv_k[r], md_k[r], uv_t[s, r], md_t[s, r]))]
        if not s_k:
            return (f"K2 N={n} row {r}: uv {uv_k[r].tolist()} against "
                    f"{uv_p[r].tolist()} is neither plain iterate "
                    f"{s_p - 1} nor {s_p + 1} (the plain twin stopped after "
                    f"update {s_p})", uv_err, md_err, [])
        s_k = s_k[0]
        part = float(steps[min(s_p, s_k) - 1, r])
        last = float(steps[s_k - 1, r])
        if abs(part - eps) > K2_UV_ATOL or last >= eps + K2_UV_ATOL:
            return (f"K2 N={n} row {r}: stopped after update {s_k} on the "
                    f"card and {s_p} in the plain twin, but the parting step "
                    f"{part:.6f} is not within {K2_UV_ATOL} of conv_eps {eps} "
                    f"(the card's last step {last:.6f})", uv_err, md_err, [])
        apart.append((r, s_p, s_k, part))
    return None, uv_err, md_err, apart


def phase_k2(captured):
    """Every captured launch re-run by the kernel and by the plain twin on
    the card, held to each other by k2_compare. Returns {N: (launches,
    launches with valid rows, uv err, mean_diff err, rows that stopped an
    update apart)}."""
    import torch

    from plsvo_torch.ops import mixed_align as ma

    if not captured:
        fail("K2 captured no launch of the slice")
    out = {}
    for args, kw, _ in captured:
        n = args[0].shape[0]
        out_k = ma.mixed_align_cuda(*args, **kw)
        out_p = ma.mixed_align_plain(*args, **kw)
        torch.cuda.synchronize()
        problem, uv_err, md_err, apart = k2_compare(args, kw, out_k, out_p)
        if problem:
            fail(problem)
        for r, s_p, s_k, part in apart:
            print(f"K2 N={n}: row {r} stopped after update {s_k} on the card "
                  f"and {s_p} in the plain twin (parting step {part:.6f} px, "
                  f"conv_eps {kw['conv_eps']})", flush=True)
        k, kv, ue, me, na = out.get(n, (0, 0, 0.0, 0.0, 0))
        out[n] = (k + 1, kv + int(bool(args[12].any())), max(ue, uv_err),
                  max(me, md_err), na + len(apart))
    for n, (k, kv, ue, me, na) in sorted(out.items()):
        print(f"K2 N={n}: verdicts equal in all {k} launches ({kv} with valid "
              f"rows), uv max abs err {ue:.3e}, mean_diff max abs err "
              f"{me:.3e}; {na} rows stopped an update apart", flush=True)
    return out


def _stage_hooks():
    """(owner, attribute, label) of the stages of a tracked frame and of a
    keyframe, as the frame handler reaches them (outermost calls only)."""
    from plsvo_torch.ops import (depth_filter, lines, pose_opt, sparse_align,
                                 struct_opt)
    from plsvo_torch.pipeline import frame_handler, fused, reprojector

    return [
        (frame_handler, "build_pyramid", "pyramid"),
        (frame_handler.FrameHandlerMono, "_step_inputs", "upload"),
        (sparse_align, "sparse_img_align", "sparse_img_align"),
        (reprojector, "reproject_points", "reproject_points"),
        (reprojector, "reproject_combined", "reproject_combined"),
        (pose_opt, "optimize_pose", "optimize_pose"),
        (struct_opt, "optimize_points", "optimize_points"),
        (depth_filter, "update_seeds_combined", "update_seeds"),
        (fused, "fetch", "fetch"),
        (frame_handler, "_kf_detect_program", "kf_detect"),
        (frame_handler.FrameHandlerMono, "_dispatch_local_ba", "local_ba"),
        (lines, "detect_segments_tiled", "detect_segments_tiled"),
        (depth_filter, "scatter_new_point_seeds_blob", "kf_seed_install"),
        (depth_filter, "scatter_new_line_seeds_blob", "kf_line_seed_install"),
    ]


def _instrument(hooks, totals):
    """Wrap each stage: synchronise before and after, add its host wall
    time to totals[label], and label it for the profiler. Returns the
    undo function."""
    import torch

    saved = []
    for owner, attr, label in hooks:
        orig = owner.__dict__[attr]

        def wrapped(*a, _orig=orig, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function("stage:" + _label):
                out = _orig(*a, **k)
            torch.cuda.synchronize()
            totals[_label] = totals.get(_label, 0.0) + time.perf_counter() - t0
            return out
        saved.append((owner, attr, orig))
        setattr(owner, attr, wrapped)

    def undo():
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)
    return undo


def phase_profile(vo, imgs, first, n_win, base_ms):
    """Two windows of n_win frames each, tracked by the same handler after
    the main run. Window 1: per-stage host wall time (each stage between
    two synchronisations). Window 2: torch.profiler: device busy share,
    kernel launches and host syncs per frame and per stage, and the device
    kernels that take the most time. base_ms: the main run's median ms per
    tracked frame, without the profiler, against which the device busy time
    is set."""
    import torch
    from torch.autograd import DeviceType

    hooks = _stage_hooks()
    stage_s = {}
    undo = _instrument(hooks, stage_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(first, first + n_win):
        vo.add_image(imgs[i], i / 30.0)
    torch.cuda.synchronize()
    wall1 = (time.perf_counter() - t0) * 1e3 / n_win
    print(f"profile: window 1 ({n_win} frames, stages synchronised): "
          f"{wall1:.2f} ms/frame; per-stage ms/frame: " + ", ".join(
              f"{k} {1e3 * v / n_win:.2f}" for k, v in sorted(
                  stage_s.items(), key=lambda kv: -kv[1])), flush=True)

    first += n_win
    wall_ms, busy_ms, launches, syncs, prof = profile_window(
        lambda: [vo.add_image(imgs[i], i / 30.0)
                 for i in range(first, first + n_win)])
    undo()
    dev_ev = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.name.startswith("stage:")]
    n = n_win
    print(f"profile: window 2 ({n} frames, under torch.profiler): wall "
          f"{wall_ms / n:.2f} ms/frame, device busy "
          + (f"{busy_ms / n:.3f} ms/frame ({100 * busy_ms / n / base_ms:.2f}% "
             f"of the unprofiled {base_ms:.2f} ms/frame: idle "
             f"{100 - 100 * busy_ms / n / base_ms:.2f}%)"
             if busy_ms > 0 else "not measured (the profiler saw no device time)")
          + f"; per frame: {launches / n:.0f} kernel launches, "
          f"{syncs / n:.1f} host syncs (tensor-to-host scalar reads)",
          flush=True)

    per_stage = {}

    def walk(e, label):
        if e.name.startswith("stage:"):
            label = e.name[6:]
        if e.name in LAUNCH_NAMES:
            per_stage[label] = per_stage.get(label, 0) + 1
        for c in e.cpu_children:
            walk(c, label)
    for e in prof.events():
        if e.cpu_parent is None:
            walk(e, "other")
    print("profile: kernel launches per frame by stage: " + ", ".join(
        f"{k} {v / n:.0f}" for k, v in sorted(per_stage.items(),
                                               key=lambda kv: -kv[1])),
          flush=True)
    if busy_ms > 0:
        by_name = {}
        for e in dev_ev:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print("profile: top device kernels (ms/frame): " + ", ".join(
            f"{k[:60]} {v / 1e3 / n:.3f}" for k, v in top), flush=True)


def main():
    # the smoke drives one card: on a host with several, it sees the first
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if torch.cuda.device_count() != 1:
        fail(f"{torch.cuda.device_count()} cards visible; the smoke drives one")
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"{name}, power limit not readable"
    print(f"device: {name} (count {torch.cuda.device_count()}); "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from plsvo_torch import _build
    from plsvo_torch.ops import fast_score as fs
    from plsvo_torch.ops import mixed_align as ma

    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    n_main, n_pts, n_lo, n_win = 40, 24, LINEONLY_FRAMES, 5
    cam, imgs, gt = bench_sequence(max(n_main + 2 * n_win, n_main + PIPE_DEPTH),
                                   device, step=RUN_STEP)
    _, imgs_p, gt_p = bench_sequence(n_pts, device)
    _, imgs_l, gt_l = bench_sequence(n_lo, device, step=LINEONLY_STEP,
                                     **LINEONLY_TEX)
    torch.cuda.synchronize()
    print(f"rendered {imgs.shape[0]} + {imgs_p.shape[0]} + {imgs_l.shape[0]} "
          f"frames {tuple(imgs.shape[1:])} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    pyr0, k1_abs, k1_rel = phase_k1(imgs[0], device)
    phase_lines(imgs[0], device)
    sl = phase_run("lines", cam, imgs, gt, device, n_main)
    sp = phase_run("points", cam, imgs_p, gt_p, device, n_pts)
    so = phase_run("lineonly", cam, imgs_l, gt_l, device, n_lo)
    spp = phase_pipelined(cam, imgs, gt, device, n_main, sl)
    k2 = phase_k2(sl["captured"] + sp["captured"] + so["captured"]
                  + spp["captured"])
    sb = phase_ba(sl, device)
    phase_profile(sl["vo"], imgs, n_main, n_win, sl["ms_median"])

    # ---- timings at the main path's shapes ----
    from plsvo_torch.ops import detection, feature_align, lines

    px = sum(p.numel() for p in pyr0)
    levels = [list(p.shape) for p in pyr0]
    k1_call = lambda: fs.fast_score_levels_cuda(pyr0, 10.0)  # noqa: E731
    k1_ms = cuda_time_ms(k1_call)
    k1_dev = kernel_device_ms(k1_call, "fast_score_kernel")
    k1_plain = cuda_time_ms(lambda: [fs.fast_score_plain(p, 10.0) for p in pyr0],
                            reps=10, inner=5)
    k1_bound = 1e3 * max(px * K1_BYTES_PER_PX / HBM_BYTES_PER_S,
                         px * K1_OPS_PER_PX / F32_OPS_PER_S)
    k1_by = ("bytes" if px * K1_BYTES_PER_PX / HBM_BYTES_PER_S
             >= px * K1_OPS_PER_PX / F32_OPS_PER_S else "operations")
    # the reprojection's launch (N = max_fts + 2 * max_segs = 384: points
    # and both endpoints of the selected lines) with the most valid rows
    caps = run_config("lines").caps
    n_k2 = caps.max_fts + 2 * caps.max_segs
    reproj = [c for c in sl["captured"]
              if c[2] == "reproject" and c[0][0].shape[0] == n_k2]
    if not reproj:
        fail(f"K2 captured no reprojection launch at N={n_k2}")
    args, kw, _ = max(reproj, key=lambda c: int(c[0][12].sum()))
    k2_ms = cuda_time_ms(lambda: ma.mixed_align_cuda(*args, **kw))
    k2_dev = kernel_device_ms(lambda: ma.mixed_align_cuda(*args, **kw),
                              "mixed_align_kernel")
    k2_plain = cuda_time_ms(lambda: ma.mixed_align_plain(*args, **kw), reps=10,
                            inner=5)
    row_iters = k2_active_row_iters(args, kw)
    k2_bound, k2_by = k2_bound_ms(args, row_iters)
    print(f"timing: K1 three-level launch {levels} ({px} px) kernel "
          f"{k1_ms:.4f} ms per call (device {k1_dev:.4f} ms), plain "
          f"{k1_plain:.4f} ms, bound {k1_bound:.5f} ms ({k1_by}; the kernel "
          f"runs at {100 * k1_bound / k1_dev:.1f}% of its bound); K2 reprojection "
          f"N={n_k2} ({int(args[12].sum())} valid rows) kernel {k2_ms:.4f} ms "
          f"per call (device {k2_dev:.4f} ms), plain {k2_plain:.4f} ms, bound "
          f"{k2_bound:.6f} ms ({k2_by}, {row_iters} active row-iterations; the "
          f"kernel runs at {100 * k2_bound / k2_dev:.1f}% of its bound)",
          flush=True)
    for lvl in pyr0:
        f1 = lambda: fs.fast_score_cuda(lvl, 10.0)  # noqa: E731
        print(f"timing: K1 {lvl.shape[0]}x{lvl.shape[1]} alone: kernel "
              f"{cuda_time_ms(f1):.4f} ms per call (device "
              f"{kernel_device_ms(f1, 'fast_score_kernel'):.4f} ms)", flush=True)
    # K2's device time depends on the data (the warp leaves once its rows
    # are inactive): every launch of the runs, replayed, by call site and N
    k2_run = {}
    for run, res in (("lines", sl), ("points", sp), ("lineonly", so)):
        groups = {}
        for c in res["captured"]:
            groups.setdefault((c[2], c[0][0].shape[0]), []).append(c)
        for (where, n), runs in sorted(groups.items()):
            # the launch of the group with the most valid rows
            hard = max(range(len(runs)), key=lambda i: int(runs[i][0][12].sum()))
            a, k, _ = runs[hard]
            f2 = lambda: ma.mixed_align_cuda(*a, **k)  # noqa: E731
            dev = calls_device_ms([lambda a=a, k=k: ma.mixed_align_cuda(*a, **k)
                                   for a, k, _ in runs], "mixed_align_kernel")
            k2_run[(run, where, n)] = (float(np.median(dev)), max(dev))
            b_ms, b_by = k2_bound_ms(a, k2_active_row_iters(a, k))
            print(f"timing: K2 {run} run, {where} N={n}: {len(runs)} launches "
                  f"(capture pass); the one with the most valid rows "
                  f"({int(a[12].sum())}): device {dev[hard]:.4f} ms, kernel "
                  f"{cuda_time_ms(f2):.4f} ms per call, bound {b_ms:.6f} ms "
                  f"({b_by}; {100 * b_ms / dev[hard]:.1f}% of its device "
                  f"time); device over the launches: median "
                  f"{k2_run[(run, where, n)][0]:.4f} ms, max "
                  f"{k2_run[(run, where, n)][1]:.4f} ms", flush=True)
    det_ms = cuda_time_ms(lambda: detection.detect_fast_grid(
        pyr0, cell_size=25, score_threshold=20.0), reps=10, inner=5)
    seg_ms = cuda_time_ms(lambda: lines.detect_segments_tiled(
        pyr0[0], n_peaks=64, run_gap_px=3.0, dist_tol=1.2), reps=5, inner=2)
    msg = (f"timing: detect_fast_grid (3 levels) {det_ms:.4f} ms per call; "
           f"detect_segments_tiled (480x752) {seg_ms:.4f} ms per call")
    # the reprojection's refinement, per call: the mixed loop around K2
    # (lines run) and the plain align2d_atlas loop (line-only run)
    for fn, res in (("align_mixed_atlas", sl), ("align2d_atlas", so)):
        if fn in res["atlas_calls"]:
            a, k = res["atlas_calls"][fn]
            f = getattr(feature_align, fn)
            al_ms = cuda_time_ms(lambda: f(*a, **k), reps=10, inner=5)
            msg += f"; {fn} (N={a[3].shape[0]}) {al_ms:.4f} ms per call"
        else:
            fail(f"{fn}: no reprojection call captured")
    print(msg, flush=True)

    nf = sl["n_frames"]
    k2_uv = max(e[2] for e in k2.values())
    k2_md = max(e[3] for e in k2.values())
    # Each error is named with its kind: "max_abs_err" is absolute (K1: the
    # score; K2: uv in pixels), "max_err" is the error each kernel is gated
    # on (K1: the score relative to max(|score|, 1); K2: mean_diff,
    # absolute). "ms" is the per-call time, wrapper and launch included;
    # "kernel_ms" the kernel's own device time (K2: on the reprojection
    # launch of N=384 with the most valid rows; "kernel_ms_run_median" and
    # "_max" over all the lines run's reprojection launches of that N).
    # K2's errors are over every converged row, those that stopped an
    # update apart on the two sides included (phase 7 counts them).
    # "launches" counts the main path's run (default_config(): points +
    # lines + local BA); "launches_points_only", "launches_line_only" and
    # "launches_pipelined" the other three runs.
    report = {"kernels": [
        {"name": "fast_score", "route": "cuda",
         "source": "plsvo_torch/csrc/fast_score.cu",
         "replaces": "plsvo_tpu/ops/pallas_fast.py:117",
         "launches": sl["launches"]["fast_score"],
         "launches_per_frame": sl["launches"]["fast_score"] / nf,
         "launches_points_only": sp["launches"]["fast_score"],
         "launches_line_only": so["launches"]["fast_score"],
         "launches_pipelined": spp["launches"]["fast_score"],
         "max_abs_err": k1_abs, "max_abs_err_kind": "abs_score",
         "max_err": k1_rel, "max_err_kind": "rel_score",
         "ms": k1_ms, "kernel_ms": k1_dev, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "shape": levels},
        {"name": "mixed_align", "route": "cuda",
         "source": "plsvo_torch/csrc/mixed_align.cu",
         "replaces": "plsvo_tpu/ops/pallas_align.py:163",
         "launches": sl["launches"]["mixed_align"],
         "launches_per_frame": sl["launches"]["mixed_align"] / nf,
         "launches_points_only": sp["launches"]["mixed_align"],
         "launches_line_only": so["launches"]["mixed_align"],
         "launches_pipelined": spp["launches"]["mixed_align"],
         "max_abs_err": k2_uv, "max_abs_err_kind": "abs_uv_px",
         "max_err": k2_md, "max_err_kind": "abs_mean_diff",
         "ms": k2_ms, "kernel_ms": k2_dev, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "rows_stopped_an_update_apart": sum(e[4] for e in k2.values()),
         "kernel_ms_run_median": k2_run[("lines", "reproject", n_k2)][0],
         "kernel_ms_run_max": k2_run[("lines", "reproject", n_k2)][1],
         "shape": [n_k2]},
    ]}
    print(f"summary: lines run ATE {sl['ate']:.6f} m, per-frame ms median "
          f"{sl['ms_median']:.2f} p90 {sl['ms_p90']:.2f} (keyframe frames p90 "
          f"{sl['kf_ms_p90']}), {sl['n_lines_made']} line landmarks, median "
          f"segment matches {sl['seg_median']:.1f}; local BA {sb['n']} "
          f"windows, {sb['ms']:.2f} ms and {sb['launches']} launches per solve "
          f"(K={sb['K']}, L={sb['L']}); points run ATE {sp['ate']:.6f} m, "
          f"per-frame ms median {sp['ms_median']:.2f} p90 {sp['ms_p90']:.2f}; "
          f"line-only run ATE {so['ate']:.6f} m, per-frame ms median "
          f"{so['ms_median']:.2f} p90 {so['ms_p90']:.2f}, {so['n_lines_made']} "
          f"line landmarks; pipelined run (depth {PIPE_DEPTH}) ATE "
          f"{spp['ate']:.6f} m, bench.py's per-frame mean {spp['bench_mean']:.2f} "
          f"p90 {spp['bench_p90']:.2f} ms against the sync lines run's "
          f"{sl['bench_mean']:.2f} / {sl['bench_p90']:.2f} ms", flush=True)
    print(json.dumps(report), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
