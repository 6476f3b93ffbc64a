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
               site), 1 in K3_EVERY K3 launches' and every local BA
               problem, then timed, with the launch counts set to 0 just
               before the timed run and read just after it. Gates: DEFAULT
               reached and kept, ATE < 1% of the path, one K3 launch per
               tracked frame, at least one local BA solve where BA is on; with
               points one K1 launch per keyframe detection, in line-only
               mode no K1 launch, align2d_atlas in every tracked frame and
               K2 only in the seed update; with lines line seeds installed
               at keyframes and at least one line landmark made from a
               converged seed; in the lines run a median segment match
               count > 0 after the first line landmark
  5b. cli    — the user's entry point, plsvo_torch.run_pipeline, on image
               folders written by the port (phase_cli): (a) a 40-frame
               752x480 pinhole dataset (PNGs, groundtruth.txt,
               dataset_params.yaml) through main(["--config", "default",
               "--local-ba", "--trajout", "--metrics", "--frames-out"]) in
               this process, with the launch counts set to 0 before and
               read after: 40 TUM rows, DEFAULT reached and kept, ATE < 1%
               of the path against groundtruth.txt read back, K1 and K2
               each launched, no relocalization; (b) a 24-frame ATAN
               dataset (w = 0.93) undistorted on ingest: maps built,
               DEFAULT reached, ATE < CLI_ATAN_ATE; (c) a handler saved
               after 14 frames and loaded on the card continues to frame 20
               no further from the uninterrupted one than two
               uninterrupted runs part (+ CLI_RESUME_SLACK); (d) `python3 -m
               plsvo_torch.run_pipeline --dataset (a) --n-frames 14` as a
               subprocess: rc 0 and the ATE line; (e) LBD of bench frames 0
               and 1, card vs CPU: float descriptors within LBD_FLOAT_ATOL,
               bits equal away from ties, match_binary equal. The images,
               PNGs and checkpoint go to a temporary directory under
               chiprun_out/, removed at the end; the CLI's own output goes
               to chiprun_out/cli_run.log
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
  6b. batched — this slice's path: BatchedVO(mode="vmap") over BATCH = 8
               sequences, default_config() with pipelined=True,
               pipeline_depth=12 (bench.py's batched configuration), the
               lines run's 752x480 frames as uint8, staggered as bench.py
               staggers them (sequence k runs k frames behind): 40 frames
               with the launch counts set to 0 before and read after, 12
               more under torch.profiler, flush(). Every K2 launch and every
               batched K1 input captured. Gates: every frame of every
               sequence delivered once; DEFAULT reached and kept; ATE < 1%
               of each path; each sequence's synced carry equal to a fresh
               upload of its map and validate_map clean; one K1 launch per
               10 requests (30 images) of each batched detection; one
               reprojection launch of B x 384 rows per batched step;
               sequences 0 and 7 tracked again by solo pipelined handlers
               within SOLO_TOL_M of the batch per frame. Report: aggregate
               fps as bench.py computes it, launches, host syncs and device
               idle per batched step
  6c. streams — BatchedVO(mode="streams"), 2 pipelined handlers, 20
               frames: every frame delivered once
  6e. mesh    — the multi-device layer on the one card (phase_mesh): (a)
               plsvo_torch.parallel.dryrun.dryrun_multichip at 2 shards of
               the card, its MULTICHIP_EFFICIENCY / MULTICHIP_BA_COMM_SPLIT
               lines printed; (b) BatchedVO(mesh=2 shards of the card) in
               6b's configuration on 6b's frames, MESH_FRAMES calls with the
               launch counts set to 0 before and read after, MESH_PROFILED
               more under torch.profiler, flush(), every K2 launch captured
               for phase 7: every frame once, DEFAULT kept, ATE < 1%, each
               synced carry equal to its mirror, each sequence within
               SOLO_TOL_M per frame of 6b's unsharded run, one reprojection
               launch of B/2 x 384 rows per shard per batched step; (c) a
               [card, CPU] mesh, B = 2 at 320x240, 16 frames (pipelined,
               depth 4): a tensor on the wrong device fails it, stages and
               centres as the card alone (within SOLO_TOL_M); (d) single,
               8-shard and (2, 4) hierarchical BA at tests/test_ba_scale.py's
               full size (K=96, L=50176) at its quality bars; (e) two
               processes over gloo, each with two shards of the card,
               against one process (kf_t 5e-4, local rows 5e-3, n_obs
               equal), and NCCL brought up at world size 1 with one
               all_reduce (the workers are this script with
               --mesh-ba-worker / --mesh-nccl-worker)
  6f. api     — the JAX package's functions off the tracking path
               (phase_api), on copies of the lines run's handler at its
               last frame (a checkpoint loaded on the card and on the CPU)
               and the next frame: reproject_segments (retry on) with the
               map's tables, card vs CPU (it refines through align2d_atlas,
               as the JAX function: no K2 launch); find_match_direct,
               epipolar_search_zmssd, epipolar_search_zmssd_atlas and
               align1d_atlas on the map's point anchors, card vs CPU at the
               tests' bars; the staged seed path (_update_seeds, then
               _harvest_seeds) through update_point_seeds_bucketed and
               update_line_seeds_bucketed at the handler's bucket of its
               live seeds and, on a second copy, the next power of two,
               with API_CONVERGE point seeds made to converge: the two
               buckets' tables equal, every candidate landmark finite and
               on its seed's bearing; one tracked frame under
               utils.profiling.device_trace, its Chrome trace holding a
               mixed_align_kernel event. Its K2 launches (call site
               "seeds_bucketed") go to phase 7
  6d. soaks   — tests/test_soak.py with the port alone, pipelined: 310
               frames at 320x240, fast_config() (8 keyframe slots), the
               orbit; at depth 12 without the blackout, and at depth 4 with
               the blackout at frames 150-152 (at depth 12 neither package
               survives it: phase_soak says why); test_soak's asserts on
               the delivered results, its tail ATE < 0.004 m included (at
               depth 12 from the JAX package's bootstrap RANSAC draws,
               reference_ransac_draws: phase_soak says why), validate_map
               clean, the synced carry equal to the mirror, at least one
               keyframe eviction
  7. K2      — the mixed-align GN kernel vs its plain twin on the inputs of
               every launch of the capture runs (5, 6, 6b, 6e and 6f):
               verdicts equal, uv
               within 2e-3 px and mean_diff within 2e-2; at most
               K2_APART_MAX rows of a launch may instead stop one update
               apart, where the step at which the two sides part lies at
               the convergence threshold and each side's result is the
               plain twin's iterate at its own stop (k2_compare); a
               launch that fails leaves its inputs in chiprun_out/
               (k2_replay replays such a file on the CPU)
  7a. K3      — the sparse image alignment kernel vs its plain twin on the
               inputs of the K3 launches captured in 5, 6, 6b and 6e (1 in
               K3_EVERY each): poses within K3_ROT_ATOL rad / K3_T_ATOL,
               seg_alive and the tracked counts equal, each level's
               iterations equal but where the two sides part at a
               chi2-increase test within float32 rounding (k3_compare);
               prints the largest differences and every call whose
               iterations differ
  7b. K1 batched — the largest batched keyframe detection's R x 3 images:
               masks equal, scores within rtol 1e-4 / atol 1e-3 more than
               8 px from the border; per-call, device and plain times
  7c. K4      — the pose optimisation kernel vs its plain twin on the
               inputs of the K4 launches captured in 5, 6, 6b and 6e (1 in
               K4_EVERY each): MAD scales and observation counts equal
               within rounding, each pass's iterations and the first
               pass's strip equal but where the two sides part at a
               decision within rounding (a chi2 tie, a row at the
               threshold); every pose within K4_POSE_ATOL at the plain
               twin's robust cost (K4_COST_RTOL) and its inlier masks the
               strip at its own pose; where the two sides did not part,
               chi2 and the information matrices within rounding
               (k4_compare); one K4 launch per tracked frame of the sync
               runs
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
               with the most valid rows (device, per-call, bound); at
               every call site and N of the three sync runs, the batched
               and mesh runs and phase 6f: the launch count, the launch
               with the most valid rows (device, per-call, plain, bound)
               and the median and max device time over the launches; K3
               and K4 each at the lines run's and the batched run's last
               captured call (per-call, device, plain, bound);
               detect_fast_grid's, detect_segments_tiled's,
               align_mixed_atlas's and align2d_atlas's per-call times
  11. report — one JSON line per the kernel report format, the card line,
               and as the last line {"ok": true, "device": {...}}

The cli phase (5b), the soaks (6d) and the streams run (6c) run right
after phase 5, before any torch.profiler session: a profiler session slows the host work after
it by ~30% on the H100 machine, so every timing after phase 6's profiled
window (6b's included) carries that slowdown.

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

# the reference's bootstrap RANSAC draws (threefry in numpy), importable
# from here as before
from plsvo_torch.utils.threefry import reference_ransac_draws  # noqa: F401

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


def _device_records(calls, kernel_name, pad=256):
    """Durations (us) of the kernel named kernel_name, as torch.profiler
    records it on the card, for each call of `calls` in order. The last
    call is run `pad` more times at the end, because the profiler loses
    the last device records of a session (late in the smoke 48-51 of
    them, every session); returns the records of `calls` only, or fewer
    when more were lost."""
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


def kernel_device_ms(fn, kernel_name, n=50, sessions=5):
    """Median device duration of the kernel named kernel_name over n calls
    of fn, as torch.profiler records it on the card. The profiler can lose
    device records of a session: the records of up to `sessions` sessions,
    every one of them a launch of the same call, are pooled until they hold
    n // 2; a failure when all the sessions together hold fewer."""
    import torch

    fn()
    torch.cuda.synchronize()
    pooled, kept = [], []
    for _ in range(sessions):
        d = _device_records([fn] * n, kernel_name)
        pooled += d
        kept.append(len(d))
        if len(pooled) >= n // 2:
            if kept != [n]:
                print(f"timing: the profiler kept {kept} of {n} records of "
                      f"{kernel_name} per session; the median is over the "
                      f"{len(pooled)} kept", flush=True)
            return float(np.median(pooled)) / 1e3
    fail(f"the profiler saw {kept} of {n} launches of {kernel_name} "
         f"in {sessions} sessions")


def calls_device_ms(calls, kernel_name, reps=10):
    """Device time of each call of `calls` (the median of `reps` runs, one
    call after the other), as torch.profiler records it, from one
    session; when the profiler loses records in three such sessions, each
    call in sessions of its own (kernel_device_ms, which fails when those
    lose too many)."""
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
    print(f"timing: the profiler kept {len(d)} of {len(runs)} records of "
          f"{kernel_name} in the last of 3 sessions; each call is timed in "
          "sessions of its own", flush=True)
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


def capture_pass(cam, imgs, device, n_main, cfg, run):
    """The run's frames through a handler of its own, untimed, capturing
    the inputs of every K2 launch (tagged by call site), of 1 in K3_EVERY
    K3 launches and 1 in K4_EVERY K4 launches (tagged by `run`), of the
    first reprojection call of
    align_mixed_atlas and of align2d_atlas, of every local BA solve, and
    the counts of every guarded BA write-back."""
    import torch

    from plsvo_torch.ops import depth_filter, matcher
    from plsvo_torch.ops import mixed_align as ma
    from plsvo_torch.ops import pose_opt as po
    from plsvo_torch.ops import sparse_align as sa
    from plsvo_torch.parallel import ba
    from plsvo_torch.pipeline.frame_handler import FrameHandlerMono

    out = dict(k2=[], atlas={}, ba=[], write_backs=[], k3=[], k4=[])
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
               (ma, "capture", k2_capture),
               (sa, "capture", k3_capture_hook(out["k3"], run)),
               (po, "capture", k4_capture_hook(out["k4"], run))]
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
    from plsvo_torch.ops import pose_opt as po
    from plsvo_torch.ops import sparse_align as sa
    from plsvo_torch.pipeline.frame_handler import (STAGE_DEFAULT,
                                                    FrameHandlerMono)
    from plsvo_torch.pipeline.state import MapState
    from plsvo_torch.utils import trajectory

    cfg = run_config(kind)
    cap = capture_pass(cam, imgs, device, n_main, cfg, kind)

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
    sa.launches = 0
    po.launches = 0
    k3_frames = 0  # frames that entered the tracked-frame step
    try:
        for i in range(n_main):
            k1_before = fs.launches
            k3_frames += vo.stage == STAGE_DEFAULT
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
        launches = {"fast_score": fs.launches, "mixed_align": ma.launches,
                    "sparse_align": sa.launches, "pose_opt": po.launches}
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
    if launches["sparse_align"] != k3_frames or not k3_frames:
        fail(f"{kind}: {launches['sparse_align']} K3 launches over "
             f"{k3_frames} tracked frames, not one each")
    if launches["pose_opt"] != k3_frames:
        fail(f"{kind}: {launches['pose_opt']} K4 launches over "
             f"{k3_frames} tracked frames, not one each")
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
                captured=cap["k2"], captured_k3=cap["k3"],
                captured_k4=cap["k4"],
                atlas_calls=cap["atlas"], ba=cap["ba"],
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
    from plsvo_torch.ops import pose_opt as po
    from plsvo_torch.ops import sparse_align as sa
    from plsvo_torch.pipeline import fused
    from plsvo_torch.pipeline.frame_handler import (STAGE_DEFAULT,
                                                    FrameHandlerMono)
    from plsvo_torch.utils import trajectory

    kind = "pipelined"
    cfg = run_config(kind)
    cap = capture_pass(cam, imgs, device, n_main, cfg, kind)
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
    sa.launches = 0
    po.launches = 0
    for i in range(n_main):
        track(i)
    launches = {"fast_score": fs.launches, "mixed_align": ma.launches,
                "sparse_align": sa.launches, "pose_opt": po.launches}
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
    return dict(launches=launches, captured=cap["k2"], captured_k3=cap["k3"],
                captured_k4=cap["k4"],
                ate=ate, path=path, bench_mean=bench_mean, bench_p90=bench_p90,
                n_deferred=len(deferred_k1), n_write_backs=len(write_backs),
                kind=kind)


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


CLI_FRAMES = 40
CLI_ATAN_FRAMES = 24
CLI_ATAN_STEP = 0.025  # m per frame, tests/test_pipeline.py's ATAN flow
CLI_ATAN_ATE = 0.02  # m, that test's bound
CLI_RESUME_AT, CLI_RESUME_TO = 14, 20
CLI_RESUME_SLACK = 1e-5
LBD_FLOAT_ATOL = 1e-4
LBD_BIT_TIE = 1e-5


def phase_cli(device, bench_imgs):
    """The user's entry point, plsvo_torch.run_pipeline, on 752x480 image
    folders written by the port: (a) a pinhole dataset through main() in
    this process, with the launch counts set to 0 before and read after;
    (b) an ATAN dataset (undistort on ingest); (c) checkpoint and resume on
    the card; (d) the user's command in a subprocess; (e) LBD on the card
    against the CPU on two frames of the bench sequence."""
    import contextlib
    import json as _json
    import shutil
    import tempfile

    import torch

    from plsvo_torch import run_pipeline
    from plsvo_torch.camera import ATANCamera
    from plsvo_torch.config import Config
    from plsvo_torch.native import loader
    from plsvo_torch.ops import fast_score as fs
    from plsvo_torch.ops import line_descriptor as lbd
    from plsvo_torch.ops import lines
    from plsvo_torch.ops import mixed_align as ma
    from plsvo_torch.pipeline.frame_handler import (STAGE_DEFAULT,
                                                    FrameHandlerMono)
    from plsvo_torch.utils import checkpoint, dataset, imageio, synthetic
    from plsvo_torch.utils import trajectory

    t_phase = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="cli_", dir=OUT_DIR)
    log_path = os.path.join(OUT_DIR, "cli_run.log")
    width, height = 752, 480
    try:
        # ---- (a) the pinhole dataset through main() ----
        ds_dir = os.path.join(root, "pinhole")
        t0 = time.perf_counter()
        dataset.write_synthetic_dataset(ds_dir, n_frames=CLI_FRAMES,
                                        width=width, height=height,
                                        device=device)
        t_write = time.perf_counter() - t0
        traj_path = os.path.join(root, "traj.txt")
        metrics_path = os.path.join(root, "metrics.jsonl")
        argv = ["--dataset", ds_dir, "--n-frames", str(CLI_FRAMES), "--config",
                "default", "--local-ba", "--trajout", traj_path, "--metrics",
                metrics_path, "--frames-out", os.path.join(root, "frames")]
        fs.launches = 0
        ma.launches = 0
        with open(log_path, "w") as log, contextlib.redirect_stdout(log):
            vo, data, _ = run_pipeline.main(argv)
        launches = {"fast_score": fs.launches, "mixed_align": ma.launches}
        decoder = dataset.last_decoder
        native = loader.get_lib() is not None
        est = trajectory.read_tum(traj_path)
        if len(est) != CLI_FRAMES:
            fail(f"cli: {len(est)} TUM rows, expected {CLI_FRAMES}")
        stages = [r.stage for r in vo.results]
        if STAGE_DEFAULT not in stages:
            fail("cli: never reached STAGE_DEFAULT")
        fd = stages.index(STAGE_DEFAULT)
        if any(st != STAGE_DEFAULT for st in stages[fd:]):
            fail(f"cli: tracking left STAGE_DEFAULT after frame {fd}: {stages[fd:]}")
        if vo.n_relocalizations:
            fail(f"cli: {vo.n_relocalizations} relocalizations")
        gt = trajectory.read_tum(os.path.join(ds_dir, "groundtruth.txt"))
        est_pos = np.stack([p for _, p, _ in est])[fd:]
        gt_pos = np.stack([p for _, p, _ in gt])[fd:CLI_FRAMES]
        ate = trajectory.ate_rmse(est_pos, gt_pos)
        path = float(np.linalg.norm(np.diff(gt_pos, axis=0), axis=-1).sum())
        if not ate < 0.01 * path:
            fail(f"cli: ATE {ate} >= 1% of the path length {path}")
        if launches["fast_score"] < 1 or launches["mixed_align"] < 1:
            fail(f"cli: the run did not reach both kernels: {launches}")
        n_png = len(os.listdir(os.path.join(root, "frames")))
        rows = [_json.loads(line) for line in open(metrics_path)]
        ms = [r["proc_ms"] for r in rows[fd + 5:]]
        print(f"cli (a): wrote {CLI_FRAMES} frames {width}x{height} in "
              f"{t_write:.1f} s; main() {len(est)} TUM rows, DEFAULT from "
              f"frame {fd}, Sim3 ATE {ate:.6f} m over a {path:.3f} m path "
              f"({100 * ate / path:.3f}%), no relocalization; launches "
              f"{launches}; per-frame ms (DEFAULT frames after the first 5, "
              f"n={len(ms)}) median {np.median(ms):.2f} p90 "
              f"{np.percentile(ms, 90):.2f}; {n_png} annotated PNGs; images "
              f"decoded by {decoder} (native loader built: {native})",
              flush=True)

        # ---- (b) an ATAN dataset: undistort on ingest ----
        atan_dir = os.path.join(root, "atan")
        os.makedirs(os.path.join(atan_dir, "images"))
        f = 460.0  # write_synthetic_dataset's focal length at 752x480
        cam = ATANCamera.create(width, height, f / width, f / height, 0.5, 0.5,
                                w=0.93)
        scene = synthetic.make_scene(np.random.default_rng(0), size=2048,
                                     texel_size=0.003)
        entries = []
        for i in range(CLI_ATAN_FRAMES):
            R = np.eye(3, dtype=np.float32)
            t = np.asarray([CLI_ATAN_STEP * i, 0.0, -2.0], np.float32)
            img = synthetic.render_aa(scene, cam, R, t, device=device)
            imageio.write_png(os.path.join(atan_dir, "images", f"{i:06d}.png"),
                              img.cpu().numpy().astype(np.uint8))
            entries.append((i / 30.0, R.T.copy(), -R.T @ t))
        trajectory.write_tum(os.path.join(atan_dir, "groundtruth.txt"), entries)
        with open(os.path.join(atan_dir, "dataset_params.yaml"), "w") as fh:
            fh.write(f"cam0:\n  cam_model: ATAN\n  cam_width: {width}\n"
                     f"  cam_height: {height}\n  cam_fx: {f / width}\n"
                     f"  cam_fy: {f / height}\n  cam_cx: 0.5\n  cam_cy: 0.5\n"
                     "  cam_d0: 0.93\nimages_subfolder: images/\n")
        with open(log_path, "a") as log, contextlib.redirect_stdout(log):
            avo, adata, _ = run_pipeline.main(
                ["--dataset", atan_dir, "--n-frames", str(CLI_ATAN_FRAMES),
                 "--trajout", os.path.join(root, "atan_traj.txt")])
        if adata._maps is None or not isinstance(adata.camera, ATANCamera):
            fail("cli (b): the ATAN dataset built no undistortion maps")
        astages = [r.stage for r in avo.results]
        if STAGE_DEFAULT not in astages:
            fail(f"cli (b): never reached STAGE_DEFAULT: {astages}")
        afd = astages.index(STAGE_DEFAULT)
        aest = np.stack([-r.R_f_w.T @ r.t_f_w for r in avo.results[afd:]])
        agt = np.stack([-R.T @ t for _, R, t in entries])[afd:]
        aate = trajectory.ate_rmse(aest.astype(np.float64), agt.astype(np.float64))
        print(f"cli (b): ATAN (w=0.93) dataset of {CLI_ATAN_FRAMES} frames, "
              f"undistortion maps built, DEFAULT from frame {afd}, Sim3 ATE "
              f"{aate:.6f} m (bound {CLI_ATAN_ATE})", flush=True)
        if not aate < CLI_ATAN_ATE:
            fail(f"cli (b): ATAN ATE {aate} >= {CLI_ATAN_ATE}")

        # ---- (c) checkpoint and resume on the card ----
        cfg = Config()
        imgs = [im for _, im in dataset.ImageFolderDataset(
            os.path.join(ds_dir, "images"), data.camera, limit=CLI_RESUME_TO)]
        handlers = []
        for _ in range(2):
            h = FrameHandlerMono(data.ideal_camera(), cfg, device=device)
            for i, im in enumerate(imgs[:CLI_RESUME_AT]):
                h.add_image(im, i / 30.0)
            handlers.append(h)
        ckpt = os.path.join(root, "ckpt.npz")
        checkpoint.save_state(handlers[0], ckpt)
        resumed = checkpoint.load_state(ckpt, device="cuda")
        if resumed.device.type != "cuda" or resumed.stage != handlers[0].stage:
            fail(f"cli (c): loaded on {resumed.device} in stage {resumed.stage}")
        poses = {"a": [], "b": [], "resumed": []}
        for i in range(CLI_RESUME_AT, CLI_RESUME_TO):
            for key, h in (("a", handlers[0]), ("b", handlers[1]),
                           ("resumed", resumed)):
                r = h.add_image(imgs[i], i / 30.0)
                if r.stage != STAGE_DEFAULT:
                    fail(f"cli (c): handler {key} left DEFAULT at frame {i}")
                poses[key].append((r.R_f_w, r.t_f_w))

        def pose_diff(x, y):
            return tuple(max(float(np.abs(p[k] - q[k]).max())
                             for p, q in zip(poses[x], poses[y])) for k in (0, 1))

        d_res, d_two = pose_diff("resumed", "a"), pose_diff("b", "a")
        print(f"cli (c): saved after {CLI_RESUME_AT} frames, loaded on "
              f"{resumed.device}, continued to frame {CLI_RESUME_TO}: resumed "
              f"vs uninterrupted max |dR| {d_res[0]:.3e}, |dt| {d_res[1]:.3e}; "
              f"two uninterrupted runs {d_two[0]:.3e}, {d_two[1]:.3e}", flush=True)
        if not all(r <= u + CLI_RESUME_SLACK for r, u in zip(d_res, d_two)):
            fail(f"cli (c): the resumed handler parts from the uninterrupted "
                 f"one by {d_res}, more than two uninterrupted runs part "
                 f"({d_two}) + {CLI_RESUME_SLACK}")

        # ---- (d) the user's command ----
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
            __file__)))
        proc = subprocess.run(
            [sys.executable, "-m", "plsvo_torch.run_pipeline", "--dataset",
             ds_dir, "--n-frames", str(CLI_RESUME_AT)], cwd=root,
            env=env, capture_output=True, text=True, timeout=600)
        ate_line = [ln for ln in proc.stdout.splitlines() if "ATE RMSE" in ln]
        print(f"cli (d): python3 -m plsvo_torch.run_pipeline --dataset ... "
              f"--n-frames {CLI_RESUME_AT}: rc {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s; {ate_line}", flush=True)
        if proc.returncode != 0 or not ate_line:
            fail(f"cli (d): rc {proc.returncode}\n{proc.stdout[-2000:]}\n"
                 f"{proc.stderr[-2000:]}")

        # ---- (e) LBD on the card against the CPU ----
        descs = []
        for img in bench_imgs[:2]:
            det = lines.detect_segments_tiled(img, n_peaks=64, run_gap_px=3.0,
                                              dist_tol=1.2)
            tab, _ = lines.dedup_segments_grid(
                det, width=img.shape[1], height=img.shape[0], cell_size=25,
                max_segs=cfg.caps.max_segs, min_length=25.0)
            d_k = lbd.compute_lbd(img, tab.sp, tab.ep, tab.valid)
            d_p = lbd.compute_lbd(img.cpu(), tab.sp.cpu(), tab.ep.cpu(),
                                  tab.valid.cpu())
            torch.cuda.synchronize()
            fk, fp = d_k.float_desc.cpu(), d_p.float_desc
            err = float((fk - fp).abs().max())
            ia, ib = lbd.binarization_pairs(fp.shape[-1])
            tie = (fp[:, ia] - fp[:, ib]).abs() <= LBD_BIT_TIE
            flips = (d_k.binary.cpu() != d_p.binary) & ~tie
            if not torch.equal(d_k.valid.cpu(), d_p.valid):
                fail("cli (e): LBD valid masks differ card vs CPU")
            if err > LBD_FLOAT_ATOL or flips.any():
                fail(f"cli (e): LBD card vs CPU: float err {err} (atol "
                     f"{LBD_FLOAT_ATOL}), {int(flips.sum())} bits flipped "
                     "away from ties")
            descs.append((d_p, err, int(d_p.valid.sum())))
        (da, ea, na), (db, eb, nb) = descs
        m_p = lbd.match_binary(da, db)
        m_k = lbd.match_binary(*(lbd.LineDescriptors(*(x.to(device) for x in d))
                                 for d in (da, db)))
        torch.cuda.synchronize()
        if not all(torch.equal(x.cpu(), y) for x, y in zip(m_k, m_p)):
            fail("cli (e): match_binary of the CPU's descriptors differs on "
                 "the card")
        print(f"cli (e): LBD of bench frames 0 and 1 ({na} and {nb} valid "
              f"segments): float descriptors card vs CPU max abs err "
              f"{max(ea, eb):.3e}, bits equal away from ties, "
              f"{int(m_p.ok.sum())} matches equal on both devices", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, decoder=decoder, native=native, ate=ate,
                path=path, ms_median=float(np.median(ms)),
                ms_p90=float(np.percentile(ms, 90)), atan_ate=aate,
                resume=d_res, uninterrupted=d_two,
                seconds=time.perf_counter() - t_phase)


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


OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")


def save_k2_launch(args, kw, site, run, problem, out_dir=OUT_DIR):
    """Keep a launch's inputs (as numpy), its options, N, call site, run and
    the gate's verdict in out_dir, for k2_replay on any machine. Returns
    the file's path."""
    os.makedirs(out_dir, exist_ok=True)
    n = args[0].shape[0]
    path = os.path.join(out_dir, f"k2_fail_{run}_{site}_N{n}_"
                                 f"{time.strftime('%Y%m%d-%H%M%S')}.npz")
    np.savez(path, **{f"arg{i}": a.detach().cpu().numpy()
                      for i, a in enumerate(args)},
             meta=json.dumps(dict(kw=kw, N=n, site=site, run=run,
                                  problem=problem)))
    return path


def k2_replay(path):
    """A saved launch on the CPU: its inputs, the plain twin's result and
    the plain twin's iterates (k2_iterates), as a dict."""
    import torch

    from plsvo_torch.ops import mixed_align as ma

    with np.load(path) as f:
        meta = json.loads(str(f["meta"]))
        args = [torch.as_tensor(f[f"arg{i}"]) for i in range(13)]
    kw = meta["kw"]
    uv_t, md_t, stop = k2_iterates(args, kw)
    return dict(meta=meta, args=args, plain=ma.mixed_align_plain(*args, **kw),
                uv_iterates=uv_t, md_iterates=md_t, stop=stop)


def k2_gate(args, kw, out_k, out_p, site, run):
    """k2_compare, and on a failure the launch's inputs kept in chiprun_out/
    before the smoke fails."""
    problem, uv_err, md_err, apart = k2_compare(args, kw, out_k, out_p)
    if problem:
        path = save_k2_launch(args, kw, site, run, problem)
        fail(f"{problem} ({run} run, {site}; inputs kept in {path})")
    return uv_err, md_err, apart


def phase_k2(captured):
    """Every captured launch, as (args, kwargs, call site, run), re-run by
    the kernel and by the plain twin on the card, held to each other by
    k2_gate. Returns {N: (launches, launches with valid rows, uv err,
    mean_diff err, rows that stopped an update apart)}."""
    import torch

    from plsvo_torch.ops import mixed_align as ma

    if not captured:
        fail("K2 captured no launch of the slice")
    out = {}
    for args, kw, site, run in captured:
        n = args[0].shape[0]
        out_k = ma.mixed_align_cuda(*args, **kw)
        out_p = ma.mixed_align_plain(*args, **kw)
        torch.cuda.synchronize()
        uv_err, md_err, apart = k2_gate(args, kw, out_k, out_p, site, run)
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


# K3 (sparse image alignment) against its plain twin on the same inputs:
# the poses within these (the card sums the 6x6 system in another order),
# and a level's iteration count equal unless the two sides part at a
# chi2-increase test whose relative chi2 step is float32 rounding
K3_ROT_ATOL = 1e-4  # rad
K3_T_ATOL = 1e-4
K3_CHI2_TIE = 1e-4
K3_EVERY = 4  # the gate re-runs 1 in K3_EVERY alignment calls


def k3_compare(out_k, trace_k, out_p):
    """The kernel's AlignResult (with its per-iteration trace: chi2, max
    |x|) against the plain twin's on the same inputs. The poses must be
    finite and within K3_ROT_ATOL / K3_T_ATOL, seg_alive and the tracked
    counts equal, and each level's iterations equal, but for one exception
    per sequence: at the first level where the counts differ, the two sides
    may part at iteration p = min(counts) >= 2 when the kernel's chi2 moved
    by at most K3_CHI2_TIE (relative) from iteration p - 1 to p, so that
    its chi2-increase test lies within float32 rounding; the later levels
    start from the parted poses and are not compared. Returns (problem or
    None, rotation err (rad), translation err, [(sequence, level index,
    kernel iters, plain iters, relative chi2 step)] of the partings)."""
    import torch

    Rk, Rp = out_k.R.double().cpu(), out_p.R.double().cpu()
    tk, tp = out_k.t.double().cpu(), out_p.t.double().cpu()
    if not (bool(torch.isfinite(Rk).all()) and bool(torch.isfinite(tk).all())):
        return "K3 returned a non-finite pose", float("nan"), float("nan"), []
    # the angle of Rk' Rp from its chord, exact for rotations
    chord = torch.linalg.norm((Rk - Rp).reshape(-1, 9), dim=-1) / (2 * 2 ** 0.5)
    rot = 2 * torch.asin(chord.clamp(max=1.0))
    rot_err = float(rot.max()) if rot.numel() else 0.0
    t_err = float((tk - tp).abs().max()) if tk.numel() else 0.0
    problem = None
    if rot_err > K3_ROT_ATOL or t_err > K3_T_ATOL:
        problem = (f"K3 pose differs from the plain twin's by {rot_err:.3e} rad "
                   f"/ {t_err:.3e} (limits {K3_ROT_ATOL} / {K3_T_ATOL})")
    for name in ("seg_alive", "n_tracked_pts", "n_tracked_segs"):
        a = getattr(out_k, name).cpu()
        b = getattr(out_p, name).cpu().to(a.dtype)
        if problem is None and not torch.equal(a, b):
            problem = f"K3 {name} {a.tolist()} against {b.tolist()}"
    ik, ip = out_k.iters.cpu().tolist(), out_p.iters.cpu().tolist()
    chi2 = trace_k[..., 0].double().cpu()
    partings = []
    for b, (lk, lp) in enumerate(zip(ik, ip)):
        for lv, (nk, np_) in enumerate(zip(lk, lp)):
            if nk == np_:
                continue
            p = min(nk, np_)
            step = (float(abs(chi2[b, lv, p - 1] - chi2[b, lv, p - 2])
                          / abs(chi2[b, lv, p - 2]).clamp_min(1e-30))
                    if p >= 2 else float("inf"))
            partings.append((b, lv, nk, np_, step))
            if problem is None and not step <= K3_CHI2_TIE:
                problem = (f"K3 sequence {b} level index {lv}: {nk} "
                           f"iterations on the card, {np_} in the plain twin, "
                           f"at a relative chi2 step {step:.3e} (> "
                           f"{K3_CHI2_TIE}: not a rounding tie)")
            break
    return problem, rot_err, t_err, partings


def k3_capture_hook(captured, run, every=K3_EVERY):
    """A sparse_align.capture hook that keeps 1 in `every` launches' inputs
    (the levels the call reads, cloned) as (args, kwargs, run)."""
    import torch

    seen = [0]

    def clone(x):
        if x is None:
            return None
        if torch.is_tensor(x):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[clone(v) for v in x])
        return x

    def hook(args, kwargs):
        seen[0] += 1
        if (seen[0] - 1) % every:
            return
        lv = set(kwargs["levels"])
        pyrs = [[p.clone() if i in lv else None for i, p in enumerate(pyr)]
                for pyr in args[:2]]
        captured.append((tuple(pyrs) + tuple(clone(a) for a in args[2:]),
                         dict(kwargs), run))
    return hook


def k3_bound_ms(args, kw, iters):
    """The least time of a K3 call on the card, (ms, "bytes" or
    "operations"): each level image read once and the row tables read once
    (f32), against ~20 operations per tap and ~130 per row (its 21 + 6
    normal-equation terms) in every iteration the call ran."""
    levels = kw["levels"]
    pts, segs = args[2], args[3]
    B, N = pts.xyz_ref.shape[:2]
    rows = N + segs.xyz_ref.shape[1] * segs.xyz_ref.shape[2]
    nbytes = 4 * sum(args[k][lv].numel() for k in (0, 1) for lv in levels)
    nbytes += sum(4 * x.numel() for x in (*pts, *segs) if x is not None)
    ops = int(iters.sum()) * rows * (16 * 20 + 130)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def phase_k3(captured):
    """Every captured alignment call, re-run by K3 and by the plain twin on
    the card and held to each other by k3_compare. Prints, per run, the
    calls checked, the largest rotation and translation differences and
    the calls whose iterations differ."""
    import torch

    from plsvo_torch.ops import sparse_align as sa

    if not captured:
        fail("K3: no alignment call was captured")
    out = {}
    for i, (args, kw, run) in enumerate(captured):
        out_k, trace = sa.sparse_img_align_cuda(*args, **kw)
        out_p = sa.sparse_img_align_plain(*args, **kw)
        torch.cuda.synchronize()
        problem, rot, terr, partings = k3_compare(out_k, trace, out_p)
        if problem:
            fail(f"{problem} ({run} run, captured call {i}, B="
                 f"{args[4].shape[0]}, levels {kw['levels']})")
        for b, lv, nk, np_, step in partings:
            print(f"K3 {run} call {i}: sequence {b} level index {lv} ran {nk} "
                  f"iterations on the card and {np_} in the plain twin (chi2 "
                  f"step {step:.2e} relative: a rounding tie)", flush=True)
        n, r, t, n_part = out.get(run, (0, 0.0, 0.0, 0))
        out[run] = (n + 1, max(r, rot), max(t, terr), n_part + bool(partings))
    for run, (n, r, t, n_part) in out.items():
        print(f"K3 {run}: {n} calls checked against the plain twin, rotation "
              f"max diff {r:.3e} rad, translation {t:.3e}; {n_part} calls "
              f"whose iterations differ", flush=True)
    return out


K4_ROT_ATOL = 1e-5  # rad: the card test's poses (synthetic, 0.3 px noise)
K4_T_ATOL = 1e-5
# a real frame's residuals are ~1e-4 on the unit plane, the difference of
# two coordinates of size ~0.5, so each side rounds them by ~3e-4 of their
# size: the two sides' chi2 part by up to ~1e-4 relative (1.2e-4 and tie
# steps up to 7.7e-5 seen on the H100) and their systems by more
K4_CHI2_TIE = 1e-3
# on real frames the two sides' MAD scales differ by rounding (~2.6e-4
# relative on the H100), so each solves a slightly other problem: optima
# ~1e-5 apart (2.2e-5 rad seen at cond(A) ~460), at the same robust cost
# within 1.3e-4 relative over 54 calls. The gate holds every sequence to
# the cost, and to a pose bound far above that drift
K4_POSE_ATOL = 1e-3  # rad and m
K4_COST_RTOL = 1e-3  # the robust cost over the valid rows, both poses
K4_MASK_TIE = 1e-6  # residual norm (unit plane) within this of the threshold
K4_SCALE_RTOL = 1e-5
# a residual is the difference of two unit-plane coordinates of size ~0.5,
# so its rounding is ~1e-7 absolute whatever its size: the MAD scales agree
# to that (a real frame's scale is ~1e-4, its median element's rounding
# ~4e-8 on the H100)
K4_SCALE_ATOL = 5e-7
K4_INFO_RTOL = 1e-2
K4_INFO_COND = 1e5  # information matrices compared up to this condition
K4_EVERY = 4  # the gate re-runs 1 in K4_EVERY pose calls


def pose_plain_iters(args, kw):
    """Each sequence's GN iterations per pass (B, 2) in the plain twin: each
    sequence run alone (what the batch gives it, its carry frozen once it
    stops), its `pose_iters` counts recorded per pass."""
    import torch

    from plsvo_torch.ops import pose_opt
    from plsvo_torch.utils import profiling

    class Passes(profiling.PerformanceMonitor):
        def count(self, name, n):
            if name == "pose_iters":
                self.passes.append(int(n))

    inp, R0, t0, focal = args
    out = []
    for b in range(R0.shape[0]):
        rec = Passes()
        rec.passes = []
        with rec.installed():
            pose_opt.optimize_pose_plain(type(inp)(*[x[b] for x in inp]),
                                         R0[b], t0[b], focal, **kw)
        out.append((rec.passes + [0, 0])[:2])
    return torch.tensor(out, dtype=torch.int32).reshape(-1, 2)


def _pose_rows(inp, R, t, scale_pt, scale_sg, thr):
    """The plain twin's residual norms of every row at the poses (R, t),
    their thresholds, and the robust cost over the valid rows (B,),
    float64 on the CPU."""
    import torch

    from plsvo_torch.ops import pose_opt

    dev = inp.pt_f.device
    R, t = R.to(dev, torch.float32), t.to(dev, torch.float32)
    sp = scale_pt.to(dev).reshape(-1, 1)
    ss = scale_sg.to(dev).reshape(-1, 1)
    _, e_pt, _ = pose_opt._pt_errors(R, t, inp)
    _, _, e_sg, _ = pose_opt._seg_errors(R, t, inp)
    n_pt, n_sg = torch.linalg.norm(e_pt, dim=-1), torch.linalg.norm(e_sg, dim=-1)
    zero = torch.zeros((), device=dev)
    cost = (torch.where(inp.pt_valid, pose_opt.tukey_rho(n_pt / sp), zero).sum(-1)
            + torch.where(inp.seg_valid, pose_opt.tukey_rho(n_sg / ss),
                          zero).sum(-1))
    th_sg = thr * ss.double().cpu() / sp.double().cpu()
    return ((n_pt.double().cpu(), torch.full_like(sp.double().cpu(), thr)),
            (n_sg.double().cpu(), th_sg), cost.double().cpu())


def k4_first_pass(args, kw):
    """Both sides' results of the first pass alone (n_iter_ref 0), whose
    inlier masks are the strip the refinement pass starts from; None when
    the call has no refinement pass."""
    from plsvo_torch.ops import pose_opt

    if kw["n_iter_ref"] <= 0:
        return None
    kw0 = dict(kw, n_iter_ref=0)
    return (pose_opt.optimize_pose_cuda(*args, **kw0)[0],
            pose_opt.optimize_pose_plain(*args, **kw0))


def _strip_apart(inp, res_k, res_p, R, t, thr):
    """The kernel's inlier masks against the strip at the pose (R, t) with
    the plain twin's thresholds: (sequences whose masks differ (B,), rows
    that differ away from the threshold, rows forgiven at it). A row is
    forgiven where its residual norm lies within K4_MASK_TIE of the
    threshold, plus, for a segment, the gap between the two sides'
    segment thresholds (which carry the scales' rounding)."""
    import torch

    (n_pt, th_pt), (n_sg, th_sg), _ = _pose_rows(
        inp, R, t, res_p.scale_pt.reshape(-1), res_p.scale_seg.reshape(-1), thr)
    th_k = (thr * res_k.scale_seg.double().cpu()
            / res_k.scale_pt.double().cpu()).reshape(-1, 1)
    apart = torch.zeros(n_pt.shape[0], dtype=torch.bool)
    away = forgiven = 0
    for name, valid, norm, th, band in (
            ("pt_inlier", inp.pt_valid, n_pt, th_pt, K4_MASK_TIE),
            ("seg_inlier", inp.seg_valid, n_sg, th_sg,
             K4_MASK_TIE + (th_k - th_sg).abs())):
        ref = valid.cpu() & (norm <= th)
        diff = getattr(res_k, name).cpu().reshape(ref.shape) != ref
        apart |= diff.any(-1)
        far = diff & ((norm - th).abs() > band)
        away += int(far.sum())
        forgiven += int((diff & ~far).sum())
    return apart, away, forgiven


def k4_compare(args, kw, out_k, iters_k, trace_k, out_p, iters_p,
               first=None):
    """The kernel's PoseOptResult (with its iterations per pass and its
    per-iteration chi2 trace) against the plain twin's on the same inputs;
    `first` holds both sides' first-pass results (k4_first_pass) when the
    call has a refinement pass.

    The two sides part where a decision lies within rounding: a pass's
    iterations may differ where the kernel's chi2 moved by at most
    K4_CHI2_TIE (relative) from iteration p - 1 to p, p = min(counts) >=
    2, so that its chi2-increase test is a tie; the first pass's strip may
    differ in rows at the threshold (as `_strip_apart` forgives them), so
    that the refinement runs on other rows. Any other difference in the
    iterations or the first strip is a fault. The MAD scales must lie
    within K4_SCALE_RTOL or K4_SCALE_ATOL and the observation counts be
    equal. Every sequence: its pose finite and within K4_POSE_ATOL, the
    robust cost over its valid rows (the plain twin's scales) at the
    kernel's pose within K4_COST_RTOL of the cost at the plain twin's
    pose, and its inlier masks the strip at the kernel's own pose but at
    the threshold. A sequence that did not part: chi2 within K4_CHI2_TIE
    and the information matrices (the float64 inverses of the
    covariances) within K4_INFO_RTOL (relative, each plus four times the
    scales' relative difference, which the weights carry) where their
    condition is at most K4_INFO_COND (beyond it the float32 inverse is
    rounding on both sides). Returns (problem or None, rotation err (rad),
    translation err, [(sequence, pass, kernel iters, plain iters, relative
    chi2 step)] of the iteration partings, rows forgiven at a
    threshold)."""
    import torch

    from plsvo_torch.ops import pose_opt

    inp, _, _, focal = args
    batch = [out_k, out_p] + (list(first) if first is not None else [])
    if out_p.R.dim() == 2:
        inp = pose_opt.PoseOptInputs(*[x[None] for x in inp])
        batch = [type(r)(*[x[None] for x in r]) for r in batch]
    res_k, res_p = batch[:2]
    Rk, Rp = res_k.R.double().cpu(), res_p.R.double().cpu()
    tk, tp = res_k.t.double().cpu(), res_p.t.double().cpu()
    if not (bool(torch.isfinite(Rk).all()) and bool(torch.isfinite(tk).all())):
        return ("K4 returned a non-finite pose", float("nan"), float("nan"),
                [], 0)
    problems = []
    thr = float(np.float32(kw["reproj_thresh"] / focal))
    ik_ = iters_k.cpu().reshape(-1, 2).tolist()
    ip_ = iters_p.cpu().reshape(-1, 2).tolist()
    chi2 = trace_k.double().cpu().reshape(len(ik_), 2, -1)
    partings = []
    for b, (pk, pp) in enumerate(zip(ik_, ip_)):
        for ps, (nk, np_) in enumerate(zip(pk, pp)):
            if nk == np_:
                continue
            p = min(nk, np_)
            step = (float(abs(chi2[b, ps, p - 1] - chi2[b, ps, p - 2])
                          / abs(chi2[b, ps, p - 2]).clamp_min(1e-30))
                    if p >= 2 else float("inf"))
            partings.append((b, ps, nk, np_, step))
            if not step <= K4_CHI2_TIE:
                problems.append(
                    f"K4 sequence {b} pass {ps}: {nk} iterations on the card, "
                    f"{np_} in the plain twin, at a relative chi2 step "
                    f"{step:.3e} (> {K4_CHI2_TIE}: not a rounding tie)")
    parted = torch.zeros(len(ik_), dtype=torch.bool)
    parted[[q[0] for q in partings]] = True
    forgiven = 0
    if first is not None:
        k1, p1 = batch[2:]
        apart, away, n = _strip_apart(inp, k1, p1, p1.R, p1.t, thr)
        if away:
            problems.append(f"K4's first-pass strip differs from the plain "
                            f"twin's in {away} rows away from the threshold")
        parted |= apart
        forgiven += n
    chord = torch.linalg.norm((Rk - Rp).reshape(-1, 9), dim=-1) / (2 * 2 ** 0.5)
    rot = 2 * torch.asin(chord.clamp(max=1.0))
    terr = (tk - tp).abs().amax(-1)
    rot_err = float(rot.max()) if rot.numel() else 0.0
    t_err = float(terr.max()) if terr.numel() else 0.0
    if rot_err > K4_POSE_ATOL or t_err > K4_POSE_ATOL:
        problems.append(f"K4 pose differs from the plain twin's by "
                        f"{rot_err:.3e} rad / {t_err:.3e} (limit "
                        f"{K4_POSE_ATOL})")
    cost_p = _pose_rows(inp, res_p.R, res_p.t, res_p.scale_pt,
                        res_p.scale_seg, thr)[2]
    cost_k = _pose_rows(inp, res_k.R, res_k.t, res_p.scale_pt,
                        res_p.scale_seg, thr)[2]
    off = ~((cost_k - cost_p).abs() <= K4_COST_RTOL * cost_p.abs())
    off &= ~(cost_k.isnan() & cost_p.isnan())
    if bool(off.any()):
        problems.append(f"K4 sequences {off.nonzero().flatten().tolist()} "
                        f"stop at a robust cost {cost_k[off].tolist()} against "
                        f"the plain twin's {cost_p[off].tolist()} (rtol "
                        f"{K4_COST_RTOL})")
    for name in ("n_obs_pt", "n_obs_seg"):
        a = getattr(res_k, name).cpu()
        b = getattr(res_p, name).cpu().to(a.dtype)
        if not torch.equal(a, b):
            problems.append(f"K4 {name} {a.tolist()} against {b.tolist()}")

    def close(name, rtol, rows, atol=0.0):
        a = getattr(res_k, name).double().cpu()[rows]
        b = getattr(res_p, name).double().cpu()[rows]
        lim = torch.maximum(rtol * b.abs(), torch.as_tensor(atol))
        same = (a == b) | (a.isnan() & b.isnan()) | ((a - b).abs() <= lim)
        if not bool(same.all()):
            problems.append(f"K4 {name} {a.tolist()} against {b.tolist()} "
                            f"(rtol {rtol}, atol {atol})")

    every = torch.ones(len(ik_), dtype=torch.bool)
    close("scale_pt", K4_SCALE_RTOL, every, K4_SCALE_ATOL)
    close("scale_seg", K4_SCALE_RTOL, every, K4_SCALE_ATOL)
    # chi2 and the system scale as the weights do: allow four times the
    # scales' relative difference on top of rounding
    ds = torch.stack([((getattr(res_k, n).double().cpu()
                        - getattr(res_p, n).double().cpu())
                       / getattr(res_p, n).double().cpu()).abs()
                      for n in ("scale_pt", "scale_seg")]).amax(0)
    ds = ds.nan_to_num(0.0)
    for b in (~parted).nonzero().flatten().tolist():
        close("chi2", K4_CHI2_TIE + 4 * float(ds[b]), torch.tensor([b]))
    ck, cp = res_k.cov.double().cpu(), res_p.cov.double().cpu()
    fin_k = torch.isfinite(ck).flatten(1).all(-1)
    fin_p = torch.isfinite(cp).flatten(1).all(-1)
    if not torch.equal(fin_k, fin_p):
        problems.append(f"K4 covariance finite {fin_k.tolist()} against "
                        f"{fin_p.tolist()}")
    else:
        sel = fin_p & ~parted
        if bool(sel.any()):
            ik, ip = (torch.linalg.inv(c[sel]) for c in (ck, cp))
            sel_c = torch.linalg.cond(ip) <= K4_INFO_COND
            info = (torch.linalg.norm((ik - ip).flatten(1), dim=-1)
                    / torch.linalg.norm(ip.flatten(1), dim=-1))[sel_c]
            lim = (K4_INFO_RTOL + 4 * ds[sel])[sel_c]
            if info.numel() and not bool((info <= lim).all()):
                problems.append(f"K4 information matrix (inverse covariance) "
                                f"differs by {float(info.max()):.3e} relative "
                                f"(limit {K4_INFO_RTOL} + 4 x the scales' "
                                "relative difference)")
    # the final strip, at the kernel's own pose
    _, away, n = _strip_apart(inp, res_k, res_p, Rk, tk, thr)
    if away:
        problems.append(f"K4's inlier masks differ from the strip at its pose "
                        f"in {away} rows away from the threshold")
    forgiven += n
    return (problems[0] if problems else None, rot_err, t_err, partings,
            forgiven)


def k4_capture_hook(captured, run, every=K4_EVERY):
    """A pose_opt.capture hook that keeps 1 in `every` launches' inputs
    (cloned) as (args, kwargs, run)."""
    seen = [0]

    def hook(args, kwargs):
        seen[0] += 1
        if (seen[0] - 1) % every:
            return
        inp, R0, t0, focal = args
        captured.append(((type(inp)(*[x.clone() for x in inp]), R0.clone(),
                          t0.clone(), focal), dict(kwargs), run))
    return hook


def k4_bound_ms(args, iters):
    """The least time of a K4 call on the card, (ms, "bytes" or
    "operations"): the row tables read once and the outputs written once
    (f32; int32 levels, byte masks), against the rows' work in every
    iteration run (~160 operations a point row and ~300 a segment row:
    transform, projection, Jacobian, weight, the 28 sums) and ~800 for
    each iteration's 6x6 Cholesky, exponential and decision, plus the
    median's sorts and the strips."""
    inp, R0 = args[0], args[1]
    B, N = inp.pt_f.shape[:2]
    M = inp.seg_line.shape[1]
    nbytes = sum(x.numel() * x.element_size() for x in inp)
    nbytes += 4 * (R0.numel() + 3 * B)
    nbytes += B * (4 * (9 + 3 + 36 + 3) + 8 + 8 + N + M)
    it = int(iters.sum())
    row_ops = 160 * N + 300 * M
    ops = it * (row_ops + 800) + 3 * B * row_ops
    n2 = max(N, M, 1)
    ops += 2 * B * n2 * max(1, int(np.log2(n2))) ** 2
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _to_cpu(x):
    import torch

    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, (tuple, list)):
        out = [_to_cpu(v) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    return x


def phase_k4(captured, out_dir=OUT_DIR):
    """Every captured pose call, re-run by K4 and by the plain twin on the
    card and held to each other by k4_compare. Prints, per run, the calls
    checked, the largest rotation and translation differences, the calls
    whose iterations differ, the inlier rows apart at a threshold and the
    largest relative difference of the robust cost at the two poses; every
    problem, then fails if there was one. The calls and both sides' results
    go to `out_dir`/k4_calls.pt for a replay on the CPU."""
    import torch

    from plsvo_torch.ops import pose_opt

    if not captured:
        fail("K4: no pose call was captured")
    out, problems, kept = {}, [], []
    for i, (args, kw, run) in enumerate(captured):
        out_k, iters_k, trace = pose_opt.optimize_pose_cuda(*args, **kw)
        out_p = pose_opt.optimize_pose_plain(*args, **kw)
        iters_p = pose_plain_iters(args, kw)
        first = k4_first_pass(args, kw)
        torch.cuda.synchronize()
        problem, rot, terr, partings, forgiven = k4_compare(
            args, kw, out_k, iters_k, trace, out_p, iters_p, first)
        kept.append(_to_cpu((args, kw, run, out_k, iters_k, trace, out_p,
                             iters_p, first)))
        thr = float(np.float32(kw["reproj_thresh"] / args[3]))
        c_p, c_k = (_pose_rows(args[0], r.R, r.t, out_p.scale_pt,
                               out_p.scale_seg, thr)[2] for r in (out_p, out_k))
        cost = float(((c_k - c_p).abs() / c_p.abs().clamp_min(1e-30)).max())
        if problem:
            problems.append(f"{problem} ({run} run, captured call {i}, B="
                            f"{args[1].shape[0]})")
            print(f"K4 problem: {problems[-1]}", flush=True)
        for b, ps, nk, np_, step in partings:
            print(f"K4 {run} call {i}: sequence {b} pass {ps} ran {nk} "
                  f"iterations on the card and {np_} in the plain twin (chi2 "
                  f"step {step:.2e} relative: a rounding tie)", flush=True)
        n, r, t, n_part, n_rows, c = out.get(run, (0, 0.0, 0.0, 0, 0, 0.0))
        out[run] = (n + 1, max(r, rot), max(t, terr), n_part + bool(partings),
                    n_rows + forgiven, max(c, cost))
    os.makedirs(out_dir, exist_ok=True)
    torch.save(kept, os.path.join(out_dir, "k4_calls.pt"))
    for run, (n, r, t, n_part, n_rows, c) in out.items():
        print(f"K4 {run}: {n} calls checked against the plain twin, rotation "
              f"max diff {r:.3e} rad, translation {t:.3e}; {n_part} calls "
              f"whose iterations differ; {n_rows} inlier rows apart at their "
              f"threshold; robust cost at the two poses apart by {c:.3e} "
              "relative at most", flush=True)
    if problems:
        fail(f"K4: {len(problems)} of {len(captured)} calls failed the gate; "
             f"the first: {problems[0]}")
    return {run: v[:5] for run, v in out.items()}


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
        (frame_handler, "_kf_detect_program_batched", "kf_detect"),
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


# ---------------------------------------------------------------------------
# This slice's path: BatchedVO (vmap mode, pipelined, bench.py's batched
# configuration), its streams mode, and the keyframe-eviction soak.
# ---------------------------------------------------------------------------

BATCH = 8  # bench.py's BENCH_BATCH default
SOLO_TOL_M = 2e-3  # batched against solo per-frame camera centres
SOAK_FRAMES = 310
SOAK_BLACKOUT = range(150, 153)
SOAK_TAIL_ATE = 0.004  # tests/test_soak.py's bound (m)


def uint8_frames(imgs):
    """bench.py's batched ingestion: frames as uint8 host arrays."""
    return [np.clip(np.round(im.cpu().numpy()), 0, 255).astype(np.uint8)
            for im in imgs]


def staggered(frames, i, B):
    """bench.py's stagger: sequence k runs k frames behind (its first k
    frames repeat frame 0), so keyframes desynchronize across the batch."""
    return [frames[max(0, i - k)] for k in range(B)]


def _site_patches(site):
    """Patches that label K2 launches with the call site being run."""
    def at_site(orig, label):
        def wrapped(*a, **k):
            site[0] = label
            try:
                return orig(*a, **k)
            finally:
                site[0] = "other"
        return wrapped

    return [(o, a, at_site(getattr(o, a), label))
            for o, a, label in _call_sites()]


def _centres(results):
    return np.stack([-r.R_f_w.T @ r.t_f_w for r in results])


def phase_batched(cam, imgs, gt_centers, device, n_main):
    """BatchedVO(mode="vmap") over BATCH sequences, default_config() with
    pipelined=True, pipeline_depth=PIPE_DEPTH (bench.py's batched
    configuration), 752x480 uint8 frames of the lines run staggered as
    bench.py staggers them: n_main frames with the launch counts set to 0
    before and read after, PIPE_DEPTH more under torch.profiler, flush().
    Every K2 launch and every batched K1 input is captured. Gates: every
    frame of every sequence delivered once; DEFAULT reached and kept; ATE
    < 1% of each path; each sequence's synced carry equal to a fresh upload
    of its map; one K1 launch per 10 keyframe requests (their 30 pyramid
    images) of each batched detection;
    sequences 0 and BATCH - 1 tracked again by solo pipelined handlers give
    per-frame centres within SOLO_TOL_M."""
    from plsvo_torch.ops import fast_score as fs
    from plsvo_torch.ops import mixed_align as ma
    from plsvo_torch.ops import pose_opt, sparse_align
    from plsvo_torch.parallel.multi_vo import BatchedVO
    from plsvo_torch.pipeline import fused
    from plsvo_torch.pipeline.frame_handler import (STAGE_DEFAULT,
                                                    FrameHandlerMono)
    from plsvo_torch.pipeline.state import validate_map
    from plsvo_torch.utils import trajectory

    kind = "batched"
    B = BATCH
    cfg = run_config("pipelined")
    frames = uint8_frames(imgs)
    n_all = n_main + PIPE_DEPTH
    n_pyr = cfg.pipeline.n_pyr_levels
    bvo = BatchedVO(cam, cfg, B, mode="vmap", device=device)
    captured, k1_inputs, drains, captured_k3 = [], [], [], []
    captured_k4 = []
    site = ["other"]

    def k2_capture(args, kwargs):
        captured.append(([a.clone() for a in args], dict(kwargs), site[0]))

    orig_levels = fs.fast_score_levels

    def levels_capture(ims, *a):
        if len(ims) > n_pyr:  # a batched keyframe detection
            k1_inputs.append([im.clone() for im in ims])
        return orig_levels(ims, *a)

    flush_det = bvo._flush_detections

    def flush_detections():
        n_req, before = len(bvo._det_q), fs.launches
        flush_det()
        if n_req:
            drains.append((n_req, fs.launches - before))

    bvo._flush_detections = flush_detections
    delivered = [[] for _ in range(B)]
    calls = []  # (ms, every sequence DEFAULT after the call)

    def track(i):
        t0 = time.perf_counter()
        rs = bvo.add_images(staggered(frames, i, B), i / 30.0)
        calls.append(((time.perf_counter() - t0) * 1e3,
                      all(st == STAGE_DEFAULT for st in bvo.stages)))
        for b, r in enumerate(rs):
            if r is not None:
                delivered[b].append(r)

    gn_calls = {}  # the last batched call of each GN loop

    def keep_call(name, orig):
        def wrapped(*a, **k):
            R0 = a[4 if name == "sparse_img_align" else 1]
            if R0.dim() == 3 and R0.shape[0] > 1:
                gn_calls[name] = (a, k)
            return orig(*a, **k)
        return wrapped

    undo = _patched([(ma, "capture", k2_capture),
                     (sparse_align, "capture",
                      k3_capture_hook(captured_k3, kind)),
                     (pose_opt, "capture", k4_capture_hook(captured_k4, kind)),
                     (fs, "fast_score_levels", levels_capture),
                     (sparse_align, "sparse_img_align",
                      keep_call("sparse_img_align",
                                sparse_align.sparse_img_align)),
                     (pose_opt, "optimize_pose",
                      keep_call("optimize_pose", pose_opt.optimize_pose))]
                    + _site_patches(site))
    try:
        fs.launches = 0
        ma.launches = 0
        sparse_align.launches = 0
        pose_opt.launches = 0
        for i in range(n_main):
            track(i)
        launches = {"fast_score": fs.launches, "mixed_align": ma.launches,
                    "sparse_align": sparse_align.launches,
                    "pose_opt": pose_opt.launches}
        timed = list(calls)
        wall_ms, busy_ms, n_launch, n_sync, _ = profile_window(
            lambda: [track(i) for i in range(n_main, n_all)])
        for rs in bvo.flush():
            for b, r in enumerate(rs):
                if r is not None:
                    delivered[b].append(r)
    finally:
        undo()
    engaged = next((i for i, (_, ok) in enumerate(calls) if ok), None)
    print(f"{kind}: {B} sequences, every one DEFAULT from call {engaged}; "
          f"stages of sequence 0: "
          + " ".join(r.stage[0] for r in delivered[0]), flush=True)
    if bvo._mt_stack is None:
        fail(f"{kind}: no chain of batched pipelined steps was live at the end")
    carries = bvo.sync_carry()
    ates, paths = [], []
    for b, vo in enumerate(bvo.vos):
        ids = [r.frame_id for r in delivered[b]]
        if ids != list(range(n_all)):
            fail(f"{kind}: sequence {b} delivered frames {ids}, not each of "
                 f"0..{n_all - 1} once in order")
        st = [r.stage for r in delivered[b]]
        if STAGE_DEFAULT not in st:
            fail(f"{kind}: sequence {b} never reached STAGE_DEFAULT")
        fd = st.index(STAGE_DEFAULT)
        if any(x != STAGE_DEFAULT for x in st[fd:]):
            fail(f"{kind}: sequence {b} left STAGE_DEFAULT after frame {fd}")
        est = _centres(delivered[b][fd:])
        gt = gt_centers[[max(0, f - b) for f in ids[fd:]]]
        if not np.isfinite(est).all():
            fail(f"{kind}: sequence {b}: non-finite camera centres")
        ate = trajectory.ate_rmse(est.astype(np.float64), gt.astype(np.float64))
        path = float(np.linalg.norm(np.diff(gt, axis=0), axis=-1).sum())
        ates.append(ate)
        paths.append(path)
        if ate >= 0.01 * path:
            fail(f"{kind}: sequence {b} ATE {ate} >= 1% of its path {path}")
        bad = fused.carry_mismatches(carries[b], fused.map_tables_upload(vo.map))
        if bad:
            fail(f"{kind}: sequence {b}'s synced carry differs from its "
                 f"mirror in {bad}")
        errs = validate_map(vo.map)
        if errs:
            fail(f"{kind}: sequence {b} map inconsistent: {errs[:5]}")
    print(f"{kind}: ATE per sequence (% of its path) "
          + ", ".join(f"{100 * a / p:.3f}" for a, p in zip(ates, paths))
          + "; every frame delivered once; each synced carry equals its "
          "mirror", flush=True)
    per = bvo.detections_per_program()
    bad_k1 = [(n, k) for n, k in drains if k != -(-n // per)]
    print(f"{kind}: batched keyframe detections per drain (requests, K1 "
          f"launches): {drains}", flush=True)
    if not drains or bad_k1:
        fail(f"{kind}: K1 launches per batched detection {drains}, not one "
             f"per {per} requests ({per * n_pyr} pyramid images)")
    sites = {}
    for args, _, where in captured:
        key = (where, args[0].shape[0])
        sites[key] = sites.get(key, 0) + 1
    print(f"{kind}: K2 launches by (call site, N): {sorted(sites.items())}",
          flush=True)
    caps = cfg.caps
    n_rep = B * (caps.max_fts + 2 * caps.max_segs)
    if sites.get(("reproject", n_rep), 0) < n_main - engaged - 1:
        fail(f"{kind}: {sites.get(('reproject', n_rep), 0)} reprojection "
             f"launches of N={n_rep}, not one per batched step")
    # the solo handlers of the first and the last sequence
    solo_err = {}
    for b in (0, B - 1):
        vo = FrameHandlerMono(cam, cfg, device=device)
        got = [vo.add_image(frames[max(0, i - b)], i / 30.0)
               for i in range(n_all)]
        got = [r for r in got if r is not None] + vo.flush()
        mine = {r.frame_id: r for r in delivered[b]
                if r.stage == STAGE_DEFAULT}
        both = [r for r in got if r.stage == STAGE_DEFAULT and r.frame_id in mine]
        if len(both) < n_all - engaged - 2:
            fail(f"{kind}: sequence {b}: the solo handler and the batch share "
                 f"only {len(both)} DEFAULT frames")
        d = np.linalg.norm(_centres(both) - _centres(
            [mine[r.frame_id] for r in both]), axis=-1)
        solo_err[b] = float(d.max())
        print(f"{kind}: sequence {b} against a solo pipelined handler: "
              f"{len(both)} common DEFAULT frames, centres max distance "
              f"{d.max() * 1e3:.4f} mm (median {np.median(d) * 1e3:.4f})",
              flush=True)
        if d.max() >= SOLO_TOL_M:
            fail(f"{kind}: sequence {b} centres {d.max()} m from the solo "
                 f"handler's (limit {SOLO_TOL_M})")
    gn = gn_iterations(gn_calls)
    for name, (it_b, it_s) in gn.items():
        how = ("K3" if name == "sparse_img_align" else "K4") + (
            " runs each sequence's own; a loop to the slowest member would "
            "run")
        print(f"{kind}: {name} of the last batched step: {it_b} GN "
              f"iterations for the batch (every level, the slowest member's "
              f"stop) against {it_s} for its sequences alone (mean "
              f"{np.mean(it_s):.1f}): {how} "
              f"{100 * (it_b / np.mean(it_s) - 1):.1f}% more iterations than "
              "a sequence's own", flush=True)
    dflt = [ms for ms, ok in timed if ok]
    steady = dflt[len(dflt) // 2:] if len(dflt) > 6 else dflt
    step_ms = float(np.mean(steady))
    fps = B * 1e3 / step_ms
    n = PIPE_DEPTH
    idle = 100 - 100 * busy_ms / n / step_ms if busy_ms > 0 else None
    print(f"{kind}: aggregate fps as bench.py computes it (B / mean of the "
          f"last half of the all-DEFAULT add_images calls, {len(steady)} "
          f"calls): {fps:.2f}; mean call {np.mean(steady):.2f} ms, p90 "
          f"{np.percentile(steady, 90):.2f} ms", flush=True)
    print(f"profile: batched window ({n} steps, one drain window, under "
          f"torch.profiler): wall {wall_ms / n:.2f} ms/step, device busy "
          + (f"{busy_ms / n:.3f} ms/step ({100 - idle:.2f}% of the "
             f"unprofiled {step_ms:.2f} ms/step: idle {idle:.2f}%)"
             if busy_ms > 0 else "not measured (the profiler saw no device time)")
          + f"; per batched step: {n_launch / n:.0f} kernel launches, "
          f"{n_sync / n:.1f} host syncs", flush=True)
    return dict(kind=kind, captured=captured, captured_k3=captured_k3,
                captured_k4=captured_k4,
                launches=launches, fps=fps,
                gn=gn, delivered=delivered,
                k1_inputs=k1_inputs, drains=drains, ates=ates, paths=paths,
                solo_err=solo_err, launches_per_step=n_launch / n,
                syncs_per_step=n_sync / n,
                idle=idle,
                k2_sites=sites, engaged=engaged)


def gn_iterations(calls):
    """GN iterations (one 6x6 solve each) of each captured batched call of
    sparse_img_align / optimize_pose: {name: (batch iterations, [per
    sequence])}, from one K3 / K4 run of the call (each sequence leaves its
    loop on its own; the batch's are what a loop to the slowest member
    would run: per level or pass the maxima, summed)."""
    from plsvo_torch.ops import pose_opt, sparse_align

    out = {}
    for name, (a, k) in sorted(calls.items()):
        if name == "sparse_img_align":
            it = sparse_align.sparse_img_align(*a, **k).iters
        else:
            it = pose_opt.optimize_pose_cuda(*a, **k)[1]
        out[name] = (int(it.amax(0).sum()), it.sum(-1).tolist())
    return out


def phase_streams(cam, imgs, device, B=2, n=20):
    """BatchedVO(mode="streams"): B pipelined handlers whose dispatches
    interleave, on n staggered frames; every frame delivered once."""
    from plsvo_torch.parallel.multi_vo import BatchedVO
    from plsvo_torch.pipeline.frame_handler import STAGE_DEFAULT

    frames = uint8_frames(imgs[:n])
    bvo = BatchedVO(cam, run_config("pipelined"), B, mode="streams",
                    device=device)
    got = [[] for _ in range(B)]
    t0 = time.perf_counter()
    for i in range(n):
        for b, r in enumerate(bvo.add_images(staggered(frames, i, B), i / 30.0)):
            if r is not None:
                got[b].append(r)
    for rs in bvo.flush():
        for b, r in enumerate(rs):
            if r is not None:
                got[b].append(r)
    for b in range(B):
        ids = [r.frame_id for r in got[b]]
        if ids != list(range(n)):
            fail(f"streams: sequence {b} delivered {ids}, not 0..{n - 1} once")
    print(f"streams: {B} handlers, {n} frames each delivered once in "
          f"{time.perf_counter() - t0:.1f} s; DEFAULT frames "
          f"{[sum(r.stage == STAGE_DEFAULT for r in g) for g in got]}",
          flush=True)


def _soak_pose(i: int):
    """tests/test_soak.py's orbit: an arc above the plane (radius 1 m, half
    a revolution over 450 frames) with a gentle yaw wobble."""
    th = 2 * np.pi * i / 900.0
    yaw = 0.25 * np.sin(th)
    R = np.asarray([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                    [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    t = np.asarray([np.sin(th), 0.3 * (np.cos(th) - 1.0), -2.0], np.float32)
    return R, t


def phase_soak(device, depth, blackout, ransac_draws=None):
    """tests/test_soak.py with the port alone, pipelined at `depth`:
    320x240, fast_config() (an 8-slot keyframe ring), its orbit and scene,
    with `blackout` a blackout at frames 150-152. Gates: test_soak's
    asserts over the delivered results (a failed frame's successors in
    flight are dropped; without the blackout its relocalization asserts
    drop out and the tail is every frame after the first DEFAULT one),
    at least one keyframe eviction, validate_map clean, and after flush()
    the synced carry equal to a fresh upload of the mirror.

    At depth 12 the blackout is not survivable, in the JAX package as in
    the port (their CPU runs, PERF.md): the failure is found 12-24 frames
    late, and relocalization keeps retrying the keyframe nearest the last
    good frame, whose 26 point features miss the reference's > 30 rule; by
    frame 150 the ring has only just filled. So the smoke runs the soak
    twice: at depth 12 without the blackout (evictions at bench.py's
    depth, where the eviction list is 24 slots wide) and at depth 4 with
    it (every test_soak assert).

    The tail ATE (the Sim3 ATE of the last 140 frames) is held to
    test_soak's 0.004 m (3x its sync 0.0014) at both depths. At depth 12 it
    depends on the bootstrap's RANSAC draws in both packages
    (tests/soak_seeds_d12.py on the CPU, the JAX package's draws of seeds
    0-5: JAX 0.0015-0.0083 m and once lost, the port 0.0015-0.0077 m and
    lost with the same seed), so the depth-12 soak passes
    `ransac_draws`=reference_ransac_draws, the reference's own bootstrap
    (seed 0: JAX 0.00249 m, the port 0.00248 m on the same frames)."""
    from plsvo_torch.camera import PinholeCamera
    from plsvo_torch.config import fast_config
    from plsvo_torch.pipeline import fused
    from plsvo_torch.pipeline.frame_handler import (STAGE_DEFAULT,
                                                    FrameHandlerMono)
    from plsvo_torch.pipeline.state import MapState, validate_map
    from plsvo_torch.utils import synthetic, trajectory

    t_start = time.perf_counter()
    n_frames = SOAK_FRAMES
    cam = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
    scene = synthetic.make_scene(np.random.default_rng(7), size=2048,
                                 texel_size=0.004)
    poses = [_soak_pose(i) for i in range(n_frames)]
    imgs = []
    for c in range(0, n_frames, 64):
        part = poses[c:c + 64]
        imgs += list(synthetic.render_batch_aa(
            scene, cam, [R for R, _ in part], [t for _, t in part], ss=2,
            device=device).cpu().numpy())
    black = np.zeros((240, 320), np.float32)
    cfg = fast_config()
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, pipelined=True, pipeline_depth=depth))
    dark = SOAK_BLACKOUT if blackout else range(0)
    evictions = []
    orig_remove = MapState.remove_keyframe

    def counting_remove(self, slot):
        evictions.append(slot)
        return orig_remove(self, slot)

    vo = FrameHandlerMono(cam, cfg, device=device, ransac_draws=ransac_draws)
    delivered, hwm = [], []
    undo = _patched([(MapState, "remove_keyframe", counting_remove)])
    try:
        for i in range(n_frames):
            img = black if i in dark else imgs[i]
            r = vo.add_image(img, i / 30.0)
            if r is not None:
                delivered.append(r)
            hwm.append(int((vo.map.pt_status > 0).sum()))
        delivered += vo.flush()
    finally:
        undo()
    ids = [r.frame_id for r in delivered]
    if len(set(ids)) != len(ids) or ids != sorted(ids):
        fail(f"soak: frames delivered out of order or twice: {ids}")
    by_id = {r.frame_id: r for r in delivered}
    stages = [by_id[i].stage if i in by_id else None for i in range(n_frames)]
    problems = []
    if STAGE_DEFAULT not in stages:
        fail("soak: never reached STAGE_DEFAULT")
    fd = stages.index(STAGE_DEFAULT)
    if fd >= 25:
        problems.append(f"first DEFAULT frame {fd} (>= 25)")
    end = SOAK_BLACKOUT[0] if blackout else n_frames
    if not all(x == STAGE_DEFAULT for x in stages[fd:end]):
        problems.append("tracking left DEFAULT before the blackout"
                        if blackout else "tracking left DEFAULT")
    back = None
    if blackout:
        # a relocalization attempt's own result is RELOCALIZING; one that
        # succeeds at once resumes a frame whose result comes later
        if vo.n_relocalizations < 1:
            problems.append("the blackout forced no relocalization")
        recov = stages[SOAK_BLACKOUT[-1] + 1:]
        if STAGE_DEFAULT in recov:
            back = recov.index(STAGE_DEFAULT) + SOAK_BLACKOUT[-1] + 1
            tail = stages[back:]
            if back - SOAK_BLACKOUT[-1] >= 20:
                problems.append(f"recovery took {back - SOAK_BLACKOUT[-1]} "
                                "frames")
            if tail.count(STAGE_DEFAULT) <= 0.9 * len(tail):
                problems.append(f"only {tail.count(STAGE_DEFAULT)} of "
                                f"{len(tail)} tail frames DEFAULT")
        else:
            problems.append("tracking never recovered after the blackout")
    n_kf = sum(r.is_keyframe for r in delivered)
    cap = cfg.caps.max_kfs
    if n_kf < cap + 2 or vo.map.n_keyframes() > cap:
        problems.append(f"{n_kf} keyframes made, {vo.map.n_keyframes()} held "
                        f"(ring of {cap})")
    idx = [i for i in range(n_frames - 140, n_frames)
           if stages[i] == STAGE_DEFAULT]
    ate = None
    if len(idx) > 100:
        est = _centres([by_id[i] for i in idx])
        gtp = np.stack([poses[i][1] for i in idx])
        ate = trajectory.ate_rmse(est.astype(np.float64),
                                  gtp.astype(np.float64), with_scale=True)
        if ate >= SOAK_TAIL_ATE:
            problems.append(f"tail ATE {ate} >= {SOAK_TAIL_ATE}")
    else:
        problems.append(f"only {len(idx)} DEFAULT frames in the last 140")
    full = [i for i in range(n_frames) if stages[i] == STAGE_DEFAULT]
    gtf = np.stack([poses[i][1] for i in full]).astype(np.float64)
    ate_all = trajectory.ate_rmse(_centres([by_id[i] for i in full])
                                  .astype(np.float64), gtf)
    path = float(np.linalg.norm(np.diff(gtf, axis=0), axis=-1).sum())
    caps = cfg.caps
    if max(hwm) >= 0.9 * caps.max_points:
        problems.append(f"live point high-water mark {max(hwm)}")
    if (vo.map.pt_status == 0).sum() <= 0.1 * caps.max_points:
        problems.append("point table nearly full")
    if (vo.map.ln_status > 0).sum() >= 0.9 * caps.max_lines:
        problems.append("line table nearly full")
    if vo._seed_alive.sum() > caps.max_seeds:
        problems.append("seed table over capacity")
    errs = validate_map(vo.map)
    if errs:
        problems.append(f"validate_map: {errs[:5]}")
    bad = fused.carry_mismatches(vo.sync_carry(), fused.map_tables_upload(vo.map))
    if bad:
        problems.append(f"the synced carry differs from the mirror in {bad}")
    label = f"soak (depth {depth}, {'blackout' if blackout else 'no blackout'})"
    print(f"{label}: {n_frames} frames in "
          f"{time.perf_counter() - t_start:.1f} s: first DEFAULT {fd}, "
          f"relocalizations {vo.n_relocalizations}, back in DEFAULT at {back}, "
          f"{len(delivered)} results delivered, {n_kf} keyframes made, "
          f"{len(evictions)} keyframe evictions, {vo.map.n_keyframes()} held; "
          f"tail ATE {ate} (test_soak's bound 0.004), ATE over all DEFAULT "
          f"frames {ate_all:.6f} m over a {path:.3f} m path "
          f"({100 * ate_all / path:.3f}%); live points high-water {max(hwm)}; "
          "validate_map "
          f"{'clean' if not errs else errs[:3]}; carry "
          f"{'equals the mirror' if not bad else bad}", flush=True)
    if not evictions:
        problems.append("no keyframe was evicted")
    if problems:
        fail(f"{label}: " + "; ".join(problems))
    return dict(evictions=len(evictions), n_kf=n_kf, ate=ate, ate_all=ate_all,
                path=path,
                relocalizations=vo.n_relocalizations, back=back,
                depth=depth, blackout=blackout)


# ---------------------------------------------------------------------------
# Phase 6e: the multi-device layer on the one card (a mesh of shards that
# share it), a [card, CPU] mesh, sharded BA at scale and torch.distributed.
# ---------------------------------------------------------------------------

# 6b's first frames, with the counts set to 0 around them: the batch
# engages at call 16 (the stagger and the bootstrap), so 24 calls hold 8
# sharded steps
MESH_FRAMES = 24
MESH_PROFILED = 2  # more batched steps under torch.profiler
BIG_BA = dict(K=96, L=50176, O=6)  # tests/test_ba_scale.py's full size


def big_ba_problem(rng, K=96, L=50176, O=6, noise=0.03):
    """tests/test_ba_scale.py's make_big_problem (keyframes on a smooth
    trajectory, each landmark seen by O consecutive keyframes, landmarks
    perturbed), built with the port's lie: (numpy problem, (R, t, pos))."""
    import torch

    from plsvo_torch import lie
    from plsvo_torch.parallel import ba

    sc = 96.0 / K
    k = np.arange(K, dtype=np.float32) * sc
    xi = np.stack([0.02 * k, 0.001 * k, 0 * k, 0 * k, 0.004 * k, 0.001 * k],
                  -1).astype(np.float32)
    Rk, tk = (a.numpy() for a in lie.se3_exp(torch.as_tensor(xi)))
    pos = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                    rng.uniform(3, 9, L)], -1).astype(np.float32)
    start = (np.arange(L) * (K - O) // L).astype(np.int64)
    obs_kf = (start[:, None] + np.arange(O)[None]).astype(np.int32)
    xyz = np.einsum("loij,lj->loi", Rk[obs_kf], pos) + tk[obs_kf]
    obs_f = (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    prob = ba.BAProblem(
        kf_R=Rk, kf_t=tk, kf_fixed=fixed,
        lm_pos=pos + rng.normal(0, noise, pos.shape).astype(np.float32),
        lm_valid=np.ones(L, bool), obs_kf=obs_kf, obs_f=obs_f,
        obs_valid=np.ones((L, O), bool))
    return prob, (Rk, tk, pos)


def mesh_ba_worker(rank, world, port, prob_path, out_path, device):
    """One process of 6e's two-process run: a gloo group on localhost, a
    (world, 2) hybrid mesh whose two local shards share `device` (the
    card), its host-local landmark range, one hierarchical BA iteration."""
    import torch
    import torch.distributed as dist

    from plsvo_torch.parallel import ba, distributed

    rank, world = int(rank), int(world)
    if not distributed.initialize(f"localhost:{port}", num_processes=world,
                                  process_id=rank, backend="gloo"):
        fail("mesh worker: the gloo group did not come up")
    dev = torch.device(device)
    mesh = distributed.hybrid_mesh(devices=[dev, dev])
    with np.load(prob_path) as f:
        prob = ba.BAProblem(**{k: f[k] for k in f.files})
    L = len(prob.lm_pos)
    lo, hi = rank * L // world, (rank + 1) * L // world
    local = prob._replace(**{k: getattr(prob, k)[lo:hi] for k in (
        "lm_pos", "lm_valid", "obs_kf", "obs_f", "obs_valid")})
    out, st = distributed.bundle_adjust_multihost(
        distributed.scatter_problem(local, mesh), mesh, n_iter=1)
    np.savez(out_path, kf_t=out.kf_t.cpu().numpy(),
             lm_local=out.lm_pos.cpu().numpy(), lo=lo, hi=hi,
             mesh=np.asarray([mesh.shape["dcn"], mesh.shape["ici"]]),
             n_obs=int(st.n_obs))
    dist.destroy_process_group()


def mesh_nccl_worker(port):
    """NCCL at world size 1: initialize() picks NCCL for the card; one
    all_reduce."""
    import torch
    import torch.distributed as dist

    from plsvo_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", num_processes=1, process_id=0)
    x = torch.arange(4, dtype=torch.float32, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"nccl worker: backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}, all_reduce {x.tolist()}", flush=True)
    if dist.get_backend() != "nccl" or x.tolist() != [0.0, 1.0, 2.0, 3.0]:
        fail("mesh: the NCCL all_reduce at world size 1 went wrong")
    dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(argvs, timeout=240):
    """Start `python3 chip_smoke.py <argv>` for each argv at once; wait for
    all, kill any left at the timeout; returns their outputs."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                              + [str(a) for a in argv],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              stdin=subprocess.DEVNULL) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            fail(f"mesh: worker {p.args[2:]} exited {p.returncode}: "
                 f"{out[-2000:]}")
    return outs


def _mesh_sequences(device, B=2, n=16):
    """tests/test_multi_vo.py's make_sequences at 320x240, rendered by the
    port: sequence b moves 0.025 m sideways and 0.004 b m up per frame."""
    from plsvo_torch.camera import PinholeCamera
    from plsvo_torch.utils import synthetic

    cam = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
    rng = np.random.default_rng(0)
    seqs = []
    for b in range(B):
        scene = synthetic.make_scene(rng, size=1024)
        seqs.append([synthetic.render_aa(
            scene, cam, np.eye(3, dtype=np.float32),
            np.asarray([0.025 * i, 0.004 * b * i, -2.0], np.float32),
            device=device).cpu().numpy() for i in range(n)])
    return cam, seqs


def _run_bvo(bvo, frames_at, n):
    """add_images over n frames and flush(): each sequence's results."""
    got = [[] for _ in bvo.vos]
    for i in range(n):
        for b, r in enumerate(bvo.add_images(frames_at(i), i / 30.0)):
            if r is not None:
                got[b].append(r)
    for rs in bvo.flush():
        for b, r in enumerate(rs):
            if r is not None:
                got[b].append(r)
    return got


def phase_mesh(cam, imgs, gt_centers, device, batched_run):
    """Phase 6e (docstring of the module): (a) dryrun_multichip at 2
    shards on the card; (b) BatchedVO over a 2-shard mesh on the card in
    6b's configuration, MESH_FRAMES frames with the launch counts set to 0
    before and read after, MESH_PROFILED more under torch.profiler,
    flush(), every K2 launch captured; (c) a [card, CPU] mesh, B = 2 at
    320x240; (d) sharded and hierarchical BA at test_ba_scale's full size;
    (e) two gloo processes sharing the card against one process, and NCCL
    at world size 1."""
    import torch

    from plsvo_torch.config import fast_config
    from plsvo_torch.ops import fast_score as fs
    from plsvo_torch.ops import mixed_align as ma
    from plsvo_torch.ops import pose_opt as po
    from plsvo_torch.ops import sparse_align as sa
    from plsvo_torch.parallel import ba, distributed
    from plsvo_torch.parallel.dryrun import dryrun_multichip
    from plsvo_torch.parallel.mesh import Mesh, Shards
    from plsvo_torch.parallel.multi_vo import BatchedVO
    from plsvo_torch.pipeline import fused
    from plsvo_torch.pipeline.frame_handler import STAGE_DEFAULT
    from plsvo_torch.pipeline.state import validate_map
    from plsvo_torch.utils import trajectory

    t_phase = time.perf_counter()
    kind = "mesh"
    out = dict(kind=kind)
    # (a) the production multi-device programs
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_multichip(2, devices=[device, device], reps=2)
    print(f"{kind}: dryrun_multichip(2) on {device} twice in "
          f"{time.perf_counter() - t0:.1f} s; BA chi2 {out['dryrun']['ba_chi2']}",
          flush=True)

    # (b) BatchedVO over two shards of the card, 6b's configuration
    B = BATCH
    cfg = run_config("pipelined")
    frames = uint8_frames(imgs)
    n_all = MESH_FRAMES + MESH_PROFILED
    mesh = Mesh([device, device], ("seq",))
    bvo = BatchedVO(cam, cfg, B, mesh=mesh, axis="seq")
    captured, site, captured_k3, captured_k4 = [], ["other"], [], []
    calls = []

    def k2_capture(args, kwargs):
        captured.append(([a.clone() for a in args], dict(kwargs), site[0]))

    delivered = [[] for _ in range(B)]

    def track(i):
        t1 = time.perf_counter()
        rs = bvo.add_images(staggered(frames, i, B), i / 30.0)
        calls.append(((time.perf_counter() - t1) * 1e3,
                      all(st == STAGE_DEFAULT for st in bvo.stages)))
        for b, r in enumerate(rs):
            if r is not None:
                delivered[b].append(r)

    undo = _patched([(ma, "capture", k2_capture),
                     (sa, "capture", k3_capture_hook(captured_k3, kind)),
                     (po, "capture", k4_capture_hook(captured_k4, kind))]
                    + _site_patches(site))
    try:
        fs.launches = 0
        ma.launches = 0
        sa.launches = 0
        po.launches = 0
        for i in range(MESH_FRAMES):
            track(i)
        launches = {"fast_score": fs.launches, "mixed_align": ma.launches,
                    "sparse_align": sa.launches, "pose_opt": po.launches}
        timed = list(calls)
        wall_ms, busy_ms, n_launch, n_sync, _ = profile_window(
            lambda: [track(i) for i in range(MESH_FRAMES, n_all)])
        for rs in bvo.flush():
            for b, r in enumerate(rs):
                if r is not None:
                    delivered[b].append(r)
    finally:
        undo()
    out.update(captured=captured, captured_k3=captured_k3,
               captured_k4=captured_k4, launches=launches)
    if not launches["fast_score"] or not launches["mixed_align"]:
        fail(f"{kind}: kernel launches of the mesh run {launches}: each "
             "kernel must launch")
    if not isinstance(bvo._mt_stack, Shards) or bvo.unsharded_steps:
        fail(f"{kind}: the batched steps did not run sharded "
             f"({bvo.unsharded_steps} unsharded)")
    engaged = next((i for i, (_, ok) in enumerate(calls) if ok), None)
    carries = bvo.sync_carry()
    ref = {b: {r.frame_id: r for r in batched_run["delivered"][b]}
           for b in range(B)}
    ates, worst = [], 0.0
    for b, vo in enumerate(bvo.vos):
        ids = [r.frame_id for r in delivered[b]]
        if ids != list(range(n_all)):
            fail(f"{kind}: sequence {b} delivered {ids}, not 0..{n_all - 1}")
        st = [r.stage for r in delivered[b]]
        if STAGE_DEFAULT not in st:
            fail(f"{kind}: sequence {b} never reached STAGE_DEFAULT")
        fd = st.index(STAGE_DEFAULT)
        if any(x != STAGE_DEFAULT for x in st[fd:]):
            fail(f"{kind}: sequence {b} left STAGE_DEFAULT after frame {fd}")
        est = _centres(delivered[b][fd:])
        gt = gt_centers[[max(0, f - b) for f in ids[fd:]]]
        ate = trajectory.ate_rmse(est.astype(np.float64), gt.astype(np.float64))
        path = float(np.linalg.norm(np.diff(gt, axis=0), axis=-1).sum())
        if not ate < 0.01 * path:
            fail(f"{kind}: sequence {b} ATE {ate} >= 1% of its path {path}")
        ates.append(100 * ate / path)
        bad = fused.carry_mismatches(carries[b], fused.map_tables_upload(vo.map))
        if bad:
            fail(f"{kind}: sequence {b}'s synced carry differs from its "
                 f"mirror in {bad}")
        errs = validate_map(vo.map)
        if errs:
            fail(f"{kind}: sequence {b} map inconsistent: {errs[:5]}")
        both = [r for r in delivered[b] if r.frame_id in ref[b]]
        if [r.stage for r in both] != [ref[b][r.frame_id].stage for r in both]:
            fail(f"{kind}: sequence {b}'s stages differ from 6b's")
        d = np.linalg.norm(_centres(both) - _centres(
            [ref[b][r.frame_id] for r in both]), axis=-1)
        worst = max(worst, float(d.max()))
        if d.max() >= SOLO_TOL_M:
            fail(f"{kind}: sequence {b} centres {d.max()} m from 6b's "
                 f"unsharded run (limit {SOLO_TOL_M})")
    dflt = [ms for ms, ok in timed if ok]
    steady = dflt[len(dflt) // 2:] if len(dflt) > 6 else dflt
    step_ms = float(np.mean(steady))
    n = MESH_PROFILED
    out.update(fps=B * 1e3 / step_ms, step_ms=step_ms,
               launches_per_step=n_launch / n, syncs_per_step=n_sync / n,
               idle=(100 - 100 * busy_ms / n / step_ms) if busy_ms > 0 else None,
               ates=ates, worst_mm=worst * 1e3, engaged=engaged)
    sites = {}
    for args, _, where in captured:
        key = (where, args[0].shape[0])
        sites[key] = sites.get(key, 0) + 1
    n_rep = (B // 2) * (cfg.caps.max_fts + 2 * cfg.caps.max_segs)
    if sites.get(("reproject", n_rep), 0) < 2 * (MESH_FRAMES - engaged - 1):
        fail(f"{kind}: {sites.get(('reproject', n_rep), 0)} reprojection "
             f"launches of N={n_rep}, not one per shard per batched step")
    out.update(k2_sites=sites, n_rep=n_rep)
    print(f"{kind}: BatchedVO over 2 shards of {device}, B={B}: every "
          f"sequence DEFAULT from call {engaged}, every frame delivered once, "
          f"ATE per sequence (% of its path) "
          + ", ".join(f"{a:.3f}" for a in ates)
          + f", each synced carry equals its mirror, centres within "
          f"{worst * 1e3:.4f} mm of 6b's unsharded run; K1 {launches['fast_score']}"
          f" and K2 {launches['mixed_align']} launches in {MESH_FRAMES} calls; "
          f"K2 by (site, N): {sorted(sites.items())}", flush=True)
    print(f"{kind}: aggregate fps {out['fps']:.2f} (mean call {step_ms:.2f} "
          f"ms over the last half of the all-DEFAULT calls); per batched "
          f"step under torch.profiler: {n_launch / n:.0f} launches, "
          f"{n_sync / n:.1f} host syncs, wall {wall_ms / n:.2f} ms, idle "
          f"{out['idle']}%", flush=True)

    # (c) a mesh of the card and the CPU
    t0 = time.perf_counter()
    cam2, seqs = _mesh_sequences(device)
    cfg2 = fast_config()
    cfg2 = dataclasses.replace(cfg2, pipeline=dataclasses.replace(
        cfg2.pipeline, pipelined=True, pipeline_depth=4))
    mixed_mesh = Mesh([device, "cpu"], ("seq",))
    mixed = BatchedVO(cam2, cfg2, 2, mesh=mixed_mesh)
    got = _run_bvo(mixed, lambda i: [s[i] for s in seqs], 16)
    plain = _run_bvo(BatchedVO(cam2, cfg2, 2, device=device),
                     lambda i: [s[i] for s in seqs], 16)
    if ([part.pt_pos.device for part in mixed._mt_stack]
            != mixed_mesh.local_devices):
        fail(f"{kind}: the [card, CPU] mesh's carries are not on their shards")
    d_mixed = 0.0
    for b in range(2):
        if [r.frame_id for r in got[b]] != list(range(16)):
            fail(f"{kind}: [card, CPU] sequence {b} delivered "
                 f"{[r.frame_id for r in got[b]]}")
        if [r.stage for r in got[b]] != [r.stage for r in plain[b]]:
            fail(f"{kind}: [card, CPU] sequence {b}'s stages differ from "
                 "the card's alone")
        d_mixed = max(d_mixed, float(np.linalg.norm(
            _centres(got[b]) - _centres(plain[b]), axis=-1).max()))
    if d_mixed >= SOLO_TOL_M or got[0][-1].stage != STAGE_DEFAULT:
        fail(f"{kind}: [card, CPU] run {d_mixed} m from the card's alone")
    for vo, carry in zip(mixed.vos, mixed.sync_carry()):
        if fused.carry_mismatches(carry, fused.map_tables_upload(vo.map)):
            fail(f"{kind}: [card, CPU] carry differs from its mirror")
    out["mixed_mm"] = d_mixed * 1e3
    print(f"{kind}: [{device}, cpu] mesh, B=2 at 320x240, 16 frames "
          f"(pipelined, depth 4): every frame once, stages as on the card "
          f"alone, centres within {d_mixed * 1e3:.4f} mm of it, carries equal "
          f"their mirrors; {time.perf_counter() - t0:.1f} s", flush=True)

    # (d) test_ba_scale at its full size
    prob, (Rk, tk, pos) = big_ba_problem(np.random.default_rng(0), **BIG_BA)
    tp = ba.problem_to(prob, device)
    chi_init = float(ba.bundle_adjust(tp, n_iter=0)[1].chi2)
    solvers = {
        "single": lambda: ba.bundle_adjust(tp, n_iter=3),
        "sharded": lambda: ba.bundle_adjust_sharded(
            prob, Mesh([device] * 8, ("lm",)), "lm", n_iter=3),
        "hybrid": lambda: distributed.bundle_adjust_multihost(
            prob, distributed.hybrid_mesh(ici_per_host=4,
                                          devices=[device] * 8), n_iter=3)}
    res, ba_ms = {}, {}
    for name, fn in solvers.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = fn()
        torch.cuda.synchronize()
        ba_ms[name] = (time.perf_counter() - t0) * 1e3
    err0 = np.linalg.norm(prob.lm_pos - pos, axis=-1)
    chi0 = float(res["single"][1].chi2)
    for name, (o, st) in res.items():
        perr = np.linalg.norm(o.kf_t.cpu().numpy() - tk, axis=-1)
        err = np.linalg.norm(o.lm_pos.cpu().numpy() - pos, axis=-1)
        c2 = float(st.chi2)
        if not (c2 <= 0.3 * chi_init and perr.max() < 0.06
                and np.median(perr) < 0.01
                and np.median(err) < 1.25 * np.median(err0)
                and (name == "single" or c2 <= max(chi0 * 1.1, 1e-4 * chi_init)
                     + 1e-9)):
            fail(f"{kind}: {name} BA at K=96, L=50176 misses test_ba_scale's "
                 f"bars: chi2 {c2} (initial {chi_init}, single {chi0}), pose "
                 f"err max {perr.max()} median {np.median(perr)}, landmark "
                 f"median {np.median(err)} (initial {np.median(err0)})")
    out["ba_ms"] = ba_ms
    print(f"{kind}: BA at test_ba_scale's size (K=96, L=50176, O=6, 3 "
          f"iterations) single / 8 shards / (2, 4) hybrid: chi2 "
          + " / ".join(f"{float(res[k][1].chi2):.4e}" for k in res)
          + f" (initial {chi_init:.4e}); ms " + " / ".join(
              f"{ba_ms[k]:.1f}" for k in res) + " (first calls)", flush=True)

    # (e) torch.distributed: two gloo processes sharing the card, and NCCL
    t0 = time.perf_counter()
    small, _ = big_ba_problem(np.random.default_rng(1), K=24, L=4096)
    tmp = os.path.join(OUT_DIR, "mesh_workers")
    os.makedirs(tmp, exist_ok=True)
    prob_path = os.path.join(tmp, "prob.npz")
    np.savez(prob_path, **{k: v for k, v in small._asdict().items()
                           if v is not None})
    port = _free_port()
    outs = [os.path.join(tmp, f"w{r}.npz") for r in range(2)]
    _run_workers([["--mesh-ba-worker", r, 2, port, prob_path, outs[r],
                   device] for r in range(2)])
    ref_p, ref_st = ba.bundle_adjust(ba.problem_to(small, device), n_iter=1)
    ref_t, ref_lm = ref_p.kf_t.cpu().numpy(), ref_p.lm_pos.cpu().numpy()
    w_err = [0.0, 0.0]
    for r in range(2):
        with np.load(outs[r]) as w:
            lo, hi = int(w["lo"]), int(w["hi"])
            w_err = [max(w_err[0], float(np.abs(w["kf_t"] - ref_t).max())),
                     max(w_err[1], float(np.abs(
                         w["lm_local"] - ref_lm[lo:hi]).max()))]
            if (list(w["mesh"]) != [2, 2] or int(w["n_obs"]) !=
                    int(ref_st.n_obs)):
                fail(f"{kind}: gloo worker {r}: mesh {list(w['mesh'])}, n_obs "
                     f"{int(w['n_obs'])} against {int(ref_st.n_obs)}")
    if w_err[0] >= 5e-4 or w_err[1] >= 5e-3:
        fail(f"{kind}: two gloo processes against one: kf_t {w_err[0]}, "
             f"local rows {w_err[1]}")
    nccl = _run_workers([["--mesh-nccl-worker", _free_port()]])[0]
    out["gloo_err"] = w_err
    print(f"{kind}: two gloo processes x 2 shards of {device} against one "
          f"process: kf_t max abs err {w_err[0]:.3e}, local rows "
          f"{w_err[1]:.3e}, n_obs equal; {nccl.strip().splitlines()[-1]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{kind}: phase 6e took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 6f: the JAX package's functions off the tracking path, on copies of
# the lines run's handler at its last frame.
# ---------------------------------------------------------------------------

API_CONVERGE = 5  # point seeds given a tiny variance, so that they converge
API_SITES = ("reproject_segments", "seeds_bucketed")


def _cpu(tree):
    from plsvo_torch.parallel.mesh import tree_map

    return tree_map(lambda a: a.cpu(), tree)


def _api_check(name, out_k, out_c, verdict, uv, uv_atol, extra=()):
    """A function's card result against its CPU result on the same inputs:
    the verdict field equal, the uv field within uv_atol where it holds,
    each (field, atol, rtol) of extra within its bars there. Returns the
    number of rows where the verdict holds."""
    k, c = _cpu(out_k), out_c
    vk, vc = getattr(k, verdict), getattr(c, verdict)
    if not _equal(vk, vc):
        fail(f"api: {name}: {verdict} differs card vs CPU in "
             f"{int((vk != vc).sum())} rows")
    m = vc.bool()
    errs = [f"{uv} {_max_err(getattr(k, uv)[m], getattr(c, uv)[m]):.3e}"]
    if _max_err(getattr(k, uv)[m], getattr(c, uv)[m]) > uv_atol:
        fail(f"api: {name}: {uv} card vs CPU beyond {uv_atol}: {errs[0]}")
    for field, atol, rtol in extra:
        a, b = getattr(k, field), getattr(c, field)
        sel = m & b.isfinite() if field == "zmssd" else m
        if field == "zmssd" and not _equal(a.isinf(), b.isinf()):
            fail(f"api: {name}: inf scores differ card vs CPU")
        bad = (a[sel] - b[sel]).abs() > atol + rtol * b[sel].abs()
        errs.append(f"{field} {_max_err(a[sel], b[sel]):.3e}")
        if bool(bad.any()):
            fail(f"api: {name}: {field} card vs CPU beyond atol {atol} / "
                 f"rtol {rtol} in {int(bad.sum())} rows")
    print(f"api: {name} card vs CPU: {verdict} equal ({int(m.sum())} of "
          f"{len(m)} rows), " + ", ".join(errs), flush=True)
    return int(m.sum())


def _equal(a, b):
    import torch

    return bool(torch.equal(a.cpu(), b.cpu()))


def _max_err(a, b):
    return float((a.cpu() - b.cpu()).abs().max()) if a.numel() else 0.0


def _api_inputs(vo, cur_pyr, n):
    """Direct-match and epipolar inputs from the handler's point landmarks:
    each anchor (keyframe, uv, bearing, level), its range, the relative pose
    of the current frame (the last frame's pose as the prior), its
    projection there, its bordered anchor patch, and the rays of 0.75 and
    1.3 times its range."""
    import torch

    from plsvo_torch.ops import feature_align as fa
    from plsvo_torch.ops import matcher as mt

    m, dev = vo.map, vo.device
    R_c, t_c = vo.last_frame.R_f_w, vo.last_frame.t_f_w
    rows = np.where((m.pt_status > 0)
                    & m.kf_occupied[np.maximum(m.pt_anchor_kf, 0)]
                    & (m.pt_anchor_kf >= 0))[0][:256]
    kf = m.pt_anchor_kf[rows]
    Rk, tk = m.kf_R[kf], m.kf_t[kf]
    centre = -np.einsum("nji,nj->ni", Rk, tk)
    depth = np.linalg.norm(m.pt_pos[rows] - centre, axis=-1)
    R_cr = np.einsum("ij,nkj->nik", R_c, Rk)
    t_cr = t_c[None] - np.einsum("nij,nj->ni", R_cr, tk)
    xyz = m.pt_pos[rows] @ R_c.T + t_c
    z = np.maximum(xyz[:, 2], 1e-6)
    uv_cur = np.stack([vo._fx * xyz[:, 0] / z + vo._cx,
                       vo._fy * xyz[:, 1] / z + vo._cy], -1)
    H, W = cur_pyr[0].shape
    valid = ((xyz[:, 2] > 0.1) & (uv_cur[:, 0] > 8) & (uv_cur[:, 0] < W - 8)
             & (uv_cur[:, 1] > 8) & (uv_cur[:, 1] < H - 8))
    f = m.pt_anchor_f[rows]

    def ray(s):
        return np.einsum("nij,nj->ni", R_cr, f * (depth * s)[:, None]) + t_cr

    def T(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    ref_stack = list(m.kf_pyr[:n])
    N = len(rows)
    lvl = T(m.pt_anchor_level[rows], torch.int32)
    eye = torch.eye(2, device=dev).expand(N, 2, 2)
    pb, pok = mt.warp_patches_affine(ref_stack, T(kf, torch.int32),
                                     T(m.pt_anchor_uv[rows]), lvl, eye,
                                     torch.zeros_like(lvl))
    ref, dx, dy = fa.ref_patch_gradients(pb, 8)
    f_A, f_B = ray(1.3), ray(0.75)
    pA = f_A[:, :2] / f_A[:, 2:3]
    pB = f_B[:, :2] / f_B[:, 2:3]
    return dict(ref_stack=ref_stack, kf=T(kf, torch.int32),
                uv_ref=T(m.pt_anchor_uv[rows]), f_ref=T(f), depth=T(depth),
                level=lvl, R=T(R_cr), t=T(t_cr), uv_cur=T(uv_cur),
                valid=T(valid, torch.bool) & pok, ref=ref, dx=dx, dy=dy,
                f_A=T(f_A), f_B=T(f_B), d_epi=T(pB - pA))


def phase_api(vo_lines, imgs, n_next, device):
    """Phase 6f: copies of the lines run's handler at its last frame (a
    checkpoint loaded on the card and on the CPU), the next frame's image:
    (a) reproject_segments (retry on) with the map's tables, card vs CPU;
    (b) find_match_direct, epipolar_search_zmssd, epipolar_search_zmssd_atlas
    and align1d_atlas on the map's point anchors, card vs CPU at the tests'
    bars; (c) the staged seed path, _update_seeds then _harvest_seeds, at
    the handler's bucket of its live seeds (update_*_seeds_bucketed) with
    API_CONVERGE point seeds made to converge, and on a second copy at the
    next power of two: every candidate landmark finite and on its seed's
    bearing, the two bucket sizes' tables equal; (d) one tracked frame under
    utils.profiling.device_trace, whose Chrome trace must hold a K2 event.
    Every K2 launch of (a) and (c) is captured for phase 7, by call site."""
    import shutil
    import tempfile

    from plsvo_torch.ops import mixed_align as ma
    from plsvo_torch.utils import checkpoint

    t_phase = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="api_", dir=OUT_DIR)
    try:
        path = os.path.join(tmp, "lines.npz")
        checkpoint.save_state(vo_lines, path)
        vo = checkpoint.load_state(path, device=device)
        vo_c = checkpoint.load_state(path, device="cpu")
        captured, site = [], ["other"]

        def k2_capture(args, kwargs):
            if site[0] != "other":
                captured.append(([a.clone() for a in args], dict(kwargs),
                                 site[0]))

        undo = _patched([(ma, "capture", k2_capture)])
        try:
            out = _api_calls(vo, vo_c, imgs, n_next, device, site, tmp)
        finally:
            undo()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = out.pop("launches")
    shapes = {s: sorted({c[0][0].shape[0] for c in captured if c[2] == s})
              for s in API_SITES}
    if launches != {s: sum(c[2] == s for c in captured) for s in API_SITES}:
        fail(f"api: K2's launch count {launches} by call site differs from "
             "its captured launches")
    if launches["seeds_bucketed"] < 2:
        fail(f"api: K2 launched {launches} times by call site; the bucketed "
             "seed updates must launch it at both bucket sizes")
    out.update(kind="api", captured=captured, launches_api=launches,
               shape_api=shapes, seconds=time.perf_counter() - t_phase)
    print(f"api: K2 launches by call site {launches}, N {shapes} "
          f"(reproject_segments refines through align2d_atlas, as the JAX "
          f"function does: no K2 launch); phase 6f took "
          f"{out['seconds']:.1f} s",
          flush=True)
    return out


def _api_calls(vo, vo_c, imgs, n_next, device, site, tmp):
    """phase_api's calls and gates on the card copy vo and the CPU copy
    vo_c of the handler (checkpoint in tmp); site labels K2 launches."""
    import torch

    from plsvo_torch.image import build_pyramid, pack_pyramid_atlas
    from plsvo_torch.ops import feature_align as fa
    from plsvo_torch.ops import matcher as mt
    from plsvo_torch.ops import mixed_align as ma
    from plsvo_torch.pipeline import fused, reprojector
    from plsvo_torch.pipeline.frame_handler import STAGE_DEFAULT
    from plsvo_torch.pipeline.state import FrameState
    from plsvo_torch.utils import checkpoint
    from plsvo_torch.utils.profiling import device_trace

    cfg = vo.cfg
    n = cfg.pipeline.n_pyr_levels
    cam = (vo._fx, vo._fy, vo._cx, vo._cy)
    img = imgs[n_next]
    cur_full = build_pyramid(img, vo.n_levels)
    cur_pyr = cur_full[:n]
    out = {}

    # (a) reproject_segments with the map's line tables
    def segs(h, pyr):
        t = fused.map_tables_from_state(h.map)
        R = torch.as_tensor(h.last_frame.R_f_w, device=h.device)
        tt = torch.as_tensor(h.last_frame.t_f_w, device=h.device)
        return reprojector.reproject_segments(
            t.ln_spos, t.ln_epos, t.ln_status, t.ln_anchor_kf,
            t.ln_anchor_suv, t.ln_anchor_euv, t.ln_anchor_sf, t.ln_anchor_ef,
            t.ln_anchor_level, t.kf_R, t.kf_t, h.map.kf_atlas_flat(n), pyr, R,
            tt, *cam, cell_size=cfg.pipeline.grid_size_segs,
            max_out=cfg.caps.max_segs, retry=True)

    launches = {}
    ma.launches = 0
    site[0] = "reproject_segments"
    try:
        rs = segs(vo, cur_pyr)
    finally:
        site[0] = "other"
    launches["reproject_segments"] = ma.launches
    rs_c = segs(vo_c, _cpu(cur_pyr))
    for name in ("lm_idx", "selected", "matched", "level"):
        if not _equal(getattr(rs, name), getattr(rs_c, name)):
            fail(f"api: reproject_segments {name} differs card vs CPU")
    mk = rs_c.matched
    e_uv = max(_max_err(rs.s_uv[mk.to(device)], rs_c.s_uv[mk]),
               _max_err(rs.e_uv[mk.to(device)], rs_c.e_uv[mk]))
    if int(rs_c.n_attempts) <= 0 or e_uv > 2e-3:
        fail(f"api: reproject_segments: {int(rs_c.n_attempts)} attempts, "
             f"endpoints card vs CPU {e_uv} (atol 2e-3)")
    print(f"api: reproject_segments (retry, N {rs.lm_idx.shape[0]} rows = "
          f"{cfg.caps.max_segs} + {max(cfg.caps.max_segs // 8, 8)}): "
          f"{int(rs_c.n_attempts)} attempts, {int(rs_c.n_matches)} matched "
          f"({int(rs_c.selected[cfg.caps.max_segs:].sum())} runner-ups "
          f"retried), equal card vs CPU, endpoints within {e_uv:.3e} px; K2 "
          f"launches {launches['reproject_segments']}", flush=True)
    out.update(seg_attempts=int(rs_c.n_attempts),
               seg_matches=int(rs_c.n_matches))

    # (b) the per-level matcher, the epipolar searches and align1d_atlas on
    # the map's point anchors
    inp = _api_inputs(vo, cur_pyr, n)
    inp_c = {k: _cpu(v) for k, v in inp.items()}

    def fmd(x, pyr):
        return mt.find_match_direct(
            x["ref_stack"], pyr, x["kf"], x["uv_ref"], x["f_ref"], x["depth"],
            x["level"], x["R"], x["t"], x["uv_cur"], x["valid"], *cam,
            max_level=n - 1)

    def epi(x, pyr):
        return mt.epipolar_search_zmssd(
            pyr, x["ref"], x["f_A"], x["f_B"], x["level"], x["valid"], *cam)

    def epi_atlas(x, pyr):
        return mt.epipolar_search_zmssd_atlas(
            *pack_pyramid_atlas(pyr), x["ref"], x["f_A"], x["f_B"],
            x["level"], x["valid"], *cam)

    def a1d(x, pyr):
        sc = 1.0 / (1 << x["level"].long()).float()[:, None]
        return fa.align1d_atlas(
            *pack_pyramid_atlas(pyr), x["ref"], x["dx"], x["dy"],
            x["uv_cur"] * sc, x["d_epi"], x["level"], x["valid"])

    n_ok = {}
    n_ok["find_match_direct"] = _api_check(
        "find_match_direct", fmd(inp, cur_pyr), fmd(inp_c, _cpu(cur_pyr)),
        "ok", "uv", 2e-3)
    for name, fn in (("epipolar_search_zmssd", epi),
                     ("epipolar_search_zmssd_atlas", epi_atlas)):
        n_ok[name] = _api_check(name, fn(inp, cur_pyr), fn(inp_c,
                                                           _cpu(cur_pyr)),
                                "ok", "uv_level", 1e-3,
                                extra=(("zmssd", 1e-3, 1e-4),))
    n_ok["align1d_atlas"] = _api_check(
        "align1d_atlas", a1d(inp, cur_pyr), a1d(inp_c, _cpu(cur_pyr)),
        "converged", "uv", 2e-3, extra=(("mean_diff", 2e-2, 0.0),))
    if min(n_ok.values()) <= 0:
        fail(f"api: a card-vs-CPU comparison held on no row: {n_ok}")
    out["n_ok"] = n_ok

    # (c) the staged seed path at the handler's bucket and the next power
    # of two (a second copy), API_CONVERGE point seeds made to converge
    path = os.path.join(tmp, "lines.npz")
    vo2 = checkpoint.load_state(path, device=device)
    vo2._bucket = lambda k, cap: 2 * type(vo)._bucket(k, cap)
    frame_id = vo.frame_id
    pr = np.where(vo._seed_alive)[0][:API_CONVERGE]
    if len(pr) < API_CONVERGE:
        fail(f"api: {len(pr)} live point seeds, fewer than {API_CONVERGE}")
    pt_before = vo.map.pt_status > 0
    ma.launches = 0
    for h in (vo, vo2):
        h.pt_seeds = h.pt_seeds._replace(sigma2=h.pt_seeds.sigma2.index_fill(
            0, torch.as_tensor(pr, device=device), 1e-12))
        frame = FrameState.empty(cfg, frame_id, frame_id / 30.0, cur_full,
                                 h.last_frame.R_f_w, h.last_frame.t_f_w)
        site[0] = "seeds_bucketed"
        try:
            h._update_seeds(frame)
        finally:
            site[0] = "other"
        h._harvest_seeds()
    launches["seeds_bucketed"] = ma.launches
    for a, b, what in ((vo.pt_seeds, vo2.pt_seeds, "point"),
                       (vo.ln_seeds, vo2.ln_seeds, "line")):
        if not _equal(a.alive, b.alive):
            fail(f"api: {what} seeds alive differ between the two buckets")
        for x, y in zip(a, b):
            if x.is_floating_point() and not bool(torch.allclose(
                    x, y, rtol=1e-4, atol=1e-6, equal_nan=True)):
                fail(f"api: {what} seed tables differ between the two buckets")
    m = vo.map
    new = np.where((m.pt_status > 0) & ~pt_before)[0]
    if len(new) < API_CONVERGE:
        fail(f"api: the harvest made {len(new)} candidate points, fewer than "
             f"the {API_CONVERGE} converged seeds")
    worst = 0.0
    for i in new:
        k = m.pt_anchor_kf[i]
        p = m.kf_R[k] @ m.pt_pos[i] + m.kf_t[k]
        if not (np.isfinite(p).all() and p[2] > 0):
            fail(f"api: candidate point {i} at {m.pt_pos[i]} is not finite "
                 "and in front of its keyframe")
        worst = max(worst, float(np.abs(p / np.linalg.norm(p)
                                        - m.pt_anchor_f[i]).max()))
    if worst > 1e-4:
        fail(f"api: a candidate point lies {worst} off its seed's bearing")
    print(f"api: _update_seeds + _harvest_seeds at buckets of "
          f"{vo._bucket(int(vo._seed_alive.sum()), cfg.caps.max_seeds)} and "
          f"its double: seed tables equal, {len(new)} candidate points made "
          f"(finite, on their seeds' bearings within {worst:.2e}), "
          f"seed_starved {vo.permon.logs.get('seed_starved')}", flush=True)
    out.update(n_candidates=len(new), launches=launches)

    # (d) one tracked frame under device_trace
    with device_trace(os.path.join(tmp, "trace")) as prof:
        r = vo.add_image(img, n_next / 30.0)
    with open(prof.trace_path) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    size = os.path.getsize(prof.trace_path)
    if r.stage != STAGE_DEFAULT or not any("mixed_align_kernel" in x
                                           for x in names):
        fail(f"api: the traced frame's stage {r.stage}; a mixed_align_kernel "
             f"event in its trace: {any('mixed_align' in x for x in names)}")
    print(f"api: device_trace of a tracked frame: {size / 1e6:.1f} MB Chrome "
          f"trace with {len(names)} event names, mixed_align_kernel among "
          "them", flush=True)
    return out


def phase_k1_batched(k1_inputs):
    """K1 at the batched detection's shapes: the largest captured batch of
    R x levels pyramid images, kernel (one launch per 32 images) against
    the plain twin: masks equal, scores within rtol 1e-4 / atol 1e-3 more
    than 8 px from the border; then its per-call, device and plain times
    and its bound."""
    import torch

    from plsvo_torch.ops import fast_score as fs

    if not k1_inputs:
        fail("K1: no batched keyframe detection was captured")
    ims = max(k1_inputs, key=len)
    before = fs.launches
    outs = fs.fast_score_levels_cuda(ims, 10.0)
    n_launch = fs.launches - before
    if n_launch != -(-len(ims) // 32):
        fail(f"K1: {len(ims)} images took {n_launch} launches")
    worst = 0.0
    for im, (m_k, s_k) in zip(ims, outs):
        m_p, s_p = fs.fast_score_plain(im, 10.0)
        if not bool((m_k == m_p).all()):
            fail(f"K1 batched {tuple(im.shape)}: masks differ in "
                 f"{int((m_k != m_p).sum())} pixels")
        d = (s_k - s_p)[8:-8, 8:-8].abs()
        lim = 1e-3 + 1e-4 * s_p[8:-8, 8:-8].abs()
        if not bool((d <= lim).all()):
            fail(f"K1 batched {tuple(im.shape)}: score off by "
                 f"{float(d.max())} away from the border")
        worst = max(worst, float(d.max()))
    torch.cuda.synchronize()
    px = sum(im.numel() for im in ims)
    f = lambda: fs.fast_score_levels_cuda(ims, 10.0)  # noqa: E731
    ms = cuda_time_ms(f, reps=10, inner=5)
    dev = kernel_device_ms(f, "fast_score_kernel")
    plain = cuda_time_ms(lambda: [fs.fast_score_plain(im, 10.0) for im in ims],
                         reps=3, inner=2)
    t_bytes = px * K1_BYTES_PER_PX / HBM_BYTES_PER_S
    t_ops = px * K1_OPS_PER_PX / F32_OPS_PER_S
    bound = 1e3 * max(t_bytes, t_ops)
    shapes = [list(im.shape) for im in ims]
    print(f"K1 batched detection: {len(ims)} images ({px} px) in {n_launch} "
          f"launch(es), masks equal, score max abs err {worst:.3e} away from "
          f"the border; kernel {ms:.4f} ms per call (device {dev:.4f} ms per "
          f"launch), plain {plain:.4f} ms, bound {bound:.5f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'})", flush=True)
    return dict(n_images=len(ims), shapes=shapes, ms=ms, kernel_ms=dev,
                plain_ms=plain, bound_ms=bound, max_abs_err=worst,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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


def k2_site_timings(runs):
    """K2's device time depends on the data (the warp leaves once its rows
    are inactive): the captured launches of each (name, run) of runs,
    replayed, by call site and N. Prints, per group, its launch count and
    for the launch with the most valid rows its device, per-call, plain
    and bound times, and the median and max device time over the group's
    launches. Returns {(name, site, N): (median, max) device ms}."""
    from plsvo_torch.ops import mixed_align as ma

    k2_run = {}
    for run, res in runs:
        groups = {}
        for c in res["captured"]:
            groups.setdefault((c[2], c[0][0].shape[0]), []).append(c)
        for (where, n), group in sorted(groups.items()):
            # the launch of the group with the most valid rows
            hard = max(range(len(group)),
                       key=lambda i: int(group[i][0][12].sum()))
            a, k, _ = group[hard]
            f2 = lambda: ma.mixed_align_cuda(*a, **k)  # noqa: E731
            dev = calls_device_ms([lambda a=a, k=k: ma.mixed_align_cuda(*a, **k)
                                   for a, k, _ in group], "mixed_align_kernel")
            d_hard = dev[hard]
            b_ms, b_by = k2_bound_ms(a, k2_active_row_iters(a, k))
            p_ms = cuda_time_ms(lambda: ma.mixed_align_plain(*a, **k), reps=3,
                                inner=2)
            k2_run[(run, where, n)] = (float(np.median(dev)), max(dev))
            print(f"timing: K2 {run} run, {where} N={n}: {len(group)} "
                  f"launches (captured); the one with the most valid rows "
                  f"({int(a[12].sum())}): device {d_hard:.4f} ms, kernel "
                  f"{cuda_time_ms(f2):.4f} ms per call, plain {p_ms:.4f} ms "
                  f"per call, bound {b_ms:.6f} ms "
                  f"({b_by}; {100 * b_ms / d_hard:.1f}% of its device "
                  f"time); device over the launches: median "
                  f"{k2_run[(run, where, n)][0]:.4f} ms, max "
                  f"{k2_run[(run, where, n)][1]:.4f} ms", flush=True)
    return k2_run


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
    scli = phase_cli(device, imgs[:2])
    # no profiler session before these: one slows the host work after it
    soaks = [phase_soak(device, PIPE_DEPTH, False,
                        ransac_draws=reference_ransac_draws),
             phase_soak(device, 4, True)]
    phase_streams(cam, imgs, device)
    spp = phase_pipelined(cam, imgs, gt, device, n_main, sl)
    sb8 = phase_batched(cam, imgs, gt, device, n_main)
    smesh = phase_mesh(cam, imgs, gt, device, sb8)
    sapi = phase_api(sl["vo"], imgs, n_main, device)
    k2 = phase_k2([c + (r["kind"],) for r in (sl, sp, so, spp, sb8, smesh,
                                              sapi)
                   for c in r["captured"]])
    k3 = phase_k3([c for r in (sl, sp, so, spp, sb8, smesh)
                   for c in r["captured_k3"]])
    k4 = phase_k4([c for r in (sl, sp, so, spp, sb8, smesh)
                   for c in r["captured_k4"]])
    k1b = phase_k1_batched(sb8["k1_inputs"])
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
    k2_run = k2_site_timings((("lines", sl), ("points", sp),
                              ("lineonly", so), ("batched", sb8),
                              ("mesh", smesh), ("api", sapi)))
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
    # K2 at the batched reprojection's shape: the B x 384-row launch with
    # the most valid rows
    n_k2b = BATCH * n_k2
    reproj_b = [c for c in sb8["captured"]
                if c[2] == "reproject" and c[0][0].shape[0] == n_k2b]
    if not reproj_b:
        fail(f"K2 captured no batched reprojection launch at N={n_k2b}")
    args_b, kw_b, _ = max(reproj_b, key=lambda c: int(c[0][12].sum()))
    k2b_ms = cuda_time_ms(lambda: ma.mixed_align_cuda(*args_b, **kw_b))
    k2b_dev = kernel_device_ms(lambda: ma.mixed_align_cuda(*args_b, **kw_b),
                               "mixed_align_kernel")
    k2b_plain = cuda_time_ms(lambda: ma.mixed_align_plain(*args_b, **kw_b),
                             reps=5, inner=2)
    k2b_bound, k2b_by = k2_bound_ms(args_b, k2_active_row_iters(args_b, kw_b))
    print(f"timing: K2 batched reprojection N={n_k2b} ({int(args_b[12].sum())} "
          f"valid rows) kernel {k2b_ms:.4f} ms per call (device {k2b_dev:.4f} "
          f"ms), plain {k2b_plain:.4f} ms, bound {k2b_bound:.6f} ms ({k2b_by}; "
          f"{100 * k2b_bound / k2b_dev:.1f}% of its device time)", flush=True)

    # K3 at the lines run's last captured call (B = 1) and at the batched
    # run's (B = BATCH): per call, device, plain, bound
    from plsvo_torch.ops import pose_opt as po
    from plsvo_torch.ops import sparse_align as sa

    k3_t = {}
    for run, res in (("lines", sl), ("batched", sb8)):
        # the last captured call of the largest batch
        a3, kw3, _ = max(reversed(res["captured_k3"]),
                         key=lambda c: c[0][4].shape[0])
        f3 = lambda a3=a3, kw3=kw3: sa.sparse_img_align_cuda(*a3, **kw3)  # noqa: E731
        it3 = f3()[0].iters
        bound3, by3 = k3_bound_ms(a3, kw3, it3)
        k3_t[run] = dict(
            B=int(a3[4].shape[0]), iters=it3.sum(-1).tolist(),
            ms=cuda_time_ms(f3), kernel_ms=kernel_device_ms(
                f3, "sparse_align_kernel"),
            plain_ms=cuda_time_ms(
                lambda a3=a3, kw3=kw3: sa.sparse_img_align_plain(*a3, **kw3),
                reps=5, inner=2), bound_ms=bound3, bound_by=by3)
        e = k3_t[run]
        print(f"timing: K3 {run} call (B={e['B']}, iterations per sequence "
              f"{e['iters']}): kernel {e['ms']:.4f} ms per call (device "
              f"{e['kernel_ms']:.4f} ms), plain {e['plain_ms']:.4f} ms, bound "
              f"{bound3:.6f} ms ({by3}; {100 * bound3 / e['kernel_ms']:.2f}% of "
              f"its device time)", flush=True)

    # K4 at the lines run's last captured call (B = 1) and at the batched
    # run's (B = BATCH): per call, device, plain, bound
    k4_t = {}
    for run, res in (("lines", sl), ("batched", sb8)):
        a4, kw4, _ = max(reversed(res["captured_k4"]),
                         key=lambda c: c[0][1].shape[0])
        f4 = lambda a4=a4, kw4=kw4: po.optimize_pose_cuda(*a4, **kw4)  # noqa: E731
        it4 = f4()[1]
        bound4, by4 = k4_bound_ms(a4, it4)
        k4_t[run] = dict(
            B=int(a4[1].shape[0]), iters=it4.tolist(),
            ms=cuda_time_ms(f4), kernel_ms=kernel_device_ms(
                f4, "pose_opt_kernel"),
            plain_ms=cuda_time_ms(
                lambda a4=a4, kw4=kw4: po.optimize_pose_plain(*a4, **kw4),
                reps=5, inner=2), bound_ms=bound4, bound_by=by4)
        e = k4_t[run]
        print(f"timing: K4 {run} call (B={e['B']}, iterations per sequence "
              f"and pass {e['iters']}): kernel {e['ms']:.4f} ms per call "
              f"(device {e['kernel_ms']:.4f} ms), plain {e['plain_ms']:.4f} "
              f"ms, bound {bound4:.6f} ms ({by4}; {100 * bound4 / e['kernel_ms']:.2f}% "
              f"of its device time)", flush=True)

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
    # "launches_pipelined" the other three runs; "launches_batched" the
    # batched run's n_main frames (BATCH sequences, vmap mode),
    # "launches_mesh" the mesh run's MESH_FRAMES (the batch over two shards
    # of the card; "shape_mesh" K2's per-shard reprojection N), and the
    # "_batched" times are at that run's shapes (K1: the largest batched
    # keyframe detection; K2: the B x 384-row reprojection launch with the
    # most valid rows); K2's "launches_api" counts phase 6f's launches by
    # call site and "shape_api" their N.
    report = {"kernels": [
        {"name": "fast_score", "route": "cuda",
         "source": "plsvo_torch/csrc/fast_score.cu",
         "replaces": "plsvo_tpu/ops/pallas_fast.py:117",
         "launches": sl["launches"]["fast_score"],
         "launches_per_frame": sl["launches"]["fast_score"] / nf,
         "launches_points_only": sp["launches"]["fast_score"],
         "launches_line_only": so["launches"]["fast_score"],
         "launches_pipelined": spp["launches"]["fast_score"],
         "launches_cli": scli["launches"]["fast_score"],
         "max_abs_err": k1_abs, "max_abs_err_kind": "abs_score",
         "max_err": k1_rel, "max_err_kind": "rel_score",
         "ms": k1_ms, "kernel_ms": k1_dev, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "shape": levels,
         "launches_batched": sb8["launches"]["fast_score"],
         "launches_mesh": smesh["launches"]["fast_score"],
         "shape_batched": k1b["shapes"], "ms_batched": k1b["ms"],
         "kernel_ms_batched": k1b["kernel_ms"],
         "plain_ms_batched": k1b["plain_ms"],
         "bound_ms_batched": k1b["bound_ms"],
         "max_abs_err_batched": k1b["max_abs_err"]},
        {"name": "mixed_align", "route": "cuda",
         "source": "plsvo_torch/csrc/mixed_align.cu",
         "replaces": "plsvo_tpu/ops/pallas_align.py:163",
         "launches": sl["launches"]["mixed_align"],
         "launches_per_frame": sl["launches"]["mixed_align"] / nf,
         "launches_points_only": sp["launches"]["mixed_align"],
         "launches_line_only": so["launches"]["mixed_align"],
         "launches_pipelined": spp["launches"]["mixed_align"],
         "launches_cli": scli["launches"]["mixed_align"],
         "max_abs_err": k2_uv, "max_abs_err_kind": "abs_uv_px",
         "max_err": k2_md, "max_err_kind": "abs_mean_diff",
         "ms": k2_ms, "kernel_ms": k2_dev, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "rows_stopped_an_update_apart": sum(e[4] for e in k2.values()),
         "kernel_ms_run_median": k2_run[("lines", "reproject", n_k2)][0],
         "kernel_ms_run_max": k2_run[("lines", "reproject", n_k2)][1],
         "shape": [n_k2],
         "launches_batched": sb8["launches"]["mixed_align"],
         "launches_mesh": smesh["launches"]["mixed_align"],
         "shape_mesh": [smesh["n_rep"]],
         "shape_batched": [n_k2b], "ms_batched": k2b_ms,
         "kernel_ms_batched": k2b_dev, "plain_ms_batched": k2b_plain,
         "bound_ms_batched": k2b_bound, "bound_by_batched": k2b_by,
         "launches_api": sapi["launches_api"],
         "shape_api": sapi["shape_api"]},
        {"name": "sparse_align", "route": "cuda",
         "source": "plsvo_torch/csrc/sparse_align.cu",
         "replaces": "the XLA while_loop of plsvo_tpu/ops/sparse_align.py:262 "
                     "(no Pallas kernel)",
         "launches": sl["launches"]["sparse_align"],
         "launches_per_frame": sl["launches"]["sparse_align"] / nf,
         "launches_points_only": sp["launches"]["sparse_align"],
         "launches_line_only": so["launches"]["sparse_align"],
         "launches_pipelined": spp["launches"]["sparse_align"],
         "launches_batched": sb8["launches"]["sparse_align"],
         "launches_mesh": smesh["launches"]["sparse_align"],
         "max_abs_err": max(e[1] for e in k3.values()),
         "max_abs_err_kind": "rot_rad",
         "max_err": max(e[2] for e in k3.values()), "max_err_kind": "abs_t",
         "calls_iters_differ": sum(e[3] for e in k3.values()),
         "calls_checked": sum(e[0] for e in k3.values()),
         "ms": k3_t["lines"]["ms"], "kernel_ms": k3_t["lines"]["kernel_ms"],
         "plain_ms": k3_t["lines"]["plain_ms"],
         "bound_ms": k3_t["lines"]["bound_ms"],
         "bound_by": k3_t["lines"]["bound_by"], "library_ms": None,
         "shape": [k3_t["lines"]["B"]],
         "shape_batched": [k3_t["batched"]["B"]],
         "ms_batched": k3_t["batched"]["ms"],
         "kernel_ms_batched": k3_t["batched"]["kernel_ms"],
         "plain_ms_batched": k3_t["batched"]["plain_ms"],
         "bound_ms_batched": k3_t["batched"]["bound_ms"]},
        {"name": "pose_opt", "route": "cuda",
         "source": "plsvo_torch/csrc/pose_opt.cu",
         "replaces": "the XLA while_loop of plsvo_tpu/ops/pose_opt.py:217 "
                     "(no Pallas kernel)",
         "launches": sl["launches"]["pose_opt"],
         "launches_per_frame": sl["launches"]["pose_opt"] / nf,
         "launches_points_only": sp["launches"]["pose_opt"],
         "launches_line_only": so["launches"]["pose_opt"],
         "launches_pipelined": spp["launches"]["pose_opt"],
         "launches_batched": sb8["launches"]["pose_opt"],
         "launches_mesh": smesh["launches"]["pose_opt"],
         "max_abs_err": max(e[1] for e in k4.values()),
         "max_abs_err_kind": "rot_rad",
         "max_err": max(e[2] for e in k4.values()), "max_err_kind": "abs_t",
         "calls_iters_differ": sum(e[3] for e in k4.values()),
         "rows_apart_at_threshold": sum(e[4] for e in k4.values()),
         "calls_checked": sum(e[0] for e in k4.values()),
         "ms": k4_t["lines"]["ms"], "kernel_ms": k4_t["lines"]["kernel_ms"],
         "plain_ms": k4_t["lines"]["plain_ms"],
         "bound_ms": k4_t["lines"]["bound_ms"],
         "bound_by": k4_t["lines"]["bound_by"], "library_ms": None,
         "shape": [k4_t["lines"]["B"]],
         "shape_batched": [k4_t["batched"]["B"]],
         "ms_batched": k4_t["batched"]["ms"],
         "kernel_ms_batched": k4_t["batched"]["kernel_ms"],
         "plain_ms_batched": k4_t["batched"]["plain_ms"],
         "bound_ms_batched": k4_t["batched"]["bound_ms"]},
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
          f"{sl['bench_mean']:.2f} / {sl['bench_p90']:.2f} ms; batched run "
          f"(B={BATCH}, vmap, depth {PIPE_DEPTH}) {sb8['fps']:.2f} aggregate "
          f"fps (B / the pipelined run's mean: "
          f"{BATCH * 1e3 / spp['bench_mean']:.2f}), "
          f"{sb8['launches_per_step']:.0f} launches and "
          f"{sb8['syncs_per_step']:.1f} host syncs per batched step, idle "
          f"{sb8['idle']}%; mesh run (the batch over 2 shards of the card) "
          f"{smesh['fps']:.2f} aggregate fps, {smesh['launches_per_step']:.0f} "
          f"launches and {smesh['syncs_per_step']:.1f} host syncs per batched "
          f"step, phase 6e {smesh['seconds']:.1f} s; soaks " + ", ".join(
              f"depth {k['depth']}{' with blackout' if k['blackout'] else ''}: "
              f"{k['evictions']} keyframe evictions, tail ATE {k['ate']}"
              for k in soaks) + f"; cli run (python -m plsvo_torch.run_pipeline "
          f"--local-ba, {CLI_FRAMES} frames) ATE {scli['ate']:.6f} m "
          f"({100 * scli['ate'] / scli['path']:.3f}% of the path), per-frame ms "
          f"median {scli['ms_median']:.2f} p90 {scli['ms_p90']:.2f}, decoder "
          f"{scli['decoder']}, ATAN ATE {scli['atan_ate']:.6f} m, phase "
          f"{scli['seconds']:.1f} s", flush=True)
    print(json.dumps(report), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-ba-worker"]:
        mesh_ba_worker(*sys.argv[2:])
    elif sys.argv[1:2] == ["--mesh-nccl-worker"]:
        mesh_nccl_worker(*sys.argv[2:])
    else:
        main()
