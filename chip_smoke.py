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
  5. runs    — FrameHandlerMono on the 752x480 plane sequence at half the
               bench's speed (RUN_STEP), default capacities, sync path
               without local BA: first points + lines on 40 frames (the
               main path), then points only on 24 frames at the bench's
               own speed;
               each run first in an untimed pass that captures every K2
               launch's inputs (tagged by call site), then timed, with the
               launch counts set to 0 just before the timed run and read
               just after it. Gates: DEFAULT reached and kept, ATE < 1% of
               the path, one K1 launch per keyframe detection; with lines
               also line seeds installed at keyframes, at least one line
               landmark made from a converged seed, and a median segment
               match count > 0 after the first line landmark
  6. K2      — the mixed-align GN kernel vs its plain twin on the inputs of
               every launch of both capture passes
  7. profile — 5 more frames of the lines run with each stage timed between
               two synchronisations, then 5 under torch.profiler: device
               busy share, kernel launches (per frame and per stage), host
               syncs, top device ops
  8. timing  — K1's three-level launch (device time, per-call time, bound)
               and each level alone; K2 at the reprojection's N=384 launch
               with the most valid rows (device, per-call, bound) and its
               device time at every call site and N of the lines run;
               detect_fast_grid's, detect_segments_tiled's and
               align_mixed_atlas's per-call times
  9. report  — one JSON line per the kernel report format, the card line,
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


def bench_sequence(n_frames, device, step=0.03):
    """The bench.py plane sequence (step m of sideways travel per frame),
    rendered by the port."""
    from plsvo_torch.camera import PinholeCamera
    from plsvo_torch.utils import synthetic

    W, H = 752, 480
    cam = PinholeCamera.create(W, H, 460.0, 460.0, W / 2, H / 2)
    scene = synthetic.make_scene(np.random.default_rng(3), size=2048,
                                 texel_size=0.003)
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


def slice_config(lines: bool):
    from plsvo_torch.config import default_config

    cfg = default_config()
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, has_ls=lines, init_ls=lines, loba_enabled=False,
        pipelined=False))


def _call_sites():
    """(owner, attribute, site) of the main path's K2 call sites."""
    from plsvo_torch.ops import depth_filter
    from plsvo_torch.pipeline import reprojector

    return [(reprojector, "reproject_combined", "reproject"),
            (reprojector, "reproject_points", "reproject"),
            (depth_filter, "update_seeds_combined", "seeds")]


def phase_run(name, cam, imgs, gt_centers, device, n_main, lines):
    """One run of the slice config (lines on or off): an untimed capture
    pass, then the timed run with fresh launch counts."""
    import torch

    from plsvo_torch.ops import depth_filter, matcher
    from plsvo_torch.ops import fast_score as fs
    from plsvo_torch.ops import mixed_align as ma
    from plsvo_torch.pipeline.frame_handler import (STAGE_DEFAULT,
                                                    FrameHandlerMono)
    from plsvo_torch.pipeline.state import MapState
    from plsvo_torch.utils import trajectory

    cfg = slice_config(lines)
    captured = []  # (args, kwargs, site) of every K2 launch of the capture pass
    atlas_calls = []  # (args, kwargs) of a reprojection align_mixed_atlas
    site = ["other"]

    def capture(args, kwargs):
        captured.append(([a.clone() for a in args], dict(kwargs), site[0]))

    def capture_atlas(orig):
        def wrapped(*a, **k):
            if not atlas_calls and a[3].shape[0] == cfg.caps.max_fts:
                atlas_calls.append(([x.clone() if torch.is_tensor(x) else x
                                     for x in a], dict(k)))
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

    # capture pass: the same frames through a handler of its own, untimed,
    # so that the timed run below carries no capture copies
    saved = [(m, "align_mixed_atlas", m.align_mixed_atlas)
             for m in (matcher, depth_filter)]
    saved += [(o, a, getattr(o, a)) for o, a, _ in _call_sites()]
    for m, _, orig in saved[:2]:
        m.align_mixed_atlas = capture_atlas(orig)
    for (o, a, label), (_, _, orig) in zip(_call_sites(), saved[2:]):
        setattr(o, a, at_site(orig, label))
    ma.capture = capture
    try:
        cap_vo = FrameHandlerMono(cam, cfg, device=device)
        for i in range(n_main):
            cap_vo.add_image(imgs[i], i / 30.0)
    finally:
        ma.capture = None
        for o, a, orig in saved:
            setattr(o, a, orig)
    del cap_vo

    created = []  # frame of every line landmark made from a converged seed
    frame_now = [-1]
    orig_new_line = MapState.new_line

    def counting_new_line(self, *a, **k):
        r = orig_new_line(self, *a, **k)
        if r >= 0:
            created.append(frame_now[0])
        return r

    vo = FrameHandlerMono(cam, cfg, device=device)
    results, ms = [], []
    k1_at_kf, ln_installs = [], []
    MapState.new_line = counting_new_line
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
        MapState.new_line = orig_new_line
    gt_centers = gt_centers[:n_main]
    stages = [r.stage for r in results]
    print(f"{name} stages:", " ".join(s[0] for s in stages), flush=True)
    if STAGE_DEFAULT not in stages:
        fail(f"{name}: never reached STAGE_DEFAULT")
    fd = stages.index(STAGE_DEFAULT)
    if any(s != STAGE_DEFAULT for s in stages[fd:]):
        fail(f"{name}: tracking left STAGE_DEFAULT after frame {fd}: {stages[fd:]}")
    if len(stages) - fd < 10:
        fail(f"{name}: only {len(stages) - fd} DEFAULT frames")
    est = np.stack([-r.R_f_w.T @ r.t_f_w for r in results[fd:]])
    gt = gt_centers[fd:]
    if not np.isfinite(est).all():
        fail(f"{name}: non-finite camera centres")
    ate = trajectory.ate_rmse(est.astype(np.float64), gt.astype(np.float64))
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=-1).sum())
    n_kf = sum(r.is_keyframe for r in results)
    tail = ms[fd + 5:]
    print(f"{name}: DEFAULT from frame {fd}, {len(results) - fd} tracked frames, "
          f"{n_kf} keyframes, {vo.map.n_keyframes()} in the map, "
          f"{int((vo.map.pt_status > 0).sum())} point landmarks, median point "
          f"matches {np.median([r.n_pt_matches for r in results[fd:]]):.0f}",
          flush=True)
    print(f"{name}: Sim3 ATE {ate:.6f} m over a {path:.3f} m path "
          f"({100 * ate / path:.3f}%)", flush=True)
    print(f"{name}: per-frame ms (DEFAULT frames after the first 5, n={len(tail)}): "
          f"median {np.median(tail):.2f}, p90 {np.percentile(tail, 90):.2f}",
          flush=True)
    print(f"{name}: launches {launches}; K1 launches at DEFAULT keyframes "
          f"{k1_at_kf}", flush=True)
    if ate >= 0.01 * path:
        fail(f"{name}: ATE {ate} >= 1% of the path length {path}")
    if launches["fast_score"] <= 0 or launches["mixed_align"] <= 0:
        fail(f"{name}: a kernel of the path never launched: {launches}")
    if not k1_at_kf or any(k != 1 for k in k1_at_kf):
        fail(f"{name}: K1 launches per tracked keyframe are {k1_at_kf}, not one each")
    seg_med = None
    if lines:
        seg = [r.n_seg_matches for r in results]
        print(f"{name}: line seeds installed at the keyframes {ln_installs}; "
              f"{len(created)} line landmarks made from converged seeds (first "
              f"at frame {created[0] if created else None}), "
              f"{int((vo.map.ln_status > 0).sum())} live at the end; segment "
              f"matches per frame {seg}", flush=True)
        if not ln_installs or sum(ln_installs[1:]) <= 0:
            fail(f"{name}: no line seed installed at a tracked keyframe: "
                 f"{ln_installs}")
        if not created:
            fail(f"{name}: no line landmark was made from a converged seed")
        after = [n for r, n in zip(results, seg)
                 if r.stage == STAGE_DEFAULT and r.frame_id > created[0]]
        seg_med = float(np.median(after)) if after else 0.0
        print(f"{name}: median segment matches over the {len(after)} tracked "
              f"frames after the first line landmark: {seg_med:.1f} (over all "
              f"tracked frames {np.median(seg[fd:]):.1f})", flush=True)
        if seg_med <= 0:
            fail(f"{name}: median segment matches after the first line "
                 f"landmark is {seg_med}")
    # per-stage host wall time (stage timers of the frame handler) over the
    # same frames as the per-frame ms
    vo.permon.finish()
    recs = [r for r in vo.permon.frames if r["frame"] >= fd + 5]
    keys = sorted({k for r in recs for k in r if k.startswith("t_")})
    stage_ms = {k[2:]: (1e3 * float(np.median([r.get(k, 0.0) for r in recs])),
                        1e3 * float(np.mean([r.get(k, 0.0) for r in recs])))
                for k in keys}
    print(f"{name}: per-stage host ms (median, mean): " + ", ".join(
        f"{k} {a:.2f}/{b:.2f}" for k, (a, b) in stage_ms.items()), flush=True)
    return dict(vo=vo, launches=launches, n_frames=len(results),
                captured=captured, atlas_calls=atlas_calls, ate=ate, path=path,
                ms_median=float(np.median(tail)),
                ms_p90=float(np.percentile(tail, 90)), seg_median=seg_med,
                n_lines_made=len(created))


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


def phase_k2(captured):
    """Every captured launch re-run by the kernel and by the plain twin on
    the card. Returns {N: (launches, launches with valid rows, uv err,
    mean_diff err)}."""
    import torch

    from plsvo_torch.ops import mixed_align as ma

    if not captured:
        fail("K2 captured no launch of the slice")
    out = {}
    for args, kw, _ in captured:
        n = args[0].shape[0]
        uv_k, c_k, md_k = ma.mixed_align_cuda(*args, **kw)
        uv_p, c_p, md_p = ma.mixed_align_plain(*args, **kw)
        torch.cuda.synchronize()
        if not bool((c_k == c_p).all()):
            fail(f"K2 converged verdicts differ at N={n}: "
                 f"{int((c_k != c_p).sum())} rows")
        both = c_k & c_p
        uv_err = float((uv_k - uv_p)[both].abs().max()) if both.any() else 0.0
        md_err = float((md_k - md_p)[both].abs().max()) if both.any() else 0.0
        if uv_err > 2e-3 or md_err > 2e-2:
            fail(f"K2 N={n}: uv err {uv_err} (atol 2e-3), md err {md_err} "
                 "(atol 2e-2)")
        k, kv, ue, me = out.get(n, (0, 0, 0.0, 0.0))
        out[n] = (k + 1, kv + int(bool(args[12].any())), max(ue, uv_err),
                  max(me, md_err))
    for n, (k, kv, ue, me) in sorted(out.items()):
        print(f"K2 N={n}: verdicts equal in all {k} launches ({kv} with valid "
              f"rows), uv max abs err {ue:.3e}, mean_diff max abs err "
              f"{me:.3e}", flush=True)
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
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + n_win):
            vo.add_image(imgs[i], i / 30.0)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    undo()
    ev = prof.key_averages()

    def count(name):
        return sum(e.count for e in ev if e.key == name)

    # device activity: kernels and copies as the card ran them (the stage
    # labels' device-side ranges and the CPU ops' attributed times would
    # count the same work twice)
    dev_ev = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.name.startswith("stage:")]
    n = n_win
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    launch_names = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")
    launches = sum(count(k) for k in launch_names)
    syncs = count("aten::_local_scalar_dense")
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
        if e.name in launch_names:
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
    n_main, n_pts, n_win = 40, 24, 5
    cam, imgs, gt = bench_sequence(n_main + 2 * n_win, device, step=RUN_STEP)
    _, imgs_p, gt_p = bench_sequence(n_pts, device)
    torch.cuda.synchronize()
    print(f"rendered {imgs.shape[0]} + {imgs_p.shape[0]} frames "
          f"{tuple(imgs.shape[1:])} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    pyr0, k1_abs, k1_rel = phase_k1(imgs[0], device)
    phase_lines(imgs[0], device)
    sl = phase_run("lines", cam, imgs, gt, device, n_main, lines=True)
    sp = phase_run("points", cam, imgs_p, gt_p, device, n_pts, lines=False)
    k2 = phase_k2(sl["captured"] + sp["captured"])
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
    caps = slice_config(True).caps
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
    # are inactive): every launch of both runs, replayed, by call site and N
    k2_run = {}
    for run, res in (("lines", sl), ("points", sp)):
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
    if sl["atlas_calls"]:
        a, k = sl["atlas_calls"][0]
        al_ms = cuda_time_ms(lambda: feature_align.align_mixed_atlas(*a, **k),
                             reps=10, inner=5)
        msg += f"; align_mixed_atlas (N={a[3].shape[0]}) {al_ms:.4f} ms per call"
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
    # "launches" counts the main path's (points + lines) run;
    # "launches_points_only" the points-only run.
    report = {"kernels": [
        {"name": "fast_score", "route": "cuda",
         "source": "plsvo_torch/csrc/fast_score.cu",
         "replaces": "plsvo_tpu/ops/pallas_fast.py:117",
         "launches": sl["launches"]["fast_score"],
         "launches_per_frame": sl["launches"]["fast_score"] / nf,
         "launches_points_only": sp["launches"]["fast_score"],
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
         "max_abs_err": k2_uv, "max_abs_err_kind": "abs_uv_px",
         "max_err": k2_md, "max_err_kind": "abs_mean_diff",
         "ms": k2_ms, "kernel_ms": k2_dev, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "kernel_ms_run_median": k2_run[("lines", "reproject", n_k2)][0],
         "kernel_ms_run_max": k2_run[("lines", "reproject", n_k2)][1],
         "shape": [n_k2]},
    ]}
    print(f"summary: lines run ATE {sl['ate']:.6f} m, per-frame ms median "
          f"{sl['ms_median']:.2f} p90 {sl['ms_p90']:.2f}, {sl['n_lines_made']} "
          f"line landmarks, median segment matches {sl['seg_median']:.1f}; "
          f"points run ATE {sp['ate']:.6f} m, per-frame ms median "
          f"{sp['ms_median']:.2f} p90 {sp['ms_p90']:.2f}", flush=True)
    print(json.dumps(report), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
