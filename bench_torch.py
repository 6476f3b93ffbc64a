"""Benchmark of the PyTorch port (plsvo_torch) on one NVIDIA GPU, computed
as bench.py computes its numbers for the JAX package.

Run from the root of a checkout: `python3 bench_torch.py`. It renders
bench.py's 72-frame 752x480 plane sequence with the port's renderer and
prints, before its last line:

- the card's name and power limit (nvidia-smi);
- single-sequence sync and pipelined runs timed in alternating turns
  (BENCH_PAIRS pairs, default 3), each with bench.py's per-frame statistic
  (mean and p90 of the last half of the DEFAULT-stage add_image calls)
  and its line landmarks: the host clock moves by a quarter within one
  process, so one pair cannot separate the two modes;

and as its last line one JSON object with bench.py's keys:

- value: 1 / the mean of the last half of the DEFAULT add_image times of
  a pipelined handler (pipeline_depth 12), the second of two passes;
- device_step_ms: the CUDA-event time of one complete tracked-frame step
  (the step's span on the stream) at that handler's end-of-sequence
  state, median of 5; device_busy_ms beside it is the kernels' own time
  in that step (torch.profiler, run last: a profiler session slows the
  host work after it);
- batched_fps_b8 (= batched_fps_b8_vmap) and batched_fps_b8_streams:
  BENCH_BATCH sequences (default 8), staggered (sequence k runs k frames
  behind), uint8 frames, BatchedVO in vmap and in streams mode at
  BENCH_BATCH_DEPTH (default 12): B / the mean of the last half of the
  add_images calls made with every sequence in DEFAULT, second of two
  passes.

BENCH_SINGLE=0, BENCH_VMAP=0 and BENCH_BATCHED=0 skip the single, vmap
and streams phases, as in bench.py. It needs a CUDA card and exits
without one. Unlike bench.py, no phase's failure is caught: a failing phase exits
non-zero without the JSON line.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

W, H = 752, 480
N_FRAMES = 72  # bench.py's sequence length


def render_frames(n_frames, device):
    """bench.py:111-158: the plane sequence, 0.03 m sideways per frame."""
    from plsvo_torch.camera import PinholeCamera
    from plsvo_torch.utils import synthetic

    cam = PinholeCamera.create(W, H, 460.0, 460.0, W / 2, H / 2)
    scene = synthetic.make_scene(np.random.default_rng(3), size=2048,
                                 texel_size=0.003)
    Rs, ts = [], []
    for i in range(n_frames):
        ang = 0.002 * i
        Rs.append(np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                              [-np.sin(ang), 0, np.cos(ang)]], np.float32))
        ts.append(np.asarray([0.03 * i, 0.008 * np.sin(0.3 * i), -2.0],
                             np.float32))
    chunks = [synthetic.render_batch_aa(scene, cam, Rs[c:c + 18],
                                        ts[c:c + 18], ss=2, device=device)
              for c in range(0, n_frames, 18)]
    import torch

    return cam, torch.cat(chunks)


def bench_stat(times):
    """bench.py:204-218: mean and p90 of the last half of the DEFAULT-stage
    calls (all of them when 10 or fewer)."""
    d = [dt for st, dt in times if st == "default"]
    steady = d[len(d) // 2:] if len(d) > 10 else d
    return float(np.mean(steady)), float(np.percentile(steady, 90))


def track(cam, cfg, imgs, device, label):
    """One handler over every frame, then flush(): (per-call (stage, s),
    the handler, line landmarks made, live at the end)."""
    from plsvo_torch.pipeline.frame_handler import (STAGE_DEFAULT,
                                                    FrameHandlerMono)
    from plsvo_torch.pipeline.state import MapState

    made = []
    orig = MapState.new_line

    def counting(self, *a, **k):
        r = orig(self, *a, **k)
        if r >= 0:
            made.append(r)
        return r

    MapState.new_line = counting
    try:
        vo = FrameHandlerMono(cam, cfg, device=device)
        times = []
        for i, img in enumerate(imgs):
            t0 = time.perf_counter()
            r = vo.add_image(img, i / 30.0)
            dt = time.perf_counter() - t0
            times.append((r.stage if r is not None else STAGE_DEFAULT, dt))
            if r is not None:
                print(f"{label} frame {r.frame_id}: stage={r.stage} "
                      f"q={r.quality} npt={r.n_pt_matches} "
                      f"nseg={r.n_seg_matches} kf={r.is_keyframe} "
                      f"{dt * 1e3:.1f}ms", file=sys.stderr)
        vo.flush()
    finally:
        MapState.new_line = orig
    return times, vo, len(made), int((vo.map.ln_status > 0).sum())


def device_step_ms(vo, img, reps=5):
    """The tracked-frame step at the handler's end-of-sequence state (map
    populated, seeds live): (CUDA-event span on the stream, median of reps;
    kernel time in one step from torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from plsvo_torch.image import build_pyramid
    from plsvo_torch.pipeline import fused

    pyr = build_pyramid(img.to(vo.device), vo.n_levels)

    def step():
        return fused.track_frame_step(*vo._step_inputs(pyr), emit_next=True,
                                      frame_id=vo.frame_id,
                                      **vo._step_kwargs())

    step()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        spans.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    return float(np.median(spans)), busy


def run_batched(cam, imgs, mode, device):
    """bench.py:227-258: B staggered uint8 sequences through BatchedVO,
    two passes; B / the mean of the last half of the all-DEFAULT calls of
    the second."""
    from plsvo_torch.config import Config, PipelineConfig
    from plsvo_torch.parallel.multi_vo import BatchedVO

    B = int(os.environ.get("BENCH_BATCH", "8"))
    depth = int(os.environ.get("BENCH_BATCH_DEPTH", "12"))
    imgs_h = [np.clip(np.round(im.cpu().numpy()), 0, 255).astype(np.uint8)
              for im in imgs]
    n = len(imgs_h)
    for _pass in range(2):
        bvo = BatchedVO(cam, Config(pipeline=PipelineConfig(
            pipelined=True, pipeline_depth=depth)), B, mode=mode,
            device=device)
        bt = []
        for i in range(n):
            t0 = time.perf_counter()
            bvo.add_images([imgs_h[max(0, i - k)] for k in range(B)], i / 30.0)
            dt = time.perf_counter() - t0
            bt.append((dt, all(s == "default" for s in bvo.stages)))
            print(f"pass{_pass} {mode} frame {i}: {dt * 1e3:.1f}ms "
                  f"stages={set(bvo.stages)}", file=sys.stderr)
        bvo.flush()
    defaults = [dt for dt, ok in bt if ok]
    steady = defaults[len(defaults) // 2:] if len(defaults) > 6 else defaults
    if not steady:
        raise RuntimeError(f"{mode}: no add_images call with every sequence "
                           "in DEFAULT")
    fps = round(B / float(np.mean(steady)), 2)
    print(f"batched {mode}: B={B} depth {depth}: {fps} aggregate frames/s "
          f"(mean call {1e3 * np.mean(steady):.2f} ms over {len(steady)} "
          f"calls)", flush=True)
    return fps, B


def main():
    import torch

    from plsvo_torch.config import Config, PipelineConfig

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA card")
    device = torch.device("cuda")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    except FileNotFoundError:
        card = None
    card = card or f"no card readable by nvidia-smi ({device})"
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    cam, imgs = render_frames(N_FRAMES, device)
    out = {"metric": "vo_fps_752x480_points_lines", "value": 0.0,
           "unit": "frames/s", "vs_baseline": 0.0, "scene": "plane"}
    if os.environ.get("BENCH_SINGLE", "1") != "0":
        cfg = Config(pipeline=PipelineConfig(pipelined=True, pipeline_depth=12))
        for _pass in range(2):
            times, vo, made, live = track(cam, cfg, imgs, device,
                                          f"pass{_pass}")
        mean_s, p90_s = bench_stat(times)
        out["value"] = round(1.0 / mean_s, 2)
        out["vs_baseline"] = round(1.0 / mean_s / 30.0, 3)
        print(f"single pipelined (depth 12), second pass: mean "
              f"{1e3 * mean_s:.2f} ms, p90 {1e3 * p90_s:.2f} ms, "
              f"{out['value']} frames/s; line landmarks made {made}, live "
              f"{live}", flush=True)
        # the two single-sequence modes in alternating turns
        for k in range(int(os.environ.get("BENCH_PAIRS", "3"))):
            row = []
            for pipelined in (False, True):
                c = Config(pipeline=PipelineConfig(pipelined=pipelined,
                                                   pipeline_depth=12))
                times, _, made, live = track(cam, c, imgs, device,
                                             f"pair{k} pipelined={pipelined}")
                m, p = bench_stat(times)
                row.append(f"{'pipelined' if pipelined else 'sync'} mean "
                           f"{1e3 * m:.2f} ms p90 {1e3 * p:.2f} ms, line "
                           f"landmarks made {made} live {live}")
            print(f"pair {k}: " + "; ".join(row), flush=True)
    if os.environ.get("BENCH_VMAP", "1") != "0":
        fps_b, B = run_batched(cam, imgs, "vmap", device)
        out["batched_fps_b8"] = fps_b
        out["batched_fps_b8_vmap"] = fps_b
        out["batched_mode"] = "vmap"
        out["batched_seqs"] = B
    if os.environ.get("BENCH_BATCHED", "1") != "0":
        fps_s, B = run_batched(cam, imgs, "streams", device)
        out["batched_fps_b8_streams"] = fps_s
        out["batched_seqs"] = B
        if "batched_fps_b8" not in out:
            out["batched_fps_b8"] = fps_s
            out["batched_mode"] = "streams"
    # last: a torch.profiler session slows the host work after it (by ~30%
    # on the H100 machine), so no timed phase may follow it
    if os.environ.get("BENCH_SINGLE", "1") != "0":
        span, busy = device_step_ms(vo, imgs[-1])
        out["device_step_ms"] = round(span, 2)
        out["device_busy_ms"] = round(busy, 2)
        print(f"device step: {span:.2f} ms on the stream, {busy:.2f} ms "
              "of kernels", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
