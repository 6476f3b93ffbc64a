#!/usr/bin/env python3
"""The benchmark of plsvo_torch: one cell of BENCHMARK.json per run.

    python3 vo_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for. Each run is one process. It builds or loads the port's
CUDA kernels (`plsvo_torch._build`, cached under `build/` in the
checkout), renders the cell's orbit on the card from the seed, drives the
program through bootstrap and a warm-up, measures for `--seconds`, checks
what the timed path produced against the plain reference
(`vobench/reference.py`) and prints one JSON object as its last line of
standard output. With `--trace 1` the window is followed by profiled
slices, and the line carries the per-layer metrics instead of the
end-to-end ones.

Everything that belongs to one cell is found by name: the configuration
(`configs/<config>.json`), the traffic mix (`traffic/<mix>.json`), the
limits of the numbers compared (`limits/<cell>.json`), one reader per
metric (`metrics/<metric>.py`) and one roofline count per kernel
(`kernels/<kernel>.py`).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

# top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "plsvo_tpu")
# warm-up gives up after this many calls (the cruise map turns after ~250)
WARMUP_MAX_CALLS = 1000


def forbidden_modules(names) -> list:
    """The forbidden top-level packages among module names, compared by
    the whole part before the first dot."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """vo_bench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vo_bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(manifest: dict, workload: str):
    """(the workload entry, its configuration file, its traffic mix), each
    found by name."""
    w = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"run.py: no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in manifest["configs"] if c["name"] == w["config"])
    return (w, load_json(ROOT / c["file"]),
            load_json(HERE / "traffic" / f"{w['traffic']}.json"))


def limits_of(workload: str) -> dict:
    """The limits of the numbers compared in a cell, found by its name."""
    return load_json(HERE / "limits" / f"{workload}.json")


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def judge(got: dict, limits: dict):
    """Each number compared beside its limit, and whether all are within
    them (a number the run could not produce counts as infinite)."""
    checks = {k: {"value": float(got.get(k, math.inf)), "limit": float(lim)}
              for k, lim in limits["limits"].items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def warm_up(streams, frames, offsets, dt: float):
    """Calls from the first frame until every stream is in DEFAULT and its
    keyframe map is in steady state: a keyframe has left it (the ring was
    full, or at the configured limit, and the furthest keyframe went).
    Then flush(). Returns the next call's index."""
    i = 0
    seen = [set() for _ in streams.handlers]
    while True:
        streams.call(frames, i, offsets, i * dt)
        i += 1
        turned = []
        for h, ids in zip(streams.handlers, seen):
            m = h.map
            live = set(m.kf_frame_id[m.kf_occupied].tolist())
            ids |= live
            turned.append(len(ids) > len(live))
        if all(turned) and all(s == "default" for s in streams.stages()):
            break
        if i >= WARMUP_MAX_CALLS:
            raise RuntimeError(f"warm-up: stages {streams.stages()}, "
                               f"keyframe ring turned {turned} after {i} calls")
    streams.flush()
    return i


def outputs(streams, n_calls: int, tap) -> dict:
    """What the timed path produced, as the reference reads it."""
    import numpy as np

    out, missing = [], 0
    for k, d in enumerate(streams.delivered):
        ok = [r for r in d if r[1] == "default" and r[2] != "insufficient"]
        fids = [r[0] for r in d]
        missing += n_calls - len(set(fids)) + (len(fids) - len(set(fids)))
        out.append({"fids": [r[0] for r in ok],
                    "R": [r[4] for r in ok], "t": [r[5] for r in ok]})
    for s, m in zip(out, streams.map_arrays()):
        s["R"] = np.asarray(s["R"]).reshape(-1, 3, 3)
        s["t"] = np.asarray(s["t"]).reshape(-1, 3)
        s["map"] = m
    return {"missing": missing, "streams": out, "k1": tap.k1, "k2": tap.k2}


def run_cell(manifest, workload, seed, seconds, trace, device, *,
             t_start=None, spec=None, limits=None, keep=None):
    """One run of a cell; returns (result dict, compared numbers). spec
    and limits replace the cell's configuration and limits files (tests
    change the stream count and the keyframe limit); keep, a dict,
    receives the outputs and the truth they were judged against (the
    controls)."""
    import torch

    from vobench import drive, orbit, reference, scene
    from vobench import trace as tr

    t_start = T_START if t_start is None else t_start
    w, spec0, mix = cell(manifest, workload)
    spec = spec or spec0
    limits = limits or limits_of(workload)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        from plsvo_torch import _build

        _build.load_library()
    plane = scene.Plane(mix["texture_seed"], **mix["scene"])
    R_w_c, t_w_c = orbit.poses(mix)
    frames_dev = scene.render(plane, spec["camera"], R_w_c, t_w_c, device,
                              ss=mix["supersample"])
    frames = frames_dev.cpu().numpy()
    n = int(spec["streams"])
    offsets = orbit.stream_offsets(mix, n, seed)

    streams = drive.Streams(spec, device)
    chk = spec["check"]
    tap = drive.KernelTap(seed, chk["k1_max"], chk["k2_every"], chk["k2_max"])
    tap.install()
    dt = mix["frame_dt_s"]
    i = warm_up(streams, frames, offsets, dt)
    drive.synchronize(device)
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s: {i} calls of warm-up; kernel library "
         f"{getattr(sys.modules.get('plsvo_torch._build'), 'build_seconds', None)} s")

    # the measured window
    permon = streams.handlers[0].permon
    permon.finish()
    n_perm = len(permon.frames)
    pos = streams.positions()
    tap.mode = "window"
    call_s, i0 = [], i
    t_w = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        streams.call(frames, i, offsets, i * dt)
        i += 1
        call_s.append(time.perf_counter() - t0)
        if time.perf_counter() - t_w >= seconds:
            break
    streams.flush()
    drive.synchronize(device)
    window_s = time.perf_counter() - t_w
    tap.mode = "off"
    permon.finish()
    rec = {"mode": streams.mode, "setup_s": setup_s, "window_s": window_s,
           "ok_frames": streams.n_ok(pos), "call_s": call_s,
           "permon": permon.frames[n_perm:], "slices": [], "kernel_pairs": {}}
    attempted = (i - i0) * n
    failed = attempted - rec["ok_frames"]
    kf = sum(1 for k, d in enumerate(streams.delivered) for r in d[pos[k]:]
             if r[3])
    _log(f"window {window_s:.3f} s: {i - i0} calls, {rec['ok_frames']} of "
         f"{attempted} frames delivered in DEFAULT, {kf} keyframes")

    slice_calls = []
    if trace:
        tcfg = spec["trace"]
        tap.mode = "slice"
        for s in range(tcfg["max_slices"]):
            a = i

            def run_slice(a=a):
                for j in range(tcfg["calls_per_slice"]):
                    streams.call(frames, a + j, offsets, (a + j) * dt)

            t_s = time.perf_counter()
            r = tr.profile_slice(run_slice, device)
            _log(f"slice {s}: {r['wall_s']:.3f} s traced, "
                 f"{time.perf_counter() - t_s:.3f} s with its reading")
            i += tcfg["calls_per_slice"]
            r["calls"] = tcfg["calls_per_slice"]
            r["frames"] = r["calls"] * n
            rec["slices"].append(r)
            slice_calls.append({"fast_score": tap.k1_slice,
                                "mixed_align": tap.k2_slice})
            tap.k1_slice, tap.k2_slice = [], []
            if any(c["fast_score"] for c in slice_calls):
                break
        tap.mode = "off"
        streams.flush()
        drive.synchronize(device)
        _log(f"traced {len(rec['slices'])} slices of "
             f"{tcfg['calls_per_slice']} calls")

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    out = outputs(streams, i, tap)
    tap.uninstall()
    del streams
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # the numbers compared, against the plain reference
    truth = {"R_w_c": R_w_c, "t_w_c": t_w_c, "offsets": offsets,
             "period": len(frames), "frames": frames_dev}
    if keep is not None:
        keep.update(out=out, truth=truth)
    t_ref = time.perf_counter()
    got = reference.numbers(out, truth)
    _log(f"reference {time.perf_counter() - t_ref:.3f} s")
    checks, correct = judge(got, limits)

    # kernel rooflines: the launches of each traced slice in order, each
    # with its device duration
    for k in ("fast_score", "mixed_align"):
        counter = load_module("kernels", k)
        pairs = []
        for r, calls in zip(rec["slices"], slice_calls):
            pairs += [(counter.bound_s(c), d)
                      for c, d in zip(calls[k], r["kernels"][k])]
        rec["kernel_pairs"][k] = pairs

    metrics = {}
    for m in metrics_of(manifest, workload, trace):
        v = load_module("metrics", m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        sl = rec["slices"]
        dev["busy_s"] = sum(s["busy_s"] for s in sl)
        dev["window_s"] = sum(s["wall_s"] for s in sl)
        ops, gaps = {}, {}
        for s in sl:
            for key, tot in (("ops", ops), ("gaps", gaps)):
                for name, v in s[key].items():
                    tot[name] = tot.get(name, 0.0) + v
        result["breakdown"] = {"device_ops": tr.top(ops),
                               "idle_gaps": tr.top(gaps)}
    for k, v in sorted(got.items()):
        if k not in checks:
            _log(f"also measured {k} {v!r}")
    result["checks"] = checks
    return result, got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    manifest = load_manifest()
    w = cell(manifest, a.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        _log(f"run.py: {a.workload} needs {w['chips']} CUDA card(s); "
             f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, _ = run_cell(manifest, a.workload, a.seed, a.seconds, bool(a.trace),
                         "cuda:0")
    bad = forbidden_modules(sys.modules)
    if bad:
        _log(f"run.py: the run loaded {bad}: the port may not load JAX or "
             "the JAX package")
        return 3
    for k, c in result["checks"].items():
        _log(f"check {k} {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
