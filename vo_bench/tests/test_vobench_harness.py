"""CPU tests of the benchmark harness (vo_bench/).

    python -m pytest vo_bench/tests -q

Covers the manifest against the benchmark's contract, that every cell's
files and every metric's reader are found by name, the readers on a
recorded fake run, the kernels' roofline counts on hand-worked shapes,
the orbit, the import check, and runs of the harness on the CPU at the
cells' own sizes: `correct` holds for the program and fails for the
planted faults. The test marked `cuda` runs only on a machine with a
card.
"""
import copy
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

VB = Path(__file__).resolve().parent.parent
ROOT = VB.parent
sys.path[:0] = [str(VB), str(ROOT)]

import run  # noqa: E402
from vobench import orbit, peaks, reference  # noqa: E402

MAN = run.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# -- the manifest ---------------------------------------------------------
def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["vo_bench"] and MAN["command"][1] == "vo_bench/run.py"
    assert 1 <= MAN["run_seconds"] <= 51
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vo_bench/") and (ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    names = [x["name"] for x in MAN["configs"] + MAN["workloads"] + METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for cell in CELLS:
        assert "setup_s" in {m["name"] for m in run.metrics_of(MAN, cell, False)}
        assert len(run.metrics_of(MAN, cell, False)) >= 2
        assert run.metrics_of(MAN, cell, True)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    w, spec, mix = run.cell(MAN, workload)
    limits = run.limits_of(workload)
    assert spec["mode"] in ("single", "batched")
    assert {"camera", "config", "check", "trace", "source", "reduced",
            "assumed", "guarantees"} <= set(spec)
    assert orbit.period(mix) > 100
    assert limits["limits"] and all(v >= 0 for v in limits["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(run.load_module("metrics", metric).read)


def test_no_per_cell_branch():
    """The harness's code names no configuration, mix or cell: it finds
    them by the names in BENCHMARK.json."""
    words = {w["config"] for w in MAN["workloads"]} | {
        w["traffic"] for w in MAN["workloads"]} | set(CELLS)
    for p in list(VB.glob("*.py")) + list(VB.glob("vobench/*.py")):
        text = p.read_text()
        for word in words:
            assert not re.search(rf"['\"]{re.escape(word)}['\"]", text), (p, word)


# -- the import check ---------------------------------------------------------
@pytest.mark.parametrize("mods,bad", [
    (["plsvo_torch", "plsvo_torch.pipeline.fused"], []),
    (["plsvo_tpu.ops"], ["plsvo_tpu"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "plsvo_tpu_extra"], []),
    (["flax.linen"], ["flax"]),
])
def test_forbidden_by_whole_top_level_name(mods, bad):
    assert run.forbidden_modules(mods) == bad


def test_harness_and_program_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "from vobench import drive, orbit, peaks, reference, scene, trace\n"
        "import plsvo_torch.pipeline.frame_handler, plsvo_torch.parallel.multi_vo\n"
        "for k in ('metrics', 'kernels'):\n"
        "    import pathlib\n"
        "    for p in sorted(pathlib.Path(%r, k).glob('*.py')):\n"
        "        run.load_module(k, p.stem)\n"
        "print(run.forbidden_modules(sys.modules))\n") % (str(VB), str(ROOT), str(VB))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_harness_reads_no_jax_files():
    for p in VB.rglob("*.py"):
        if "tests" in p.parts:
            continue
        text = p.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|plsvo_tpu)\b",
                             text, re.M), p
        assert not re.search(r"BENCH_|MULTICHIP_|bench\.py|bench_torch", text), p


# -- the readers on a recorded fake run ----------------------------------------
def _rec(**kw):
    rec = {"mode": "single", "setup_s": 21.5, "window_s": 25.0,
           "ok_frames": 100, "call_s": [], "permon": [], "slices": [],
           "kernel_pairs": {}}
    rec.update(kw)
    return rec


def read(name, rec):
    return run.load_module("metrics", name).read(rec)


def test_fps_counts_the_whole_window():
    # 100 frames delivered over a 25 s window, whatever the calls took
    assert read("fps", _rec(call_s=[0.1] * 50 + [0.4] * 50)) == 4.0


def test_p90_runs_over_every_call():
    # 90 tracked frames of 200 ms, 10 keyframe frames of 500 ms
    calls = [0.2] * 90 + [0.5] * 10
    assert read("frame_ms_p90", _rec(call_s=calls)) == pytest.approx(
        1e3 * np.percentile(calls, 90))
    assert read("frame_ms_p90", _rec(call_s=calls)) > 200.0


def test_setup_reader():
    assert read("setup_s", _rec()) == 21.5


def test_permon_readers():
    frames = [{"t_device_step": 0.1, "t_fetch": 0.05},
              {"t_device_step": 0.2, "t_fetch": 0.05, "t_keyframe_path": 0.08,
               "t_local_ba": 0.03},
              {"t_pyramid_creation": 0.01}]
    r = _rec(permon=frames)
    assert read("step_ms.single", r) == pytest.approx(200.0)
    assert read("kf_ms.single", r) == pytest.approx(80.0)
    assert read("local_ba_ms.single", r) == pytest.approx(30.0)
    assert read("kf_ms.single", _rec()) is None


def test_slice_readers():
    sl = [{"wall_s": 2.0, "busy_s": 0.2, "launches": 160000, "syncs": 300,
           "calls": 8, "frames": 8},
          {"wall_s": 2.0, "busy_s": 0.4, "launches": 150000, "syncs": 280,
           "calls": 8, "frames": 8}]
    r = _rec(slices=sl)
    assert read("launches_per_frame.single", r) == pytest.approx(310000 / 16)
    assert read("launches_per_step.batch", r) == pytest.approx(310000 / 16)
    assert read("syncs_per_step.batch", r) == pytest.approx(580 / 16)
    assert read("device_idle_pct", r) == pytest.approx(85.0)
    assert read("device_idle_pct", _rec()) is None


def test_roofline_readers_never_read_zero_without_launches():
    assert read("fast_score_roofline", _rec()) is None
    r = _rec(kernel_pairs={"mixed_align": [(1e-6, 4e-6), (1e-6, 6e-6)]})
    assert read("mixed_align_roofline", r) == pytest.approx(20.0)


def test_slice_record_on_cpu():
    """The profiler's raw events of a slice: host syncs counted, no device
    activity and no launches without a card."""
    from vobench import trace

    def work():
        x = torch.randn(32, 32)
        for _ in range(20):
            x = x @ x * 0.01
            float(x.sum())

    r = trace.profile_slice(work, "cpu")
    assert r["syncs"] == 20 and r["launches"] == 0 and r["busy_s"] == 0.0
    assert r["wall_s"] > 0 and r["kernels"] == {"fast_score": [],
                                                "mixed_align": []}


# -- the roofline counts -------------------------------------------------------
def test_k1_count_hand_worked():
    k1 = run.load_module("kernels", "fast_score")
    px = 480 * 752 + 240 * 376 + 120 * 188  # 473,760
    t = k1.bound_s([(480, 752), (240, 376), (120, 188)])
    assert px == 473760
    assert t == pytest.approx(px * 9 / peaks.HBM_BYTES_PER_S)  # bytes bound
    assert px * 63 / peaks.F32_OPS_PER_S < t


def _k2_inputs(valid):
    """Rows whose reference patch equals their window: each valid row
    converges after one iteration."""
    N = len(valid)
    win = torch.full((N, 16, 16), 50.0)
    z64 = torch.zeros(N, 64)
    return [win, torch.zeros(N, 2), torch.full((N, 64), 50.0), z64, z64, z64,
            torch.eye(3).repeat(N, 1, 1), torch.eye(2).repeat(N, 1, 1),
            torch.zeros(N, 2), torch.zeros(N, dtype=torch.bool),
            torch.full((N, 2), 7.5), torch.full((N, 2), 100.0),
            torch.tensor(valid)]


def test_k2_count_hand_worked():
    k2 = run.load_module("kernels", "mixed_align")
    kw = dict(patch_size=8, wp=16, n_iter=10, conv_eps=0.03)
    inputs = _k2_inputs([True, False, False, False])
    uv, conv, md, active = reference.k2_reference(inputs, kw)
    assert active == [1, 0] and conv.tolist() == [True, False, False, False]
    n_bytes = 1 * (256 * 4 + 4 * 64 * 4 + 21 * 4 + 2 + 13) + 3 * (1 + 8 + 13)
    assert k2.bound_s((inputs, kw)) == pytest.approx(
        n_bytes / peaks.HBM_BYTES_PER_S)


# -- the orbit -------------------------------------------------------------------
@pytest.mark.parametrize("mix", sorted({w["traffic"] for w in MAN["workloads"]}))
def test_orbit_stays_on_the_plane_and_closes(mix):
    m = orbit.load(VB / "traffic" / f"{mix}.json")
    cam = run.cell(MAN, next(w["name"] for w in MAN["workloads"]
                             if w["traffic"] == mix))[1]["camera"]
    half = 0.5 * m["scene"]["size"] * m["scene"]["texel_size"]
    assert orbit.view_half_diagonal(m, cam) + m["radius_m"] <= half
    R, t = orbit.poses(m)
    P = orbit.period(m)
    steps = np.linalg.norm(np.diff(np.concatenate([t, t[:1]]), axis=0), axis=1)
    assert len(t) == P and np.allclose(steps, steps.mean(), rtol=0.1)
    assert abs(np.hypot(*steps[:1].tolist(), 0) - m["step_m"]) < 0.2 * m["step_m"]
    assert np.allclose(np.linalg.det(R), 1.0)
    offs = orbit.stream_offsets(m, 8, 0)
    assert len(set(offs)) == 8 and offs[1] == round(P / 8)


def test_render_follows_the_pose():
    """A frame rendered after moving the camera by one texel's worth of
    pixels equals the first frame shifted by that many pixels."""
    from vobench import scene

    plane = scene.Plane(5, size=256, texel_size=0.01)
    cam = {"width": 64, "height": 48, "fx": 100.0, "fy": 100.0, "cx": 32.0,
           "cy": 24.0}
    R = np.repeat(np.eye(3)[None], 2, 0)
    t = np.array([[0.0, 0.0, -1.0], [0.04, 0.0, -1.0]])  # 4 px at depth 1
    f = scene.render(plane, cam, R, t, "cpu", ss=1).to(torch.int16)
    assert (f[1][:, :-4] - f[0][:, 4:]).abs().max() <= 1


# -- runs on the CPU ---------------------------------------------------------------
def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "3", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


# the batched configuration, kept for a later cell (PERF.md, Open
# questions): its CPU run is judged by the single cell's limits
X8 = "euroc_mono_x8"
MAN_X8 = copy.deepcopy(MAN)
MAN_X8["configs"].append({"name": X8, "file": f"vo_bench/configs/{X8}.json"})
MAN_X8["workloads"].append({"name": f"{X8}.cruise", "config": X8,
                            "traffic": "cruise", "chips": 1})


def _cpu_run(manifest, workload, streams=None, seconds=4.0):
    """A run on the CPU at the cell's frame size, with the keyframe map
    limited to 4 so that the warm-up's map turns after ~5 keyframes."""
    torch.set_num_threads(4)
    spec = copy.deepcopy(run.cell(manifest, workload)[1])
    spec["config"]["pipeline"]["max_n_kfs"] = 4
    if streams:
        spec["streams"] = streams
    limits = run.limits_of(CELLS[0])
    keep = {}
    res, got = run.run_cell(manifest, workload, 2 ** 33 + 17, seconds, False,
                            "cpu", spec=spec, limits=limits, keep=keep)
    return res, got, keep, limits


@pytest.fixture(scope="module")
def single_run():
    return _cpu_run(MAN, CELLS[0])


@pytest.fixture(scope="module")
def batched_run():
    return _cpu_run(MAN_X8, f"{X8}.cruise", streams=2)


def _judge(keep, limits, out):
    return run.judge(reference.numbers(out, keep["truth"]), limits)[1]


def test_cpu_single_run_is_correct(single_run):
    res, got, keep, limits = single_run
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and set(res["metrics"]) == {
        "fps", "frame_ms_p90", "setup_s"}
    assert list(res)[-1] == "checks"
    assert keep["out"]["k1"] and keep["out"]["k2"]


def test_cpu_batched_run_is_judged(batched_run):
    """The batched entry runs end to end and every submitted frame is
    accounted for. (On the CPU a stream of this run is lost inside the
    window and never relocalizes; PERF.md's Open questions.)"""
    res, got, keep, limits = batched_run
    out = keep["out"]
    ok = sum(len(s["fids"]) for s in out["streams"])
    assert res["attempted"] > 0 and 0 <= res["failed"] <= res["attempted"]
    assert set(res["metrics"]) == {"fps", "setup_s"}
    assert len(out["streams"]) == 2 and ok > 0
    assert res["correct"] == run.judge(got, limits)[1]


def _frozen(out):
    """A step that returns its state unchanged: every pose the first, every
    keyframe the oldest, and so no K1 detection in the window."""
    out = copy.deepcopy(out)
    for s in out["streams"]:
        s["R"][:] = s["R"][0]
        s["t"][:] = s["t"][0]
        m = s["map"]
        j = int(np.argmin(m["kf_fids"]))
        m["kf_R"][:] = m["kf_R"][j]
        m["kf_t"][:] = m["kf_t"][j]
    out["k1"] = []
    return out


def _altered_keyframe(out):
    """The local-BA write-back alters one keyframe: its pose is written
    into the slot of another keyframe."""
    out = copy.deepcopy(out)
    m = out["streams"][0]["map"]
    order = np.argsort(m["kf_fids"])
    a, b = order[0], order[-1]
    m["kf_R"][b], m["kf_t"][b] = m["kf_R"][a], m["kf_t"][a]
    return out


def _landmarks_off_the_plane(out):
    """The write-back alters the landmarks: each moved a quarter of its
    distance along the ray from the newest keyframe's centre."""
    out = copy.deepcopy(out)
    m = out["streams"][0]["map"]
    j = int(np.argmax(m["kf_fids"]))
    c = reference.centres(m["kf_R"][j], m["kf_t"][j])
    m["landmarks"] = c + 1.25 * (m["landmarks"] - c)
    return out


def _altered_pose(out):
    """One answer altered where it is produced: a pose moved by 0.05 map
    units (~10 cm)."""
    out = copy.deepcopy(out)
    s = out["streams"][0]
    s["t"][len(s["t"]) // 2] += 0.05
    return out


def _altered_k1(out):
    out = copy.copy(out)
    imgs, outs, thr = out["k1"][0]
    m, sc = outs[0]
    sc = sc.clone()
    sc[100, 200] += 5.0
    out["k1"] = [(imgs, [(m, sc)] + outs[1:], thr)] + out["k1"][1:]
    return out


def _altered_k2(out):
    out = copy.copy(out)
    k2 = list(out["k2"])
    j = next(j for j, (_, _, o) in enumerate(k2) if bool(o[1].any()))
    inputs, kw, (uv, conv, md) = k2[j]
    conv = conv.clone()
    conv[torch.nonzero(conv)[0, 0]] = False
    k2[j] = (inputs, kw, (uv, conv, md))
    out["k2"] = k2
    return out


def _half_batch(out):
    """Half of the batch left out: its streams deliver nothing."""
    out = copy.deepcopy(out)
    n = len(out["streams"])
    out["missing"] += sum(len(s["fids"]) for s in out["streams"][n // 2:])
    for s in out["streams"][n // 2:]:
        s["fids"], s["R"], s["t"] = [], s["R"][:0], s["t"][:0]
    return out


@pytest.mark.parametrize("fault", [_frozen, _altered_pose, _altered_k1,
                                   _altered_k2, _altered_keyframe,
                                   _landmarks_off_the_plane])
def test_cpu_single_run_fails_each_fault(single_run, fault):
    _, _, keep, limits = single_run
    assert _judge(keep, limits, keep["out"])
    assert not _judge(keep, limits, fault(keep["out"]))


@pytest.mark.parametrize("fault", [_frozen, _half_batch])
def test_cpu_batched_run_fails_each_fault(batched_run, fault):
    _, _, keep, limits = batched_run
    assert not _judge(keep, limits, fault(keep["out"]))


@pytest.mark.parametrize("control", [reference.control, reference.frozen])
def test_controls_fail(single_run, control):
    """The reference in the program's place in bfloat16, and with every
    pose held at the first and every keyframe at the oldest, are not
    correct."""
    _, _, keep, limits = single_run
    ctl = control(keep["out"], keep["truth"])
    assert not run.judge(reference.numbers(ctl, keep["truth"]), limits)[1]


@pytest.mark.cuda
def test_card_run_is_correct(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "vo_bench/run.py", "--workload",
                          CELLS[0], "--seed", "77", "--seconds", "5",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
