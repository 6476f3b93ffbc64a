"""The port stands alone: it (with chip_smoke.py and bench_torch.py)
imports neither JAX nor the JAX package (nor does its multi-device layer
alone), its entry points (BatchedVO included) run on the card unless told
otherwise, and a CUDA tensor never falls back to the plain twins."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from plsvo_torch import _build
from plsvo_torch.config import default_config, fast_config
from plsvo_torch.camera import PinholeCamera
from plsvo_torch.ops import detection, fast_score, mixed_align
from plsvo_torch.pipeline import frame_handler

ROOT = Path(__file__).resolve().parents[1]

_ONE_STEP = r"""
import dataclasses, pkgutil, importlib, sys
import numpy as np
import torch
torch.set_num_threads(1)  # as the parallel test workers run the port
import plsvo_torch
for m in pkgutil.walk_packages(plsvo_torch.__path__, "plsvo_torch."):
    importlib.import_module(m.name)
from plsvo_torch.camera import PinholeCamera
from plsvo_torch.config import fast_config
from plsvo_torch.pipeline.frame_handler import FrameHandlerMono
from plsvo_torch.utils import synthetic
cam = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
scene = synthetic.make_scene(np.random.default_rng(7), size=1024,
                             texel_size=0.004)
cfg = fast_config()
points = dataclasses.replace(cfg, pipeline=dataclasses.replace(
    cfg.pipeline, has_ls=False, init_ls=False))
lines = cfg
# frame 6 of the golden sequence of tests/test_pipeline.py: enough corners
# for the first keyframe
ang = 0.018
R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                [-np.sin(ang), 0, np.cos(ang)]], np.float32)
img = synthetic.render_aa(scene, cam, R, np.asarray([0.132, 0.006 * np.sin(1.8), -2.0]),
                          device="cpu")
n = []
pipelined = dataclasses.replace(cfg, pipeline=dataclasses.replace(
    cfg.pipeline, pipelined=True, pipeline_depth=4))
for c in (points, lines, pipelined):
    r = FrameHandlerMono(cam, c, device="cpu").add_image(img, 0.0)
    assert (r.stage, r.quality) == ("first", "good") and r.n_pt_matches > 0, r
    n.append(r.n_pt_matches)
# the lines config adds KLT targets along the detected segments
assert n[1] > n[0] and n[2] == n[1], n
from plsvo_torch.parallel.mesh import Mesh
from plsvo_torch.parallel.multi_vo import BatchedVO
for mode, mesh in (("vmap", None), ("streams", None),
                   ("vmap", Mesh(["cpu"] * 2, ("seq",)))):
    rs = BatchedVO(cam, pipelined, 2, mode=mode, mesh=mesh,
                   device="cpu").add_images([img, img], 0.0)
    assert [(r.stage, r.quality) for r in rs] == [("first", "good")] * 2, rs
import importlib.util
spec = importlib.util.spec_from_file_location("bench_torch", "bench_torch.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "plsvo_tpu"))
print("BAD", bad)
"""


def test_port_runs_without_jax_in_a_fresh_process():
    out = subprocess.run([sys.executable, "-c", _ONE_STEP], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout


def test_no_source_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|plsvo_tpu)\b", re.M)
    files = sorted((ROOT / "plsvo_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    assert len(files) > 20
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("module", [
    "plsvo_torch.parallel.mesh", "plsvo_torch.parallel.distributed",
    "plsvo_torch.parallel.dryrun", "plsvo_torch.parallel.batched",
    "plsvo_torch.parallel.ba", "plsvo_torch.parallel.multi_vo"])
def test_multi_device_modules_import_no_jax(module):
    """The multi-device layer alone in a fresh process pulls in neither JAX
    nor the JAX package."""
    code = (f"import sys, {module}; print('BAD', sorted(k for k in "
            "sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
            "'plsvo_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout


def test_entry_point_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frame_handler.FrameHandlerMono(cam, fast_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frame_handler.resolve_device(None)


def _helper_call(name, tmp):
    """A call of a public helper that creates tensors, with no device."""
    import numpy as np

    from plsvo_torch import convert, run_pipeline
    from plsvo_torch.utils import checkpoint, dataset
    from plsvo_torch.ops import depth_filter, homography
    from plsvo_torch.parallel.multi_vo import BatchedVO
    from plsvo_torch.pipeline.state import MapState
    from plsvo_torch.utils import synthetic

    cam = PinholeCamera.create(64, 48, 50.0, 50.0, 32.0, 24.0)
    R, t = np.eye(3, dtype=np.float32), np.asarray([0.0, 0.0, -2.0], np.float32)
    f = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (8, 1))
    return {
        "render_aa": lambda: synthetic.render_aa(
            synthetic.make_scene(np.random.default_rng(1), size=64,
                                 texel_size=0.02), cam, R, t),
        "render_batch_aa": lambda: synthetic.render_batch_aa(
            synthetic.make_scene(np.random.default_rng(1), size=64,
                                 texel_size=0.02), cam, [R], [t]),
        "homography_init": lambda: homography.homography_init(
            f, f, np.ones(8, bool), focal=50.0),
        "empty_point_seeds": lambda: depth_filter.empty_point_seeds(8),
        "empty_line_seeds": lambda: depth_filter.empty_line_seeds(8),
        "frame_state_from_numpy": lambda: convert.frame_state_from_numpy(
            {"pyr": [np.zeros((48, 64), np.float32)]}),
        "map_state_from_numpy": lambda: convert.map_state_from_numpy(
            {}, fast_config(), 3, (48, 64), (50.0, 50.0, 32.0, 24.0)),
        "point_seeds_from_numpy": lambda: convert.point_seeds_from_numpy({}),
        "line_seeds_from_numpy": lambda: convert.line_seeds_from_numpy({}),
        "MapState": lambda: MapState(fast_config(), 3, (48, 64)),
        "BatchedVO": lambda: BatchedVO(cam, fast_config(), 2),
        "write_synthetic_dataset": lambda: dataset.write_synthetic_dataset(
            str(tmp / "ds"), n_frames=1, width=64, height=48),
        "load_state": lambda: checkpoint.load_state(str(tmp / "none.npz")),
        "run_pipeline": lambda: run_pipeline.main(
            ["--synthetic", str(tmp / "cli"), "--n-frames", "1"]),
    }[name]


@pytest.mark.parametrize("name", [
    "render_aa", "render_batch_aa", "homography_init", "empty_point_seeds",
    "empty_line_seeds", "frame_state_from_numpy", "map_state_from_numpy",
    "point_seeds_from_numpy", "line_seeds_from_numpy", "MapState",
    "BatchedVO", "write_synthetic_dataset", "load_state", "run_pipeline"])
def test_helpers_default_to_cuda(monkeypatch, tmp_path, name):
    """Every public helper that creates tensors runs on the card unless the
    caller names a device (the CLI: --device): with no card and no device
    it raises, before it writes anything."""
    call = _helper_call(name, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert list(tmp_path.iterdir()) == []


def test_native_loader_is_the_ports_own():
    """plsvo_torch.native builds its own copy of the loader source into the
    build directory and never loads the JAX package's library
    (plsvo_tpu/native/_loader.so)."""
    from plsvo_torch.native import loader

    assert loader._SRC == ROOT / "plsvo_torch" / "native" / "loader.cpp"
    assert loader.BUILD_ROOT == ROOT / "build" / "plsvo_torch_native"
    lib = loader.get_lib()
    if lib is not None:  # g++ and zlib present
        assert Path(lib._name).resolve().parent.parent == loader.BUILD_ROOT
        assert "plsvo_tpu" not in lib._name


def _slice_config(make, **override):
    import dataclasses

    cfg = make()
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **override))


@pytest.fixture(scope="module")
def first_frame():
    """Frame 6 of the golden sequence of tests/test_pipeline.py, rendered
    by the port on the CPU."""
    import numpy as np

    from plsvo_torch.utils import synthetic

    torch.set_num_threads(1)
    cam = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
    scene = synthetic.make_scene(np.random.default_rng(7), size=1024,
                                 texel_size=0.004)
    ang = 0.018
    R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.asarray([0.132, 0.006 * np.sin(1.8), -2.0], np.float32)
    return cam, synthetic.render_aa(scene, cam, R, t, device="cpu")


@pytest.mark.parametrize("field,value", [
    pytest.param("loba_enabled", True, id="loba_enabled"),
    pytest.param("has_pt", False, id="has_pt"),
    pytest.param("use_edgelets", False, id="use_edgelets"),
    pytest.param("has_refinement", True, id="has_refinement"),
    pytest.param("pipelined", True, id="pipelined")])
def test_sync_option_tracks_first_frame(first_frame, field, value):
    """Each option the port covers constructs on the CPU and takes the
    first frame (line-only mode from segment targets alone; pipelined mode
    runs its first frames as the sync path does)."""
    cfg = _slice_config(fast_config, **{field: value})
    cam, img = first_frame
    vo = frame_handler.FrameHandlerMono(cam, cfg, device="cpu")
    r = vo.add_image(img, 0.0)
    assert (r.stage, r.quality) == ("first", "good"), r
    assert r.n_pt_matches > 0


class _AtanCamera:
    """A camera model other than the pinhole (stand-in for ATAN)."""

    width, height = 320, 240
    fx = fy = 250.0
    cx, cy = 160.0, 120.0


@pytest.mark.parametrize("make_cam,match", [
    pytest.param(_AtanCamera, "camera model", id="non_pinhole_camera")])
def test_unported_config_raises(make_cam, match):
    """The handler tracks on a pinhole camera, as the JAX package's does: any
    other camera object raises (a distorted camera's frames are undistorted
    on ingest and tracked with its ideal pinhole)."""
    with pytest.raises(NotImplementedError, match=match):
        frame_handler.FrameHandlerMono(make_cam(), fast_config(), device="cpu")


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(mesh="2 cpu shards", mode="streams"), "streams",
                 id="mesh"),
    pytest.param(dict(cam=_AtanCamera()), "camera model", id="non_pinhole"),
    pytest.param(dict(mode="sharded"), "mode", id="mode")])
def test_batched_vo_unported_options_raise(kw, match):
    """Options BatchedVO does not take raise: a mesh in streams mode (the
    batch splits over a mesh in vmap mode only, as in the JAX package),
    other camera models and other modes."""
    from plsvo_torch.parallel.mesh import Mesh
    from plsvo_torch.parallel.multi_vo import BatchedVO

    args = dict(cam=PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0),
                cfg=fast_config(), n_sequences=2, device="cpu")
    args.update(kw)
    if args.get("mesh") == "2 cpu shards":
        args["mesh"] = Mesh(["cpu"] * 2, ("seq",))
    with pytest.raises((NotImplementedError, ValueError), match=match):
        BatchedVO(**args)


@pytest.mark.parametrize("make", [fast_config, default_config],
                         ids=["fast_config", "default_config"])
def test_lines_config_constructs_on_cpu(make):
    """Both configs unmodified (points + lines, local BA, sync) construct
    on the CPU."""
    cfg = make()
    assert cfg.pipeline.has_ls and cfg.pipeline.init_ls
    assert cfg.pipeline.loba_enabled and not cfg.pipeline.pipelined
    cam = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
    vo = frame_handler.FrameHandlerMono(cam, cfg, device="cpu")
    assert vo.ln_seeds.mu_s.shape == (cfg.caps.max_seed_segs,)


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """A tensor off the CPU goes to the kernel; with a broken kernel library
    the call raises and nothing is counted as launched. (Meta tensors stand
    in for CUDA tensors on machines without a card.)"""
    def broken(verbose=False):
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "load_library", broken)
    k1, k2 = fast_score.launches, mixed_align.launches
    img = torch.empty((48, 64), device="meta")
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        fast_score.fast_score(img, 10.0)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        fast_score.fast_score_levels([img, torch.empty((24, 32), device="meta")],
                                     10.0)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        detection.detect_fast_grid([img], cell_size=16)
    N = 4
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    args = (m(N, 16, 16), m(N, 2), m(N, 64), m(N, 64), m(N, 64), m(N, 64),
            m(N, 3, 3), m(N, 2, 2), m(N, 2), m(N).bool(), m(N, 2), m(N, 2),
            m(N).bool())
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        mixed_align.mixed_align(*args, patch_size=8, wp=16, n_iter=10)
    assert (fast_score.launches, mixed_align.launches) == (k1, k2)
