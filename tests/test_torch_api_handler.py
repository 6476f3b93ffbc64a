"""The handler's staged seed path and the other handler and step entry
points off the tracking path, on the CPU: `_update_seeds` +
`_harvest_seeds` held against the JAX handler's on the same checkpoint of
a short 320x240 fast_config() run, `start()` / `last_processing_time()`,
`fused.track_frame_core_blob` against `track_frame_core`, and
`utils.profiling.device_trace`."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.camera import PinholeCamera as TPin
from plsvo_torch.image import build_pyramid
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.pipeline import fused
from plsvo_torch.pipeline.state import ST_CANDIDATE, FrameState
from plsvo_torch.utils import checkpoint as tckpt
from plsvo_torch.utils.profiling import device_trace
from plsvo_tpu import image as ji
from plsvo_tpu.camera import PinholeCamera
from plsvo_tpu.config import fast_config
from plsvo_tpu.pipeline.state import FrameState as JFrameState
from plsvo_tpu.utils import checkpoint as jckpt
from plsvo_tpu.utils import synthetic

from test_torch_pipeline import jax_ransac_draws

torch.set_num_threads(1)

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
N_RUN = 11  # bootstrap at frame 9, one tracked frame after it


def port_handler():
    return tfh.FrameHandlerMono(
        TPin.create(320, 240, 250.0, 250.0, 160.0, 120.0),
        convert.config_from_dict(dataclasses.asdict(fast_config())),
        device="cpu", ransac_draws=jax_ransac_draws)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A port handler over tests/test_torch_checkpoint_cross.py's sequence
    to frame N_RUN - 1, saved; the handler then tracks frame N_RUN, whose
    image and pose the staged update is given."""
    scene = synthetic.make_scene(np.random.default_rng(0), size=1024,
                                 texel_size=0.004)
    imgs = [np.asarray(synthetic.render_aa(
        scene, CAM, jnp.eye(3), jnp.asarray([0.025 * i, 0.0, -2.0]))[0])
        for i in range(N_RUN + 1)]
    vo = port_handler()
    for i in range(N_RUN):
        vo.add_image(imgs[i], i / 30.0)
    assert vo.stage == "default"
    path = str(tmp_path_factory.mktemp("ckpt") / "run.npz")
    tckpt.save_state(vo, path)
    r = vo.add_image(imgs[N_RUN], N_RUN / 30.0)
    return dict(path=path, img=imgs[N_RUN], R=r.R_f_w, t=r.t_f_w, vo=vo)


def _converge_rows(alive, k):
    """The first k alive rows: the test shrinks their variance so that they
    converge in this update, in both packages."""
    rows = np.where(alive)[0][:k]
    assert len(rows) == k
    return rows


def test_staged_seed_update_matches_jax(run):
    jvo = jckpt.load_state(run["path"])
    tvo = tckpt.load_state(run["path"], device="cpu")
    np.testing.assert_array_equal(tvo._seed_alive, jvo._seed_alive)
    assert tvo._seed_alive.sum() >= 10 and tvo._lnseed_alive.sum() >= 4
    # some seeds converge now: a variance far below z_range / 200
    pr = _converge_rows(tvo._seed_alive, 5)
    lr = _converge_rows(tvo._lnseed_alive, 3)
    js, jl = jvo.pt_seeds, jvo.ln_seeds
    jvo.pt_seeds = js._replace(sigma2=js.sigma2.at[pr].set(1e-12))
    jvo.ln_seeds = jl._replace(sigma2_s=jl.sigma2_s.at[lr].set(1e-12),
                               sigma2_e=jl.sigma2_e.at[lr].set(1e-12))
    ts, tl = tvo.pt_seeds, tvo.ln_seeds
    tvo.pt_seeds = ts._replace(sigma2=ts.sigma2.index_fill(
        0, torch.as_tensor(pr), 1e-12))
    tvo.ln_seeds = tl._replace(
        sigma2_s=tl.sigma2_s.index_fill(0, torch.as_tensor(lr), 1e-12),
        sigma2_e=tl.sigma2_e.index_fill(0, torch.as_tensor(lr), 1e-12))
    pt_before, ln_before = tvo.map.pt_status > 0, tvo.map.ln_status > 0

    jf = JFrameState.empty(jvo.cfg, N_RUN, N_RUN / 30.0,
                           ji.build_pyramid(jnp.asarray(run["img"]),
                                            jvo.n_levels), run["R"], run["t"])
    tf = FrameState.empty(tvo.cfg, N_RUN, N_RUN / 30.0,
                          build_pyramid(torch.tensor(run["img"]),
                                        tvo.n_levels), run["R"], run["t"])
    jvo._update_seeds(jf)
    tvo._update_seeds(tf)
    # bucket rows: the alive rows of the host mirrors, padded to 32 / 64
    np.testing.assert_array_equal(tvo._pt_rows, jvo._pt_rows)
    np.testing.assert_array_equal(tvo._ln_rows, jvo._ln_rows)
    assert tvo._pt_converged_dev is not None
    jvo._harvest_seeds()
    tvo._harvest_seeds()
    assert tvo._pt_converged_dev is None and tvo._ln_converged_dev is None

    # the seed tables and their mirrors. A variance is a difference of
    # nearly equal terms after the match, the triangulation and the Bayes
    # update: the two packages' roundings part it by up to ~1.1e-4
    # relative here (one line endpoint), so the estimates are held to
    # 2e-4
    np.testing.assert_array_equal(tvo._seed_alive, jvo._seed_alive)
    np.testing.assert_array_equal(tvo._lnseed_alive, jvo._lnseed_alive)
    live = np.asarray(jvo.pt_seeds.alive)
    np.testing.assert_array_equal(tvo.pt_seeds.alive.numpy(), live)
    for name in ("mu", "sigma2", "a", "b"):
        np.testing.assert_allclose(getattr(tvo.pt_seeds, name).numpy()[live],
                                   np.asarray(getattr(jvo.pt_seeds, name))[live],
                                   rtol=2e-4, err_msg=name)
    llive = np.asarray(jvo.ln_seeds.alive)
    np.testing.assert_array_equal(tvo.ln_seeds.alive.numpy(), llive)
    for name in ("mu_s", "sigma2_s", "mu_e", "sigma2_e", "a", "b"):
        np.testing.assert_allclose(getattr(tvo.ln_seeds, name).numpy()[llive],
                                   np.asarray(getattr(jvo.ln_seeds, name))[llive],
                                   rtol=2e-4, err_msg=name)
    for key in ("seed_starved", "seed_starved_ln"):
        assert tvo.permon.logs[key] == jvo.permon.logs[key], key

    # the candidate landmarks: the same rows, positions within 1e-4 m
    tm_, jm_ = tvo.map, jvo.map
    np.testing.assert_array_equal(tm_.pt_status, jm_.pt_status)
    np.testing.assert_array_equal(tm_.ln_status, jm_.ln_status)
    new_pt = np.where((tm_.pt_status > 0) & ~pt_before)[0]
    assert len(new_pt) >= len(pr)
    assert (tm_.pt_status[new_pt] == ST_CANDIDATE).all()
    assert ((tm_.ln_status > 0) & ~ln_before).sum() >= len(lr)
    np.testing.assert_allclose(tm_.pt_pos, jm_.pt_pos, atol=1e-4)
    np.testing.assert_allclose(tm_.ln_spos, jm_.ln_spos, atol=1e-4)
    np.testing.assert_allclose(tm_.ln_epos, jm_.ln_epos, atol=1e-4)
    # each new point lies on its seed's bearing, in front of its keyframe
    for i in new_pt:
        k = tm_.pt_anchor_kf[i]
        p = tm_.kf_R[k] @ tm_.pt_pos[i] + tm_.kf_t[k]
        assert np.isfinite(p).all() and p[2] > 0
        np.testing.assert_allclose(p / np.linalg.norm(p), tm_.pt_anchor_f[i],
                                   atol=1e-5)


def test_harvest_is_a_noop_on_the_fused_path(run):
    vo = run["vo"]
    assert vo._pt_converged_dev is None and vo._ln_converged_dev is None
    alive = vo._seed_alive.copy()
    n_pt = int((vo.map.pt_status > 0).sum())
    vo._harvest_seeds()
    np.testing.assert_array_equal(vo._seed_alive, alive)
    assert int((vo.map.pt_status > 0).sum()) == n_pt


def test_start_and_last_processing_time(run):
    vo = port_handler()
    assert vo.last_processing_time() == 0.0
    vo.stage = tfh.STAGE_PAUSED
    vo.start()
    assert vo.stage == tfh.STAGE_FIRST
    running = run["vo"]
    assert running.stage == tfh.STAGE_DEFAULT
    running.start()
    assert running.stage == tfh.STAGE_DEFAULT
    t = running.last_processing_time()
    assert t > 0.0 and t == running.permon.timers["tot_time"]


def test_track_frame_core_blob_matches_track_frame_core(run):
    """The same step from one packed blob and from the tables themselves:
    exactly equal, as packing f32 / bool / small integers is exact."""
    vo = tckpt.load_state(run["path"], device="cpu")
    frame, m = vo.last_frame, vo.map
    center = frame.cam_center_w()
    pv = frame.pt_valid & (frame.pt_lm >= 0)
    lm = np.where(pv, frame.pt_lm, 0)
    sv = frame.seg_valid & (frame.seg_lm >= 0)
    slm = np.where(sv, frame.seg_lm, 0)
    tabs = [frame.pt_uv, frame.pt_f,
            np.linalg.norm(m.pt_pos[lm] - center, axis=-1),
            pv & (m.pt_status[lm] > 0), frame.seg_suv, frame.seg_euv,
            frame.seg_sf, frame.seg_ef,
            np.linalg.norm(m.ln_spos[slm] - center, axis=-1),
            np.linalg.norm(m.ln_epos[slm] - center, axis=-1),
            sv & (m.ln_status[slm] > 0), frame.R_f_w, frame.t_f_w,
            np.clip(m.pt_last_optim, -1, 2**24 - 1),
            np.clip(m.ln_last_optim, -1, 2**24 - 1)]
    caps = vo.cfg.caps
    specs = fused.last_blob_specs(caps.max_fts, caps.max_segs,
                                  caps.max_points, caps.max_lines)
    cur_pyr = build_pyramid(torch.tensor(run["img"]), vo.n_levels)
    n = vo.cfg.pipeline.n_pyr_levels
    kw = vo._fused_kwargs()
    mt = fused.map_tables_from_state(m)
    cam = (vo._fx, vo._fy, vo._cx, vo._cy)
    out_blob = fused.track_frame_core_blob(
        frame.pyr, cur_pyr, [p.clone() for p in m.kf_pyr[:n]],
        torch.as_tensor(fused.pack_blob_host(tabs)), mt, *cam, specs=specs,
        **kw)

    def one(a, kind):
        t = torch.as_tensor(np.asarray(a))
        return (t.bool() if kind == "bool" else t.float())[None]

    parts = [one(a, k) for a, (_, k) in zip(tabs, specs)]
    out = fused.track_frame_core(
        [p[None] for p in frame.pyr], [p[None] for p in cur_pyr],
        m.kf_atlas_flat(n)._replace(flat=m.kf_atlas_flat(n).flat[None]),
        fused.LastFrameTables(*parts[:11]), *parts[11:13],
        fused._one(mt), *parts[13:], *cam, **kw)
    leaves_b = fused._leaves(out_blob)
    leaves = fused._leaves(fused._first(out))
    assert len(leaves_b) == len(leaves) > 20
    for a, b in zip(leaves_b, leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert int(out_blob.pt.n_matches) > 20


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        a = torch.randn(64, 64)
        (a @ a).sum().item()
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
