"""The port's main path on the CPU against the JAX package's: both
FrameHandlerMono run the golden 28-frame 320x240 sequence of
tests/test_pipeline.py with `fast_config()` unmodified (points, edgelets
and lines, local BA at every keyframe, sync), on identical numpy frames,
with JAX's bootstrap RANSAC draws given to the port. One tracked
frame with matched line landmarks is also stepped by both packages from
the same state, and the combined point + segment reprojection is held
against JAX on identical inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.camera import PinholeCamera as TCam
from plsvo_torch.image import build_pyramid as tbuild_pyramid
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.pipeline import fused as tfused
from plsvo_torch.pipeline import reprojector as trep
from plsvo_torch.pipeline.state import FrameState as TFrameState
from plsvo_torch.pipeline.state import map_statistics, validate_map
from plsvo_tpu.camera import PinholeCamera
from plsvo_tpu.config import fast_config
from plsvo_tpu.image import build_pyramid
from plsvo_tpu.pipeline import fused as jfused
from plsvo_tpu.pipeline import reprojector as jrep
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH
from plsvo_tpu.pipeline.state import map_statistics as jmap_statistics
from plsvo_tpu.utils import trajectory

from test_torch_pipeline import CAM, centers, first_default, jax_ransac_draws
from test_torch_step import golden_frames

STEP_FRAME = 26  # the JAX run matches line landmarks from frame 25 on

# One intra-op thread per test process, as in test_torch_pipeline.py.
torch.set_num_threads(1)


def lines_config():
    cfg = fast_config()
    assert cfg.pipeline.has_ls and cfg.pipeline.loba_enabled
    return cfg


def tcam():
    return TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0)


def port_handler_from(jvo, cfg):
    """A port handler on the CPU holding the JAX handler's state, line
    seeds and line tables included."""
    tvo = tfh.FrameHandlerMono(tcam(), convert.config_from_dict(
        dataclasses.asdict(cfg)), device="cpu")
    jm = jvo.map
    tables = {k: v for k, v in vars(jm).items() if isinstance(v, np.ndarray)}
    tables["kf_pyr"] = [np.asarray(p) for p in jm.kf_pyr]
    tvo.map = convert.map_state_from_numpy(
        tables, tvo.cfg, tvo.n_levels, (CAM.height, CAM.width),
        (CAM.fx, CAM.fy, CAM.cx, CAM.cy), device="cpu")
    fields = {f.name: getattr(jvo.last_frame, f.name)
              for f in dataclasses.fields(TFrameState)}
    fields["pyr"] = [np.asarray(p) for p in jvo.last_frame.pyr]
    tvo.last_frame = convert.frame_state_from_numpy(fields, device="cpu")
    tvo.pt_seeds = convert.point_seeds_from_numpy(
        {k: np.asarray(v) for k, v in jvo.pt_seeds._asdict().items()},
        device="cpu")
    tvo.ln_seeds = convert.line_seeds_from_numpy(
        {k: np.asarray(v) for k, v in jvo.ln_seeds._asdict().items()},
        device="cpu")
    tvo._seed_alive = jvo._seed_alive.copy()
    tvo._lnseed_alive = jvo._lnseed_alive.copy()
    tvo.batch_counter = jvo.batch_counter
    tvo.stage = tfh.STAGE_DEFAULT
    tvo.frame_id = jvo.frame_id
    return tvo


def _reproject_both(jvo, tvo, img, R, t):
    """reproject_combined of both packages on the same map, keyframes,
    frame and pose."""
    n = jvo.cfg.pipeline.n_pyr_levels
    caps = jvo.cfg.caps
    kw = dict(cell_size=25, cell_size_segs=25, max_pts_out=caps.max_fts,
              max_segs_out=caps.max_segs, has_edgelets=True)
    jmt = jfused.map_tables_from_state(jvo.map)
    j = jrep.reproject_combined(
        *jmt[:6], *jmt[8:12], *jmt[12:21], jmt.kf_R, jmt.kf_t,
        jvo.map.kf_atlas_flat(n), build_pyramid(jnp.asarray(img), n), jnp.asarray(R), jnp.asarray(t),
        CAM.fx, CAM.fy, CAM.cx, CAM.cy, pt_anchor_type=jmt.pt_anchor_type,
        pt_anchor_dir=jmt.pt_anchor_dir, **kw)
    tmt = tfused.map_tables_from_state(tvo.map)
    t_ = trep.reproject_combined(
        *tmt[:6], *tmt[8:12], *tmt[12:21], tmt.kf_R, tmt.kf_t,
        tvo.map.kf_atlas_flat(n), tbuild_pyramid(torch.tensor(img), n),
        torch.tensor(R), torch.tensor(t), 250.0, 250.0, 160.0, 120.0,
        pt_anchor_type=tmt.pt_anchor_type, pt_anchor_dir=tmt.pt_anchor_dir,
        **kw)
    return j, t_


@pytest.fixture(scope="module")
def runs():
    cfg = lines_config()
    imgs = golden_frames(28)
    jvo = JFH(CAM, cfg)
    jres = [jvo.add_image(im, i / 30.0) for i, im in enumerate(imgs[:STEP_FRAME])]
    # the tracked-frame step of both packages from the same state
    tvo_s = port_handler_from(jvo, cfg)
    img = imgs[STEP_FRAME]
    jvo.map.mt_mark_clean()
    jstep = jfused.track_frame_step(
        *jvo._step_inputs(build_pyramid(jnp.asarray(img), jvo.n_levels)),
        **jvo._step_kwargs())
    tstep = tfused.track_frame_step(
        *tvo_s._step_inputs(tbuild_pyramid(torch.tensor(img), tvo_s.n_levels)),
        **tvo_s._step_kwargs())
    R, t = (np.asarray(a) for a in (jstep.fused.R_f_w, jstep.fused.t_f_w))
    reproj = _reproject_both(jvo, tvo_s, img, R, t)
    jres += [jvo.add_image(im, i / 30.0)
             for i, im in enumerate(imgs[STEP_FRAME:], STEP_FRAME)]
    tvo = tfh.FrameHandlerMono(tcam(), convert.config_from_dict(
        dataclasses.asdict(cfg)), device="cpu", ransac_draws=jax_ransac_draws)
    tres = [tvo.add_image(im, i / 30.0) for i, im in enumerate(imgs)]
    gt = np.stack([np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0],
                              np.float32) for i in range(28)])
    return dict(jres=jres, tres=tres, jvo=jvo, tvo=tvo, gt=gt, jstep=jstep,
                tstep=tstep, reproj=reproj)


def test_lines_port_bootstraps_with_jax_and_keeps_tracking(runs):
    jres, tres = runs["jres"], runs["tres"]
    fd = first_default(tres)
    assert fd == first_default(jres)
    assert all(r.stage == tfh.STAGE_DEFAULT for r in tres[fd:])
    assert all(r.quality == tfh.QUALITY_GOOD for r in tres[fd + 3:])
    assert runs["tvo"].n_relocalizations == 0
    # local BA ran at keyframes and wrote keyframes and landmarks back
    written = [(f["local_ba_kfs"], f["local_ba_landmarks"])
               for f in runs["tvo"].permon.frames if "local_ba_kfs" in f]
    assert written and all(k > 0 and n > 0 for k, n in written), written


def test_lines_port_trajectory_matches_jax(runs):
    jres, tres = runs["jres"], runs["tres"]
    fd = first_default(tres)
    ate = trajectory.ate_rmse(centers(tres[fd:]).astype(np.float64),
                              runs["gt"][fd:].astype(np.float64),
                              with_scale=True)
    # JAX measures 0.00388 on this sequence (0.00521 without local BA);
    # the JAX golden bound is 0.006 (tests/test_pipeline.py:81)
    assert ate < 0.006, ate
    d = np.linalg.norm(centers(tres) - centers(jres), axis=-1)
    assert d.max() < 2e-3, d


def test_lines_port_segments_and_line_landmarks_match_jax(runs):
    jres, tres, tvo = runs["jres"], runs["tres"], runs["tvo"]
    assert (tvo._lnseed_install_frame >= 0).any()  # line seeds installed
    # from the first frame where JAX matches a line landmark on
    first = [r.n_seg_matches > 0 for r in jres].index(True)
    med_j = np.median([r.n_seg_matches for r in jres[first:]])
    med_t = np.median([r.n_seg_matches for r in tres[first:]])
    assert med_j > 0
    assert abs(med_t - med_j) <= 0.1 * med_j, (med_t, med_j)
    st, sj = map_statistics(tvo.map), jmap_statistics(runs["jvo"].map)
    assert sj["n_lines"] > 0
    assert abs(st["n_lines"] - sj["n_lines"]) <= 0.1 * sj["n_lines"], (st, sj)
    assert st["n_keyframes"] == sj["n_keyframes"], (st, sj)
    assert validate_map(tvo.map) == []


def test_reproject_combined_matches_jax(runs):
    (jp, js), (tp, ts) = runs["reproj"]
    for j, t, uv in ((jp, tp, ("uv",)), (js, ts, ("s_uv", "e_uv"))):
        m = np.asarray(j.matched)
        np.testing.assert_array_equal(t.matched.numpy(), m)
        np.testing.assert_array_equal(t.lm_idx.numpy()[m], np.asarray(j.lm_idx)[m])
        for name in uv:
            np.testing.assert_allclose(getattr(t, name).numpy()[m],
                                       np.asarray(getattr(j, name))[m],
                                       atol=2e-3, err_msg=name)
    assert np.asarray(jp.matched).sum() >= 20
    assert np.asarray(js.matched).sum() >= 3


def test_lines_step_matches_jax(runs):
    jstep, tstep = runs["jstep"], runs["tstep"]
    jf, tf = jstep.fused, tstep.fused
    np.testing.assert_allclose(tf.R_f_w.numpy(), np.asarray(jf.R_f_w), atol=1e-4)
    np.testing.assert_allclose(tf.t_f_w.numpy(), np.asarray(jf.t_f_w), atol=1e-4)
    j_ids = set(np.asarray(jf.seg.lm_idx)[np.asarray(jf.seg.matched)].tolist())
    t_ids = set(tf.seg.lm_idx.numpy()[tf.seg.matched.numpy()].tolist())
    assert len(j_ids) >= 3 and j_ids == t_ids
    # the line seeds went through the combined seed batch of both packages
    jl, tl = jstep.ln_seeds, tstep.ln_seeds
    np.testing.assert_array_equal(tl.alive.numpy(), np.asarray(jl.alive))
    live = np.asarray(jl.alive)
    assert live.sum() >= 5
    for name in ("mu_s", "mu_e", "a", "b"):
        np.testing.assert_allclose(getattr(tl, name).numpy()[live],
                                   np.asarray(getattr(jl, name))[live],
                                   rtol=1e-3, err_msg=name)
