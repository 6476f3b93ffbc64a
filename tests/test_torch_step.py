"""One tracked-frame step of the port against the JAX package's, from the
same mid-sequence state.

The JAX FrameHandlerMono runs the golden 320x240 sequence (points-only sync
config, `fast_config` capacities) up to frame 22. Its config, last frame,
map tables and device seed table cross over through `plsvo_torch.convert`,
and both packages run the fused frame step on frame 22."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.camera import PinholeCamera as TCam
from plsvo_torch.image import build_pyramid as tbuild_pyramid
from plsvo_torch.pipeline import fused as tfused
from plsvo_torch.pipeline.frame_handler import FrameHandlerMono as TFH
from plsvo_torch.pipeline.state import FrameState as TFrameState
from plsvo_tpu.camera import PinholeCamera
from plsvo_tpu.config import fast_config
from plsvo_tpu.image import build_pyramid
from plsvo_tpu.pipeline import fused as jfused
from plsvo_tpu.pipeline.frame_handler import STAGE_DEFAULT
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH
from plsvo_tpu.utils import synthetic

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
STEP_FRAME = 22


def slice_config():
    cfg = fast_config()
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, has_ls=False, init_ls=False, loba_enabled=False,
        pipelined=False))


def golden_frames(n_frames):
    """Frames of the golden sequence of tests/test_pipeline.py (seed 7)."""
    scene = synthetic.make_scene(np.random.default_rng(7), size=1024,
                                 texel_size=0.004)
    imgs = []
    for i in range(n_frames):
        ang = 0.003 * i
        R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0], np.float32)
        img, _ = synthetic.render_aa(scene, CAM, jnp.asarray(R), jnp.asarray(t))
        imgs.append(np.asarray(img))
    return imgs


def port_handler_from(jvo, cfg):
    """A port FrameHandlerMono on the CPU holding the JAX handler's state."""
    tvo = TFH(TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0),
              convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    jm = jvo.map
    tables = {k: v for k, v in vars(jm).items() if isinstance(v, np.ndarray)}
    tables["kf_pyr"] = [np.asarray(p) for p in jm.kf_pyr]
    tvo.map = convert.map_state_from_numpy(
        tables, tvo.cfg, tvo.n_levels, (CAM.height, CAM.width),
        (CAM.fx, CAM.fy, CAM.cx, CAM.cy), device="cpu")
    last = jvo.last_frame
    fields = {f.name: getattr(last, f.name)
              for f in dataclasses.fields(TFrameState)}
    fields["pyr"] = [np.asarray(p) for p in last.pyr]
    tvo.last_frame = convert.frame_state_from_numpy(fields, device="cpu")
    tvo.pt_seeds = convert.point_seeds_from_numpy(
        {k: np.asarray(v) for k, v in jvo.pt_seeds._asdict().items()},
        device="cpu")
    tvo._seed_alive = jvo._seed_alive.copy()
    tvo.batch_counter = jvo.batch_counter
    tvo.stage = STAGE_DEFAULT
    tvo.frame_id = jvo.frame_id
    return tvo


@pytest.fixture(scope="module")
def steps():
    cfg = slice_config()
    imgs = golden_frames(STEP_FRAME + 1)
    jvo = JFH(CAM, cfg)
    for i in range(STEP_FRAME):
        jvo.add_image(imgs[i], i / 30.0)
    assert jvo.stage == STAGE_DEFAULT
    tvo = port_handler_from(jvo, cfg)
    img = imgs[STEP_FRAME]
    jvo.map.mt_mark_clean()
    jstep = jfused.track_frame_step(
        *jvo._step_inputs(build_pyramid(jnp.asarray(img), jvo.n_levels)),
        **jvo._step_kwargs())
    tpyr = tbuild_pyramid(torch.as_tensor(img), tvo.n_levels)
    tstep = tfused.track_frame_step(*tvo._step_inputs(tpyr),
                                    **tvo._step_kwargs())
    return jstep, tstep


def test_step_pose_matches_jax(steps):
    jstep, tstep = steps
    np.testing.assert_allclose(tstep.fused.R_f_w.numpy(),
                               np.asarray(jstep.fused.R_f_w), atol=1e-4)
    np.testing.assert_allclose(tstep.fused.t_f_w.numpy(),
                               np.asarray(jstep.fused.t_f_w), atol=1e-4)


def test_step_matched_landmarks_match_jax(steps):
    jstep, tstep = steps
    jpt, tpt = jstep.fused.pt, tstep.fused.pt
    j_ids = set(np.asarray(jpt.lm_idx)[np.asarray(jpt.matched)].tolist())
    t_ids = set(tpt.lm_idx.numpy()[tpt.matched.numpy()].tolist())
    assert len(j_ids) >= 20
    assert len(j_ids & t_ids) >= 0.98 * max(len(j_ids), len(t_ids)), \
        (sorted(j_ids ^ t_ids), len(j_ids), len(t_ids))


def test_step_seed_tables_match_jax(steps):
    jstep, tstep = steps
    js, ts = jstep.pt_seeds, tstep.pt_seeds
    both = np.asarray(js.alive) & ts.alive.numpy()
    assert both.sum() >= 20
    assert (np.asarray(js.alive) == ts.alive.numpy()).mean() >= 0.98
    for name in ("mu", "sigma2", "a", "b"):
        np.testing.assert_allclose(getattr(ts, name).numpy()[both],
                                   np.asarray(getattr(js, name))[both],
                                   rtol=1e-3, err_msg=name)
