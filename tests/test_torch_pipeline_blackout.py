"""Sync relocalization after a blackout in both packages
(tests/test_pipeline.py:329): the golden sequence is tracked for two
thirds of its 28 frames, a black frame fails tracking, and replaying the
frames from just before the blackout relocalizes against the closest
keyframe and resumes DEFAULT tracking. The port (fast_config(), sync,
the JAX package's bootstrap draws) recovers at the same replayed frame as
the JAX package, at a camera centre within 2 mm of its."""
import dataclasses

import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.camera import PinholeCamera as TPin
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_tpu.config import fast_config
from plsvo_tpu.pipeline.frame_handler import STAGE_RELOCALIZING
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH

from test_torch_pipeline import CAM, jax_ransac_draws
from test_torch_step import golden_frames

torch.set_num_threads(1)


def blackout(vo, imgs):
    """The JAX test's steps; returns (stage after the black frame, the
    replayed frame index that recovered or None, the results of the
    replay)."""
    split = 2 * len(imgs) // 3
    for i in range(split):
        vo.add_image(imgs[i], i / 30.0)
    assert vo.stage == "default"
    vo.add_image(np.zeros_like(imgs[0]), split / 30.0)
    after_black = vo.stage
    replay = []
    for j in range(split - 2, len(imgs)):
        r = vo.add_image(imgs[j], (j + 10) / 30.0)
        replay.append(r)
        if r.stage == "default" or vo.stage == "default":
            return after_black, j, replay
    return after_black, None, replay


@pytest.fixture(scope="module")
def runs():
    imgs = golden_frames(28)
    cfg = fast_config()
    jout = blackout(JFH(CAM, cfg), imgs)
    tvo = tfh.FrameHandlerMono(
        TPin.create(320, 240, 250.0, 250.0, 160.0, 120.0),
        convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu",
        ransac_draws=jax_ransac_draws)
    return jout, blackout(tvo, imgs), tvo


def test_sync_blackout_relocalizes_and_recovers(runs):
    (jstage, jj, jreplay), (tstage, tj, treplay), tvo = runs
    assert jstage == tstage == STAGE_RELOCALIZING == tfh.STAGE_RELOCALIZING
    assert jj is not None, "the JAX package did not recover"
    assert tj == jj, (tj, jj)
    assert tvo.n_relocalizations >= 1
    assert [r.stage for r in treplay] == [r.stage for r in jreplay]


def test_sync_blackout_recovered_pose_matches_jax(runs):
    (_, _, jreplay), (_, _, treplay), _ = runs
    for jr, tr in zip(jreplay, treplay):
        d = np.linalg.norm(-tr.R_f_w.T @ tr.t_f_w + jr.R_f_w.T @ jr.t_f_w)
        assert d < 2e-3, (tr.frame_id, d)
