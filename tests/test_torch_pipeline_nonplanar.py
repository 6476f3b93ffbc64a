"""The port's main path on a non-planar scene, on the CPU, against the JAX
package's: both FrameHandlerMono run the box scene of tests/test_pipeline.py
(`make_box_scene(default_rng(11))`, textured boxes of 15-45 cm on the
ground plane, 28 frames at 320x240, rendered by JAX) with `fast_config()`
unmodified (points, edgelets and lines, local BA, sync). The homography
bootstrap locks onto the ground plane; the depth filter and local BA must
then map the boxes."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.camera import PinholeCamera as TCam
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.pipeline.state import validate_map
from plsvo_tpu.config import fast_config
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH
from plsvo_tpu.utils import synthetic, trajectory

from test_torch_pipeline import CAM, centers, first_default, jax_ransac_draws

torch.set_num_threads(1)


def box_frames(n_frames=28):
    """tests/test_pipeline.py's `_box_sequence` on its box scene."""
    scene = synthetic.make_box_scene(np.random.default_rng(11), size=1024,
                                     texel_size=0.004)
    imgs, gt = [], []
    for i in range(n_frames):
        ang = 0.003 * i
        R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0], np.float32)
        img, _ = synthetic.render_boxes_aa(scene, CAM, jnp.asarray(R),
                                           jnp.asarray(t))
        imgs.append(np.asarray(img))
        gt.append(t)
    return imgs, np.stack(gt)


@pytest.fixture(scope="module")
def runs():
    cfg = fast_config()
    imgs, gt = box_frames()
    jvo = JFH(CAM, cfg)
    jres = [jvo.add_image(im, i / 30.0) for i, im in enumerate(imgs)]
    tvo = tfh.FrameHandlerMono(
        TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0),
        convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu",
        ransac_draws=jax_ransac_draws)
    tres = [tvo.add_image(im, i / 30.0) for i, im in enumerate(imgs)]
    return dict(jres=jres, tres=tres, jvo=jvo, tvo=tvo, gt=gt)


def test_nonplanar_port_tracks_with_jax(runs):
    jres, tres, tvo = runs["jres"], runs["tres"], runs["tvo"]
    fd = first_default(tres)
    assert fd == first_default(jres)
    assert all(r.stage == tfh.STAGE_DEFAULT for r in tres[fd:])
    assert tvo.n_relocalizations == 0
    assert any(f.get("local_ba_kfs", 0) > 0 for f in tvo.permon.frames)
    assert validate_map(tvo.map) == []


def test_nonplanar_port_trajectory_matches_jax(runs):
    jres, tres = runs["jres"], runs["tres"]
    fd = first_default(tres)
    ate = trajectory.ate_rmse(centers(tres[fd:]).astype(np.float64),
                              runs["gt"][fd:].astype(np.float64),
                              with_scale=True)
    # the JAX golden bound (tests/test_pipeline.py:483)
    assert ate < 0.007, ate
    d = np.linalg.norm(centers(tres) - centers(jres), axis=-1)
    assert d.max() < 2e-3, d


def test_nonplanar_port_maps_the_boxes(runs):
    """At least 5 point landmarks 5% closer than the dominant plane (the
    box tops), as the JAX test asks of its own map."""
    m = runs["tvo"].map
    zs = m.pt_pos[m.pt_status > 0][:, 2]
    med = float(np.median(zs))
    assert (zs < 0.95 * med).sum() >= 5, (med, np.sort(zs)[:10])
