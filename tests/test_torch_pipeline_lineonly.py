"""The port's line-only mode and its no-edgelet mode on the CPU, against
the JAX package's, each as two FrameHandlerMono on identical numpy frames
(rendered by JAX, JAX's bootstrap RANSAC draws given to the port):

- line-only (`fast_config()` with has_pt=False, local BA on) on the
  line-rich scene of tests/test_pipeline.py
  (`make_scene(default_rng(7), n_rects=420, n_blobs=40)`, 28 frames):
  bootstrap from segment KLT targets, then tracking on the bootstrap
  points and line landmarks, no point seeds, every point and endpoint
  refined by align2d_atlas;
- use_edgelets=False (`fast_config()` otherwise unmodified) on the golden
  28-frame sequence, held to JAX frame by frame."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.camera import PinholeCamera as TCam
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.pipeline.state import map_statistics, validate_map
from plsvo_tpu.config import fast_config
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH
from plsvo_tpu.pipeline.state import map_statistics as jmap_statistics
from plsvo_tpu.utils import synthetic, trajectory

from test_torch_pipeline import CAM, centers, first_default, jax_ransac_draws
from test_torch_step import golden_frames

torch.set_num_threads(1)


def config(**override):
    cfg = fast_config()
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **override))


def line_rich_frames(n_frames=28):
    """The frames of tests/test_pipeline.py's
    test_pipeline_lines_only_default_gates."""
    scene = synthetic.make_scene(np.random.default_rng(7), size=1024,
                                 texel_size=0.004, n_rects=420, n_blobs=40)
    imgs = []
    for i in range(n_frames):
        ang = 0.003 * i
        R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0],
                       np.float32)
        imgs.append(np.asarray(synthetic.render_aa(
            scene, CAM, jnp.asarray(R), jnp.asarray(t))[0]))
    return imgs


def run_both(cfg, imgs):
    jvo = JFH(CAM, cfg)
    jres = [jvo.add_image(im, i / 30.0) for i, im in enumerate(imgs)]
    tvo = tfh.FrameHandlerMono(
        TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0),
        convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu",
        ransac_draws=jax_ransac_draws)
    tres = [tvo.add_image(im, i / 30.0) for i, im in enumerate(imgs)]
    return dict(jres=jres, tres=tres, jvo=jvo, tvo=tvo)


@pytest.fixture(scope="module")
def lineonly():
    return run_both(config(has_pt=False), line_rich_frames())


@pytest.fixture(scope="module")
def no_edgelets():
    return run_both(config(use_edgelets=False), golden_frames(28))


def _within(a, b):
    """Within 10% of JAX's b, or 1 where JAX has fewer than 10."""
    return abs(a - b) <= (0.1 * b if b >= 10 else 1)


def test_lineonly_port_bootstraps_with_jax_and_keeps_tracking(lineonly):
    jres, tres, tvo = lineonly["jres"], lineonly["tres"], lineonly["tvo"]
    fd = first_default(tres)
    assert fd == first_default(jres)
    tail = tres[fd:]
    assert all(r.stage == tfh.STAGE_DEFAULT for r in tail), \
        [r.stage for r in tail]
    assert all(r.quality == tfh.QUALITY_GOOD for r in tail[2:])
    assert tvo.n_relocalizations == 0
    assert validate_map(tvo.map) == []


def test_lineonly_port_maps_lines_only(lineonly):
    jres, tres, tvo = lineonly["jres"], lineonly["tres"], lineonly["tvo"]
    # no point seed was ever installed: the depth filter maps lines only
    assert not (tvo._seed_install_frame >= 0).any()
    assert not tvo._seed_alive.any()
    st, sj = map_statistics(tvo.map), jmap_statistics(lineonly["jvo"].map)
    assert sj["n_lines"] >= 5
    assert _within(st["n_lines"], sj["n_lines"]), (st, sj)
    mj = max(r.n_seg_matches for r in jres)
    mt = max(r.n_seg_matches for r in tres)
    assert mj >= 5 and _within(mt, mj), (mt, mj)


def test_no_edgelets_port_matches_jax_per_frame(no_edgelets):
    jres, tres, tvo = no_edgelets["jres"], no_edgelets["tres"], no_edgelets["tvo"]
    fd = first_default(tres)
    assert fd == first_default(jres)
    assert all(r.stage == tfh.STAGE_DEFAULT for r in tres[fd:])
    gt = np.stack([np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0])
                   for i in range(28)])
    ate = trajectory.ate_rmse(centers(tres[fd:]).astype(np.float64),
                              gt[fd:], with_scale=True)
    assert ate < 0.006, ate
    d = np.linalg.norm(centers(tres) - centers(jres), axis=-1)
    assert d.max() < 2e-3, d
    # no edgelet seed was installed
    assert not (tvo._seed_host["type"][tvo._seed_install_frame >= 0] == 1).any()
    # point matches per frame within 5% (or 2) of JAX's
    for t, j in zip(tres, jres):
        assert abs(t.n_pt_matches - j.n_pt_matches) <= max(
            2, 0.05 * j.n_pt_matches), (t.frame_id, t.n_pt_matches,
                                        j.n_pt_matches)
