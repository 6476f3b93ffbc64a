"""The photo-textured sequences of tests/test_pipeline.py in both
packages: the box scene with matplotlib's photograph as texture (:495,
non-planar) and the plane textured with it (:510), 28 frames at 320x240,
fast_config(). Each package renders its own frames; the port starts from
the JAX package's bootstrap RANSAC draws. Per-frame camera centres agree
within 2 mm, and each run meets the JAX test's bounds."""
import dataclasses

import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.camera import PinholeCamera as TPin
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.utils import synthetic as tsyn
from plsvo_tpu.config import fast_config
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH
from plsvo_tpu.utils import synthetic as jsyn
from plsvo_tpu.utils import trajectory

from test_torch_pipeline import CAM, centers, first_default, jax_ransac_draws

torch.set_num_threads(1)

TCAM = TPin.create(320, 240, 250.0, 250.0, 160.0, 120.0)
# the JAX tests' ATE bounds (tests/test_pipeline.py:507, :536)
ATE_BOUND = {"nonplanar": 0.005, "plane": 0.012}


def scenes(kind):
    """(JAX scene, port scene, JAX renderer, port renderer)."""
    jphoto = jsyn.make_photo_scene(texel_size=0.002, tiles=3)
    tphoto = tsyn.make_photo_scene(texel_size=0.002, tiles=3)
    if kind == "plane":
        return jphoto, tphoto, jsyn.render_aa, tsyn.render_aa
    box = dict(texel_size=0.002, n_boxes=6, height_range=(0.10, 0.25))
    return (jsyn.make_box_scene(np.random.default_rng(11),
                                texture=np.asarray(jphoto.texture), **box),
            tsyn.make_box_scene(np.random.default_rng(11),
                                texture=tphoto.texture, **box),
            jsyn.render_boxes_aa, tsyn.render_boxes_aa)


@pytest.fixture(scope="module", params=["nonplanar", "plane"])
def run(request):
    jscene, tscene, jrender, trender = scenes(request.param)
    cfg = fast_config()
    jvo = JFH(CAM, cfg)
    tvo = tfh.FrameHandlerMono(
        TCAM, convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu",
        ransac_draws=jax_ransac_draws)
    gt = []
    for i in range(28):
        ang = 0.003 * i
        R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0], np.float32)
        jvo.add_image(np.asarray(jrender(jscene, CAM, R, t)[0]), i / 30.0)
        tvo.add_image(trender(tscene, TCAM, R, t, device="cpu"), i / 30.0)
        gt.append(t)
    return dict(kind=request.param, jres=jvo.results, tres=tvo.results,
                tvo=tvo, gt=np.stack(gt))


def test_photo_port_tracks_with_jax(run):
    jres, tres = run["jres"], run["tres"]
    fd = first_default(tres)
    assert fd == first_default(jres)
    assert all(r.stage == tfh.STAGE_DEFAULT for r in tres[fd:])
    assert run["tvo"].n_relocalizations == 0
    if run["kind"] == "plane":
        # tests/test_pipeline.py:538: the photograph feeds the depth filter
        assert (run["tvo"].map.pt_status > 0).sum() > 30


def test_photo_port_trajectory_matches_jax(run):
    jres, tres = run["jres"], run["tres"]
    fd = first_default(tres)
    ate = trajectory.ate_rmse(centers(tres[fd:]).astype(np.float64),
                              run["gt"][fd:].astype(np.float64))
    assert ate < ATE_BOUND[run["kind"]], ate
    d = np.linalg.norm(centers(tres) - centers(jres), axis=-1)
    assert d.max() < 2e-3, d
