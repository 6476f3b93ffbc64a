"""The undistort-on-ingest flow of tests/test_pipeline.py (radtan :356 and
ATAN :386) in both packages: frames rendered through the distorted camera,
undistorted once on the host with the camera's maps, tracked by
FrameHandlerMono on the ideal pinhole with fast_config(), 20 frames at
320x240. Each package renders and undistorts its own frames (the port's
renderer, camera models and maps are under test too); the port starts
from the JAX package's bootstrap RANSAC draws. Per-frame camera centres
agree within 2 mm, and each run meets the JAX test's ATE bound."""
import dataclasses

import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.camera import ATANCamera as TAtan
from plsvo_torch.camera import PinholeCamera as TPin
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.utils import dataset as tds
from plsvo_torch.utils import synthetic as tsyn
from plsvo_tpu.camera import ATANCamera, PinholeCamera
from plsvo_tpu.config import fast_config
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH
from plsvo_tpu.utils import dataset as jds
from plsvo_tpu.utils import synthetic as jsyn
from plsvo_tpu.utils import trajectory

from test_torch_pipeline import centers, first_default, jax_ransac_draws

torch.set_num_threads(1)

RADTAN = [-0.28, 0.07, 1e-4, 2e-5, 0.0]
N_FRAMES = 20
ATE_BOUND = 0.02  # tests/test_pipeline.py:383, :416


def cameras(model):
    if model == "radtan":
        args = (320, 240, 250.0, 250.0, 160.0, 120.0)
        return (PinholeCamera.create(*args, dist=RADTAN),
                TPin.create(*args, dist=RADTAN))
    args = (320, 240, 250.0 / 320, 250.0 / 240, 0.5, 0.5)
    return ATANCamera.create(*args, w=0.93), TAtan.create(*args, w=0.93)


def run_pair(model):
    """Both packages over the sequence of the JAX test (its `rng` fixture's
    scene, 0.025 m sideways per frame)."""
    jcam, tcam = cameras(model)
    jscene = jsyn.make_scene(np.random.default_rng(0), size=1024)
    tscene = tsyn.make_scene(np.random.default_rng(0), size=1024)
    jmaps, tmaps = jds.undistort_maps(jcam), tds.undistort_maps(tcam)
    cfg = fast_config()
    jvo = JFH(jcam.ideal(), cfg)
    tvo = tfh.FrameHandlerMono(
        tcam.ideal(), convert.config_from_dict(dataclasses.asdict(cfg)),
        device="cpu", ransac_draws=jax_ransac_draws)
    gt, diff = [], []
    for i in range(N_FRAMES):
        R = np.eye(3, dtype=np.float32)
        t = np.asarray([0.025 * i, 0.0, -2.0], np.float32)
        jimg = jds.undistort_image(np.asarray(jsyn.render_aa(jscene, jcam, R, t)[0]),
                                   jmaps)
        timg = tds.undistort_image(
            tsyn.render_aa(tscene, tcam, R, t, device="cpu").numpy(), tmaps)
        diff.append(float(np.abs(jimg - timg).max()))
        jvo.add_image(jimg, i / 30.0)
        tvo.add_image(timg, i / 30.0)
        gt.append(t)
    return dict(jres=jvo.results, tres=tvo.results, tvo=tvo, gt=np.stack(gt),
                frame_diff=max(diff))


@pytest.fixture(scope="module", params=["radtan", "atan"])
def run(request):
    return run_pair(request.param)


def test_distorted_frames_agree(run):
    """The two packages' undistorted frames differ by less than a
    hundredth of a grey level."""
    assert run["frame_diff"] < 0.01, run["frame_diff"]


def test_distorted_port_tracks_with_jax(run):
    jres, tres = run["jres"], run["tres"]
    fd = first_default(tres)
    assert fd == first_default(jres)
    assert all(r.stage == tfh.STAGE_DEFAULT for r in tres[fd:])
    assert run["tvo"].n_relocalizations == 0
    ate = trajectory.ate_rmse(centers(tres[fd:]).astype(np.float64),
                              run["gt"][fd:].astype(np.float64))
    jate = trajectory.ate_rmse(centers(jres[fd:]).astype(np.float64),
                               run["gt"][fd:].astype(np.float64))
    assert ate < ATE_BOUND and jate < ATE_BOUND, (ate, jate)
    d = np.linalg.norm(centers(tres) - centers(jres), axis=-1)
    assert d.max() < 2e-3, d
