"""Checkpoint and resume of the port's handler (tests/test_checkpoint.py on
the port): a handler saved after 14 frames and loaded continues exactly as
the uninterrupted one; the seed mirrors survive; a pipelined handler is
saved after flush() and resumes from a full upload of the map; a handler
with frames in flight refuses to save."""
import dataclasses

import numpy as np
import pytest
import torch

from plsvo_torch.camera import PinholeCamera
from plsvo_torch.config import fast_config
from plsvo_torch.pipeline.frame_handler import FrameHandlerMono
from plsvo_torch.utils import checkpoint, synthetic

torch.set_num_threads(1)

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)


def frames(n=20):
    scene = synthetic.make_scene(np.random.default_rng(0), size=1024,
                                 texel_size=0.004)
    return [synthetic.render_aa(scene, CAM, np.eye(3, dtype=np.float32),
                                np.asarray([0.025 * i, 0.0, -2.0], np.float32),
                                device="cpu").numpy() for i in range(n)]


@pytest.fixture(scope="module")
def imgs():
    return frames()


def pipelined(depth):
    cfg = fast_config()
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, pipelined=True, pipeline_depth=depth))


def test_checkpoint_resume_continues_identically(tmp_path, imgs):
    vo_a = FrameHandlerMono(CAM, fast_config(), device="cpu")
    for i in range(14):
        vo_a.add_image(imgs[i], i / 30.0)
    p = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(vo_a, p)
    vo_b = checkpoint.load_state(p, device="cpu")
    assert vo_b.stage == vo_a.stage == "default"
    assert vo_b.map.n_keyframes() == vo_a.map.n_keyframes()
    np.testing.assert_allclose(vo_b.map.pt_pos, vo_a.map.pt_pos)
    np.testing.assert_allclose(vo_b.pt_seeds.mu.numpy(), vo_a.pt_seeds.mu.numpy())
    for a, b in zip(vo_a.map.kf_pyr, vo_b.map.kf_pyr):
        assert torch.equal(a, b)
    for i in range(14, 20):
        ra = vo_a.add_image(imgs[i], i / 30.0)
        rb = vo_b.add_image(imgs[i], i / 30.0)
        np.testing.assert_allclose(rb.t_f_w, ra.t_f_w, atol=1e-5)
        np.testing.assert_allclose(rb.R_f_w, ra.R_f_w, atol=1e-5)


def test_checkpoint_preserves_seed_mirrors(tmp_path, imgs):
    vo = FrameHandlerMono(CAM, fast_config(), device="cpu")
    for i in range(14):
        vo.add_image(imgs[i], i / 30.0)
    assert vo._seed_alive.sum() > 0
    p = str(tmp_path / "c.npz")
    checkpoint.save_state(vo, p)
    vo2 = checkpoint.load_state(p, device="cpu")
    np.testing.assert_array_equal(vo2._seed_alive, vo._seed_alive)
    np.testing.assert_array_equal(vo2._lnseed_alive, vo._lnseed_alive)
    np.testing.assert_allclose(vo2._seed_host["uv"], vo._seed_host["uv"])
    np.testing.assert_array_equal(vo2._seed_install_frame,
                                  vo._seed_install_frame)
    assert torch.equal(vo2.generator.get_state(), vo.generator.get_state())
    with np.load(p) as z:
        port_keys = sorted(k for k in z.files if k.startswith("port."))
    assert port_keys == ["port.generator", "port.lnseed_install_frame",
                         "port.seed_install_frame"]


def test_pipelined_checkpoint_after_flush(tmp_path, imgs):
    """A pipelined handler saved after flush() continues as the original
    does after the same flush (both restart the chain from a full upload of
    the map); saving with frames in flight raises."""
    vo_a = FrameHandlerMono(CAM, pipelined(2), device="cpu")
    for i in range(14):
        vo_a.add_image(imgs[i], i / 30.0)
    p = str(tmp_path / "p.npz")
    with pytest.raises(ValueError, match="flush"):
        checkpoint.save_state(vo_a, p)
    vo_a.flush()
    vo_a.sync_carry()
    checkpoint.save_state(vo_a, p)
    vo_b = checkpoint.load_state(p, device="cpu")
    assert vo_b._mt_carry is None and vo_b.cfg.pipeline.pipelined
    out_a, out_b = [], []
    for i in range(14, 20):
        out_a.append(vo_a.add_image(imgs[i], i / 30.0))
        out_b.append(vo_b.add_image(imgs[i], i / 30.0))
    out_a = [r for r in out_a if r is not None] + vo_a.flush()
    out_b = [r for r in out_b if r is not None] + vo_b.flush()
    assert [r.frame_id for r in out_b] == [r.frame_id for r in out_a] \
        == list(range(14, 20))
    for ra, rb in zip(out_a, out_b):
        assert rb.stage == ra.stage == "default"
        np.testing.assert_allclose(rb.t_f_w, ra.t_f_w, atol=1e-5)
        np.testing.assert_allclose(rb.R_f_w, ra.R_f_w, atol=1e-5)
