"""A checkpoint crosses between the packages in both directions, in the
JAX package's file format: a handler of one package runs 14 frames of
tests/test_checkpoint.py's sequence and is saved; the other package loads
it and continues to frame 20 beside the saving package's own
continuation. Per-frame camera centres agree within 2 mm."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.camera import PinholeCamera as TPin
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.utils import checkpoint as tckpt
from plsvo_tpu.camera import PinholeCamera
from plsvo_tpu.config import fast_config
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH
from plsvo_tpu.utils import checkpoint as jckpt
from plsvo_tpu.utils import synthetic

from test_torch_pipeline import jax_ransac_draws

torch.set_num_threads(1)

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)


@pytest.fixture(scope="module")
def imgs():
    scene = synthetic.make_scene(np.random.default_rng(0), size=1024,
                                 texel_size=0.004)
    return [np.asarray(synthetic.render_aa(
        scene, CAM, jnp.eye(3), jnp.asarray([0.025 * i, 0.0, -2.0]))[0])
        for i in range(20)]


def port_handler():
    return tfh.FrameHandlerMono(
        TPin.create(320, 240, 250.0, 250.0, 160.0, 120.0),
        convert.config_from_dict(dataclasses.asdict(fast_config())),
        device="cpu", ransac_draws=jax_ransac_draws)


def continue_both(saver, loaded, imgs):
    d = []
    for i in range(14, 20):
        ra = saver.add_image(imgs[i], i / 30.0)
        rb = loaded.add_image(imgs[i], i / 30.0)
        assert ra.stage == rb.stage == "default", (i, ra.stage, rb.stage)
        d.append(np.linalg.norm(-ra.R_f_w.T @ ra.t_f_w + rb.R_f_w.T @ rb.t_f_w))
    return np.asarray(d)


def test_jax_checkpoint_resumed_by_port(tmp_path, imgs):
    jvo = JFH(CAM, fast_config())
    for i in range(14):
        jvo.add_image(imgs[i], i / 30.0)
    p = str(tmp_path / "jax.npz")
    jckpt.save_state(jvo, p)
    tvo = tckpt.load_state(p, device="cpu")
    assert tvo.stage == jvo.stage and tvo.frame_id == jvo.frame_id
    assert tvo.map.n_keyframes() == jvo.map.n_keyframes()
    np.testing.assert_array_equal(tvo.map.pt_pos, jvo.map.pt_pos)
    np.testing.assert_array_equal(tvo._seed_alive, jvo._seed_alive)
    np.testing.assert_array_equal(tvo.pt_seeds.mu.numpy(),
                                  np.asarray(jvo.pt_seeds.mu))
    d = continue_both(jvo, tvo, imgs)
    assert d.max() < 2e-3, d


def test_port_checkpoint_resumed_by_jax(tmp_path, imgs):
    tvo = port_handler()
    for i in range(14):
        tvo.add_image(imgs[i], i / 30.0)
    p = str(tmp_path / "port.npz")
    tckpt.save_state(tvo, p)
    jvo = jckpt.load_state(p)
    assert jvo.stage == tvo.stage and jvo.frame_id == tvo.frame_id
    np.testing.assert_array_equal(jvo.map.pt_pos, tvo.map.pt_pos)
    np.testing.assert_array_equal(np.asarray(jvo.ln_seeds.mu_s),
                                  tvo.ln_seeds.mu_s.numpy())
    assert jvo._any_line_seeds == bool(tvo._lnseed_alive.any())
    d = continue_both(tvo, jvo, imgs)
    assert d.max() < 2e-3, d
