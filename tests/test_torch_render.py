"""The port's synthetic renderer against the JAX package's: the same
scene (same numpy texture stream) rendered at the same poses."""
import jax.numpy as jnp
import numpy as np
import pytest

from plsvo_torch.camera import PinholeCamera as TCam
from plsvo_torch.utils import synthetic as tsyn
from plsvo_tpu.camera import PinholeCamera
from plsvo_tpu.utils import synthetic as jsyn


def pose(i):
    ang = 0.003 * i
    R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0], np.float32)
    return R, t


def test_scene_texture_is_identical():
    a = jsyn.make_scene(np.random.default_rng(3), size=512, texel_size=0.006)
    b = tsyn.make_scene(np.random.default_rng(3), size=512, texel_size=0.006)
    np.testing.assert_array_equal(a.texture, b.texture)
    np.testing.assert_array_equal(a.origin, b.origin)
    assert (a.texel_size, a.plane_z) == (b.texel_size, b.plane_z)


@pytest.mark.parametrize("frame", [0, 11])
def test_render_aa_matches_jax(frame):
    scene = jsyn.make_scene(np.random.default_rng(7), size=1024,
                            texel_size=0.004)
    R, t = pose(frame)
    jimg, _ = jsyn.render_aa(scene, PinholeCamera.create(
        320, 240, 250.0, 250.0, 160.0, 120.0), jnp.asarray(R), jnp.asarray(t))
    timg = tsyn.render_aa(tsyn.make_scene(np.random.default_rng(7), size=1024,
                                          texel_size=0.004),
                          TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0),
                          R, t, device="cpu")
    assert tuple(timg.shape) == (240, 320)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=1e-3)


def test_render_batch_matches_single():
    scene = tsyn.make_scene(np.random.default_rng(1), size=256, texel_size=0.02)
    cam = TCam.create(160, 120, 125.0, 125.0, 80.0, 60.0)
    poses = [pose(i) for i in (0, 5)]
    batch = tsyn.render_batch_aa(scene, cam, [p[0] for p in poses],
                                 [p[1] for p in poses], device="cpu")
    for k, (R, t) in enumerate(poses):
        np.testing.assert_array_equal(batch[k].numpy(),
                                      tsyn.render_aa(scene, cam, R, t,
                                                     device="cpu").numpy())
