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


RADTAN = [-0.28, 0.07, 1e-4, 2e-5, 0.0]


def _cameras(model):
    """The same camera in both packages: the radtan pinhole or the ATAN
    camera of tests/test_pipeline.py's undistort-on-ingest flows."""
    from plsvo_torch.camera import ATANCamera as TAtan
    from plsvo_tpu.camera import ATANCamera

    if model == "radtan":
        return (PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0,
                                     dist=RADTAN),
                TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0, dist=RADTAN))
    if model == "atan":
        args = (320, 240, 250.0 / 320, 250.0 / 240, 0.5, 0.5)
        return ATANCamera.create(*args, w=0.93), TAtan.create(*args, w=0.93)
    return (PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0),
            TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0))


@pytest.mark.parametrize("model", ["pinhole", "radtan", "atan"])
def test_distorted_render_matches_jax(model):
    """A camera with distortion renders distorted frames, as the JAX
    package's renderer does (it casts the rays of the distorted pixels):
    within 0.05 grey levels at the plane of render_aa's seed-1 scene."""
    jc, tc = _cameras(model)
    assert jc.has_distortion == tc.has_distortion == (model != "pinhole")
    R, t = np.eye(3, dtype=np.float32), np.asarray([0, 0, -2.0], np.float32)
    jimg, _ = jsyn.render_aa(jsyn.make_scene(np.random.default_rng(1),
                                             size=1024), jc, R, t)
    timg = tsyn.render_aa(tsyn.make_scene(np.random.default_rng(1), size=1024),
                          tc, R, t, device="cpu")
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=0.05,
                               rtol=0)


@pytest.mark.parametrize("model", ["radtan", "atan"])
def test_depth_at_matches_jax(model, rng):
    jc, tc = _cameras(model)
    scene = tsyn.make_scene(np.random.default_rng(1), size=64)
    R, t = pose(9)
    uv = rng.uniform(0, 240, (40, 2)).astype(np.float32)
    want = jsyn.depth_at(jsyn.make_scene(np.random.default_rng(1), size=64),
                         jc, jnp.asarray(R), jnp.asarray(t), jnp.asarray(uv))
    got = tsyn.depth_at(scene, tc, R, t, uv, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _box_scenes():
    return (jsyn.make_box_scene(np.random.default_rng(11), size=1024,
                                texel_size=0.004),
            tsyn.make_box_scene(np.random.default_rng(11), size=1024,
                                texel_size=0.004))


def test_box_scene_is_identical():
    j, t = _box_scenes()
    for name in ("texture", "origin", "box_min", "box_max"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)), name)
    assert (t.texel_size, t.plane_z) == (j.texel_size, j.plane_z)


@pytest.mark.parametrize("frame", [0, 27])
def test_render_boxes_aa_matches_jax(frame):
    """tests/test_pipeline.py's box sequence (seed 11) at its first and last
    poses."""
    j, t = _box_scenes()
    R, tr = pose(frame)
    jimg, _ = jsyn.render_boxes_aa(j, PinholeCamera.create(
        320, 240, 250.0, 250.0, 160.0, 120.0), jnp.asarray(R), jnp.asarray(tr))
    timg = tsyn.render_boxes_aa(t, TCam.create(320, 240, 250.0, 250.0, 160.0,
                                               120.0), R, tr, device="cpu")
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=0.05,
                               rtol=0)


def test_photo_scene_and_orbit_equal_jax():
    j = jsyn.make_photo_scene(texel_size=0.002, tiles=3)
    t = tsyn.make_photo_scene(texel_size=0.002, tiles=3)
    np.testing.assert_array_equal(t.texture, np.asarray(j.texture))
    np.testing.assert_array_equal(t.origin, np.asarray(j.origin))
    for (jr, jt), (tr, tt) in zip(jsyn.orbit_trajectory(30),
                                  tsyn.orbit_trajectory(30)):
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tt, jt)
