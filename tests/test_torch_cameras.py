"""The port's ATAN camera and the pinhole's frame test against the JAX
package's, on random points, and the undistortion maps of both camera
models (the host half of the undistort-on-ingest flow)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch.camera import ATANCamera as TAtan
from plsvo_torch.camera import PinholeCamera as TPin
from plsvo_torch.utils import dataset as tds
from plsvo_tpu.camera import ATANCamera, PinholeCamera
from plsvo_tpu.utils import dataset as jds

RADTAN = [-0.28, 0.07, 1e-4, 2e-5, 0.0]


def atan_pair(w=0.93):
    args = (320, 240, 250.0 / 320, 250.0 / 240, 0.5, 0.5)
    return ATANCamera.create(*args, w=w), TAtan.create(*args, w=w)


def test_atan_intrinsics_match_jax():
    j, t = atan_pair()
    for name in ("fx", "fy", "cx", "cy", "w"):
        assert getattr(t, name) == float(np.asarray(getattr(j, name))), name
    assert t.has_distortion and j.has_distortion
    assert not TAtan.create(64, 48, 0.8, 0.8, 0.5, 0.5, w=0.0).has_distortion
    ji, ti = j.ideal(), t.ideal()
    assert isinstance(ti, TPin) and not ti.has_distortion
    assert (ti.width, ti.height) == (ji.width, ji.height)
    for name in ("fx", "fy", "cx", "cy"):
        assert getattr(ti, name) == float(np.asarray(getattr(ji, name))), name


@pytest.mark.parametrize("op", ["project", "project_nodist", "unproject",
                                "unproject_nodist", "distort", "is_in_frame"])
def test_atan_ops_match_jax(op, rng):
    j, t = atan_pair()
    xyz = np.concatenate([rng.uniform(-1.5, 1.5, (200, 2)),
                          rng.uniform(0.5, 4.0, (200, 1))], -1).astype(np.float32)
    xyz[0] = [0.0, 0.0, 2.0]  # on the axis: the r -> 0 branch
    uv = rng.uniform(-20, 340, (200, 2)).astype(np.float32)
    uv[0] = [t.cx, t.cy]
    un = rng.uniform(-1.2, 1.2, (200, 2)).astype(np.float32)
    un[0] = 0.0
    ops = {
        "project": lambda c, a: c.project(a(xyz)),
        "project_nodist": lambda c, a: c.project(a(xyz), distort=False),
        "unproject": lambda c, a: c.unproject(a(uv)),
        "unproject_nodist": lambda c, a: c.unproject(a(uv), undistort=False),
        "distort": lambda c, a: c.distort(a(un)),
        "is_in_frame": lambda c, a: c.is_in_frame(a(uv), border=4.0, level=1),
    }
    want, got = ops[op](j, jnp.asarray), ops[op](t, torch.as_tensor)
    if op == "is_in_frame":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-6)


def test_atan_unproject_inverts_project(rng):
    _, t = atan_pair()
    xyz = np.concatenate([rng.uniform(-0.8, 0.8, (100, 2)),
                          np.ones((100, 1))], -1).astype(np.float32)
    f = t.unproject(t.project(torch.as_tensor(xyz)))
    want = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    np.testing.assert_allclose(f.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("border,level", [(0.0, 0), (8.0, 0), (2.0, 2)])
def test_pinhole_is_in_frame_matches_jax(border, level, rng):
    j = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0, dist=RADTAN)
    t = TPin.create(320, 240, 250.0, 250.0, 160.0, 120.0, dist=RADTAN)
    assert t.has_distortion and not t.ideal().has_distortion
    uv = rng.uniform(-10, 330, (500, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        t.is_in_frame(torch.as_tensor(uv), border, level).numpy(),
        np.asarray(j.is_in_frame(jnp.asarray(uv), border, level)))


@pytest.mark.parametrize("model", ["radtan", "atan"])
def test_undistort_maps_and_image_match_jax(model, rng):
    if model == "radtan":
        j = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0,
                                 dist=RADTAN)
        t = TPin.create(320, 240, 250.0, 250.0, 160.0, 120.0, dist=RADTAN)
    else:
        j, t = atan_pair()
    jm, tm = jds.undistort_maps(j), tds.undistort_maps(t)
    for a, b in zip(tm, jm):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    np.testing.assert_allclose(tds.undistort_image(img, tm),
                               jds.undistort_image(img, jm), atol=2e-2)
