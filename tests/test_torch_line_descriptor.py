"""LBD descriptors, the Hamming matcher and the device grid dedup of the
port against the JAX package's (plsvo_tpu/ops/line_descriptor.py,
plsvo_tpu/ops/lines.py::dedup_segments_grid), and the three tests of
tests/test_line_descriptor.py on the port alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import lie as tlie
from plsvo_torch.camera import PinholeCamera as TCam
from plsvo_torch.ops import line_descriptor as tlbd
from plsvo_torch.ops import lines as tlines
from plsvo_torch.utils import synthetic as tsyn
from plsvo_tpu.camera import PinholeCamera
from plsvo_tpu.ops import line_descriptor as jlbd
from plsvo_tpu.ops import lines as jlines
from plsvo_tpu.utils import synthetic as jsyn

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
TCAM = TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0)
FLOAT_TOL = 1e-5
POSE0 = (np.eye(3, dtype=np.float32), np.asarray([0, 0, -2.0], np.float32))


def jdetect(img, n=24):
    det = jlines.detect_segments(img, n_peaks=48)
    tab, _ = jlines.dedup_segments_grid(
        det, width=320, height=240, cell_size=25, max_segs=n, min_length=25.0)
    return tab


def tdetect(img, n=24):
    det = tlines.detect_segments(img, n_peaks=48)
    tab, _ = tlines.dedup_segments_grid(
        det, width=320, height=240, cell_size=25, max_segs=n, min_length=25.0)
    return tab


def test_binarization_pairs_equal_jax():
    ka, kb = jax.random.split(jax.random.PRNGKey(1234))
    for D in (72, 40):
        ia, ib = tlbd.binarization_pairs(D)
        np.testing.assert_array_equal(
            ia, np.asarray(jax.random.randint(ka, (256,), 0, D)))
        np.testing.assert_array_equal(
            ib, np.asarray(jax.random.randint(kb, (256,), 0, D)))


@pytest.fixture(scope="module")
def views():
    """Two nearby views of the seed-0 plane, segments detected by JAX, and
    both packages' descriptors of them."""
    scene = jsyn.make_scene(np.random.default_rng(0), size=1024)
    R1 = np.asarray(tlie.so3_exp(torch.tensor([0.0, 0.01, 0.005])), np.float32)
    t1 = POSE0[1] + np.asarray([0.03, -0.01, 0.0], np.float32)
    out = []
    for R, t in (POSE0, (R1, t1)):
        img, _ = jsyn.render_aa(scene, CAM, R, t)
        tab = jdetect(img)
        jd = jlbd.compute_lbd(img, tab.sp, tab.ep, tab.valid)
        td = tlbd.compute_lbd(*(torch.as_tensor(np.array(a)) for a in
                                (img, tab.sp, tab.ep, tab.valid)))
        out.append((tab, jd, td))
    return out


def test_compute_lbd_matches_jax(views):
    for tab, jd, td in views:
        assert int(np.asarray(jd.valid).sum()) >= 4
        np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
        jf = np.asarray(jd.float_desc)
        np.testing.assert_allclose(td.float_desc.numpy(), jf, atol=FLOAT_TOL,
                                   rtol=0)
        # a bit may flip only where the two entries it compares are within
        # the float tolerance of each other
        ia, ib = tlbd.binarization_pairs(jf.shape[-1])
        close = np.abs(jf[:, ia] - jf[:, ib]) <= FLOAT_TOL
        differ = td.binary.numpy() != np.asarray(jd.binary)
        assert not (differ & ~close).any()
        assert td.binary.dtype == torch.uint8


def test_match_binary_matches_jax(views):
    (_, ja, ta), (_, jb, tb) = views
    for kw in ({}, {"max_dist": 60}, {"max_dist": 40, "ratio": 0.7}):
        jm = jlbd.match_binary(ja, jb, **kw)
        # the JAX package's descriptors through the port's matcher
        tm = tlbd.match_binary(*(tlbd.LineDescriptors(
            *(torch.as_tensor(np.array(x)) for x in d)) for d in (ja, jb)),
            **kw)
        for got, want in zip(tm, jm):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(np.asarray(jlbd.match_binary(ja, jb).ok).sum()) >= 3


def test_lbd_descriptors_valid(rng):
    scene = tsyn.make_scene(rng, size=1024)
    img = tsyn.render_aa(scene, TCAM, *POSE0, device="cpu")
    tab = tdetect(img)
    desc = tlbd.compute_lbd(img, tab.sp, tab.ep, tab.valid)
    v = desc.valid.numpy()
    assert v.sum() >= 4
    norms = np.linalg.norm(desc.float_desc.numpy()[v], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)
    assert set(np.unique(desc.binary.numpy())) <= {0, 1}


def test_lbd_matching_across_views(rng):
    """Descriptors of the same 3-D lines in two nearby views match."""
    scene = tsyn.make_scene(rng, size=1024)
    R1 = np.asarray(tlie.so3_exp(torch.tensor([0.0, 0.01, 0.005])), np.float32)
    t1 = POSE0[1] + np.asarray([0.03, -0.01, 0.0], np.float32)
    img0 = tsyn.render_aa(scene, TCAM, *POSE0, device="cpu")
    img1 = tsyn.render_aa(scene, TCAM, R1, t1, device="cpu")
    tab0, tab1 = tdetect(img0), tdetect(img1)
    d0 = tlbd.compute_lbd(img0, tab0.sp, tab0.ep, tab0.valid)
    d1 = tlbd.compute_lbd(img1, tab1.sp, tab1.ep, tab1.valid)
    m = tlbd.match_binary(d0, d1)
    ok = m.ok.numpy()
    assert ok.sum() >= 3, f"only {ok.sum()} matches"
    mid0 = 0.5 * (tab0.sp + tab0.ep).numpy()
    mid1 = 0.5 * (tab1.sp + tab1.ep).numpy()
    idx = m.idx.numpy()
    good = sum(np.linalg.norm(mid0[i] - mid1[idx[i]]) < 25
               for i in np.where(ok)[0])
    assert good >= 0.7 * ok.sum()


def test_lbd_rejects_unrelated(rng):
    scene_a = tsyn.make_scene(rng, size=1024)
    scene_b = tsyn.make_scene(rng, size=1024)
    img_a = tsyn.render_aa(scene_a, TCAM, *POSE0, device="cpu")
    img_b = tsyn.render_aa(scene_b, TCAM, *POSE0, device="cpu")
    ta, tb = tdetect(img_a), tdetect(img_b)
    da = tlbd.compute_lbd(img_a, ta.sp, ta.ep, ta.valid)
    db = tlbd.compute_lbd(img_b, tb.sp, tb.ep, tb.valid)
    m = tlbd.match_binary(da, db, max_dist=60)
    assert m.ok.numpy().sum() <= max(2, 0.25 * ta.valid.numpy().sum())


def _seg_img(h=240, w=320):
    """tests/test_lines.py's bars on dark ground."""
    img = np.full((h, w), 40.0, np.float32)
    img[60:80, 40:280] = 220.0
    img[120:200, 150:170] = 220.0
    return img


def _random_table(rng, S=80):
    """tests/test_lines.py::test_dedup_np_matches_device's table."""
    sp = rng.uniform(5, 300, (S, 2)).astype(np.float32)
    ep = sp + rng.uniform(-80, 80, (S, 2)).astype(np.float32)
    length = np.linalg.norm(ep - sp, axis=-1).astype(np.float32)
    return jlines.SegmentTable(
        sp=sp, ep=ep, length=length, angle=np.zeros(S, np.float32),
        response=length, valid=rng.random(S) > 0.2)


@pytest.mark.parametrize("case", ["bars", "bars_occupied", "random",
                                  "random_small_cap"])
def test_dedup_segments_grid_matches_jax(case, rng):
    """The tables of tests/test_lines.py:51, :66 and :188; with 24 rows or 4
    of capacity the occupancy also holds the segments past the table."""
    n_cells = (-(-320 // 25)) * (-(-240 // 25))
    occupied = None
    if case.startswith("bars"):
        det = jlines.detect_segments(jnp.asarray(_seg_img()), n_peaks=32)
        kw = dict(width=320, height=240, cell_size=25, max_segs=8,
                  min_length=30.0)
        if case == "bars_occupied":
            occupied = np.ones(n_cells, bool)
    else:
        det = _random_table(rng)
        kw = dict(width=320, height=240, cell_size=25,
                  max_segs=24 if case == "random" else 4, min_length=20.0)
    jtab, jocc = jlines.dedup_segments_grid(
        jlines.SegmentTable(*(jnp.asarray(np.asarray(a)) for a in det)),
        occupied=None if occupied is None else jnp.asarray(occupied), **kw)
    ttab, tocc = tlines.dedup_segments_grid(
        tlines.SegmentTable(*(torch.as_tensor(np.asarray(a)) for a in det)),
        occupied=None if occupied is None else torch.as_tensor(occupied), **kw)
    assert ttab.sp.shape == (kw["max_segs"], 2)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    for got, want in zip(ttab, jtab):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "bars_occupied":
        assert not ttab.valid.any()
    else:
        assert int(ttab.valid.sum()) >= 2
