"""Parity on the CPU of the JAX package's functions that are off the
tracking path (the reference's per-level matcher and epipolar search,
1-D alignment, `reproject_segments`, the bucketed seed updates, and the
camera and image helpers) between the port and the JAX package, with
the JAX package's own tests of them run on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import camera as tcam
from plsvo_torch import image as ti
from plsvo_torch.ops import depth_filter as tdf
from plsvo_torch.ops import feature_align as tfa
from plsvo_torch.ops import lines as tl
from plsvo_torch.ops import matcher as tm
from plsvo_torch.ops import sparse_align as tsa
from plsvo_torch.pipeline import reprojector as trp
from plsvo_tpu import camera as jcam
from plsvo_tpu import image as ji
from plsvo_tpu import lie
from plsvo_tpu.ops import depth_filter as jdf
from plsvo_tpu.ops import feature_align as jfa
from plsvo_tpu.ops import matcher as jm
from plsvo_tpu.ops import sparse_align as jsa
from plsvo_tpu.pipeline import reprojector as jrp
from plsvo_tpu.utils import synthetic

CAM = jcam.PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
FX, FY, CX, CY = 250.0, 250.0, 160.0, 120.0
# K2's parity bars (tests/test_pallas_align.py), for the GN loops here
UV_ATOL, MD_ATOL = 2e-3, 2e-2


def T(a):
    return torch.as_tensor(np.array(a))


def N_(a):
    return np.asarray(a)


def make_pair(rng, dt=(0.03, -0.015, 0.01), drot=0.015, **tex):
    """tests/test_matcher.py's image pair (tex: the texture's counts);
    poses T_f_w and T_cur_ref."""
    scene = synthetic.make_scene(rng, size=1024, texel_size=0.004, **tex)
    R_ref = np.eye(3, dtype=np.float32)
    t_ref = np.array([0.0, 0.0, -2.0], np.float32)
    R_cur = np.asarray(lie.so3_exp(jnp.asarray([0.0, drot, 0.5 * drot])),
                       np.float32)
    t_cur = t_ref + np.asarray(dt, np.float32)
    img_ref = np.asarray(synthetic.render_aa(scene, CAM, R_ref, t_ref)[0])
    img_cur = np.asarray(synthetic.render_aa(scene, CAM, R_cur, t_cur)[0])
    Rcr, tcr = lie.compose(*lie.inverse(jnp.asarray(R_cur), jnp.asarray(t_cur)),
                           jnp.asarray(R_ref), jnp.asarray(t_ref))
    return (scene, (R_ref, t_ref), (R_cur, t_cur), img_ref, img_cur,
            (N_(Rcr), N_(tcr)))


def gt_points(rng, scene, pose, n=32, border=30):
    R, t = pose
    uv = np.stack([rng.uniform(border, 320 - border, n),
                   rng.uniform(border, 240 - border, n)], -1).astype(np.float32)
    rays = N_(CAM.unproject(jnp.asarray(uv)))
    z = N_(synthetic.depth_at(scene, CAM, jnp.asarray(R), jnp.asarray(t),
                              jnp.asarray(uv)))
    return uv, rays, z / rays[:, 2]


def bordered(img, uv):
    return ti.extract_patches(T(img), T(uv), 10)[0]


def assert_align_equal(rt, rj):
    """Verdicts equal; uv and mean_diff within K2's bars where converged."""
    conv = N_(rj.converged)
    np.testing.assert_array_equal(rt.converged.numpy(), conv)
    np.testing.assert_allclose(rt.uv.numpy()[conv], N_(rj.uv)[conv],
                               atol=UV_ATOL)
    np.testing.assert_allclose(rt.mean_diff.numpy()[conv],
                               N_(rj.mean_diff)[conv], atol=MD_ATOL)


# ---- camera and image helpers ----


def test_project2d_unproject2d():
    p = T([[2.0, 4.0, 2.0]])
    np.testing.assert_allclose(tcam.project2d(p).numpy(), [[1.0, 2.0]])
    np.testing.assert_allclose(tcam.unproject2d(T([[1.0, 2.0]])).numpy(),
                               [[1.0, 2.0, 1.0]])


def test_project2d_unproject2d_match_jax(rng):
    xyz = rng.normal(0, 2, (4, 16, 3)).astype(np.float32)
    xyz[0, :4, 2] = [0.0, 1e-11, -1e-11, 2e-10]  # the |z| < 1e-10 guard
    np.testing.assert_array_equal(tcam.project2d(T(xyz)).numpy(),
                                  N_(jcam.project2d(jnp.asarray(xyz))))
    uv = xyz[..., :2]
    np.testing.assert_array_equal(tcam.unproject2d(T(uv)).numpy(),
                                  N_(jcam.unproject2d(jnp.asarray(uv))))


def test_extract_patches_shape(rng):
    img = T(rng.uniform(0, 255, size=(64, 64)).astype(np.float32))
    centers = T([[10.0, 12.0], [31.5, 40.25]])
    patches, ok = ti.extract_patches(img, centers, 4)
    assert patches.shape == (2, 16)
    assert ok.all()
    flat = ti.extract_patches(torch.full((64, 64), 7.0), centers, 8)[0]
    np.testing.assert_allclose(flat.numpy(), 7.0)


def test_extract_patches_matches_jax(rng):
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    centers = np.stack([rng.uniform(-3, 67, 40), rng.uniform(-3, 51, 40)],
                       -1).astype(np.float32)
    for ps in (4, 10):
        pt, okt = ti.extract_patches(T(img), T(centers), ps)
        pj, okj = ji.extract_patches(jnp.asarray(img), jnp.asarray(centers), ps)
        np.testing.assert_array_equal(okt.numpy(), N_(okj))
        assert 0 < okt.sum() < len(centers)
        np.testing.assert_allclose(pt.numpy(), N_(pj), atol=1e-5)


def test_pack_bilinear_and_multi_match_jax(rng):
    img = rng.uniform(0, 255, (24, 32)).astype(np.float32)
    dx, dy = ji.gradient(jnp.asarray(img))
    pj = ji.pack_bilinear(jnp.asarray(img))
    pt = ti.pack_bilinear(T(img))
    np.testing.assert_allclose(pt.numpy(), N_(pj), atol=1e-5)
    uv = np.stack([rng.uniform(-1.5, 33, 300), rng.uniform(-1.5, 25, 300)],
                  -1).astype(np.float32)
    # bilinear_sample on the packed taps, as on the image
    vj, okj = ji.bilinear_sample(pj, jnp.asarray(uv))
    vt, okt = ti.bilinear_sample(pt, T(uv))
    np.testing.assert_array_equal(okt.numpy(), N_(okj))
    np.testing.assert_allclose(vt.numpy(), N_(vj), atol=1e-5)
    np.testing.assert_allclose(ti.bilinear_sample(T(img), T(uv))[0].numpy(),
                               vt.numpy(), atol=1e-5)
    chans = [img, N_(dx), N_(dy)]
    mj = ji.pack_bilinear_multi([jnp.asarray(c) for c in chans])
    mt = ti.pack_bilinear_multi([T(c) for c in chans])
    assert mt.shape == (24, 32, 4, 3)
    np.testing.assert_allclose(mt.numpy(), N_(mj), atol=1e-5)
    sj, sokj = ji.bilinear_sample_multi(mj, jnp.asarray(uv))
    st, sokt = ti.bilinear_sample_multi(mt, T(uv))
    # the 1-px interior rule: valid only where the 2x2 support avoids the
    # outermost ring
    np.testing.assert_array_equal(sokt.numpy(), N_(sokj))
    assert 0 < sokt.sum() < okt.sum()
    np.testing.assert_allclose(st.numpy(), N_(sj), atol=1e-5)


def test_ensure_flat_atlas_and_lazy_pyr(rng):
    stack = [rng.uniform(0, 255, (3, 24 >> lv, 32 >> lv)).astype(np.float32)
             for lv in range(3)]
    fa = ti.ensure_flat_atlas([T(s) for s in stack])
    assert ti.ensure_flat_atlas(fa) is fa
    ja = ji.ensure_flat_atlas([jnp.asarray(s) for s in stack])
    for a, b in zip(fa, ja):
        np.testing.assert_array_equal(a.numpy(), N_(b))
    lp = ti.LazyPyr([T(s) for s in stack], 1)
    assert len(lp) == 3
    np.testing.assert_array_equal(lp[2].numpy(), stack[2][1])
    assert lp[0] is lp[0]  # cached
    assert [x.shape for x in lp[1:]] == [(12, 16), (6, 8)]
    assert [x.shape for x in lp] == [(24, 32), (12, 16), (6, 8)]


def test_make_align_points_matches_jax(rng):
    uv = rng.uniform(0, 300, (20, 2)).astype(np.float32)
    f = rng.normal(size=(20, 3)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    d = rng.uniform(0.5, 4, 20).astype(np.float32)
    v = rng.random(20) < 0.7
    pt = tsa.make_align_points(T(uv), T(f), T(d), T(v))
    pj = jsa.make_align_points(jnp.asarray(uv), jnp.asarray(f), jnp.asarray(d),
                               jnp.asarray(v))
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), N_(b))
    # the range along the distance-normalised bearing, not the z-depth
    np.testing.assert_allclose(np.linalg.norm(pt.xyz_ref.numpy(), axis=-1), d,
                               rtol=1e-6)


# ---- 1-D alignment ----


@pytest.fixture(scope="module")
def still_pair():
    """One view (tests/test_matcher.py's reference frame) and 16 of its
    points, at which the tests align against the view itself."""
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, size=1024, texel_size=0.004)
    pose = (np.eye(3, dtype=np.float32), np.array([0.0, 0.0, -2.0], np.float32))
    img = np.asarray(synthetic.render_aa(scene, CAM, *pose)[0])
    uv, _, _ = gt_points(rng, scene, pose, n=16)
    ref, dx, dy = tfa.ref_patch_gradients(bordered(img, uv), 8)
    return img, uv, ref, dx, dy, scene, pose


def test_align1d_moves_only_along_direction(still_pair):
    img, uv, ref, dx, dy = still_pair[:5]
    d = np.tile(np.asarray([[1.0, 0.0]], np.float32), (len(uv), 1))
    uv_init = uv + np.asarray([1.2, 0.0], np.float32)
    out = tfa.align1d(T(img), ref, dx, dy, T(uv_init), T(d),
                      torch.ones(len(uv), dtype=torch.bool))
    conv = out.converged.numpy()
    assert conv.mean() > 0.5
    err_x = np.abs(out.uv.numpy()[:, 0] - uv[:, 0])
    err_y = np.abs(out.uv.numpy()[:, 1] - uv[:, 1])
    assert np.median(err_x[conv]) < 0.15
    np.testing.assert_allclose(err_y, np.abs(uv_init[:, 1] - uv[:, 1]),
                               atol=1e-5)


def test_align1d_matches_jax(still_pair):
    img, uv, ref, dx, dy = still_pair[:5]
    rng = np.random.default_rng(1)
    n = len(uv)
    d = rng.normal(size=(n, 2)).astype(np.float32)
    uv_init = (uv + d * rng.uniform(-2, 2, (n, 1))).astype(np.float32)
    uv_init[0] = [3.0, 5.0]  # starts out of frame: never active
    valid = rng.random(n) < 0.85
    args = [ref.numpy(), dx.numpy(), dy.numpy(), uv_init, d, valid]
    rt = tfa.align1d(T(img), *map(T, args))
    rj = jfa.align1d(jnp.asarray(img), *map(jnp.asarray, args))
    assert 4 <= N_(rj.converged).sum() < n
    assert_align_equal(rt, rj)


def _edge_image(H=120, W=160, x_edge=80.5):
    xx = np.arange(W, dtype=np.float64)
    img = 40.0 + 160.0 / (1.0 + np.exp(-(xx - x_edge) * 1.2))
    return np.tile(img[None, :], (H, 1))


def test_align1d_atlas_moves_only_along_direction():
    rng = np.random.default_rng(0)
    img = T(_edge_image() + rng.normal(0, 1.0, (120, 160)))
    atlas, x_off, sizes = ti.pack_pyramid_atlas([img])
    cx_, cy_ = 80.5, 60.0
    ref, dx, dy = tfa.ref_patch_gradients(bordered(img, [[cx_, cy_]]), 8)
    out = tfa.align1d_atlas(atlas, x_off, sizes, ref, dx, dy,
                            T([[cx_ + 2.0, cy_]]), T([[1.0, 0.0]]),
                            torch.zeros(1, dtype=torch.int32),
                            torch.ones(1, dtype=torch.bool), patch_size=8)
    assert bool(out.converged[0])
    uv = out.uv[0].numpy()
    assert abs(uv[0] - cx_) < 0.35, uv
    assert abs(uv[1] - cy_) < 1e-5, uv


def test_align1d_atlas_matches_jax(still_pair):
    img_ref, scene, pose_ref = still_pair[0], *still_pair[5:]
    rng = np.random.default_rng(2)
    uv, _, _ = gt_points(rng, scene, pose_ref, n=48, border=12)
    n = len(uv)
    lvl = rng.integers(0, 3, n).astype(np.int32)
    pyr = ti.build_pyramid(T(img_ref), 3)
    scale = (1.0 / (1 << lvl)).astype(np.float32)[:, None]
    pb = torch.stack([bordered(pyr[lv], uv[i:i + 1] * scale[i])[0]
                      for i, lv in enumerate(lvl)])
    ref, dx, dy = [a.numpy() for a in tfa.ref_patch_gradients(pb, 8)]
    d = rng.normal(size=(n, 2)).astype(np.float32)
    # up to 4 px along d: some rows leave their 18x18 window
    uv_init = (uv * scale + d / np.linalg.norm(d, axis=-1, keepdims=True)
               * rng.uniform(-4, 4, (n, 1))).astype(np.float32)
    valid = rng.random(n) < 0.9
    at, xo, sz = ti.pack_pyramid_atlas(pyr)
    rest = [ref, dx, dy, uv_init, d, lvl, valid]
    rt = tfa.align1d_atlas(at, xo, sz, *map(T, rest))
    aj, xj, sj = ji.pack_pyramid_atlas([jnp.asarray(p.numpy()) for p in pyr])
    rj = jfa.align1d_atlas(aj, xj, sj, *map(jnp.asarray, rest))
    assert 8 <= N_(rj.converged).sum() < n
    assert_align_equal(rt, rj)


# ---- the per-level matcher ----


def test_zmssd_matches_jax(rng):
    a = rng.uniform(0, 255, (6, 7, 64)).astype(np.float32)
    b = rng.uniform(0, 255, (6, 7, 64)).astype(np.float32)
    np.testing.assert_allclose(tm.zmssd(T(a), T(b)).numpy(),
                               N_(jm.zmssd(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-4)
    np.testing.assert_allclose(tm.zmssd(T(a), T(b), dim=1).numpy(),
                               N_(jm.zmssd(jnp.asarray(a), jnp.asarray(b),
                                           axis=1)), rtol=1e-4)


@pytest.fixture(scope="module")
def match_pair():
    rng = np.random.default_rng(0)
    scene, pose_ref, _, img_ref, img_cur, (Rcr, tcr) = make_pair(rng)
    uv, rays, rng_d = gt_points(rng, scene, pose_ref, n=48)
    ok_d = np.isfinite(rng_d) & (rng_d > 0.1)
    xyz_cur = (rays * rng_d[:, None]) @ Rcr.T + tcr
    uv_cur = N_(CAM.project(jnp.asarray(xyz_cur), distort=False))
    in_cur = ((uv_cur[:, 0] > 20) & (uv_cur[:, 0] < 300)
              & (uv_cur[:, 1] > 20) & (uv_cur[:, 1] < 220))
    uv_init = (uv_cur + rng.uniform(-2, 2, uv_cur.shape)).astype(np.float32)
    n = len(uv)
    # anchors at levels 0-2 of two keyframe images (the second a copy)
    level = rng.integers(0, 3, n).astype(np.int32)
    kf = (rng.random(n) < 0.5).astype(np.int32)
    return dict(img_ref=img_ref, img_cur=img_cur, uv=uv, rays=rays,
                rng_d=rng_d.astype(np.float32), valid=ok_d & in_cur,
                uv_cur=uv_cur, uv_init=uv_init, level=level, kf=kf,
                R=np.tile(Rcr[None], (n, 1, 1)), t=np.tile(tcr[None], (n, 1)))


def pyramids(img, n=3):
    pt = ti.build_pyramid(T(img), n)
    return pt, [jnp.asarray(p.numpy()) for p in pt]


def test_warp_patches_affine_matches_jax(match_pair):
    m = match_pair
    rng = np.random.default_rng(3)
    n = len(m["uv"])
    pt, pj = pyramids(m["img_ref"])
    st = [torch.stack([p, p]) for p in pt]
    sj = [jnp.stack([p, p]) for p in pj]
    A = (np.eye(2) + rng.normal(0, 0.15, (n, 2, 2))).astype(np.float32)
    sl = rng.integers(0, 2, n).astype(np.int32)
    args = [m["kf"], m["uv"], m["level"], A, sl]
    vt, okt = tm.warp_patches_affine(st, *map(T, args))
    vj, okj = jm.warp_patches_affine(sj, *map(jnp.asarray, args))
    np.testing.assert_array_equal(okt.numpy(), N_(okj))
    assert 0 < okt.sum() < n
    np.testing.assert_allclose(vt.numpy(), N_(vj), atol=1e-3)


def test_find_match_direct_on_pair(match_pair):
    m = match_pair
    n = len(m["uv"])
    pt, _ = pyramids(m["img_ref"])
    pc, _ = pyramids(m["img_cur"])
    res = tm.find_match_direct(
        [p[None] for p in pt], pc, torch.zeros(n, dtype=torch.int32),
        T(m["uv"]), T(m["rays"]), T(m["rng_d"]),
        torch.zeros(n, dtype=torch.int32), T(m["R"]), T(m["t"]),
        T(m["uv_init"]), T(m["valid"]), FX, FY, CX, CY, max_level=2)
    ok = res.ok.numpy()
    assert ok.sum() > 0.5 * m["valid"].sum()
    err = np.linalg.norm(res.uv.numpy() - m["uv_cur"], axis=-1)
    assert np.median(err[ok]) < 0.3


def test_find_match_direct_matches_jax(match_pair):
    """Anchors at levels 0-2 in two keyframe images, search levels up to
    max_level 4 (beyond the 3-level current pyramid: never matched)."""
    m = match_pair
    pt, pj = pyramids(m["img_ref"])
    pc, pcj = pyramids(m["img_cur"])
    args = [m["kf"], m["uv"], m["rays"], m["rng_d"], m["level"], m["R"],
            m["t"], m["uv_init"], m["valid"]]
    rt = tm.find_match_direct([torch.stack([p, p]) for p in pt], pc,
                              *map(T, args), FX, FY, CX, CY)
    rj = jm.find_match_direct([jnp.stack([p, p]) for p in pj], pcj,
                              *map(jnp.asarray, args), FX, FY, CX, CY)
    ok = N_(rj.ok)
    np.testing.assert_array_equal(rt.ok.numpy(), ok)
    np.testing.assert_array_equal(rt.level.numpy(), N_(rj.level))
    assert ok.sum() >= 10
    np.testing.assert_allclose(rt.uv.numpy()[ok], N_(rj.uv)[ok], atol=UV_ATOL)


@pytest.fixture(scope="module")
def epi_pair():
    rng = np.random.default_rng(0)
    scene, pose_ref, _, img_ref, img_cur, (Rcr, tcr) = make_pair(
        rng, dt=(0.12, 0.0, 0.0), drot=0.0)
    uv, rays, rng_d = gt_points(rng, scene, pose_ref, n=32)
    ok_d = np.isfinite(rng_d) & (rng_d > 0.1)
    f_A = (rays * (rng_d * 1.4)[:, None]) @ Rcr.T + tcr
    f_B = (rays * (rng_d * 0.7)[:, None]) @ Rcr.T + tcr
    return dict(img_ref=img_ref, img_cur=img_cur, uv=uv, rays=rays,
                rng_d=rng_d, ok_d=ok_d, f_A=f_A.astype(np.float32),
                f_B=f_B.astype(np.float32), Rcr=Rcr, tcr=tcr, rng=rng)


def test_epipolar_search_finds_depth(epi_pair):
    e = epi_pair
    n = len(e["uv"])
    pc, _ = pyramids(e["img_cur"])
    ref_patch, pok = ti.extract_patches(T(e["img_ref"]), T(e["uv"]), 8)
    res = tm.epipolar_search_zmssd(
        pc, ref_patch, T(e["f_A"]), T(e["f_B"]),
        torch.zeros(n, dtype=torch.int32), T(e["ok_d"]) & pok, FX, FY, CX, CY,
        n_steps=96)
    ok = res.ok.numpy()
    assert ok.sum() > 0.5 * e["ok_d"].sum()
    rp, dx, dy = tfa.ref_patch_gradients(bordered(e["img_ref"], e["uv"]), 8)
    ref2 = tfa.align2d(pc[0], rp, dx, dy, res.uv_level, res.ok)
    f_cur = tcam.PinholeCamera.create(320, 240, FX, FY, CX, CY).unproject(
        ref2.uv)
    d_ref, _, tri_ok = tm.triangulate_depth(T(e["Rcr"]), T(e["tcr"]),
                                            T(e["rays"]), f_cur)
    mk = ref2.converged.numpy() & tri_ok.numpy() & ok
    assert mk.sum() >= 8
    rel = np.abs(d_ref.numpy()[mk] - e["rng_d"][mk]) / e["rng_d"][mk]
    assert np.median(rel) < 0.02


@pytest.mark.parametrize("form", ["levels", "atlas"])
def test_epipolar_search_matches_jax(epi_pair, form):
    """Both forms on the same inputs at search levels 0-2, in a noisy
    current image (so that a good match's score is well above f32
    rounding); rows out of frame score inf."""
    e = epi_pair
    rng = np.random.default_rng(4)
    n = len(e["uv"])
    img_cur = (e["img_cur"] + rng.normal(0, 3, e["img_cur"].shape)
               ).astype(np.float32)
    ref_patch = ti.extract_patches(T(e["img_ref"]), T(e["uv"]), 8)[0].numpy()
    f_A, f_B = e["f_A"].copy(), e["f_B"].copy()
    f_A[:3] += [3.0, 0.0, 0.0]  # bands wholly out of the image
    f_B[:3] += [3.0, 0.0, 0.0]
    sl = rng.integers(0, 3, n).astype(np.int32)
    args = [ref_patch, f_A, f_B, sl, e["ok_d"]]
    pc, pcj = pyramids(img_cur)
    if form == "levels":
        rt = tm.epipolar_search_zmssd(pc, *map(T, args), FX, FY, CX, CY,
                                      n_steps=64)
        rj = jm.epipolar_search_zmssd(pcj, *map(jnp.asarray, args), FX, FY,
                                      CX, CY, n_steps=64)
    else:
        rt = tm.epipolar_search_zmssd_atlas(
            *ti.pack_pyramid_atlas(pc), *map(T, args), FX, FY, CX, CY,
            n_steps=64)
        rj = jm.epipolar_search_zmssd_atlas(
            *ji.pack_pyramid_atlas(pcj), *map(jnp.asarray, args), FX, FY, CX,
            CY, n_steps=64)
    ok = N_(rj.ok)
    np.testing.assert_array_equal(rt.ok.numpy(), ok)
    assert 8 <= ok.sum() < n
    zj = N_(rj.zmssd)
    np.testing.assert_array_equal(np.isinf(rt.zmssd.numpy()), np.isinf(zj))
    assert np.isinf(zj[:3]).all()
    fin = np.isfinite(zj)
    np.testing.assert_allclose(rt.zmssd.numpy()[fin], zj[fin], rtol=1e-4)
    np.testing.assert_allclose(rt.uv_level.numpy()[ok], N_(rj.uv_level)[ok],
                               atol=1e-3)


# ---- reproject_segments ----


@pytest.fixture(scope="module")
def segment_map():
    """Line landmarks from the segments detected in a keyframe of a
    line-rich texture, at their true depth, a quarter of them displaced
    (their refinement fails and the cell's runner-up is retried); two
    keyframe slots."""
    rng = np.random.default_rng(7)
    scene, (R0, t0), (R1, t1), img0, img1, _ = make_pair(
        rng, dt=(0.04, 0.01, 0.0), drot=0.01, n_rects=420, n_blobs=40)
    det = tl.detect_segments_tiled(T(img0), n_peaks=64, run_gap_px=3.0,
                                   dist_tol=1.2)
    segs = tl.dedup_segments_grid_np(det, width=320, height=240, cell_size=25,
                                     max_segs=64, min_length=12.0)
    L = 64
    sp, ep = segs.sp.astype(np.float32), segs.ep.astype(np.float32)

    def world(uv):
        f = N_(CAM.unproject(jnp.asarray(uv)))
        z = N_(synthetic.depth_at(scene, CAM, jnp.asarray(R0), jnp.asarray(t0),
                                  jnp.asarray(uv)))
        return f, (f * (z / f[:, 2])[:, None]) @ R0.T + t0

    sf, spos = world(sp)
    ef, epos = world(ep)
    live = segs.valid & np.isfinite(spos).all(-1) & np.isfinite(epos).all(-1)
    off = rng.random(L) < 0.25
    shift = rng.normal(0, 0.05, (L, 3)) * off[:, None]
    status = np.where(live, rng.integers(1, 3, L), 0).astype(np.int8)
    # the tables hold T_f_w; the renderer's poses are T_w_f
    kf_R = np.stack([R0.T, np.eye(3, dtype=np.float32)])
    kf_t = np.stack([-R0.T @ t0, np.zeros(3, np.float32)])
    tabs = [np.nan_to_num(spos + shift).astype(np.float32),
            np.nan_to_num(epos + shift).astype(np.float32), status,
            np.zeros(L, np.int32), sp, ep, sf.astype(np.float32),
            ef.astype(np.float32), rng.integers(0, 2, L).astype(np.int32),
            kf_R, kf_t]
    assert live.sum() >= 30
    return dict(tabs=tabs, img0=img0, img1=img1, R1=R1.T, t1=-R1.T @ t1)


@pytest.mark.parametrize("retry", [True, False])
def test_reproject_segments_matches_jax(segment_map, retry):
    s = segment_map
    pk, pkj = pyramids(s["img0"])
    pc, pcj = pyramids(s["img1"])
    kw = dict(cell_size=50, max_out=16, retry=retry)
    rt = trp.reproject_segments(
        *map(T, s["tabs"]), ti.pack_pyramid_atlas_flat([p[None] for p in pk]),
        pc, T(s["R1"]), T(s["t1"]), FX, FY, CX, CY, **kw)
    rj = jrp.reproject_segments(
        *map(jnp.asarray, s["tabs"]), [p[None] for p in pkj], pcj,
        jnp.asarray(s["R1"]), jnp.asarray(s["t1"]), FX, FY, CX, CY, **kw)
    assert rt.lm_idx.shape == ((16 + 8,) if retry else (16,))
    for name in ("lm_idx", "selected", "matched", "level", "n_attempts",
                 "n_matches"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      N_(getattr(rj, name)), name)
    m = N_(rj.matched)
    assert m[:16].sum() >= 4
    if retry:
        # the retry round selected and matched runner-ups
        assert N_(rj.selected)[16:].sum() >= 1 and m[16:].sum() >= 1
    for name in ("s_uv", "e_uv"):
        np.testing.assert_allclose(getattr(rt, name).numpy()[m],
                                   N_(getattr(rj, name))[m], atol=UV_ATOL)


# ---- the bucketed seed updates ----


@pytest.fixture(scope="module")
def seed_tables():
    """Point and line seeds of a keyframe (FAST winners and segments
    detected by the port, whose tables equal the JAX package's), placed at
    scattered rows of larger tables; the frame moves sideways."""
    from plsvo_torch.ops import detection as tdet

    rng = np.random.default_rng(5)
    scene = synthetic.make_scene(rng, size=1024, texel_size=0.004)
    R0 = np.eye(3, dtype=np.float32)
    t0 = np.array([0.0, 0.0, -2.0], np.float32)
    t1 = t0 + np.asarray([0.06, 0.006, 0.0], np.float32)
    img0 = N_(synthetic.render_aa(scene, CAM, R0, t0)[0])
    img1 = N_(synthetic.render_aa(scene, CAM, R0, t1)[0])
    grid = tdet.detect_fast_grid(ti.build_pyramid(T(img0), 3), cell_size=20)
    order = np.argsort(-grid.score.numpy())[:64]
    mu, sigma2, z_range = jdf.seed_init_params(depth_mean=2.2, depth_min=0.9)

    def place(cols, cap):
        rows = np.sort(rng.choice(cap, len(cols["mu" if "mu" in cols
                                              else "mu_s"]), replace=False))
        out = {k: np.zeros((cap,) + v.shape[1:], v.dtype)
               for k, v in cols.items()}
        for k, v in cols.items():
            out[k][rows] = v
        return out

    uv = grid.uv.numpy()[order]
    S = len(uv)
    pt = place(dict(
        kf_idx=np.zeros(S, np.int32), uv=uv.astype(np.float32),
        f=N_(CAM.unproject(jnp.asarray(uv))).astype(np.float32),
        level=grid.level.numpy()[order].astype(np.int32),
        mu=(mu * rng.uniform(0.8, 1.2, S)).astype(np.float32),
        sigma2=np.full(S, sigma2, np.float32),
        z_range=np.full(S, z_range, np.float32),
        a=np.full(S, 10.0, np.float32),
        b=(10.0 + rng.integers(0, 4, S)).astype(np.float32),
        batch_id=np.zeros(S, np.int32),
        alive=grid.valid.numpy()[order] & (rng.random(S) < 0.9)), 100)
    segs = tl.dedup_segments_grid_np(
        tl.detect_segments_tiled(T(img0), n_peaks=64, run_gap_px=3.0,
                                 dist_tol=1.2),
        width=320, height=240, cell_size=25, max_segs=32, min_length=20.0)
    L = 32

    def mu_l():
        return (np.float32(mu) * rng.uniform(0.8, 1.2, L)).astype(np.float32)

    ln = place(dict(
        kf_idx=np.zeros(L, np.int32), s_uv=segs.sp.astype(np.float32),
        e_uv=segs.ep.astype(np.float32),
        sf=N_(CAM.unproject(jnp.asarray(segs.sp))).astype(np.float32),
        ef=N_(CAM.unproject(jnp.asarray(segs.ep))).astype(np.float32),
        level=np.zeros(L, np.int32), mu_s=mu_l(),
        sigma2_s=np.full(L, sigma2, np.float32),
        z_range_s=np.full(L, z_range, np.float32), mu_e=mu_l(),
        sigma2_e=np.full(L, sigma2, np.float32),
        z_range_e=np.full(L, z_range, np.float32),
        a=np.full(L, 10.0, np.float32),
        b=(10.0 + rng.integers(0, 4, L)).astype(np.float32),
        batch_id=np.zeros(L, np.int32), alive=segs.valid), 48)
    return dict(pt=pt, ln=ln, img0=img0, img1=img1, R0=R0, t0=t0, t1=t1)


def bucket(alive, B):
    idx = np.where(alive)[0]
    rows = np.zeros(B, np.int32)
    rows[:len(idx)] = idx
    return rows, np.arange(B) < len(idx)


@pytest.mark.parametrize("kind", ["points", "lines"])
def test_bucketed_seed_update_matches_jax(seed_tables, kind):
    """The update of the alive rows in a bucket (padding rows point at row
    0): the full table's rows outside the bucket, row 0 included, are
    untouched; the bucket-space result and the written rows equal JAX's
    at test_torch_seeds.py's bars."""
    p = seed_tables
    full = p["pt"] if kind == "points" else p["ln"]
    n_alive = int(full["alive"].sum())
    B = 64 if kind == "points" else 32
    assert 0 < n_alive < B and not full["alive"][0]
    rows, pad = bucket(full["alive"], B)
    pt, pj = pyramids(p["img0"])
    pct, pcj = pyramids(p["img1"])
    tj, tt = ((jdf.PointSeeds, tdf.PointSeeds) if kind == "points"
              else (jdf.LineSeeds, tdf.LineSeeds))
    fnj, fnt = ((jdf.update_point_seeds_bucketed,
                 tdf.update_point_seeds_bucketed) if kind == "points" else
                (jdf.update_line_seeds_bucketed,
                 tdf.update_line_seeds_bucketed))
    fj, rj = fnj(tj(**{k: jnp.asarray(v) for k, v in full.items()}),
                 jnp.asarray(rows), jnp.asarray(pad), jnp.asarray(p["R0"])[None],
                 jnp.asarray(p["t0"])[None], [q[None] for q in pj], pcj,
                 jnp.asarray(p["R0"]), jnp.asarray(p["t1"]), FX, FY, CX, CY,
                 jnp.asarray(0, jnp.int32), n_epi_steps=128)
    ft, rt = fnt(tt(**{k: T(v) for k, v in full.items()}), T(rows), T(pad),
                 T(p["R0"])[None], T(p["t0"])[None],
                 [q[None] for q in pt], pct, T(p["R0"]), T(p["t1"]), FX, FY,
                 CX, CY, 0, n_epi_steps=128)
    # bucket space: verdicts equal, estimates within rtol 1e-4 where live
    for name in ("converged", "matched", "skipped"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      N_(getattr(rj, name)), name)
    assert N_(rj.matched).sum() >= 3
    np.testing.assert_array_equal(rt.seeds.alive.numpy(), N_(rj.seeds.alive))
    live = N_(rj.seeds.alive) | N_(rj.converged)
    est = (("mu", "sigma2", "a", "b") if kind == "points" else
           ("mu_s", "sigma2_s", "mu_e", "sigma2_e", "a", "b"))
    for name in est:
        np.testing.assert_allclose(getattr(rt.seeds, name).numpy()[live],
                                   N_(getattr(rj.seeds, name))[live],
                                   rtol=1e-4, err_msg=name)
    # the full table: rows outside the bucket (row 0, where the padding
    # points, among them) untouched; the written rows are the bucket's
    # first n_alive rows
    w = rows[:n_alive]
    outside = np.ones(len(full["alive"]), bool)
    outside[w] = False
    for name in tt._fields:
        np.testing.assert_array_equal(getattr(ft, name).numpy()[outside],
                                      full[name][outside], name)
        np.testing.assert_array_equal(
            getattr(ft, name).numpy()[w],
            getattr(rt.seeds, name).numpy()[:n_alive], name)
    np.testing.assert_array_equal(ft.alive.numpy(), N_(fj.alive))


def test_render_matches_jax():
    """The point-sampled renderer (image and z-depth) against the JAX
    package's, on a pose that sees past the textured plane."""
    from plsvo_torch.camera import PinholeCamera as TPin
    from plsvo_torch.utils import synthetic as ts

    scene = synthetic.make_scene(np.random.default_rng(3), size=256,
                                 texel_size=0.004)
    R = N_(lie.so3_exp(jnp.asarray([0.3, 0.1, 0.0])))
    t = np.array([0.1, -0.2, -1.5], np.float32)
    ij, dj = synthetic.render(scene, CAM, R, t)
    it, dt = ts.render(scene, TPin.create(320, 240, FX, FY, CX, CY), R, t,
                       device="cpu")
    hit = np.isfinite(N_(dj))
    np.testing.assert_array_equal(np.isfinite(dt.numpy()), hit)
    assert 0 < hit.sum() < hit.size
    np.testing.assert_allclose(it.numpy(), N_(ij), atol=0.05)
    np.testing.assert_allclose(dt.numpy()[hit], N_(dj)[hit], rtol=1e-5)
