"""Line-segment parity between the port and the JAX package on the CPU: the
Hough segment detector (single image and tiled), the host grid dedup,
segment rows of sparse image alignment and of pose optimization, line
coefficients, segment structure optimization and the line-seed install."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch import image as ti
from plsvo_torch.ops import depth_filter as tdf
from plsvo_torch.ops import lines as tl
from plsvo_torch.ops import pose_opt as tpo
from plsvo_torch.ops import sparse_align as tsa
from plsvo_torch.ops import struct_opt as tso
from plsvo_tpu import image as ji
from plsvo_tpu import lie as jlie
from plsvo_tpu.camera import PinholeCamera
from plsvo_tpu.ops import depth_filter as jdf
from plsvo_tpu.ops import lines as jl
from plsvo_tpu.ops import pose_opt as jpo
from plsvo_tpu.ops import sparse_align as jsa
from plsvo_tpu.ops import struct_opt as jso
from plsvo_tpu.utils import synthetic

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
FX, FY, CX, CY = 250.0, 250.0, 160.0, 120.0


def T(a):
    return torch.as_tensor(np.array(a))


def bars_image():
    """The bright bars of tests/test_lines.py."""
    img = np.full((240, 320), 40.0, np.float32)
    img[60:80, 40:280] = 220.0
    img[120:200, 150:170] = 220.0
    return img


def golden_frame(i=0):
    """Frame i of the golden 320x240 sequence of tests/test_pipeline.py."""
    scene = synthetic.make_scene(np.random.default_rng(7), size=1024,
                                 texel_size=0.004)
    ang = 0.003 * i
    R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0], np.float32)
    return np.asarray(synthetic.render_aa(scene, CAM, jnp.asarray(R),
                                          jnp.asarray(t))[0])


# each case is a list of same-shape images; the golden case spans the
# sequence, so that a one-ulp angle difference has many edges to flip a bin
IMAGES = {"bars": lambda: [bars_image()],
          "flat": lambda: [np.full((120, 160), 100.0, np.float32)],
          "golden": lambda: [golden_frame(i) for i in (0, 9, 18, 27)]}


def assert_tables_equal(t, j, min_valid):
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    np.testing.assert_array_equal(t.response.numpy(), np.asarray(j.response))
    assert jv.sum() >= min_valid
    for name in ("sp", "ep"):
        np.testing.assert_allclose(getattr(t, name).numpy()[jv],
                                   np.asarray(getattr(j, name))[jv], atol=1e-2,
                                   err_msg=name)


@pytest.mark.parametrize("tiled", [False, True], ids=["single", "tiled"])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_detect_segments_matches_jax(name, tiled):
    for img in IMAGES[name]():
        if tiled:
            kw = dict(n_peaks=64, run_gap_px=3.0, dist_tol=1.2)
            j = jl.detect_segments_tiled(jnp.asarray(img), **kw)
            t = tl.detect_segments_tiled(T(img), **kw)
        else:
            j = jl.detect_segments(jnp.asarray(img), n_peaks=32)
            t = tl.detect_segments(T(img), n_peaks=32)
        assert_tables_equal(t, j, {"flat": 0, "bars": 4, "golden": 20}[name])


def test_dedup_segments_grid_np_matches_jax():
    raw = jl.detect_segments_tiled(jnp.asarray(golden_frame()), n_peaks=64,
                                   run_gap_px=3.0, dist_tol=1.2)
    raw = jl.SegmentTable(*[np.asarray(a) for a in raw])
    occ = np.zeros(13 * 10, bool)
    occ[::7] = True
    for occupied in (None, occ):
        kw = dict(width=320, height=240, cell_size=25, max_segs=32,
                  min_length=20.0, occupied=occupied)
        j = jl.dedup_segments_grid_np(raw, **kw)
        t = tl.dedup_segments_grid_np(tl.SegmentTable(*raw), **kw)
        assert j.valid.sum() >= 8
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def _bearings(rng, n, spread=0.5):
    f = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-spread, spread, n),
                  np.ones(n)], -1)
    return (f / np.linalg.norm(f, axis=-1, keepdims=True)).astype(np.float32)


def test_line_coeffs_from_bearings_matches_jax(rng):
    sf, ef = _bearings(rng, 64), _bearings(rng, 64)
    np.testing.assert_allclose(
        tpo.line_coeffs_from_bearings(T(sf), T(ef)).numpy(),
        np.asarray(jpo.line_coeffs_from_bearings(jnp.asarray(sf), jnp.asarray(ef))),
        atol=1e-6)


def test_optimize_segments_matches_jax(rng):
    L, O = 24, 4
    s_gt = np.stack([rng.uniform(-1, 1, L), rng.uniform(-1, 1, L),
                     rng.uniform(3, 6, L)], -1).astype(np.float32)
    e_gt = (s_gt + rng.normal(0, 0.4, s_gt.shape)).astype(np.float32)
    Rs, ts = [], []
    for _ in range(O):
        xi = rng.normal(0, 0.2, 6).astype(np.float32)
        xi[3:] *= 0.2
        R, t = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi)))
        Rs.append(np.tile(R[None], (L, 1, 1)))
        ts.append(np.tile(t[None], (L, 1)))
    R_o, t_o = np.stack(Rs, 1), np.stack(ts, 1)
    ok = rng.random((L, O)) < 0.8
    ok[:, :2] = True  # one bearing alone leaves the depth unconstrained

    def obs(pos):
        xyz = np.einsum("loij,lj->loi", R_o, pos) + t_o
        f = (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(np.float32)
        return [R_o, t_o, f, ok]

    s0 = (s_gt + rng.normal(0, 0.05, s_gt.shape)).astype(np.float32)
    e0 = (e_gt + rng.normal(0, 0.05, e_gt.shape)).astype(np.float32)
    valid = rng.random(L) < 0.9
    oj = jso.optimize_segments(jnp.asarray(s0), jnp.asarray(e0),
                               jso.StructObs(*[jnp.asarray(a) for a in obs(s_gt)]),
                               jso.StructObs(*[jnp.asarray(a) for a in obs(e_gt)]),
                               jnp.asarray(valid))
    ot = tso.optimize_segments(T(s0), T(e0), tso.StructObs(*[T(a) for a in obs(s_gt)]),
                               tso.StructObs(*[T(a) for a in obs(e_gt)]), T(valid))
    for a, b in zip(ot[:2], oj[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for a, b in zip(ot[2:], oj[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sparse_img_align_with_segments_matches_jax(rng):
    scene = synthetic.make_scene(rng, size=1024, texel_size=0.004)
    R_ref = np.eye(3, dtype=np.float32)
    t_ref = np.array([0.0, 0.0, -2.0], np.float32)
    R_cur = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.01, 0.005])), np.float32)
    t_cur = t_ref + np.asarray([0.02, -0.01, 0.008], np.float32)
    img_ref = np.asarray(synthetic.render_aa(scene, CAM, R_ref, t_ref)[0])
    img_cur = np.asarray(synthetic.render_aa(scene, CAM, R_cur, t_cur)[0])

    def gt(uv):
        rays = np.asarray(CAM.unproject(jnp.asarray(uv)))
        z = np.asarray(synthetic.depth_at(scene, CAM, jnp.asarray(R_ref),
                                          jnp.asarray(t_ref), jnp.asarray(uv)))
        return rays, (z / rays[:, 2]).astype(np.float32)

    n, M, K = 48, 24, 4
    uv = np.stack([rng.uniform(20, 300, n), rng.uniform(20, 220, n)],
                  -1).astype(np.float32)
    rays, d = gt(uv)
    pts = [(rays * d[:, None]).astype(np.float32), uv, np.isfinite(d) & (d > 0.1)]
    s_uv = np.stack([rng.uniform(30, 290, M), rng.uniform(30, 210, M)],
                    -1).astype(np.float32)
    ang = rng.uniform(0, np.pi, M)
    e_uv = np.clip(s_uv + 50.0 * np.stack([np.cos(ang), np.sin(ang)], -1),
                   25, [295, 215]).astype(np.float32)
    sf, sd = gt(s_uv)
    ef, ed = gt(e_uv)
    seg_valid = (rng.random(M) < 0.9) & (sd > 0.1) & (ed > 0.1)
    seg_cols = [s_uv, e_uv, sf, ef, sd, ed, seg_valid]
    rj = jsa.sparse_img_align(
        ji.build_pyramid(jnp.asarray(img_ref), 5),
        ji.build_pyramid(jnp.asarray(img_cur), 5),
        jsa.AlignPoints(*[jnp.asarray(a) for a in pts]),
        jsa.make_align_segments(*[jnp.asarray(a) for a in seg_cols], K, FX, FY,
                                CX, CY),
        jnp.eye(3), jnp.zeros(3), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
        levels=(4, 3, 2), n_iter=30)
    rt = tsa.sparse_img_align(
        ti.build_pyramid(T(img_ref), 5), ti.build_pyramid(T(img_cur), 5),
        tsa.AlignPoints(*[T(a) for a in pts]),
        tsa.make_align_segments(*[T(a) for a in seg_cols], K, FX, FY, CX, CY),
        torch.eye(3), torch.zeros(3), FX, FY, CX, CY, levels=(4, 3, 2),
        n_iter=30)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    np.testing.assert_array_equal(rt.seg_alive.numpy(), np.asarray(rj.seg_alive))
    assert int(rt.n_tracked_segs) == int(rj.n_tracked_segs) >= 10


def test_optimize_pose_with_segments_matches_jax(rng):
    n, M = 48, 24
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(2, 5, n)], -1).astype(np.float32)
    xi = np.asarray([0.05, -0.03, 0.02, 0.01, -0.02, 0.015], np.float32)
    R_gt, t_gt = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi)))

    def bearing(p):
        xyz = p @ R_gt.T + t_gt
        return (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(np.float32)

    f = bearing(pts)
    f[:, :2] += rng.normal(0, 0.25 / 250.0, f[:, :2].shape).astype(np.float32)
    f[:4, :2] += 0.05
    spos = np.stack([rng.uniform(-1, 1, M), rng.uniform(-0.8, 0.8, M),
                     rng.uniform(2, 5, M)], -1).astype(np.float32)
    epos = (spos + rng.normal(0, 0.5, spos.shape)).astype(np.float32)
    # the observed line passes through points of the true segment near its
    # endpoints, with noise; a few are gross outliers
    a = rng.uniform(-0.2, 0.2, (M, 1)).astype(np.float32)
    obs_s = bearing(spos + a * (epos - spos))
    obs_e = bearing(epos + a * (epos - spos))
    obs_s[:, :2] += rng.normal(0, 0.25 / 250.0, (M, 2)).astype(np.float32)
    obs_s[:3, :2] += 0.04
    line = np.asarray(jpo.line_coeffs_from_bearings(jnp.asarray(obs_s),
                                                    jnp.asarray(obs_e)))
    seg_level = (np.arange(M) % 3).astype(np.int32)
    seg_valid = rng.random(M) < 0.9
    dR, dt = jlie.se3_exp(jnp.asarray([0.003, 0.004, -0.003, 0.0015, 0.002,
                                       -0.0015], np.float32))
    R0, t0 = (np.asarray(x) for x in jlie.compose(dR, dt, jnp.asarray(R_gt),
                                                  jnp.asarray(t_gt)))
    cols = [f, (np.arange(n) % 3).astype(np.int32), pts, np.ones(n, bool), line,
            seg_level, spos, epos, seg_valid]
    rj = jpo.optimize_pose(jpo.PoseOptInputs(*[jnp.asarray(c) for c in cols]),
                           jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(250.0))
    rt = tpo.optimize_pose(tpo.PoseOptInputs(*[T(c) for c in cols]), T(R0),
                           T(t0), 250.0)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-5)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-5)
    np.testing.assert_array_equal(rt.pt_inlier.numpy(), np.asarray(rj.pt_inlier))
    seg_in = np.asarray(rj.seg_inlier)
    np.testing.assert_array_equal(rt.seg_inlier.numpy(), seg_in)
    assert 10 <= seg_in.sum() < seg_valid.sum()
    np.testing.assert_allclose(float(rt.scale_seg), float(rj.scale_seg), rtol=1e-5)
    np.testing.assert_allclose(float(rt.scale_pt), float(rj.scale_pt), rtol=1e-5)


def _line_seed_blob(rng, S, B, k):
    rows = np.zeros(B, np.float32)
    rows[:k] = rng.choice(S, k, replace=False)
    mask = np.zeros(B, np.float32)
    mask[:k] = 1.0
    cols = [rng.normal(100, 50, (B, 2)), rng.normal(100, 50, (B, 2)),
            _bearings(rng, B), _bearings(rng, B)]
    return np.concatenate(
        [rows, mask, np.full(B, 3.0)] + [c.astype(np.float32).ravel() for c in cols]
        + [np.zeros(B), np.asarray([0.45, 0.012, 1.7, 5.0])]).astype(np.float32)


def test_scatter_new_line_seeds_blob_matches_jax(rng):
    S, B = 64, 32
    j = jdf.empty_line_seeds(S)
    t = tdf.empty_line_seeds(S, device="cpu")
    for k in (20, 9):
        blob = _line_seed_blob(rng, S, B, k)
        j = jdf.scatter_new_line_seeds_blob(j, jnp.asarray(blob), B=B)
        # the port takes the four scalars of the blob's tail from the host
        t = tdf.scatter_new_line_seeds_blob(t, T(blob[:-4]), B=B,
                                            scalars=blob[-4:])
    assert int(t.alive.sum()) >= 20
    for name in tdf.LineSeeds._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    back = convert.line_seeds_from_numpy(
        {k: np.asarray(v) for k, v in j._asdict().items()}, device="cpu")
    for a, b in zip(back, t):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
