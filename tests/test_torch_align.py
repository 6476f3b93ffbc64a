"""Alignment / matching / optimization parity between the port and the JAX
package on CPU (the mixed-align loop, sparse image alignment, direct
matching, epipolar search, pose and structure optimization, bootstrap KLT
and RANSAC). The mixed-align CUDA kernel is held against its plain twin in
tests/test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import image as ti
from plsvo_torch.ops import feature_align as tfa
from plsvo_torch.ops import homography as th
from plsvo_torch.ops import klt as tk
from plsvo_torch.ops import matcher as tm
from plsvo_torch.ops import pose_opt as tpo
from plsvo_torch.ops import sparse_align as tsa
from plsvo_torch.ops import struct_opt as tso
from plsvo_tpu import image as ji
from plsvo_tpu import lie as jl
from plsvo_tpu.camera import PinholeCamera
from plsvo_tpu.ops import feature_align as jfa
from plsvo_tpu.ops import homography as jh
from plsvo_tpu.ops import klt as jk
from plsvo_tpu.ops import matcher as jm
from plsvo_tpu.ops import pose_opt as jpo
from plsvo_tpu.ops import sparse_align as jsa
from plsvo_tpu.ops import struct_opt as jso
from plsvo_tpu.utils import synthetic

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
FX, FY, CX, CY = 250.0, 250.0, 160.0, 120.0


def T(a):
    return torch.as_tensor(np.array(a))


def mixed_problem(rng, N=64, H=120, W=160):
    """The inputs of tests/test_pallas_align.py."""
    img = jnp.asarray(np.clip(rng.normal(128, 40, (H, W)), 0, 255)
                      .astype(np.float32))
    img = jax.scipy.signal.convolve2d(img, jnp.ones((3, 3)) / 9.0, mode="same")
    atlas, x_off, sizes = ji.pack_pyramid_atlas([img, img[::2, ::2]])
    B = 10
    uv_true = np.stack([rng.uniform(12, W - 12, N),
                        rng.uniform(12, H - 12, N)], -1).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(B) - B / 2 + 0.5, np.arange(B) - B / 2 + 0.5,
                         indexing="ij")
    pos = jnp.asarray(uv_true[:, None, :]
                      + np.stack([xx.ravel(), yy.ravel()], -1)[None])
    ref, dx, dy = jfa.ref_patch_gradients(ji.bilinear_sample(img, pos)[0], 8)
    uv0 = (uv_true + rng.uniform(-2, 2, (N, 2))).astype(np.float32)
    d = rng.normal(size=(N, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    is1d = rng.random(N) < 0.3
    valid = rng.random(N) < 0.9
    arrays = [np.asarray(a) for a in (atlas, x_off, sizes, ref, dx, dy)]
    arrays += [uv0, d, is1d, np.zeros(N, np.int32), valid]
    return arrays, uv_true


def run_mixed(arrays):
    j = jfa.align_mixed_atlas(*[jnp.asarray(a) for a in arrays], patch_size=8,
                              n_iter=10, backend="xla")
    t_args = [T(a) for a in arrays]
    t_args[9] = t_args[9].long()
    t = tfa.align_mixed_atlas(*t_args, patch_size=8, n_iter=10)
    return j, t


def check_mixed(j, t):
    cj = np.asarray(j.converged)
    ct = t.converged.numpy()
    np.testing.assert_array_equal(ct, cj)
    assert cj.sum() >= 20
    np.testing.assert_allclose(t.uv.numpy()[cj], np.asarray(j.uv)[cj],
                               atol=2e-3)
    np.testing.assert_allclose(t.mean_diff.numpy()[cj],
                               np.asarray(j.mean_diff)[cj], atol=2e-2)


def test_align_mixed_plain_matches_xla(rng):
    arrays, _ = mixed_problem(rng)
    check_mixed(*run_mixed(arrays))


def test_align_mixed_1d_rows_move_along_direction(rng):
    arrays, _ = mixed_problem(rng)
    arrays[8] = np.ones_like(arrays[8])
    j, t = run_mixed(arrays)
    check_mixed(j, t)
    disp = t.uv.numpy() - arrays[6]
    d = arrays[7]
    moved = np.linalg.norm(disp, axis=-1) > 1e-6
    assert np.all(np.abs(disp[:, 0] * d[:, 1] - disp[:, 1] * d[:, 0])[moved] < 1e-3)


def _pair(rng, dt, drot, ss=2):
    scene = synthetic.make_scene(rng, size=1024, texel_size=0.004)
    R_ref = np.eye(3, dtype=np.float32)
    t_ref = np.array([0.0, 0.0, -2.0], np.float32)
    R_cur = np.asarray(jl.so3_exp(jnp.asarray([0.0, drot, 0.5 * drot])), np.float32)
    t_cur = t_ref + np.asarray(dt, np.float32)
    img_ref = np.asarray(synthetic.render_aa(scene, CAM, R_ref, t_ref, ss=ss)[0])
    img_cur = np.asarray(synthetic.render_aa(scene, CAM, R_cur, t_cur, ss=ss)[0])
    Rcr, tcr = jl.compose(*jl.inverse(jnp.asarray(R_cur), jnp.asarray(t_cur)),
                          jnp.asarray(R_ref), jnp.asarray(t_ref))
    return scene, (R_ref, t_ref), img_ref, img_cur, np.asarray(Rcr), np.asarray(tcr)


def _gt_points(rng, scene, pose, n, border=30):
    uv = np.stack([rng.uniform(border, 320 - border, n),
                   rng.uniform(border, 240 - border, n)], -1).astype(np.float32)
    rays = np.asarray(CAM.unproject(jnp.asarray(uv)))
    z = np.asarray(synthetic.depth_at(scene, CAM, jnp.asarray(pose[0]),
                                      jnp.asarray(pose[1]), jnp.asarray(uv)))
    return uv, rays, (z / rays[:, 2]).astype(np.float32)


def test_sparse_img_align_matches_jax(rng):
    scene, pose_ref, img_ref, img_cur, _, _ = _pair(rng, (0.02, -0.01, 0.008), 0.01)
    uv, rays, rng_d = _gt_points(rng, scene, pose_ref, 96, border=12)
    valid = np.isfinite(rng_d) & (rng_d > 0.1)
    xyz = (rays * rng_d[:, None]).astype(np.float32)
    M, K = 8, 4
    z2, z3, z1 = (np.zeros((M, 2), np.float32), np.zeros((M, 3), np.float32),
                  np.zeros(M, np.float32))
    segs_j = jsa.make_align_segments(*[jnp.asarray(a) for a in
                                       (z2, z2, z3, z3, z1, z1)],
                                     jnp.zeros(M, bool), K, FX, FY, CX, CY)
    segs_t = tsa.make_align_segments(*[T(a) for a in (z2, z2, z3, z3, z1, z1)],
                                     torch.zeros(M, dtype=torch.bool), K,
                                     FX, FY, CX, CY)
    rj = jsa.sparse_img_align(
        ji.build_pyramid(jnp.asarray(img_ref), 5),
        ji.build_pyramid(jnp.asarray(img_cur), 5),
        jsa.AlignPoints(jnp.asarray(xyz), jnp.asarray(uv), jnp.asarray(valid)),
        segs_j, jnp.eye(3), jnp.zeros(3), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
        levels=(4, 3, 2), n_iter=30)
    rt = tsa.sparse_img_align(
        ti.build_pyramid(T(img_ref), 5), ti.build_pyramid(T(img_cur), 5),
        tsa.AlignPoints(T(xyz), T(uv), T(valid)), segs_t, torch.eye(3),
        torch.zeros(3), FX, FY, CX, CY, levels=(4, 3, 2), n_iter=30)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    assert int(rt.n_tracked_pts) == int(rj.n_tracked_pts) > 30


def _find_match_inputs(rng):
    scene, pose_ref, img_ref, img_cur, Rcr, tcr = _pair(
        rng, (0.03, -0.015, 0.01), 0.015, ss=1)
    uv, rays, rng_d = _gt_points(rng, scene, pose_ref, 48)
    ok_d = np.isfinite(rng_d) & (rng_d > 0.1)
    N = len(uv)
    xyz_cur = (rays * rng_d[:, None]) @ Rcr.T + tcr
    uv_gt = np.stack([FX * xyz_cur[:, 0] / xyz_cur[:, 2] + CX,
                      FY * xyz_cur[:, 1] / xyz_cur[:, 2] + CY], -1)
    uv_init = (uv_gt + rng.uniform(-2, 2, uv_gt.shape)).astype(np.float32)
    ftype = (rng.random(N) < 0.3).astype(np.int32)
    gdir = rng.normal(size=(N, 2)).astype(np.float32)
    gdir /= np.linalg.norm(gdir, axis=-1, keepdims=True)
    return dict(img_ref=img_ref, img_cur=img_cur, uv=uv, rays=rays,
                rng_d=rng_d, valid=ok_d, Rcr=np.tile(Rcr[None], (N, 1, 1)),
                tcr=np.tile(tcr[None], (N, 1)), uv_init=uv_init,
                ftype=ftype, gdir=gdir, N=N)


def test_find_match_direct_atlas_matches_jax(rng):
    """With edgelets: corners 2-D and edgelets 1-D in the mixed loop."""
    _check_find_match(rng, has_edgelets=True)


def test_find_match_direct_atlas_align2d_matches_jax(rng):
    """Without edgelets (use_edgelets=False, line-only mode): every row
    refines 2-D through align2d_atlas's 18x18 windows."""
    _check_find_match(rng, has_edgelets=False)


def _check_find_match(rng, has_edgelets):
    p = _find_match_inputs(rng)
    N = p["N"]
    kf_j = ji.pack_pyramid_atlas_flat(
        [q[None] for q in ji.build_pyramid(jnp.asarray(p["img_ref"]), 3)])
    cur_j = ji.pack_pyramid_atlas(ji.build_pyramid(jnp.asarray(p["img_cur"]), 3))
    kf_t = ti.pack_pyramid_atlas_flat(
        [q[None] for q in ti.build_pyramid(T(p["img_ref"]), 3)])
    cur_t = ti.pack_pyramid_atlas(ti.build_pyramid(T(p["img_cur"]), 3))
    names = ("uv", "rays", "rng_d")
    rj = jm.find_match_direct_atlas(
        kf_j, *cur_j, jnp.zeros(N, jnp.int32),
        *[jnp.asarray(p[k]) for k in names], jnp.zeros(N, jnp.int32),
        jnp.asarray(p["Rcr"]), jnp.asarray(p["tcr"]), jnp.asarray(p["uv_init"]),
        jnp.asarray(p["valid"]), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
        jnp.asarray(p["ftype"]), jnp.asarray(p["gdir"]), max_level=2,
        has_edgelets=has_edgelets)
    rt = tm.find_match_direct_atlas(
        kf_t, *cur_t, torch.zeros(N, dtype=torch.long),
        *[T(p[k]) for k in names], torch.zeros(N, dtype=torch.long),
        T(p["Rcr"]), T(p["tcr"]), T(p["uv_init"]), T(p["valid"]),
        FX, FY, CX, CY, T(p["ftype"]), T(p["gdir"]), max_level=2,
        has_edgelets=has_edgelets)
    ok = np.asarray(rj.ok)
    np.testing.assert_array_equal(rt.ok.numpy(), ok)
    assert ok.sum() > 0.5 * p["valid"].sum()
    np.testing.assert_array_equal(rt.level.numpy(), np.asarray(rj.level))
    np.testing.assert_allclose(rt.uv.numpy()[ok], np.asarray(rj.uv)[ok],
                               atol=2e-3)


def test_epipolar_search_sliding_matches_jax(rng):
    scene, pose_ref, img_ref, img_cur, Rcr, tcr = _pair(
        rng, (0.12, 0.0, 0.0), 0.0, ss=1)
    uv, rays, rng_d = _gt_points(rng, scene, pose_ref, 32)
    ok_d = np.isfinite(rng_d) & (rng_d > 0.1)
    N = len(uv)
    pb = np.asarray(ji.extract_patches(jnp.asarray(img_ref), jnp.asarray(uv), 10)[0])
    f_A = ((rays * (rng_d * 1.4)[:, None]) @ Rcr.T + tcr).astype(np.float32)
    f_B = ((rays * (rng_d * 0.7)[:, None]) @ Rcr.T + tcr).astype(np.float32)
    lvl = (np.arange(N) % 2).astype(np.int32)
    cur_j = ji.pack_pyramid_atlas(ji.build_pyramid(jnp.asarray(img_cur), 3))
    cur_t = ti.pack_pyramid_atlas(ti.build_pyramid(T(img_cur), 3))
    rj = jm.epipolar_search_sliding_atlas(
        *cur_j, jnp.asarray(pb), jnp.asarray(f_A), jnp.asarray(f_B),
        jnp.asarray(lvl), jnp.asarray(ok_d), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
        n_steps=64)
    rt = tm.epipolar_search_sliding_atlas(
        *cur_t, T(pb), T(f_A), T(f_B), T(lvl), T(ok_d), FX, FY, CX, CY,
        n_steps=64)
    ok = np.asarray(rj.ok)
    np.testing.assert_array_equal(rt.ok.numpy(), ok)
    assert ok.sum() > 0.5 * ok_d.sum()
    np.testing.assert_allclose(rt.uv_level.numpy()[ok],
                               np.asarray(rj.uv_level)[ok], atol=1e-3)
    np.testing.assert_allclose(rt.zmssd.numpy()[ok], np.asarray(rj.zmssd)[ok],
                               rtol=1e-3, atol=1e-2)


def _world(rng, n_pts=64):
    pts = np.stack([rng.uniform(-1.0, 1.0, n_pts), rng.uniform(-0.8, 0.8, n_pts),
                    rng.uniform(2.0, 5.0, n_pts)], -1).astype(np.float32)
    return pts


@pytest.mark.parametrize("n_iter_ref", [0, 3])
def test_optimize_pose_matches_jax(rng, n_iter_ref):
    pts = _world(rng)
    n = len(pts)
    xi = np.asarray([0.05, -0.03, 0.02, 0.01, -0.02, 0.015], np.float32)
    R_gt, t_gt = (np.asarray(a) for a in jl.se3_exp(jnp.asarray(xi)))
    xyz = pts @ R_gt.T + t_gt
    f = (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(np.float32)
    f[:, :2] += rng.normal(0, 0.25 / 250.0, f[:, :2].shape).astype(np.float32)
    f[:6, :2] += 0.05  # gross outliers
    level = (np.arange(n) % 3).astype(np.int32)
    dxi = np.asarray([0.003, 0.004, -0.003, 0.0015, 0.002, -0.0015], np.float32)
    dR, dt = jl.se3_exp(jnp.asarray(dxi))
    R0, t0 = (np.asarray(a) for a in jl.compose(dR, dt, jnp.asarray(R_gt),
                                                 jnp.asarray(t_gt)))
    M = 8
    z3 = np.zeros((M, 3), np.float32)
    inp_j = jpo.PoseOptInputs(
        jnp.asarray(f), jnp.asarray(level), jnp.asarray(pts), jnp.ones(n, bool),
        jnp.asarray(z3), jnp.zeros(M, jnp.int32), jnp.asarray(z3),
        jnp.asarray(z3), jnp.zeros(M, bool))
    inp_t = tpo.PoseOptInputs(
        T(f), T(level), T(pts), torch.ones(n, dtype=torch.bool), T(z3),
        torch.zeros(M, dtype=torch.int32), T(z3), T(z3),
        torch.zeros(M, dtype=torch.bool))
    rj = jpo.optimize_pose(inp_j, jnp.asarray(R0), jnp.asarray(t0),
                           jnp.asarray(250.0), n_iter_ref=n_iter_ref)
    rt = tpo.optimize_pose(inp_t, T(R0), T(t0), 250.0, n_iter_ref=n_iter_ref)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-5)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-5)
    np.testing.assert_array_equal(rt.pt_inlier.numpy(), np.asarray(rj.pt_inlier))
    np.testing.assert_allclose(float(rt.scale_pt), float(rj.scale_pt), rtol=1e-5)


def test_optimize_points_matches_jax(rng):
    L, O = 32, 5
    pos_gt = np.stack([rng.uniform(-1, 1, L), rng.uniform(-1, 1, L),
                       rng.uniform(3, 6, L)], -1).astype(np.float32)
    Rs, ts, fs = [], [], []
    for _ in range(O):
        xi = rng.normal(0, 0.3, 6).astype(np.float32)
        xi[3:] *= 0.2
        R, t = (np.asarray(a) for a in jl.se3_exp(jnp.asarray(xi)))
        xyz = pos_gt @ R.T + t
        fs.append(xyz / np.linalg.norm(xyz, axis=-1, keepdims=True))
        Rs.append(np.tile(R[None], (L, 1, 1)))
        ts.append(np.tile(t[None], (L, 1)))
    obs = [np.stack(Rs, 1), np.stack(ts, 1), np.stack(fs, 1).astype(np.float32),
           rng.random((L, O)) < 0.8]
    pos0 = (pos_gt + rng.normal(0, 0.05, pos_gt.shape)).astype(np.float32)
    valid = rng.random(L) < 0.9
    pj, ij = jso.optimize_points(jnp.asarray(pos0),
                                 jso.StructObs(*[jnp.asarray(a) for a in obs]),
                                 jnp.asarray(valid))
    pt, it = tso.optimize_points(T(pos0), tso.StructObs(*[T(a) for a in obs]),
                                 T(valid))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)


def test_klt_and_ransac_match_jax(rng):
    scene, pose_ref, img_ref, img_cur, Rcr, tcr = _pair(
        rng, (0.1, 0.01, 0.0), 0.01, ss=1)
    N = 96
    uv = np.stack([rng.uniform(20, 300, N), rng.uniform(20, 220, N)],
                  -1).astype(np.float32)
    valid = rng.random(N) < 0.95
    pj = ji.build_pyramid(jnp.asarray(img_ref), 4)
    cj = ji.build_pyramid(jnp.asarray(img_cur), 4)
    uj, okj, _ = jk.track_klt(pj, cj, jnp.asarray(uv), jnp.asarray(valid))
    ut, okt, _ = tk.track_klt(ti.build_pyramid(T(img_ref), 4),
                              ti.build_pyramid(T(img_cur), 4), T(uv), T(valid))
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj.sum() > 40
    np.testing.assert_allclose(ut.numpy()[okj], np.asarray(uj)[okj], atol=2e-3)
    # RANSAC with JAX's hypothesis draws injected
    f_ref = np.asarray(CAM.unproject(jnp.asarray(uv)))
    f_cur = np.asarray(CAM.unproject(uj))
    ok = okj & valid
    n_valid = max(int(ok.sum()), 1)
    draws = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (256, 4), 0,
                                          n_valid))
    hj = jh.homography_init(f_ref, f_cur, ok, focal=250.0)
    ht = th.homography_init(f_ref, f_cur, ok, focal=250.0, draws=draws,
                            device="cpu")
    assert ht.ok == hj.ok
    np.testing.assert_array_equal(ht.inliers, hj.inliers)
    np.testing.assert_allclose(ht.R_cur_ref, hj.R_cur_ref, atol=1e-4)
    np.testing.assert_allclose(ht.depths_ref, hj.depths_ref, rtol=1e-3)

