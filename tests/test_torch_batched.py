"""The port's batch axis on the CPU: `batched_sparse_align` against the
JAX package's vmapped one on tests/test_batched.py's B = 4 fixture, the
batched `sparse_img_align` and `optimize_pose` against one sequence at a
time, the mixed-align plain twin over the flattened rows of B sequences
against one call per sequence, `bundle_adjust_blob_batched` against the
JAX package's, and the batched keyframe detection program against one
program per request (with the K1 scorer called once for all requests)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import lie as tlie
from plsvo_torch.config import fast_config
from plsvo_torch.image import build_pyramid
from plsvo_torch.ops import fast_score as tfs
from plsvo_torch.ops import feature_align as tfa
from plsvo_torch.ops import pose_opt as tpo
from plsvo_torch.ops import sparse_align as tsa
from plsvo_torch.parallel import ba as tba
from plsvo_torch.parallel import batched as tbatched
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_tpu.parallel import ba as jba
from plsvo_tpu.parallel import batched as jbatched

from test_ba import make_line_problem
from test_batched import CAM, make_batch
from test_torch_align import mixed_problem
from test_torch_step import golden_frames

torch.set_num_threads(1)

FX, FY, CX, CY = (float(np.asarray(v)) for v in (CAM.fx, CAM.fy, CAM.cx, CAM.cy))


def T(a):
    return None if a is None else torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def align_batch():
    pyr_r, pyr_c, pts, segs, _, _ = make_batch(np.random.default_rng(0), 4)
    return pyr_r, pyr_c, pts, segs


def test_batched_sparse_align_matches_jax(align_batch):
    pyr_r, pyr_c, pts, segs = align_batch
    B = pts.valid.shape[0]
    R0, t0 = jnp.tile(jnp.eye(3)[None], (B, 1, 1)), jnp.zeros((B, 3))
    Rj, tj, npj, nsj, aj = jbatched.batched_sparse_align(
        pyr_r, pyr_c, pts, segs, R0, t0, CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    Rt, tt, npt, nst, at = tbatched.batched_sparse_align(
        [T(p) for p in pyr_r], [T(p) for p in pyr_c],
        tsa.AlignPoints(*[T(a) for a in pts]),
        tsa.AlignSegments(*[T(a) for a in segs]), T(R0), T(t0),
        FX, FY, CX, CY)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_array_equal(npt.numpy(), np.asarray(npj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_batched_sparse_align_equals_single(align_batch):
    """Each sequence of the batch gets what it gets alone: a sequence whose
    loop stopped keeps its carry while the others iterate."""
    pyr_r, pyr_c, pts, segs = align_batch
    B = pts.valid.shape[0]
    pr, pc = [T(p) for p in pyr_r], [T(p) for p in pyr_c]
    pts_t = tsa.AlignPoints(*[T(a) for a in pts])
    segs_t = tsa.AlignSegments(*[T(a) for a in segs])
    kw = dict(levels=(4, 3, 2), n_iter=30, patch_size=4)
    rb = tsa.sparse_img_align(pr, pc, pts_t, segs_t,
                              torch.eye(3).expand(B, 3, 3),
                              torch.zeros(B, 3), FX, FY, CX, CY, **kw)
    for b in range(B):
        rs = tsa.sparse_img_align(
            [p[b] for p in pr], [p[b] for p in pc],
            tsa.AlignPoints(*[a[b] for a in pts_t]),
            tsa.AlignSegments(*[None if a is None else a[b] for a in segs_t]),
            torch.eye(3), torch.zeros(3), FX, FY, CX, CY, **kw)
        np.testing.assert_allclose(rb.R[b].numpy(), rs.R.numpy(), atol=1e-5)
        np.testing.assert_allclose(rb.t[b].numpy(), rs.t.numpy(), atol=1e-5)
        assert float(abs(rb.chi2[b] - rs.chi2)) <= 1e-5 * max(1.0, float(rs.chi2))
        assert int(rb.n_tracked_pts[b]) == int(rs.n_tracked_pts)


def _pose_problem(rng, N=64, M=12, focal=250.0):
    """Points and segments seen from a known pose, noisy bearings, a
    perturbed initial pose; some rows invalid."""
    R, t = tlie.se3_exp(T(rng.normal(0, [0.02] * 3 + [0.03] * 3)
                          .astype(np.float32)))
    pw = rng.uniform([-1, -1, 2], [1, 1, 4], (N, 3)).astype(np.float32)
    sw = rng.uniform([-1, -1, 2], [1, 1, 4], (M, 3)).astype(np.float32)
    ew = sw + rng.normal(0, 0.3, (M, 3)).astype(np.float32)

    def bearing(x):
        c = x @ R.T + t
        c = c + T(rng.normal(0, 0.5 / focal, c.shape).astype(np.float32)) * c[:, 2:]
        return c / torch.linalg.norm(c, dim=-1, keepdim=True)

    pt_f = bearing(T(pw))
    line = tpo.line_coeffs_from_bearings(bearing(T(sw)), bearing(T(ew)))
    inp = tpo.PoseOptInputs(
        pt_f=pt_f, pt_level=T(rng.integers(0, 3, N).astype(np.int32)),
        pt_pos_w=T(pw), pt_valid=T(rng.random(N) > 0.15), seg_line=line,
        seg_level=T(rng.integers(0, 2, M).astype(np.int32)), seg_spos_w=T(sw),
        seg_epos_w=T(ew), seg_valid=T(rng.random(M) > 0.2))
    dR, dt = tlie.se3_exp(T(rng.normal(0, 0.01, 6).astype(np.float32)))
    R0, t0 = tlie.compose(dR, dt, R, t)
    return inp, R0, t0


@pytest.mark.parametrize("n_iter_ref", [0, 3])
def test_batched_optimize_pose_equals_single(n_iter_ref):
    rng = np.random.default_rng(3)
    probs = [_pose_problem(rng) for _ in range(3)]
    inp_b = tpo.PoseOptInputs(*[torch.stack(xs) for xs in
                                zip(*[p[0] for p in probs])])
    R0 = torch.stack([p[1] for p in probs])
    t0 = torch.stack([p[2] for p in probs])
    kw = dict(n_iter=10, n_iter_ref=n_iter_ref, reproj_thresh=2.0)
    rb = tpo.optimize_pose(inp_b, R0, t0, 250.0, **kw)
    for b, (inp, R, t) in enumerate(probs):
        rs = tpo.optimize_pose(inp, R, t, 250.0, **kw)
        np.testing.assert_allclose(rb.R[b].numpy(), rs.R.numpy(), atol=1e-5)
        np.testing.assert_allclose(rb.t[b].numpy(), rs.t.numpy(), atol=1e-5)
        np.testing.assert_array_equal(rb.pt_inlier[b].numpy(),
                                      rs.pt_inlier.numpy())
        np.testing.assert_array_equal(rb.seg_inlier[b].numpy(),
                                      rs.seg_inlier.numpy())
        np.testing.assert_allclose(float(rb.scale_pt[b]), float(rs.scale_pt),
                                   rtol=1e-6)


def test_mixed_align_flattened_rows_equal_per_sequence():
    """K2's plain twin over the rows of 3 sequences, each row reading its
    own sequence's atlas, equals one call per sequence exactly."""
    rng = np.random.default_rng(5)
    probs = [mixed_problem(rng, N=48)[0] for _ in range(3)]
    per_seq = []
    for arrays in probs:
        a = [T(x) for x in arrays]
        a[9] = a[9].long()
        per_seq.append(tfa.align_mixed_atlas(*a, patch_size=8, n_iter=10))
    rows = [[T(x) for x in arrays] for arrays in probs]
    atlas = torch.stack([r[0] for r in rows])
    flat = [torch.cat([r[i] for r in rows]) for i in range(3, 11)]
    flat[6] = flat[6].long()
    seq = torch.arange(3).repeat_interleave(48)
    out = tfa.align_mixed_atlas(atlas, rows[0][1], rows[0][2], *flat,
                                patch_size=8, n_iter=10, seq=seq)
    for name in ("uv", "converged", "mean_diff"):
        assert torch.equal(getattr(out, name),
                           torch.cat([getattr(r, name) for r in per_seq])), name
    assert int(out.converged.sum()) >= 40


def test_bundle_adjust_blob_batched_matches_jax():
    probs = [make_line_problem(np.random.default_rng(s))[0] for s in (0, 1)]
    blobs, specs = zip(*[jba.problem_blob(p) for p in probs])
    assert specs[0] == specs[1]
    kw = dict(n_iter=3, pose_prior=1.0, accept_gate=False)
    jR, jt, jl = jba.bundle_adjust_blob_batched(
        jnp.asarray(np.stack(blobs)), spec=specs[0], **kw)
    to, ts = tba.bundle_adjust_blob_batched(
        T(np.stack(blobs)), spec=specs[0], **kw)
    # the tolerances of test_torch_ba.py::test_bundle_adjust_matches_jax
    np.testing.assert_allclose(to.kf_R.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(to.kf_t.numpy(), np.asarray(jt), atol=1e-4)
    lj = np.asarray(jl)
    err = np.linalg.norm(to.lm_pos.numpy() - lj, axis=-1)
    assert (err <= 1e-3 * np.linalg.norm(lj, axis=-1)).all(), err.max()
    # each row is that problem solved alone
    for r, blob in enumerate(blobs):
        so, _ = tba.bundle_adjust_blob(T(blob), spec=specs[0], **kw)
        np.testing.assert_allclose(to.kf_R[r].numpy(), so.kf_R.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(to.lm_pos[r].numpy(), so.lm_pos.numpy(),
                                   atol=1e-5)


def test_batched_detection_equals_single(monkeypatch):
    cfg = fast_config()
    cam = tfh.PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
    vo = tfh.FrameHandlerMono(cam, cfg, device="cpu")
    statics = vo._detect_statics()
    imgs = golden_frames(12)
    pyrs = [build_pyramid(T(imgs[i]), vo.n_levels) for i in (3, 11)]
    rng = np.random.default_rng(0)
    C = cfg.caps.max_fts + 2 * cfg.caps.max_segs
    occ_uv = rng.uniform(0, [320, 240], (2, C, 2)).astype(np.float32)
    occ_ok = rng.random((2, C)) < 0.2
    calls = []
    orig = tfs.fast_score_levels
    monkeypatch.setattr(tfs, "fast_score_levels",
                        lambda imgs, *a: calls.append(len(imgs)) or orig(imgs, *a))
    out = tfh._kf_detect_program_batched(
        tuple(torch.stack([p[lv] for p in pyrs]) for lv in range(vo.n_levels)),
        T(occ_uv), T(occ_ok), **statics)
    assert calls == [2 * statics["n_pyr"]]
    for r, pyr in enumerate(pyrs):
        single = tfh._kf_detect_program_batched(
            [p[None] for p in pyr], T(occ_uv[r])[None], T(occ_ok[r])[None],
            **statics)
        for got, want in zip(out, single):
            for a, b in zip(got, want):
                assert torch.equal(a[r], b[0])
    assert int(out[0].valid.sum()) > 20 and int(out[1].valid.sum()) > 0
