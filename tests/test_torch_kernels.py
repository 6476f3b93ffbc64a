"""The four CUDA kernels against their plain PyTorch twins on the card,
and the slice on the card. Every test here needs a CUDA card and nvcc, so on a
CPU-only machine each one skips.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX: `python -m pytest --noconftest tests/test_torch_kernels.py -q`.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from plsvo_torch import image as ti
from plsvo_torch import lie
from plsvo_torch.camera import PinholeCamera
from plsvo_torch.config import fast_config
from plsvo_torch.ops import fast_score as tfs
from plsvo_torch.ops import feature_align as tfa
from plsvo_torch.ops import lines as tl
from plsvo_torch.ops import mixed_align as tma
from plsvo_torch.ops import pose_opt as tpo
from plsvo_torch.ops import sparse_align as tsa
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.utils import synthetic, trajectory


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _structured(gen, shape):
    img = gen.uniform(0, 255, shape).astype(np.float32)
    img[30:60, 40:90] += 120.0
    return np.clip(img, 0, 255).astype(np.float32)


# The kernel's box is separable: per column a pairwise tree over the 8 rows'
# gradient products, then a pairwise tree over 8 columns across lanes. The
# plain twin differences f32 cumsums along rows, then columns. The two
# round differently by up to 1.0e-4 relative on the bench levels and
# 2.5e-4 on the 100x300 noise image (measured on an H100).
def _score_rel_err(s_k, s_p):
    return float(((s_k - s_p).abs() / s_p.abs().clamp_min(1.0)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 752), (240, 376), (120, 188),
                                   (100, 300), (97, 131), (37, 53)])
def test_fast_score_kernel_matches_plain(cuda, gen, shape):
    img = torch.as_tensor(_structured(gen, shape), device=cuda)
    before = tfs.launches
    m_k, s_k = tfs.fast_score_cuda(img, 10.0)
    assert tfs.launches == before + 1
    m_p, s_p = tfs.fast_score_plain(img, 10.0)
    assert torch.equal(m_k, m_p)
    assert _score_rel_err(s_k, s_p) < 1e-3
    # a same-shape batch is one launch over a list of images
    mb, sb = tfs.fast_score_cuda(torch.stack([img, img]), 10.0)
    assert tfs.launches == before + 2
    assert torch.equal(mb[1], m_k) and torch.equal(sb[1], s_k)


def _bench_frame(device):
    """Frame 0 of chip_smoke.py's 752x480 plane sequence."""
    cam = PinholeCamera.create(752, 480, 460.0, 460.0, 376.0, 240.0)
    scene = synthetic.make_scene(np.random.default_rng(3), size=2048,
                                 texel_size=0.003)
    return synthetic.render_aa(scene, cam, np.eye(3, dtype=np.float32),
                               np.asarray([0.0, 0.0, -2.0], np.float32),
                               device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["bench_levels", "odd_shapes"])
def test_fast_score_levels_kernel_matches_plain(cuda, gen, which):
    """One launch for a list of images of different shapes: the three
    752x480 levels of the bench scene, or three odd shapes."""
    if which == "bench_levels":
        imgs = ti.build_pyramid(_bench_frame(cuda), 3)
    else:
        imgs = [torch.as_tensor(_structured(gen, s), device=cuda)
                for s in [(100, 300), (97, 131), (37, 53)]]
    before = tfs.launches
    outs = tfs.fast_score_levels(imgs, 10.0)
    assert tfs.launches == before + 1
    for img, (m_k, s_k) in zip(imgs, outs):
        m_p, s_p = tfs.fast_score_plain(img, 10.0)
        assert torch.equal(m_k, m_p), tuple(img.shape)
        assert int(m_p.sum()) > 0
        rel = _score_rel_err(s_k, s_p)
        print(f"K1 {tuple(img.shape)}: score max rel err {rel:.3e}")
        assert rel < 1e-3


# corners and edge points of the two bright bars of the "lines" problem
_BAR_POINTS = np.asarray([[20, 30], [140, 30], [20, 50], [140, 50], [70, 60],
                          [90, 60], [70, 110], [90, 110], [50, 30], [110, 50],
                          [70, 85], [90, 85]], np.float32)


def _mixed_problem(gen, device, N=256, H=120, W=160, mode="mixed"):
    """The inputs of tests/test_pallas_align.py, built with the port; mode
    picks the 1-D rows (none, all, or ~30%). A few rows start outside their
    window and ~10% are invalid. Mode "lines" is a reprojection batch of the
    lines path: the first half mixed point rows, the second half segment
    endpoints (2-D rows, zero direction) on the corners and edges of two
    bright bars."""
    img = np.clip(gen.normal(128, 40, (H, W)), 0, 255).astype(np.float32)
    if mode == "lines":
        img = 0.5 * img
        img[30:50, 20:140] += 150.0
        img[60:110, 70:90] += 150.0
    p = np.pad(img, 1)
    img = sum(p[i:i + H, j:j + W] for i in range(3) for j in range(3)) / 9.0
    img = torch.as_tensor(img.astype(np.float32), device=device)
    atlas, x_off, sizes = ti.pack_pyramid_atlas([img, img[::2, ::2]])
    B = 10
    uv_true = np.stack([gen.uniform(12, W - 12, N),
                        gen.uniform(12, H - 12, N)], -1).astype(np.float32)
    n_end = N - N // 2 if mode == "lines" else 0
    if n_end:
        uv_true[N // 2:] = (_BAR_POINTS[np.arange(n_end) % len(_BAR_POINTS)]
                            + gen.uniform(-1, 1, (n_end, 2)))
    yy, xx = np.meshgrid(np.arange(B) - B / 2 + 0.5, np.arange(B) - B / 2 + 0.5,
                         indexing="ij")
    pos = uv_true[:, None, :] + np.stack([xx.ravel(), yy.ravel()], -1)[None]
    patch, _ = ti.bilinear_sample(img, torch.as_tensor(pos.astype(np.float32),
                                                       device=device))
    ref, dx, dy = tfa.ref_patch_gradients(patch, 8)
    uv0 = (uv_true + gen.uniform(-2, 2, (N, 2))).astype(np.float32)
    uv0[gen.random(N) < 0.05] += 9.0  # outside the window from the start
    d = gen.normal(size=(N, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    is_1d = {"2d": np.zeros(N, bool), "1d": np.ones(N, bool),
             "mixed": gen.random(N) < 0.3,
             "lines": gen.random(N) < 0.3}[mode]
    if n_end:
        is_1d[N // 2:] = False
        d[N // 2:] = 0.0
    T = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (atlas, x_off, sizes, ref, dx, dy, T(uv0), T(d), T(is_1d),
            torch.zeros(N, dtype=torch.long, device=device),
            T(gen.random(N) < 0.9))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["2d", "1d", "mixed"])
@pytest.mark.parametrize("N", [1, 3, 5, 192, 257])
def test_mixed_align_kernel_matches_plain(cuda, gen, N, mode):
    """The parity bar of ROADMAP B2: equal verdicts, uv atol 2e-3,
    mean_diff atol 2e-2."""
    args = _mixed_problem(gen, cuda, N=N, mode=mode)
    captured = []
    tma.capture = lambda a, k: captured.append((a, k))
    try:
        before = tma.launches
        out = tfa.align_mixed_atlas(*args, patch_size=8, n_iter=10)
    finally:
        tma.capture = None
    assert tma.launches == before + 1
    kargs, kw = captured[0]
    uv_p, c_p, md_p = tma.mixed_align_plain(*kargs, **kw)
    assert torch.equal(out.converged, c_p)
    if N >= 192:
        assert int(c_p.sum()) >= N // 4
    if c_p.any():
        assert float((out.uv - uv_p)[c_p].abs().max()) < 2e-3
        assert float((out.mean_diff - md_p)[c_p].abs().max()) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("N", [48, 384])
def test_mixed_align_kernel_with_segment_endpoint_rows(cuda, gen, N):
    """K2 at the lines path's reprojection shapes (N=384: 192 points + 2 x
    96 endpoints; its retry batch N=48), half the rows segment endpoints:
    the parity bar of ROADMAP B2."""
    args = _mixed_problem(gen, cuda, N=N, mode="lines")
    captured = []
    tma.capture = lambda a, k: captured.append((a, k))
    try:
        before = tma.launches
        out = tfa.align_mixed_atlas(*args, patch_size=8, n_iter=10)
    finally:
        tma.capture = None
    assert tma.launches == before + 1
    kargs, kw = captured[0]
    uv_p, c_p, md_p = tma.mixed_align_plain(*kargs, **kw)
    assert torch.equal(out.converged, c_p)
    assert int(c_p[N // 2:].sum()) >= N // 8
    assert float((out.uv - uv_p)[c_p].abs().max()) < 2e-3
    assert float((out.mean_diff - md_p)[c_p].abs().max()) < 2e-2


# EuRoC cam0's rectified intrinsics, the benchmark's camera
ALIGN_CAM = PinholeCamera.create(752, 480, 458.654, 457.296, 367.215, 248.375)


def _align_problem(device, B=1, N=192, M=96, K=8, adaptive=True, seed=0):
    """B sequences over the bench plane: a reference frame 2 m above it and
    a current frame moved ~1 cm and ~5 mrad (each sequence its own motion),
    N points and M segments (20-80 px) at random pixels of the reference
    at their true depths, ~5% of the points and ~10% of the segments
    invalid. Segments carry their 3-D endpoints (length-adaptive samples)
    or, not adaptive, K fixed samples only. Returns sparse_img_align's
    arguments and keywords."""
    gen = np.random.default_rng(seed)
    scene = synthetic.make_scene(np.random.default_rng(3), size=2048,
                                 texel_size=0.003)
    cam = ALIGN_CAM
    lo, hi = np.asarray([15.0, 15.0]), np.asarray([cam.width - 15.0,
                                                   cam.height - 15.0])
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731

    def ray(uv):
        return np.stack([(uv[..., 0] - cam.cx) / cam.fx,
                         (uv[..., 1] - cam.cy) / cam.fy,
                         np.ones(uv.shape[:-1], np.float32)], -1)

    pyr_r, pyr_c, cols = [], [], []
    for b in range(B):
        t_ref = np.asarray([0.1 * b, -0.05 * b, -2.0], np.float32)
        R_cur = lie.so3_exp(T(gen.normal(0, 0.005, 3))).cpu().numpy()
        t_cur = t_ref + gen.normal(0, 0.01, 3).astype(np.float32)
        for pyr, (R, t) in ((pyr_r, (np.eye(3, dtype=np.float32), t_ref)),
                            (pyr_c, (R_cur, t_cur))):
            pyr.append(ti.build_pyramid(synthetic.render_aa(
                scene, cam, R, t, device=device), 5))

        def depth(uv):
            return synthetic.depth_at(scene, cam, np.eye(3, dtype=np.float32),
                                      t_ref, uv.astype(np.float32),
                                      device=device).cpu().numpy()

        uv = gen.uniform(lo, hi, (N, 2))
        s_uv = gen.uniform(lo, hi, (M, 2))
        ang, ln = gen.uniform(0, np.pi, M), gen.uniform(20, 80, M)
        e_uv = np.clip(s_uv + ln[:, None] * np.stack([np.cos(ang),
                                                      np.sin(ang)], -1), lo, hi)
        cols.append((ray(uv) * depth(uv)[:, None], uv, gen.random(N) < 0.95,
                     s_uv, e_uv, ray(s_uv), ray(e_uv), depth(s_uv),
                     depth(e_uv), gen.random(M) < 0.9))
    col = [np.stack([c[i] for c in cols]) for i in range(10)]
    pts = tsa.AlignPoints(T(col[0]), T(col[1]), torch.as_tensor(
        col[2], device=device))
    segs = tsa.make_align_segments(*[T(c) for c in col[3:9]],
                                   torch.as_tensor(col[9], device=device), K,
                                   cam.fx, cam.fy, cam.cx, cam.cy)
    if not adaptive:
        segs = tsa.AlignSegments(segs.xyz_ref, segs.uv_ref, segs.valid)
    pyrs = [[torch.stack([p[lv] for p in pyr]) for lv in range(5)]
            for pyr in (pyr_r, pyr_c)]
    R0 = torch.eye(3, device=device).expand(B, 3, 3).contiguous()
    return ((*pyrs, pts, segs, R0, torch.zeros((B, 3), device=device),
             cam.fx, cam.fy, cam.cx, cam.cy),
            dict(levels=(4, 3, 2), n_iter=30, patch_size=4))


# (batch, points, segments, samples a segment, adaptive): the bench's
# shapes alone and batched, points only, segments only, fast_config()'s 4
# fixed samples, and rows that overflow shared memory (the global scratch)
_ALIGN_CASES = {"batch1": dict(B=1), "batch4": dict(B=4),
                "points_only": dict(M=0), "segments_only": dict(N=0),
                "fixed_k4": dict(B=2, K=4, adaptive=False),
                "scratch_k32": dict(B=2, K=32)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_ALIGN_CASES))
def test_sparse_align_kernel_matches_plain(cuda, case):
    """K3 against the plain twin on the same card inputs, held as
    chip_smoke.py's gate holds it: poses within 1e-4 rad and 1e-4,
    seg_alive and the tracked counts equal, the iterations of each level
    equal but where the two sides part at a chi2-increase test within
    float32 rounding (reported as a warning). Two launches give the same
    bits; an unbatched call dispatches to the kernel."""
    args, kw = _align_problem(cuda, **_ALIGN_CASES[case])
    before = tsa.launches
    out_k, trace = tsa.sparse_img_align_cuda(*args, **kw)
    assert tsa.launches == before + 1
    out_p = tsa.sparse_img_align_plain(*args, **kw)
    problem, rot, terr, partings = chip_smoke.k3_compare(out_k, trace, out_p)
    assert problem is None, problem
    for b, lv, nk, np_, step in partings:
        warnings.warn(f"{case}: sequence {b} level index {lv} ran {nk} "
                      f"iterations on the card, {np_} in the plain twin "
                      f"(relative chi2 step {step:.2e})")
    n_pts, n_segs = out_p.n_tracked_pts, out_p.n_tracked_segs
    N, M = args[2].valid.shape[1], args[3].valid.shape[1]
    assert bool((n_pts >= N // 2).all()) and bool((n_segs >= M // 2).all())
    assert int(out_p.iters.min()) >= 1
    again, _ = tsa.sparse_img_align_cuda(*args, **kw)
    for x, y in zip(out_k, again):
        assert torch.equal(x, y)
    if case == "batch1":
        one = tsa.sparse_img_align(
            [p[0] for p in args[0]], [p[0] for p in args[1]],
            tsa.AlignPoints(*[a[0] for a in args[2]]),
            tsa.AlignSegments(*[a[0] for a in args[3]]), args[4][0],
            args[5][0], *args[6:], **kw)
        assert tsa.launches == before + 3
        for x, y in zip(one, out_k):
            assert torch.equal(x, y[0])


def _pose_problem(device, B=1, N=192, M=96, kinds=(), seed=0):
    """B sequences of the pose stage's problem at the tracked-frame step's
    capacities, EuRoC cam0's focal: a camera ~2 m from N points and M
    segments (endpoints 2-2.3 m deep) seen from its true pose with 0.3 px of
    noise, ~10% of the points and segments 5-30 px off (outliers), ~15% of
    the rows invalid, levels 0-2, and an initial pose ~1 cm and ~5 mrad
    off. kinds[b] makes sequence b "points" (no valid segment), "lines" (no
    valid point), "empty" (no valid row) or "nan" (a valid point with a NaN
    bearing: the first step is NaN). Returns optimize_pose's arguments and
    keywords."""
    gen = np.random.default_rng(seed)
    f = ALIGN_CAM.fx
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731

    def bearings(x, R, t, n):
        c = x @ R.T + t
        uv = c[:, :2] / c[:, 2:]
        uv += gen.normal(0, 0.3 / f, uv.shape)
        off = gen.random(n) < 0.1
        uv[off] += (gen.uniform(5, 30, (int(off.sum()), 2)) / f
                    * gen.choice([-1, 1], (int(off.sum()), 2)))
        b = np.concatenate([uv, np.ones((n, 1))], -1)
        return b / np.linalg.norm(b, axis=-1, keepdims=True)

    cols, R0s, t0s = [], [], []
    for b in range(B):
        R = lie.so3_exp(torch.as_tensor(gen.normal(0, 0.05, 3))).numpy()
        t = gen.normal(0, 0.1, 3)
        pw = np.stack([gen.uniform(-1.5, 1.5, N), gen.uniform(-1, 1, N),
                       gen.uniform(2.0, 2.3, N)], -1)
        sw = np.stack([gen.uniform(-1.5, 1.5, M), gen.uniform(-1, 1, M),
                       gen.uniform(2.0, 2.3, M)], -1)
        ew = sw + gen.normal(0, 0.3, (M, 3)) * [1, 1, 0.1]
        pw, sw, ew = [(x - t) @ R for x in (pw, sw, ew)]  # world frame
        pt_valid = gen.random(N) > 0.15
        seg_valid = gen.random(M) > 0.15
        kind = kinds[b] if b < len(kinds) else None
        if kind in ("lines", "empty"):
            pt_valid[:] = False
        if kind in ("points", "empty"):
            seg_valid[:] = False
        pt_f = bearings(pw, R, t, N)
        if kind == "nan":
            pt_valid[0] = True
            pt_f[0] = np.nan
        line = tpo.line_coeffs_from_bearings(T(bearings(sw, R, t, M)),
                                             T(bearings(ew, R, t, M)))
        cols.append((pt_f, gen.integers(0, 3, N), pw, pt_valid, line,
                     gen.integers(0, 3, M), sw, ew, seg_valid))
        dR, dt = lie.se3_exp(torch.as_tensor(gen.normal(0, [0.01] * 3 + [0.005] * 3)))
        Ri, ti = lie.compose(dR, dt, torch.as_tensor(R), torch.as_tensor(t))
        R0s.append(Ri.numpy())
        t0s.append(ti.numpy())
    inp = tpo.PoseOptInputs(
        pt_f=T(np.stack([c[0] for c in cols])),
        pt_level=torch.as_tensor(np.stack([c[1] for c in cols]), dtype=torch.int32,
                                 device=device),
        pt_pos_w=T(np.stack([c[2] for c in cols])),
        pt_valid=torch.as_tensor(np.stack([c[3] for c in cols]), device=device),
        seg_line=torch.stack([c[4] for c in cols]),
        seg_level=torch.as_tensor(np.stack([c[5] for c in cols]),
                                  dtype=torch.int32, device=device),
        seg_spos_w=T(np.stack([c[6] for c in cols])),
        seg_epos_w=T(np.stack([c[7] for c in cols])),
        seg_valid=torch.as_tensor(np.stack([c[8] for c in cols]), device=device))
    return ((inp, T(np.stack(R0s)), T(np.stack(t0s)), f),
            dict(n_iter=10, n_iter_ref=3, reproj_thresh=2.0))


# (batch, kinds of sequence): one sequence, the batch of eight with
# sequences that stop apart (no valid row, a NaN first step), points only,
# lines only
_POSE_CASES = {"batch1": dict(B=1),
               "batch8": dict(B=8, kinds=(None, "empty", "points", "lines",
                                          "nan", None, None, None)),
               "points_only": dict(B=2, kinds=("points", "points")),
               "lines_only": dict(B=2, kinds=("lines", "lines"))}


@pytest.mark.cuda
@pytest.mark.parametrize("n_iter_ref", [0, 3])
@pytest.mark.parametrize("case", list(_POSE_CASES))
def test_pose_opt_kernel_matches_plain(cuda, case, n_iter_ref):
    """K4 against the plain twin on the same card inputs, held as
    chip_smoke.py's gate holds it: the MAD scales and the observation
    counts equal within rounding, each pass's iterations and the first
    pass's strip equal but where the two sides part at a decision within
    rounding (a chi2 tie, reported as a warning; a row at the threshold),
    every pose at the plain twin's robust cost and its inlier masks the
    strip at its own pose but for rows within 1e-6 of the threshold, chi2
    and the information matrices within rounding where the two sides did
    not part; and, on these synthetic frames, the poses of the sequences
    whose iterations did not part within 1e-5.
    Two launches give the same bits; an unbatched call dispatches to the
    kernel."""
    args, kw = _pose_problem(cuda, **_POSE_CASES[case])
    kw["n_iter_ref"] = n_iter_ref
    first = chip_smoke.k4_first_pass(args, kw)
    before = tpo.launches
    out_k, iters_k, trace = tpo.optimize_pose_cuda(*args, **kw)
    assert tpo.launches == before + 1
    out_p = tpo.optimize_pose_plain(*args, **kw)
    iters_p = chip_smoke.pose_plain_iters(args, kw)
    problem, rot, terr, partings, forgiven = chip_smoke.k4_compare(
        args, kw, out_k, iters_k, trace, out_p, iters_p, first)
    assert problem is None, problem
    for b, ps, nk, np_, step in partings:
        warnings.warn(f"{case}: sequence {b} pass {ps} ran {nk} iterations on "
                      f"the card, {np_} in the plain twin (relative chi2 step "
                      f"{step:.2e})")
    # where the iterations did not part, the poses agree within 1e-5
    same = [b for b in range(iters_p.shape[0])
            if b not in {q[0] for q in partings}]
    if same:
        assert float((out_k.R - out_p.R)[same].abs().max()) <= chip_smoke.K4_ROT_ATOL
        assert float((out_k.t - out_p.t)[same].abs().max()) <= chip_smoke.K4_T_ATOL
    assert int(iters_p[:, 0].min()) >= 1
    assert (int(iters_p[:, 1].min()) >= 1) == (n_iter_ref > 0)
    # the outliers are stripped
    n_in = out_p.pt_inlier.sum(-1) + out_p.seg_inlier.sum(-1)
    n_obs = out_p.n_obs_pt + out_p.n_obs_seg
    assert bool((n_in < n_obs)[n_obs > 20].all())
    again, it2, tr2 = tpo.optimize_pose_cuda(*args, **kw)
    for x, y in zip(out_k + (iters_k,), again + (it2,)):
        assert torch.equal(x, y) if x.dtype != torch.float32 else \
            torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0))
    if case == "batch1":
        inp, R0, t0, focal = args
        one = tpo.optimize_pose(tpo.PoseOptInputs(*[a[0] for a in inp]),
                                R0[0], t0[0], focal, **kw)
        assert tpo.launches == before + 3
        for x, y in zip(one, out_k):
            assert torch.equal(x, y[0])


@pytest.mark.cuda
def test_detect_segments_card_matches_cpu(cuda):
    """The keyframe line detector on the card against the same code on the
    CPU (scatter-add votes, stable sorts) on frame 0 of the bench scene."""
    img = _bench_frame(cuda)
    kw = dict(n_peaks=64, run_gap_px=3.0, dist_tol=1.2)
    k = tl.detect_segments_tiled(img, **kw)
    p = tl.detect_segments_tiled(img.cpu(), **kw)
    v = p.valid
    assert torch.equal(k.valid.cpu(), v) and int(v.sum()) >= 50
    assert torch.equal(k.response.cpu(), p.response)
    for name in ("sp", "ep"):
        assert float((getattr(k, name).cpu() - getattr(p, name))[v].abs().max()) < 1e-2


def _golden_run(device, lines):
    """The golden 320x240 sequence of tests/test_pipeline.py rendered by the
    port: points only without local BA (tests/test_torch_pipeline.py's
    config), or `fast_config()` unmodified with lines and local BA
    (tests/test_torch_pipeline_lines.py's)."""
    cam = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
    scene = synthetic.make_scene(np.random.default_rng(7), size=1024,
                                 texel_size=0.004)
    cfg = fast_config()
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, has_ls=lines, init_ls=lines, loba_enabled=lines))
    vo = tfh.FrameHandlerMono(cam, cfg, device=device)
    res, gt = [], []
    for i in range(28):
        ang = 0.003 * i
        R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0], np.float32)
        res.append(vo.add_image(synthetic.render_aa(scene, cam, R, t,
                                                    device=device), i / 30.0))
        gt.append(t)
    stages = [r.stage for r in res]
    fd = stages.index(tfh.STAGE_DEFAULT)
    assert all(s == tfh.STAGE_DEFAULT for s in stages[fd:]), stages
    est = np.stack([-r.R_f_w.T @ r.t_f_w for r in res[fd:]]).astype(np.float64)
    return vo, res, trajectory.ate_rmse(
        est, np.stack(gt[fd:]).astype(np.float64), with_scale=True)


@pytest.mark.cuda
def test_slice_tracks_on_the_card(cuda):
    """The points-only sync slice on the card: the bound of the CPU run of
    tests/test_torch_pipeline.py."""
    k1, k2, k3 = tfs.launches, tma.launches, tsa.launches
    _, _, ate = _golden_run(cuda, lines=False)
    assert tfs.launches > k1 and tma.launches > k2 and tsa.launches > k3
    assert ate < 0.002, ate


@pytest.mark.cuda
def test_lines_slice_tracks_on_the_card(cuda):
    """Points + lines + local BA on the card: the golden bound of the CPU
    run of tests/test_torch_pipeline_lines.py, and line landmarks made."""
    vo, res, ate = _golden_run(cuda, lines=True)
    assert ate < 0.006, ate
    assert (vo._lnseed_install_frame >= 0).any()
    assert int((vo.map.ln_status > 0).sum()) > 0
    assert max(r.n_seg_matches for r in res) > 0
