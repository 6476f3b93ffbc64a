"""The K2 gate of chip_smoke.py (`k2_compare`) on the CPU: the plain twin
passes against itself, one row stopping one update apart at the
convergence threshold passes, and planted faults fail it: every row
returning one update late or early, one such row away from the threshold,
a row returning its starting guess, and a wrong threshold.

The "kernel" results here are the plain twin's own, run or edited, so the
test needs no card. The inputs are tests/test_torch_kernels.py's mixed
problem (N = 256, ~30% 1-D rows, ~10% invalid)."""
import numpy as np
import pytest
import torch

import chip_smoke
from plsvo_torch import image as ti
from plsvo_torch.ops import feature_align as tfa
from plsvo_torch.ops import mixed_align as tma


def _k2_args(N=256, H=120, W=160):
    """The 13 inputs and the keywords of the K2 call of align_mixed_atlas
    on a smoothed noise image."""
    gen = np.random.default_rng(0)
    img = np.clip(gen.normal(128, 40, (H, W)), 0, 255).astype(np.float32)
    p = np.pad(img, 1)
    img = sum(p[i:i + H, j:j + W] for i in range(3) for j in range(3)) / 9.0
    img = torch.as_tensor(img.astype(np.float32))
    atlas, x_off, sizes = ti.pack_pyramid_atlas([img, img[::2, ::2]])
    B = 10
    uv_true = np.stack([gen.uniform(12, W - 12, N),
                        gen.uniform(12, H - 12, N)], -1).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(B) - B / 2 + 0.5, np.arange(B) - B / 2 + 0.5,
                         indexing="ij")
    pos = uv_true[:, None, :] + np.stack([xx.ravel(), yy.ravel()], -1)[None]
    patch, _ = ti.bilinear_sample(img, torch.as_tensor(pos.astype(np.float32)))
    ref, dx, dy = tfa.ref_patch_gradients(patch, 8)
    uv0 = (uv_true + gen.uniform(-2, 2, (N, 2))).astype(np.float32)
    d = gen.normal(size=(N, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    captured = []
    real = tma.mixed_align

    def capture(*a, **k):
        captured.append((a, k))
        return real(*a, **k)

    tma.mixed_align = capture
    try:
        tfa.align_mixed_atlas(
            atlas, x_off, sizes, ref, dx, dy, torch.as_tensor(uv0),
            torch.as_tensor(d), torch.as_tensor(gen.random(N) < 0.3),
            torch.zeros(N, dtype=torch.long),
            torch.as_tensor(gen.random(N) < 0.9), patch_size=8, n_iter=10)
    finally:
        tma.mixed_align = real
    (args, kw), = captured
    return args, kw


@pytest.fixture(scope="module")
def problem():
    args, kw = _k2_args()
    out = tma.mixed_align_plain(*args, **kw)
    assert int(out[1].sum()) >= 64  # enough converged rows to plant on
    return args, kw, out, chip_smoke.k2_iterates(args, kw)


def test_k2_gate_passes_the_plain_twin(problem):
    args, kw, out, _ = problem
    res = tma.mixed_align_plain(*args, **kw)
    assert chip_smoke.k2_compare(args, kw, res, out) == (None, 0.0, 0.0, [])


def _at(out, rows, uv_t, md_t, s):
    """out with rows replaced by their plain iterates at updates s[rows]."""
    uv, conv, md = (t.clone() for t in out)
    uv[rows] = uv_t[s[rows], rows]
    md[rows] = md_t[s[rows], rows]
    return uv, conv, md


@pytest.mark.parametrize("fault", ["late_all", "early_all", "late_one_far",
                                   "early_one_far", "start", "eps_high",
                                   "eps_low"])
def test_k2_gate_fails_planted_faults(problem, fault):
    args, kw, out, (uv_t, md_t, stop) = problem
    steps = torch.linalg.norm(uv_t[1:] - uv_t[:-1], dim=-1)
    conv = out[1]
    rows = torch.arange(conv.shape[0])
    eps = kw["conv_eps"]
    if fault in ("eps_high", "eps_low"):
        bad = tma.mixed_align_plain(*args, **dict(
            kw, conv_eps=eps * (1.5 if fault == "eps_high" else 0.5)))
    elif fault == "start":
        # a converged row that moved: it returns its starting guess
        r = int(rows[conv & (steps[0] > 0.1)][0])
        bad = tuple(t.clone() for t in out)
        bad[0][r] = args[10][r]
        bad[2][r] = 0.0
    else:
        late = fault.startswith("late")
        s = stop + 1 if late else stop - 1
        ok = conv & (s >= 1) & (s <= kw["n_iter"])
        # the update at which the sides part, and the row moved by more
        # than the gate's atol between the two iterates
        part = steps[torch.minimum(stop, s).clamp_min(1) - 1, rows]
        moved = (uv_t[s.clamp(0, kw["n_iter"]), rows]
                 - uv_t[stop, rows]).abs().amax(-1) > 2 * chip_smoke.K2_UV_ATOL
        sel = rows[ok & moved]
        if fault.endswith("one_far"):
            sel = rows[ok & moved & ((part - eps).abs() > 0.01)][:1]
        assert len(sel) >= 1
        bad = _at(out, sel, uv_t, md_t, s)
    problem_msg = chip_smoke.k2_compare(args, kw, bad, out)[0]
    assert problem_msg is not None, fault


def test_k2_gate_accepts_one_row_at_the_threshold(problem):
    """A row whose step at update S lies just below conv_eps stops there in
    the plain twin; a kernel that rounds the step just above conv_eps
    stops at S + 1. With conv_eps set at that row's step, the kernel's
    result for it (the plain iterate S + 1) passes; it fails when no row
    may stop apart."""
    args, kw, out, (uv_t, md_t, _) = problem
    steps = torch.linalg.norm(uv_t[1:] - uv_t[:-1], dim=-1)
    n_iter = kw["n_iter"]
    found = None
    for r in torch.nonzero(out[1])[:, 0].tolist():
        st = steps[:, r]
        for S in range(1, n_iter):
            a, b = float(st[S - 1]), float(st[S])
            if (b > 2 * chip_smoke.K2_UV_ATOL and a > b + 1e-3
                    and bool((st[:S - 1] > a + 1e-4).all())):
                found = (r, S, a)
                break
        if found:
            break
    assert found is not None
    r, S, a = found
    kw_t = dict(kw, conv_eps=a + 1e-5)
    out_p = tma.mixed_align_plain(*args, **kw_t)
    uv_tt, md_tt, stop_t = chip_smoke.k2_iterates(args, kw_t)
    assert int(stop_t[r]) == S and bool(out_p[1][r])
    out_k = _at(out_p, torch.tensor([r]), uv_tt, md_tt,
                torch.full_like(stop_t, S + 1))
    problem_msg, uv_err, _, apart = chip_smoke.k2_compare(args, kw_t, out_k, out_p)
    assert problem_msg is None
    assert [(x[0], x[1], x[2]) for x in apart] == [(r, S, S + 1)]
    assert abs(apart[0][3] - kw_t["conv_eps"]) < 1e-4
    assert uv_err > chip_smoke.K2_UV_ATOL
    assert chip_smoke.k2_compare(args, kw_t, out_k, out_p,
                                 apart_max=0)[0] is not None
