"""The motion-only pose optimisation's dispatch, its iteration counts and
its card gate, on the CPU.

- `optimize_pose` sends CPU tensors to the plain twin and any other tensor
  to the CUDA kernel's wrapper, which refuses CPU tensors;
- in a batch whose sequences stop at different iterations, each sequence
  gets the result it gets alone (its carry frozen once it stops);
- the `pose_iters` counter of a launch's per-sequence iterations, given
  to the monitor as a tensor, resolves to the plain loop's count;
- chip_smoke.py's K4 gate (`k4_compare`) passes the plain twin against
  itself and a parting at a chi2 rounding tie, and fails planted faults.

The "kernel" results of the gate tests are the plain twin's own, edited or
computed with the fault, so nothing here needs a card."""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from plsvo_torch import lie
from plsvo_torch.ops import pose_opt as tpo
from plsvo_torch.utils import profiling

from test_torch_kernels import _pose_problem

torch.set_num_threads(1)

# two sound sequences and one with no valid row (it stops at the first
# iteration, by the zero step)
KINDS = (None, "empty", None)


@pytest.fixture(scope="module")
def problem():
    """Three sequences of the card parity test's problem on the CPU, the
    plain twin's result, each sequence's iterations per pass, a trace of
    constant chi2 (a rounding tie wherever two sides part) and the first
    pass's result."""
    args, kw = _pose_problem("cpu", B=3, kinds=KINDS, seed=1)
    res = tpo.optimize_pose_plain(*args, **kw)
    iters = chip_smoke.pose_plain_iters(args, kw)
    trace = torch.ones((3, 2, max(kw["n_iter"], kw["n_iter_ref"])))
    first = tpo.optimize_pose_plain(*args, **dict(kw, n_iter_ref=0))
    return args, kw, res, iters, trace, first


def test_dispatch_sends_cpu_tensors_to_the_plain_twin(problem, monkeypatch):
    args, kw, res, iters, trace, first = problem
    calls = []

    def spy(name, out):
        def f(*a, **k):
            calls.append((name, a[0].pt_f.device.type))
            return out
        return f

    monkeypatch.setattr(tpo, "optimize_pose_plain", spy("plain", res))
    monkeypatch.setattr(tpo, "optimize_pose_cuda",
                        spy("cuda", (res, iters, trace)))
    assert tpo.optimize_pose(*args, **kw) is res
    # a tensor on any other device goes to the kernel's wrapper
    meta = (tpo.PoseOptInputs(*[a.to("meta") for a in args[0]]), *args[1:])
    assert tpo.optimize_pose(*meta, **kw) is res
    assert calls == [("plain", "cpu"), ("cuda", "meta")]


def test_kernel_wrapper_refuses_cpu_tensors(problem):
    args, kw = problem[:2]
    before = tpo.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tpo.optimize_pose_cuda(*args, **kw)
    assert tpo.launches == before


def _close(a, b, atol=1e-5):
    a, b = a.double(), b.double()
    return bool((((a - b).abs() <= atol) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("n_iter_ref", [0, 3])
def test_sequences_that_stop_apart_get_their_own_results(n_iter_ref):
    """A batch whose sequences stop at different iterations (among them
    one with no valid row and one whose first step is NaN) gives each
    sequence what it gets alone, for both passes."""
    args, kw = _pose_problem("cpu", B=4, kinds=(None, "empty", None, "nan"),
                             seed=2)
    kw["n_iter_ref"] = n_iter_ref
    inp, R0, t0, focal = args
    iters = chip_smoke.pose_plain_iters(args, kw)
    assert len(set(iters[:, 0].tolist())) > 1
    assert iters[1, 0] == 1 and iters[3, 0] == 1
    assert bool((iters[:, 1] >= 1).all()) == (n_iter_ref > 0)
    rb = tpo.optimize_pose(*args, **kw)
    for b in range(4):
        rs = tpo.optimize_pose(tpo.PoseOptInputs(*[a[b] for a in inp]),
                               R0[b], t0[b], focal, **kw)
        for name in ("R", "t", "scale_pt", "scale_seg", "chi2"):
            assert _close(getattr(rb, name)[b], getattr(rs, name)), name
        for name in ("pt_inlier", "seg_inlier", "n_obs_pt", "n_obs_seg"):
            assert torch.equal(getattr(rb, name)[b], getattr(rs, name)), name
    # the NaN step rolls back to the initial pose; no valid row: no move
    assert torch.equal(rb.R[3], R0[3]) and torch.equal(rb.R[1], R0[1])


@pytest.mark.parametrize("B", [1, 3])
def test_iteration_counter_from_a_tensor_matches_the_plain_count(B):
    """`count_iterations` of the per-sequence counts (a tensor, as the
    kernel returns them) resolves at the frame's end to the count that the
    plain loop gives the monitor for the same batch."""
    args, kw = _pose_problem("cpu", B=3, kinds=KINDS, seed=1)
    inp, R0, t0, focal = args
    if B == 1:
        args = (tpo.PoseOptInputs(*[a[:1] for a in inp]), R0[:1], t0[:1],
                focal)
    mon = profiling.PerformanceMonitor()
    with mon.installed():
        tpo.optimize_pose(*args, **kw)
    plain = mon.counts["pose_iters"]
    iters = chip_smoke.pose_plain_iters(args, kw)
    assert plain == int(iters.amax(0).sum())
    mon = profiling.PerformanceMonitor()
    mon.new_frame(0)
    with mon.installed():
        tpo.count_iterations(iters)
    assert mon.counts == {}  # the tensor is not read inside the frame
    mon.finish()
    assert mon.frames == [{"frame": 0, "n_pose_iters": plain}]


def _edited(res, **kw):
    return res._replace(**kw)


def test_k4_gate_passes_the_plain_twin_against_itself(problem):
    args, kw, res, iters, trace, first = problem
    assert chip_smoke.k4_compare(args, kw, res, iters, trace, res, iters,
                                 (first, first)) == (None, 0.0, 0.0, [], 0)


def test_k4_gate_passes_a_parting_at_a_rounding_tie(problem):
    """A sequence runs one iteration more in its first pass: allowed where
    the chi2 step at the parting lies within K4_CHI2_TIE, and reported."""
    args, kw, res, iters, trace, first = problem
    it = iters.clone()
    it[0, 0] += 1
    tr = trace.clone()
    p = int(iters[0, 0])
    tr[0, 0, p - 1] = 1.0 + 0.5 * chip_smoke.K4_CHI2_TIE
    problem_, rot, t, partings, _ = chip_smoke.k4_compare(
        args, kw, res, it, tr, res, iters, (first, first))
    assert problem_ is None and rot == t == 0.0
    assert [q[:4] for q in partings] == [(0, 0, p + 1, p)]


@pytest.mark.parametrize("fault", ["unfrozen_carry", "strip_skipped",
                                   "wrong_mad_scale", "refinement_dropped",
                                   "first_strip", "chi2_step", "rotation",
                                   "translation", "parted_off_cost",
                                   "n_obs_pt", "non_finite"])
def test_k4_gate_fails_planted_faults(problem, fault):
    args, kw, res, iters, trace, first = problem
    inp, R0, t0, focal = args
    k, it, tr, k1 = res, iters, trace, first
    if fault == "unfrozen_carry":
        # every sequence reports the slowest one's iterations: the sequence
        # with no valid row stopped at its first
        assert int(iters[1, 0]) == 1 < int(iters[:, 0].max())
        it = iters.amax(0).expand(3, 2).clone()
    elif fault == "strip_skipped":
        assert bool((inp.pt_valid & ~res.pt_inlier).any())
        k = _edited(res, pt_inlier=inp.pt_valid.clone(),
                    seg_inlier=inp.seg_valid.clone())
    elif fault == "wrong_mad_scale":
        # the scale taken at the final pose, not the initial one
        _, e_pt, _ = tpo._pt_errors(res.R, res.t, inp)
        wrong = tpo.mad_scale(torch.linalg.norm(e_pt, dim=-1), inp.pt_valid)
        assert bool((wrong != res.scale_pt).any())
        k = _edited(res, scale_pt=wrong)
    elif fault == "refinement_dropped":
        kw0 = dict(kw, n_iter_ref=0)
        k = tpo.optimize_pose_plain(*args, **kw0)
        it = chip_smoke.pose_plain_iters(args, kw0)
    elif fault == "first_strip":
        # the refinement started from a first strip that kept an outlier
        out = inp.pt_valid & ~first.pt_inlier
        assert bool(out[0].any())
        row = int(out[0].nonzero()[0])
        mask = first.pt_inlier.clone()
        mask[0, row] = True
        k1 = _edited(first, pt_inlier=mask)
    elif fault == "chi2_step":  # parting where chi2 moved 1%: not rounding
        it = iters.clone()
        it[2, 0] += 1
        p = int(iters[2, 0])
        tr = trace.clone()
        tr[2, 0, p - 1] = 1.01
    elif fault == "rotation":  # off the cost's minimum
        dR, _ = lie.se3_exp(torch.tensor([0.0, 0.0, 0.0, 5e-4, 0.0, 0.0]))
        k = _edited(res, R=res.R @ dR)
    elif fault == "translation":  # past the pose bound
        k = _edited(res, t=res.t + torch.tensor([0.0, 2e-3, 0.0]))
    elif fault == "parted_off_cost":
        # a parting at a tie, and a pose within the parted limit but off
        # the cost's valley
        it = iters.clone()
        it[0, 0] += 1
        dR, _ = lie.se3_exp(torch.tensor([0.0, 0.0, 0.0, 5e-4, 0.0, 0.0]))
        k = _edited(res, R=res.R @ dR)
    elif fault == "n_obs_pt":
        k = _edited(res, n_obs_pt=res.n_obs_pt + 1)
    else:
        R = res.R.clone()
        R[0, 0, 0] = math.nan
        k = _edited(res, R=R)
    problem_, rot, _, _, _ = chip_smoke.k4_compare(args, kw, k, it, tr, res,
                                                   iters, (k1, first))
    assert problem_ is not None, fault
    if fault == "rotation":
        assert abs(rot - 5e-4) < 1e-6


def test_k4_capture_keeps_one_in_every(problem):
    args, kw = problem[:2]
    kept = []
    hook = chip_smoke.k4_capture_hook(kept, "lines", every=3)
    for _ in range(7):
        hook(args, kw)
    assert len(kept) == 3 and all(run == "lines" for _, _, run in kept)
    a, k, _ = kept[0]
    assert k == kw and a[3] == args[3]
    assert torch.equal(a[0].pt_f, args[0].pt_f) and a[0].pt_f is not args[0].pt_f
    assert np.isclose(float(a[1].sum()), float(args[1].sum()))
