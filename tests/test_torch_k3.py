"""The sparse image alignment's dispatch, its iteration counts and its card
gate, on the CPU.

- `sparse_img_align` sends CPU tensors to the plain twin and any other
  tensor to the CUDA kernel's wrapper, which refuses CPU tensors;
- the plain twin's per-level iterations (`AlignResult.iters`) are each
  sequence's own, and the `align_iters` counter sums the slowest
  sequence's;
- a count given to the monitor as a tensor reaches the frame's record
  as the same int, once its copy has landed;
- chip_smoke.py's K3 gate (`k3_compare`) passes the plain twin against
  itself and a parting at a chi2 rounding tie, and fails planted faults.

The "kernel" results of the gate tests are the plain twin's own, edited,
so nothing here needs a card."""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from plsvo_torch import lie
from plsvo_torch.ops import sparse_align as tsa
from plsvo_torch.utils import profiling

from test_torch_kernels import _align_problem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    """Two sequences of the card parity test's bench-plane problem, on the
    CPU, and the plain twin's result and a trace of its chi2 (constant: a
    rounding tie wherever two sides part)."""
    args, kw = _align_problem("cpu", B=2)
    res = tsa.sparse_img_align_plain(*args, **kw)
    trace = torch.ones(res.iters.shape + (kw["n_iter"], 2))
    return args, kw, res, trace


def test_dispatch_sends_cpu_tensors_to_the_plain_twin(problem, monkeypatch):
    args, kw, res, _ = problem
    calls = []

    def spy(name, out):
        def f(*a, **k):
            calls.append((name, a[2].xyz_ref.device.type))
            return out
        return f

    monkeypatch.setattr(tsa, "sparse_img_align_plain", spy("plain", res))
    monkeypatch.setattr(tsa, "sparse_img_align_cuda", spy("cuda", (res, None)))
    assert tsa.sparse_img_align(*args, **kw) is res
    # a tensor on any other device goes to the kernel's wrapper
    meta = (args[0], args[1], tsa.AlignPoints(*[a.to("meta") for a in args[2]]),
            *args[3:])
    assert tsa.sparse_img_align(*meta, **kw) is res
    assert calls == [("plain", "cpu"), ("cuda", "meta")]


def test_kernel_wrapper_refuses_cpu_tensors(problem):
    args, kw, _, _ = problem
    before = tsa.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsa.sparse_img_align_cuda(*args, **kw)
    assert tsa.launches == before


def test_plain_iterations_match_the_counter(problem):
    """`AlignResult.iters` holds each sequence's iterations per level; the
    counter sums the slowest sequence's over the levels, for a batch and
    for one sequence alone; one allowed iteration runs one on each level."""
    args, kw, res, _ = problem
    assert res.iters.dtype == torch.int32 and res.iters.shape == (2, 3)
    assert 1 <= int(res.iters.min()) and int(res.iters.max()) <= kw["n_iter"]
    mon = profiling.PerformanceMonitor()
    with mon.installed():
        again = tsa.sparse_img_align(*args, **kw)
    assert torch.equal(again.iters, res.iters)
    assert mon.counts == {"align_iters": int(res.iters.amax(0).sum())}
    one_args = ([p[1] for p in args[0]], [p[1] for p in args[1]],
                tsa.AlignPoints(*[a[1] for a in args[2]]),
                tsa.AlignSegments(*[a[1] for a in args[3]]), args[4][1],
                args[5][1], *args[6:])
    mon = profiling.PerformanceMonitor()
    with mon.installed():
        one = tsa.sparse_img_align(*one_args, **kw)
    assert one.iters.shape == (3,)
    assert mon.counts == {"align_iters": int(one.iters.sum())}
    assert tsa.sparse_img_align(
        *one_args, **dict(kw, n_iter=1)).iters.tolist() == [1, 1, 1]


def test_tensor_counts_resolve_to_the_same_int_at_the_frames_end():
    mon = profiling.PerformanceMonitor()
    mon.new_frame(0)
    with mon.installed():
        profiling.count("c", 2)
        profiling.count("c", torch.tensor([3, 4], dtype=torch.int32))
    assert mon.counts == {"c": 2}  # the tensor is not read inside the frame
    mon.new_frame(1)
    with mon.installed():
        profiling.count("c", torch.tensor(5))
    mon.finish()
    assert [(r["frame"], r["n_c"]) for r in mon.frames] == [(0, 9), (1, 5)]


class _Event:
    """A copy's event that has landed once `ready[0]` is set."""

    def __init__(self):
        self.ready = [False]
        self.waited = False

    def query(self):
        return self.ready[0]

    def synchronize(self):
        self.waited = True


def test_a_count_waits_for_its_copy_but_not_the_frame(monkeypatch):
    """A card count's record gets its value at the first new_frame after
    its copy has landed, never by waiting there; finish waits for the
    rest."""
    events = []

    def host_copy(t):
        events.append(_Event())
        return t.clone(), events[-1]

    monkeypatch.setattr(profiling, "_host_copy", host_copy)
    mon = profiling.PerformanceMonitor()
    mon.new_frame(0)
    with mon.installed():
        profiling.count("it", torch.tensor([6, 3, 9]))
    mon.new_frame(1)  # the copy has not landed: the record waits
    assert mon.frames == [{"frame": 0}] and not events[0].waited
    with mon.installed():
        profiling.count("it", torch.tensor([4, 4]))
    events[0].ready[0] = True
    mon.new_frame(2)  # frame 0's copy has landed, frame 1's not
    assert mon.frames == [{"frame": 0, "n_it": 18}, {"frame": 1}]
    assert not (events[0].waited or events[1].waited)
    mon.finish()  # waits
    assert mon.frames[1] == {"frame": 1, "n_it": 8} and events[1].waited


def _edited(res, **kw):
    return res._replace(**{k: v for k, v in kw.items()})


def test_k3_gate_passes_the_plain_twin_against_itself(problem):
    _, _, res, trace = problem
    assert chip_smoke.k3_compare(res, trace, res) == (None, 0.0, 0.0, [])


def test_k3_gate_passes_a_parting_at_a_rounding_tie(problem):
    """One sequence runs one iteration more on a level: allowed where the
    chi2 step at the parting lies within K3_CHI2_TIE, and reported once
    (the later levels start from the parted poses)."""
    _, _, res, trace = problem
    it = res.iters.clone()
    it[0, 0] += 1
    it[0, 2] += 2
    tr = trace.clone()
    p = int(res.iters[0, 0])
    tr[0, 0, p - 1, 0] = 1.0 + 0.5 * chip_smoke.K3_CHI2_TIE
    problem_, rot, t, partings = chip_smoke.k3_compare(
        _edited(res, iters=it), tr, res)
    assert problem_ is None and rot == t == 0.0
    assert [q[:4] for q in partings] == [(0, 0, p + 1, p)]


@pytest.mark.parametrize("fault", ["chi2_step", "first_iteration", "rotation",
                                   "translation", "seg_alive", "n_tracked_pts",
                                   "non_finite"])
def test_k3_gate_fails_planted_faults(problem, fault):
    _, _, res, trace = problem
    tr, k = trace.clone(), res
    if fault == "chi2_step":  # parting where chi2 moved 1%: not rounding
        it = res.iters.clone()
        it[1, 1] -= 1
        p = int(it[1, 1])
        tr[1, 1, p - 1, 0] = 1.01
        k = _edited(res, iters=it)
    elif fault == "first_iteration":  # no chi2 test at the first iteration
        it = res.iters.clone()
        it[0, 2] = 1 if int(res.iters[0, 2]) > 1 else 2
        k = _edited(res, iters=it)
    elif fault == "rotation":
        dR, _ = lie.se3_exp(torch.tensor([0.0, 0.0, 0.0, 0.0, 2e-4, 0.0]))
        k = _edited(res, R=res.R @ dR)
    elif fault == "translation":
        k = _edited(res, t=res.t + torch.tensor([0.0, 2e-4, 0.0]))
    elif fault == "seg_alive":
        a = res.seg_alive.clone()
        a[1, 3] = ~a[1, 3]
        k = _edited(res, seg_alive=a)
    elif fault == "n_tracked_pts":
        k = _edited(res, n_tracked_pts=res.n_tracked_pts + 1)
    else:
        R = res.R.clone()
        R[0, 0, 0] = math.nan
        k = _edited(res, R=R)
    problem_, rot, t, _ = chip_smoke.k3_compare(k, tr, res)
    assert problem_ is not None, fault
    if fault == "rotation":
        assert abs(rot - 2e-4) < 1e-6


def test_k3_capture_keeps_one_in_every_and_the_levels_read(problem):
    args, kw, _, _ = problem
    kept = []
    hook = chip_smoke.k3_capture_hook(kept, "lines", every=3)
    for _ in range(7):
        hook(args, kw)
    assert len(kept) == 3 and all(run == "lines" for _, _, run in kept)
    a, k, _ = kept[0]
    assert k == kw
    assert [p is None for p in a[0]] == [True, True, False, False, False]
    assert torch.equal(a[0][4], args[0][4]) and a[0][4] is not args[0][4]
    assert torch.equal(a[2].xyz_ref, args[2].xyz_ref)
    assert np.isclose(a[6], args[6])
