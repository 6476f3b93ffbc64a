"""The port's landmark-sharded BA (plsvo_torch.parallel.ba.
bundle_adjust_sharded) on an 8-shard CPU mesh against the JAX package's
bundle_adjust and bundle_adjust_sharded on its 8 virtual CPU devices
(tests/conftest.py), with tests/test_ba.py's bars: one iteration within
kf_t 5e-4 and lm_pos 5e-3 (different reduction orders; landmark
back-substitution amplifies them along the weak depth direction), eight
iterations to chi2 < 0.2 chi2_0, the same n_obs and chi2 < 2x the single
device's. tests/test_ba_scale.py's quality bars hold single, sharded and
hierarchical solves at a reduced make_big_problem (K=24, L=8192; all
three at the full K=96, L=50176 run on the card in chip_smoke.py), and
the single solver at the full size, where it solves in f64."""
import jax
import numpy as np
import pytest
import torch

from plsvo_torch.parallel import ba as tba
from plsvo_torch.parallel import distributed as tdist
from plsvo_torch.parallel.mesh import Mesh, Shards
from plsvo_tpu.parallel import ba as jba

from test_ba import make_line_problem, make_problem
from test_ba_scale import make_big_problem

torch.set_num_threads(1)


def np_problem(prob):
    return tba.BAProblem(*[None if a is None else np.asarray(a) for a in prob])


def cpu_mesh(n=8, axis="ba"):
    return Mesh(["cpu"] * n, (axis,))


def jax_mesh(n=8, axis="ba"):
    devices = jax.devices()
    assert len(devices) >= n, "conftest must provide 8 virtual devices"
    return jax.sharding.Mesh(np.asarray(devices[:n]), (axis,))


def close(t, j, atol, name):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("kind", ["points", "lines"])
def test_one_iteration_matches_jax(kind):
    rng = np.random.default_rng(0)
    prob = (make_problem(rng, L=64)[0] if kind == "points"
            else make_line_problem(rng, S=24)[0])  # 64 / 48 rows over 8
    out_t, st_t = tba.bundle_adjust_sharded(np_problem(prob), cpu_mesh(),
                                            "ba", n_iter=1)
    for ref, _ in (jba.bundle_adjust(prob, n_iter=1),
                   jba.bundle_adjust_sharded(prob, jax_mesh(), "ba",
                                             n_iter=1)):
        close(out_t.kf_t, ref.kf_t, 5e-4, "kf_t")
        close(out_t.lm_pos, ref.lm_pos, 5e-3, "lm_pos")
    assert out_t.lm_pos.shape == prob.lm_pos.shape


def test_eight_iterations_converge_like_jax(rng):
    prob, _ = make_problem(rng, L=64)
    chi2_0 = float(jba._assemble_shard(prob, 1.0 / 250.0, 1e-8)[5])
    _, st_t = tba.bundle_adjust_sharded(np_problem(prob), cpu_mesh(), "ba",
                                        n_iter=8)
    _, st_1 = jba.bundle_adjust(prob, n_iter=8)
    _, st_s = jba.bundle_adjust_sharded(prob, jax_mesh(), "ba", n_iter=8)
    assert float(st_t.chi2) < 0.2 * chi2_0
    assert int(st_t.n_obs) == int(st_1.n_obs) == int(st_s.n_obs)
    assert float(st_t.chi2) < 2.0 * float(st_1.chi2)


def test_comm_identity_matches_jax(rng):
    """The timing-only variant (each psum a local x * n): JAX's outputs at
    the one-iteration bars, and on one shard the real path exactly."""
    prob, _ = make_problem(rng, L=64)
    npp = np_problem(prob)
    out_t, st_t = tba.bundle_adjust_sharded(npp, cpu_mesh(), "ba", n_iter=1,
                                            comm_identity=True)
    out_j, st_j = jba.bundle_adjust_sharded(prob, jax_mesh(), "ba", n_iter=1,
                                            comm_identity=True)
    close(out_t.kf_t, out_j.kf_t, 5e-4, "kf_t")
    close(out_t.lm_pos, out_j.lm_pos, 5e-3, "lm_pos")
    assert int(st_t.n_obs) == int(st_j.n_obs)
    one = cpu_mesh(1)
    a, sa = tba.bundle_adjust_sharded(npp, one, "ba", n_iter=2,
                                      comm_identity=True)
    b, sb = tba.bundle_adjust_sharded(npp, one, "ba", n_iter=2)
    for x, y in zip(a, b):
        if x is not None:
            assert torch.equal(x, y)
    assert float(sa.chi2) == float(sb.chi2)


def test_sharding_does_not_depend_on_the_device_map(rng):
    """Eight shards on one device, or a problem already split into Shards,
    give what eight shards give; rows must divide over the shards."""
    prob, _ = make_problem(rng, L=64)
    npp = np_problem(prob)
    mesh = cpu_mesh()
    a, _ = tba.bundle_adjust_sharded(npp, mesh, "ba", n_iter=2)
    parts = tba.shard_problem(npp, mesh, "ba")
    assert isinstance(parts, Shards) and len(parts) == 8
    assert all(p.lm_pos.shape == (8, 3) and p.kf_R.shape == (4, 3, 3)
               for p in parts)
    b, _ = tba.bundle_adjust_sharded(parts, mesh, "ba", n_iter=2)
    assert torch.equal(a.lm_pos, b.lm_pos) and torch.equal(a.kf_t, b.kf_t)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        tba.bundle_adjust_sharded(npp, cpu_mesh(6), "ba", n_iter=1)


def test_big_map_single_vs_sharded_vs_hybrid():
    """tests/test_ba_scale.py's bars at K=24, L=8192 (the port's three
    solvers; the JAX package's run the full size in that file)."""
    prob, (Rk, tk, pos) = make_big_problem(np.random.default_rng(0), K=24,
                                           L=8192)
    npp = np_problem(prob)
    tp = tba.problem_to(npp, "cpu")
    _, st_0 = tba.bundle_adjust(tp, n_iter=0)
    chi_init = float(st_0.chi2)
    out_1, st_1 = tba.bundle_adjust(tp, n_iter=3)
    chi0 = float(st_1.chi2)
    out_s, st_s = tba.bundle_adjust_sharded(npp, cpu_mesh(8, "lm"), "lm",
                                            n_iter=3)
    hmesh = tdist.hybrid_mesh(ici_per_host=4, devices=["cpu"] * 8)
    out_h, st_h = tdist.bundle_adjust_multihost(
        tdist.scatter_problem(npp, hmesh), hmesh, n_iter=3)
    err0 = np.linalg.norm(npp.lm_pos - pos, axis=-1)
    for name, out, st in (("single", out_1, st_1), ("sharded", out_s, st_s),
                          ("hybrid", out_h, st_h)):
        assert float(st.chi2) <= 0.3 * chi_init, (name, float(st.chi2))
        perr = np.linalg.norm(out.kf_t.numpy() - tk, axis=-1)
        assert np.max(perr) < 0.06, (name, np.max(perr))
        assert np.median(perr) < 0.01, (name, np.median(perr))
        err = np.linalg.norm(out.lm_pos.numpy() - pos, axis=-1)
        assert np.median(err) < 1.25 * np.median(err0), (name, np.median(err))
    floor = 1e-4 * chi_init
    assert float(st_s.chi2) <= max(chi0 * 1.1, floor) + 1e-9
    assert float(st_h.chi2) <= max(chi0 * 1.1, floor) + 1e-9


def test_map_scale_ba_solves_in_f64():
    """tests/test_ba_scale.py's full problem (K=96, L=50176) solved by the
    port's bundle_adjust at that test's bars. It has more than F64_SLOTS
    observation slots, so it solves in f64: in f32 the rounding of the
    Schur terms swamps its gradient (the port in f32 missed the landmark
    bar: tests/ba_scale_precision.py). A local BA window stays below the
    limit."""
    prob, (Rk, tk, pos) = make_big_problem(np.random.default_rng(0))
    npp = np_problem(prob)
    assert npp.obs_valid.size > tba.F64_SLOTS >= 2048 * 8
    tp = tba.problem_to(npp, "cpu")
    chi_init = float(tba.bundle_adjust(tp, n_iter=0)[1].chi2)
    out, st = tba.bundle_adjust(tp, n_iter=3)
    assert out.lm_pos.dtype == torch.float32
    assert float(st.chi2) <= 0.3 * chi_init
    perr = np.linalg.norm(out.kf_t.numpy() - tk, axis=-1)
    assert np.max(perr) < 0.06 and np.median(perr) < 0.01
    err0 = np.linalg.norm(npp.lm_pos - pos, axis=-1)
    err = np.linalg.norm(out.lm_pos.numpy() - pos, axis=-1)
    assert np.median(err) < 1.25 * np.median(err0)
