"""The port's local BA (plsvo_torch.parallel.ba) against the JAX package's
(plsvo_tpu.parallel.ba) on the CPU: identical numpy problems from
tests/test_ba.py (points, K=4, L=64, O=6; line endpoints, S=24) go through
the Schur assembly, the chunked assembly, the GN loop with and without the
accept gate, the packed-blob entry, and the window builders and guarded
write-backs on tests/test_local_ba.py's small map."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch import lie as tlie
from plsvo_torch.parallel import ba as tba
from plsvo_tpu import lie as jlie
from plsvo_tpu.parallel import ba as jba
from plsvo_tpu.pipeline.state import ST_DELETED

from test_ba import make_line_problem, make_problem
from test_local_ba import _small_map

torch.set_num_threads(1)

HUBER, LM_DAMP = 1.0 / 250.0, 1e-8


def problems(kind):
    rng = np.random.default_rng(0)
    if kind == "points":
        prob, _ = make_problem(rng, K=4, L=64, O=6)
    else:
        prob, _ = make_line_problem(rng)
    return prob, tba.problem_to(
        tba.BAProblem(*[None if a is None else np.asarray(a) for a in prob]),
        "cpu")


KINDS = ["points", "lines"]


# (rtol, atol) per output. The default is rtol 1e-4, atol 1e-6. Looser,
# with the error measured on these problems beside it:
# - points S: entries near 0 are differences of Schur terms of size ~10,
#   so they carry the f32 rounding of those terms (measured 2.9e-5 abs,
#   max |S| 11.7);
# - lines: a line-endpoint row's 3x3 landmark block is damped only by 1e-4
#   of its trace across the segment and is near-singular, so the f32
#   rounding of the two packages' sums is amplified in its inverse and in
#   the Schur terms built from it (measured: Hpp_inv 5.8e-3 relative, S
#   7.1e-4 abs of max |S| 9.8, b 1.1e-5 abs of max |b| 0.068).
ASSEMBLY_TOL = {
    "points": {"S": (1e-4, 5e-5)},
    "lines": {"S": (1e-4, 1e-3), "b": (1e-4, 2e-5), "Hpp_inv": (1e-2, 1e-6)},
}


@pytest.mark.parametrize("kind", KINDS)
def test_assemble_direct_matches_jax(kind):
    jp, tp = problems(kind)
    j = jba._assemble_shard_direct(jp, HUBER, LM_DAMP)
    t = tba._assemble_shard_direct(tp, HUBER, LM_DAMP)
    for name, a, b in zip(("S", "b", "Hpp_inv", "b_p"), t[:4], j[:4]):
        rtol, atol = ASSEMBLY_TOL[kind].get(name, (1e-4, 1e-6))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(float(t[5]), float(j[5]), rtol=1e-5)
    assert int(t[6]) == int(j[6]) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_assemble_chunked_equals_direct(kind):
    _, tp = problems(kind)
    d = tba._assemble_shard_direct(tp, HUBER, LM_DAMP)
    c = tba._assemble_shard(tp, HUBER, LM_DAMP, chunk=16)
    for name, a, b in zip(("S", "b", "Hpp_inv", "b_p", "W", "chi2"), c, d):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    assert int(c[6]) == int(d[6])


# (n_iter, pose_prior, accept_gate): the gated solve, and the settings the
# pipeline runs at every keyframe (loba_num_iter, loba_pose_prior)
SETTINGS = {"gated": (6, 0.0, True), "pipeline": (3, 1.0, False)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_bundle_adjust_matches_jax(kind, setting):
    n_iter, prior, gate = SETTINGS[setting]
    jp, tp = problems(kind)
    kw = dict(n_iter=n_iter, pose_prior=prior, accept_gate=gate)
    jo, js = jba.bundle_adjust(jp, **kw)
    to, ts = tba.bundle_adjust(tp, **kw)
    np.testing.assert_allclose(to.kf_R.numpy(), np.asarray(jo.kf_R), atol=1e-4)
    np.testing.assert_allclose(to.kf_t.numpy(), np.asarray(jo.kf_t), atol=1e-4)
    lj = np.asarray(jo.lm_pos)
    err = np.linalg.norm(to.lm_pos.numpy() - lj, axis=-1)
    assert (err <= 1e-3 * np.linalg.norm(lj, axis=-1)).all(), err.max()
    np.testing.assert_allclose(float(ts.chi2), float(js.chi2), rtol=1e-3)
    assert int(ts.n_obs) == int(js.n_obs)
    # the solve moved something: the gated run cuts chi2
    c0 = float(tba._assemble_shard(tp, HUBER, LM_DAMP)[5])
    assert float(ts.chi2) < c0


def test_bundle_adjust_blob_equals_bundle_adjust():
    _, tp = problems("lines")
    host = tba.BAProblem(*[tba._host(a) for a in tp])
    blob, spec = tba.problem_blob(host)
    kw = dict(n_iter=3, pose_prior=1.0, accept_gate=False)
    bo, bs = tba.bundle_adjust_blob(torch.as_tensor(blob), spec=spec, **kw)
    do, ds = tba.bundle_adjust(tp, **kw)
    for a, b in zip(bo, do):
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(bs.chi2) == float(ds.chi2)


def test_pose_prior_terms_match_jax_at_identity_slots():
    """The pose prior's batched log/compose/inverse at K=16, with several
    poses at identity (gauge-fixed and empty slots) and others near it."""
    rng = np.random.default_rng(3)
    K = 16
    xi0 = rng.normal(0, 0.05, (K, 6)).astype(np.float32)
    xi0[[0, 5, 9, 15]] = 0.0
    dxi = rng.normal(0, 1e-3, (K, 6)).astype(np.float32)
    dxi[[0, 2, 9]] = 0.0
    dxi[3, 3:] = 1e-6  # a rotation below the small-angle switch
    R0, t0 = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi0)))
    dR, dt = jlie.se3_exp(jnp.asarray(dxi))
    R, t = (np.asarray(a) for a in jlie.compose(dR, dt, jnp.asarray(R0),
                                                 jnp.asarray(t0)))
    fixed = np.zeros(K, bool)
    fixed[[0, 15]] = True
    z = np.zeros((1, 3), np.float32)
    host = dict(lm_pos=z, lm_valid=np.ones(1, bool),
                obs_kf=np.zeros((1, 1), np.int32), obs_f=z[:, None],
                obs_valid=np.zeros((1, 1), bool))
    jp, jp0 = (jba.BAProblem(kf_R=jnp.asarray(Ra), kf_t=jnp.asarray(ta),
                             kf_fixed=jnp.asarray(fixed), **host)
               for Ra, ta in ((R, t), (R0, t0)))
    tp, tp0 = (tba.problem_to(tba.BAProblem(kf_R=Ra, kf_t=ta, kf_fixed=fixed,
                                            **host), "cpu")
               for Ra, ta in ((R, t), (R0, t0)))
    _, bj = jba._pose_prior_terms(jp, jp0, 1.0)
    _, bt = tba._pose_prior_terms(tp, tp0, 1.0)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=2e-6)
    np.testing.assert_allclose(bt.numpy().reshape(K, 6)[~fixed],
                               -dxi[~fixed], atol=5e-5)
    # the batched Lie maps themselves, one call over all K poses
    np.testing.assert_allclose(
        tlie.se3_log(torch.tensor(R), torch.tensor(t)).numpy(),
        np.asarray(jlie.se3_log(jnp.asarray(R), jnp.asarray(t))), atol=2e-6)


def _small_maps():
    """tests/test_local_ba.py's small map, and the port's MapState with
    the same tables."""
    cfg, jm = _small_map()
    tables = {k: v.copy() for k, v in vars(jm).items()
              if isinstance(v, np.ndarray)}
    tables["kf_pyr"] = [np.asarray(p) for p in jm.kf_pyr]
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tm = convert.map_state_from_numpy(tables, tcfg, 3, (64, 64),
                                      (100.0, 100.0, 32.0, 32.0),
                                      device="cpu")
    return cfg, jm, tcfg, tm


def _assert_problems_equal(tp, jp, tmeta, jmeta):
    for name, a, b in zip(tba.BAProblem._fields, tp, jp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    assert set(tmeta) == set(jmeta)
    for k in jmeta:
        np.testing.assert_array_equal(np.asarray(tmeta[k]),
                                      np.asarray(jmeta[k]), err_msg=k)


@pytest.mark.parametrize("core", [[2, 3], [0, 1, 2, 3]],
                         ids=["window", "all_core"])
def test_window_problem_and_guarded_write_back_match_jax(core):
    cfg, jm, tcfg, tm = _small_maps()
    jp, jmeta = jba.problem_from_window(jm, cfg, core_slots=core,
                                        pad_bucket=16)
    tp, tmeta = tba.problem_from_window(tm, tcfg, core_slots=core,
                                        pad_bucket=16)
    _assert_problems_equal(tp, jp, tmeta, jmeta)
    kf_R = np.asarray(jp.kf_R).copy()
    kf_t = np.asarray(jp.kf_t) + 0.5
    lm = np.asarray(jp.lm_pos) + 0.25
    # between dispatch and write-back: KF 3 replaced, point 0 deleted
    for m in (jm, tm):
        m.kf_frame_id[3] = 99
        m.pt_status[0] = ST_DELETED
    tm.dev("pt_pos")  # a device copy the write-back must drop
    counts_j = jba.write_back_window(jm, kf_R, kf_t, lm, jmeta)
    counts_t = tba.write_back_window(tm, torch.as_tensor(kf_R),
                                     torch.as_tensor(kf_t),
                                     torch.as_tensor(lm), tmeta)
    assert counts_t == counts_j
    assert not tm._dev
    for name in ("kf_R", "kf_t", "pt_pos", "ln_spos", "ln_epos"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)


def test_map_problem_and_write_back_match_jax():
    cfg, jm, tcfg, tm = _small_maps()
    jp, jmeta = jba.problem_from_map(jm, cfg)
    tp, tmeta = tba.problem_from_map(tm, tcfg)
    _assert_problems_equal(tp, jp, tmeta, jmeta)
    out = jp._replace(kf_t=jp.kf_t + 0.5, lm_pos=jp.lm_pos + 0.25)
    jba.write_back_to_map(jm, out, jmeta)
    tba.write_back_to_map(tm, tba.problem_to(
        tba.BAProblem(*[None if a is None else np.asarray(a) for a in out]),
        "cpu"), tmeta)
    for name in ("kf_R", "kf_t", "pt_pos", "ln_spos", "ln_epos"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)
