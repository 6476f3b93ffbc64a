"""The port's multi-process layer (plsvo_torch.parallel.distributed) on the
CPU: initialize()'s latch semantics (tests/test_distributed.py's four
cases, with torch.distributed.init_process_group monkeypatched: no real
process group is made inside a test worker), hybrid_mesh's shapes over
eight CPU devices, the hierarchical BA against the JAX package's
bundle_adjust_multihost and bundle_adjust at test_distributed.py's bars,
and a real two-process gloo run (this file's _worker, started as two
subprocesses) against the JAX package's single-device bundle_adjust."""
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from plsvo_torch import lie as tlie
from plsvo_torch.parallel import ba as tba
from plsvo_torch.parallel import distributed
from plsvo_torch.parallel.mesh import Mesh
from plsvo_tpu.parallel import ba as jba
from plsvo_tpu.parallel import distributed as jdist

from test_ba import make_problem

torch.set_num_threads(1)

CLUSTER_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK", "SLURM_JOB_ID",
                "OMPI_COMM_WORLD_SIZE", "OMPI_MCA_orte_hnp_uri")


@pytest.fixture
def fresh(monkeypatch):
    """initialize() as in a fresh process with no cluster in the
    environment; init_process_group records its calls instead of
    running."""
    monkeypatch.setattr(distributed, "_state", None)
    for k in CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    return calls


def test_initialize_single_process_is_safe(fresh):
    assert distributed.initialize() is False
    assert distributed.initialize() is False
    assert not dist.is_initialized() and distributed.world_size() == 1


def test_initialize_unexpected_failure_raises(fresh, monkeypatch):
    """A cluster is configured and its bring-up fails: the failure is
    raised, not turned into a single-process run, and nothing is latched
    (a corrected retry may proceed)."""
    monkeypatch.setenv("SLURM_JOB_ID", "1234")

    def boom(*a, **k):
        raise RuntimeError("connection refused by coordinator 10.0.0.1:1234")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="connection refused"):
        distributed.initialize()
    assert distributed._state is None


def test_initialize_no_cluster_latches_single_process(fresh, monkeypatch):
    """The environment names a cluster but not its rendezvous: the benign
    could-not-detect case falls back and latches, so a later bare call
    makes no second attempt; a call with explicit arguments still may."""
    monkeypatch.setenv("SLURM_JOB_ID", "1234")
    calls = []

    def no_rendezvous(*a, **k):
        calls.append(1)
        raise ValueError("Error initializing torch.distributed using env:// "
                         "rendezvous: environment variable MASTER_ADDR "
                         "expected, but not set")

    monkeypatch.setattr(dist, "init_process_group", no_rendezvous)
    assert distributed.initialize() is False
    assert distributed.initialize() is False
    assert len(calls) == 1 and distributed._state == "single"
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    distributed.initialize("localhost:1234", num_processes=2, process_id=1)
    (a, k), = calls[1:]
    assert k == dict(init_method="tcp://localhost:1234", world_size=2,
                     rank=1)
    assert a == ("nccl" if torch.cuda.is_available() else "gloo",)
    assert distributed._state == "live"


def test_initialize_without_cluster_env_is_quiet(fresh):
    """Nothing in the environment says cluster: latch single-process
    without attempting a bring-up."""
    assert distributed.initialize() is False
    assert distributed._state == "single"
    assert not fresh  # never attempted


def test_hybrid_mesh_shapes():
    mesh = distributed.hybrid_mesh(ici_per_host=4, devices=["cpu"] * 8)
    assert mesh.axis_names == ("dcn", "ici")
    assert mesh.shape == {"dcn": 2, "ici": 4}
    assert mesh.devices.shape == (2, 4) and len(mesh.local_devices) == 8
    mesh1 = distributed.hybrid_mesh(devices=["cpu"] * 8)
    assert mesh1.shape == {"dcn": 1, "ici": 8}
    jm = jdist.hybrid_mesh(ici_per_host=4)
    assert dict(jm.shape) == mesh.shape
    with pytest.raises(ValueError, match="not divisible"):
        distributed.hybrid_mesh(ici_per_host=3, devices=["cpu"] * 8)


def _hybrid():
    return distributed.hybrid_mesh(ici_per_host=4, devices=["cpu"] * 8)


def _np(prob):
    return tba.BAProblem(*[None if a is None else np.asarray(a) for a in prob])


def test_multihost_ba_matches_jax(rng):
    prob, gt = make_problem(rng, L=64)
    mesh = _hybrid()
    sharded = distributed.scatter_problem(_np(prob), mesh)
    out_t, _ = distributed.bundle_adjust_multihost(sharded, mesh, n_iter=1)
    jmesh = jdist.hybrid_mesh(ici_per_host=4)
    out_jh, _ = jdist.bundle_adjust_multihost(
        jdist.scatter_problem(prob, jmesh), jmesh, n_iter=1)
    out_j1, _ = jba.bundle_adjust(prob, n_iter=1)
    for ref in (out_jh, out_j1):
        np.testing.assert_allclose(out_t.kf_t.numpy(), np.asarray(ref.kf_t),
                                   atol=2e-4)
        np.testing.assert_allclose(out_t.lm_pos.numpy(),
                                   np.asarray(ref.lm_pos), atol=2e-3)

    # eight iterations: convergence quality of the single-device run
    out_h, st_h = distributed.bundle_adjust_multihost(sharded, mesh, n_iter=8)
    out_1, st_1 = jba.bundle_adjust(prob, n_iter=8)
    R_gt, t_gt, _ = gt

    def dist_err(R, t):
        return tlie.distance(torch.as_tensor(np.array(R)),
                             torch.as_tensor(np.array(t)),
                             torch.as_tensor(R_gt),
                             torch.as_tensor(t_gt))[1].numpy()

    d_h = dist_err(out_h.kf_R, out_h.kf_t)
    d_1 = dist_err(out_1.kf_R, out_1.kf_t)
    assert d_h[2:].max() < 1.5 * max(d_1[2:].max(), 1e-4)
    assert float(st_h.chi2) < 1.2 * float(st_1.chi2) + 1e-8
    assert int(st_h.n_obs) == int(st_1.n_obs)


def test_multihost_ba_fixed_poses_stay_fixed(rng):
    prob, _ = make_problem(rng, L=64)
    mesh = _hybrid()
    out, _ = distributed.bundle_adjust_multihost(
        distributed.scatter_problem(_np(prob), mesh), mesh, n_iter=4)
    np.testing.assert_allclose(out.kf_R[:2].numpy(), np.asarray(prob.kf_R[:2]),
                               atol=1e-6)
    np.testing.assert_allclose(out.kf_t[:2].numpy(), np.asarray(prob.kf_t[:2]),
                               atol=1e-6)


def _worker(rank, world, port, prob_path, out_path):
    """One process of the two-process run: a gloo group on localhost, two
    CPU shards of its own, its host-local landmark range scattered, one
    hierarchical BA iteration, its results written for the parent."""
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    live = distributed.initialize(f"localhost:{port}", num_processes=world,
                                  process_id=rank, backend="gloo")
    assert live and dist.get_world_size() == world
    mesh = distributed.hybrid_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"dcn": world, "ici": 2}, mesh.shape
    with np.load(prob_path) as f:
        prob = tba.BAProblem(**{k: f[k] for k in f.files})
    L = len(prob.lm_pos)
    lo, hi = rank * L // world, (rank + 1) * L // world
    local = prob._replace(**{k: getattr(prob, k)[lo:hi] for k in (
        "lm_pos", "lm_valid", "obs_kf", "obs_f", "obs_valid")})
    out, stats = distributed.bundle_adjust_multihost(
        distributed.scatter_problem(local, mesh), mesh, n_iter=1)
    np.savez(out_path, kf_t=out.kf_t.numpy(), lm_local=out.lm_pos.numpy(),
             lo=lo, hi=hi, chi2=float(stats.chi2), n_obs=int(stats.n_obs))
    dist.destroy_process_group()


def test_two_process_gloo_ba(tmp_path):
    """Two OS processes, each with two CPU shards, a gloo group on a
    localhost port, host-local problem construction and one hierarchical
    iteration: the JAX package's single-device result."""
    prob, _ = make_problem(np.random.default_rng(0), L=64)
    prob_path = tmp_path / "prob.npz"
    np.savez(prob_path, **{k: np.asarray(v) for k, v in prob._asdict().items()
                           if v is not None})
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [tmp_path / f"w{i}.npz" for i in range(2)]
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "from test_torch_distributed import _worker; "
            "_worker(*sys.argv[1:])").format(here, os.path.dirname(here))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(i), "2", str(port), str(prob_path),
         str(outs[i])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    ref, ref_stats = jba.bundle_adjust(prob, n_iter=1)
    w = [np.load(o) for o in outs]
    for i in (0, 1):
        np.testing.assert_allclose(w[i]["kf_t"], np.asarray(ref.kf_t),
                                   atol=5e-4)
        lo, hi = int(w[i]["lo"]), int(w[i]["hi"])
        np.testing.assert_allclose(w[i]["lm_local"],
                                   np.asarray(ref.lm_pos)[lo:hi], atol=5e-3)
        assert int(w[i]["n_obs"]) == int(ref_stats.n_obs)


# MULTICHIP_EFFICIENCY's and MULTICHIP_BA_COMM_SPLIT's keys in the JAX
# package's dryrun (__graft_entry__.py::dryrun_multichip)
JAX_RECORD_KEYS = {
    "MULTICHIP_EFFICIENCY": {
        "n_devices", "iteration_budgets", "t_step_1dev_ms", "t_step_ndev_ms",
        "efficiency", "timeshare_efficiency", "t_concurrent_unsharded_ms",
        "sharding_overhead_factor", "note"},
    "MULTICHIP_BA_COMM_SPLIT": {
        "n_devices", "t_ba_ms", "t_ba_comm_identity_ms", "comm_fraction",
        "note"},
}


def test_dryrun_multichip_on_two_cpu_shards(capsys):
    """The port's dryrun (2 CPU shards, 320x240, fast_config()) prints the
    JAX dryrun's records with their keys, and its map-capacity BA program
    gives the JAX package's sharded BA at test_ba.py's one-iteration bars."""
    import json

    from plsvo_torch.config import fast_config
    from plsvo_torch.parallel import dryrun

    out = dryrun.dryrun_multichip(2, ["cpu", "cpu"], width=320, height=240,
                                  cfg=fast_config(), reps=1)
    printed = {}
    for line in capsys.readouterr().out.splitlines():
        name, _, rec = line.partition(" ")
        if name in JAX_RECORD_KEYS:
            printed[name] = json.loads(rec)
    for name, keys in JAX_RECORD_KEYS.items():
        assert keys <= set(printed[name]), (name, printed[name])
    eff = printed["MULTICHIP_EFFICIENCY"]
    assert eff["n_devices"] == 2 and eff["iteration_budgets"] == "production"
    assert all(np.isfinite(eff[k]) and eff[k] > 0 for k in (
        "t_step_1dev_ms", "t_step_ndev_ms", "efficiency"))
    assert out["ba_chi2"]["hybrid_mesh"] == {"dcn": 2, "ici": 1}
    np.testing.assert_allclose(out["ba_chi2"]["hybrid"],
                               out["ba_chi2"]["sharded"], rtol=1e-2)

    prob = dryrun.map_capacity_problem(fast_config().caps, 2,
                                       np.random.default_rng(0))
    t_out, _ = tba.bundle_adjust_sharded(prob, Mesh(["cpu"] * 2, ("seq",)),
                                         "seq", n_iter=1)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    j_out, _ = jba.bundle_adjust_sharded(
        jba.BAProblem(*[None if a is None else jax.numpy.asarray(a)
                        for a in prob]), jmesh, "seq", n_iter=1)
    np.testing.assert_allclose(t_out.kf_t.numpy(), np.asarray(j_out.kf_t),
                               atol=5e-4)
    np.testing.assert_allclose(t_out.lm_pos.numpy(), np.asarray(j_out.lm_pos),
                               atol=5e-3)
