"""Multi-process runtime on torch.distributed.

Port of `plsvo_tpu/parallel/distributed.py`:

- `initialize()`: process-group bring-up (`torch.distributed.
  init_process_group`, NCCL on the card, gloo otherwise). With no
  arguments it joins a cluster only when the environment names one
  (torchrun's RANK / WORLD_SIZE / MASTER_ADDR, SLURM, OMPI) and is
  otherwise a latched single-process no-op, so every entry point can call
  it unconditionally. An unexpected bring-up failure with a cluster
  configured raises.
- `hybrid_mesh()`: a (dcn, ici) mesh (`parallel/mesh.py`). Under a live
  group the outer axis has one row per process and the inner one this
  process's devices; in one process it is (n // ici_per_host,
  ici_per_host) over the given devices.
- `scatter_problem()` / `bundle_adjust_multihost()`: BA with landmark
  rows split over both axes; the reduced camera system is summed over the
  inner (in-process) axis first and only that partial crosses processes.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from plsvo_torch.parallel import ba as ba_mod
from plsvo_torch.parallel.mesh import Mesh, Shards

# None = never attempted; "single" = a bare call found no cluster (latched
# so repeat bare calls do not retry, but a call with explicit arguments may
# still proceed); "live" = a process group is up
_state = None
# the devices `local_device_ids` named (hybrid_mesh's default when given)
_local_devices = None

_CLUSTER_ENV = ("MASTER_ADDR", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE",
                "OMPI_MCA_orte_hnp_uri")


def _cluster_env_present() -> bool:
    """Does the environment say this process is one of a cluster (torchrun,
    SLURM, OMPI)?"""
    if os.environ.get("WORLD_SIZE") and os.environ.get("RANK"):
        return True
    return any(os.environ.get(k) for k in _CLUSTER_ENV)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _backend(backend):
    if backend is not None:
        return backend
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, local_device_ids=None, *,
               backend: Optional[str] = None) -> bool:
    """Bring up the torch.distributed process group.

    Returns True when a multi-process group is (now) live, False for the
    single-process case. Safe to call more than once and in a plain
    single-process run: with no coordinator given and no cluster in the
    environment it latches the single-process state and returns False. A
    group the caller already brought up is used as it is. An unexpected
    failure raises and latches nothing, so a corrected call may retry.
    `coordinator_address` is "host:port" (a tcp:// rendezvous); the
    backend is NCCL when a card is present, else gloo, unless named."""
    global _state, _local_devices
    if local_device_ids is not None:
        _local_devices = [torch.device("cuda", int(i))
                          for i in local_device_ids]
        torch.cuda.set_device(_local_devices[0])
    explicit = coordinator_address is not None or num_processes is not None
    if dist.is_initialized():
        _state = "live"
        return world_size() > 1
    if _state == "live" or (_state == "single" and not explicit):
        return world_size() > 1
    if not explicit:
        if not _cluster_env_present():
            _state = "single"
            return False
        try:
            dist.init_process_group(_backend(backend), init_method="env://")
        except Exception as e:
            if isinstance(e, ValueError) and "environment variable" in str(e):
                # the environment names a cluster but not its rendezvous
                # (env:// needs MASTER_ADDR, MASTER_PORT, RANK and
                # WORLD_SIZE): nothing to join. Latched; a call with
                # explicit arguments may still proceed
                _state = "single"
                return False
            # any other failure (coordinator unreachable, port clash,
            # partial cluster) is raised, never swallowed: a quiet
            # single-process fallback would give wrong results silently
            logging.getLogger(__name__).error(
                "torch.distributed bring-up failed: %s", e)
            raise
        _state = "live"
        return world_size() > 1
    addr = coordinator_address or "{}:{}".format(
        os.environ.get("MASTER_ADDR", "localhost"),
        os.environ.get("MASTER_PORT", "29500"))
    dist.init_process_group(
        _backend(backend), init_method=f"tcp://{addr}",
        world_size=int(num_processes if num_processes is not None else 1),
        rank=int(process_id or 0))
    _state = "live"
    return world_size() > 1


def _visible_cards():
    if _local_devices is not None:
        return list(_local_devices)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices= explicitly (e.g. "
                           "['cpu'] * 8) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def hybrid_mesh(ici_per_host: Optional[int] = None, *, dcn_axis: str = "dcn",
                ici_axis: str = "ici", devices=None) -> Mesh:
    """A 2-D (hosts, devices-per-host) mesh.

    Under a live group of W processes: one `dcn_axis` row per process, each
    holding that process's devices (`devices`, by default its visible
    cards); reductions over `ici_axis` stay in the process, those over
    `dcn_axis` go through all_reduce. In one process: (n // ici_per_host,
    ici_per_host) over `devices` (ici_per_host defaults to n)."""
    devices = list(devices) if devices is not None else _visible_cards()
    n = len(devices)
    W = world_size()
    if W > 1:
        return Mesh([devices] * W, (dcn_axis, ici_axis), process_axis=dcn_axis)
    per = ici_per_host or n
    if n % per:
        raise ValueError(f"{n} devices not divisible by ici_per_host {per}")
    return Mesh([devices[r * per:(r + 1) * per] for r in range(n // per)],
                (dcn_axis, ici_axis))


def scatter_problem(prob: "ba_mod.BAProblem", mesh: Mesh,
                    dcn_axis: str = "dcn", ici_axis: str = "ici") -> Shards:
    """The problem on the mesh's local shards: landmark rows split over
    (dcn, ici), poses on every shard. With several processes the caller
    passes its host-local landmark range (its blocks' rows); in one process
    the whole problem."""
    return ba_mod.shard_problem(prob, mesh, (dcn_axis, ici_axis))


def bundle_adjust_multihost(prob, mesh: Mesh, dcn_axis: str = "dcn",
                            ici_axis: str = "ici", *, n_iter: int = 10,
                            huber: float = 1.0 / 250.0,
                            damping: float = 1e-4, lm_damp: float = 1e-8,
                            pose_prior: float = 0.0):
    """Hierarchical distributed BA over a (dcn, ici) mesh.

    Landmark ranges split over dcn x ici (each process owns a contiguous
    range, each of its shards a sub-range). Per GN iteration each shard
    assembles its partial reduced camera system; the partials are summed
    over the ici axis first (in the process), then over the dcn axis (one
    all_reduce of a (6K, 6K) matrix per process). The solve is replicated
    and landmark back-substitution stays on the owning shard. `prob` is
    scatter_problem's Shards or a BAProblem to scatter. Returns (problem,
    stats) on the first local device: every landmark row in a single
    process, this process's range under several."""
    parts = (prob if isinstance(prob, Shards)
             else scatter_problem(prob, mesh, dcn_axis, ici_axis))

    def reduce(xs):
        return mesh.psum(mesh.psum(xs, ici_axis), dcn_axis)

    out, stats = ba_mod._bundle_adjust_parts(
        parts, reduce, ba_mod.global_slots(parts, mesh), n_iter=n_iter,
        huber=huber, damping=damping, lm_damp=lm_damp, pose_prior=pose_prior)
    return ba_mod.join_problem(out), stats
