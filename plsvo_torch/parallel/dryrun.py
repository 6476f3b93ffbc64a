"""The multi-device programs at production shapes, one step of each, with
their scaling signals: the port of `__graft_entry__.dryrun_multichip`.

1. `fused.track_frame_step_list(mesh=)`: the complete tracked-frame step
   at 752x480 with `Config()` capacities, B = n_shards sequences split
   over a ("seq",) mesh.
2. `ba.bundle_adjust_sharded`: map-capacity BA (max_kfs keyframes,
   max_points + 2 * max_lines landmark rows), landmark-sharded, timed with
   the real reduction and with `comm_identity`.
3. `distributed.bundle_adjust_multihost` over `hybrid_mesh`, after
   `distributed.initialize()`.

Prints the JAX package's `MULTICHIP_EFFICIENCY` and
`MULTICHIP_BA_COMM_SPLIT` lines. Shards on one card run one after another,
so on one card these ratios measure the cost of sharding, not scaling
across cards.

    python -m plsvo_torch.parallel.dryrun 2      # two shards, the card(s)
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import sys
import time

import numpy as np
import torch


def _sync(devices):
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _timed(fn, devices, reps):
    """Best wall time of `reps` calls after a warm one, each waited for."""
    fn()
    _sync(devices)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(devices)
        best = min(best, time.perf_counter() - t0)
    return best


def _frame_inputs(cam, cfg, B, device, rng):
    """B sequences' inputs of the batched frame step: random 752x480 frames
    and a few live point rows, so that every stage has work."""
    from plsvo_torch.image import build_pyramid
    from plsvo_torch.pipeline import fused
    from plsvo_torch.pipeline.frame_handler import FrameHandlerMono
    from plsvo_torch.pipeline.state import FrameState

    H, W = cam.height, cam.width
    seqs = []
    for _ in range(B):
        vo = FrameHandlerMono(cam, cfg, device=device)
        img0, img1 = (torch.as_tensor(rng.uniform(0, 255, (H, W))
                                      .astype(np.float32)).to(device)
                      for _ in range(2))
        last = FrameState.empty(cfg, 0, 0.0, build_pyramid(img0, vo.n_levels),
                                np.eye(3, dtype=np.float32),
                                np.zeros(3, np.float32))
        last.pt_uv[:16] = rng.uniform(40, 400, (16, 2)).astype(np.float32)
        last.pt_f[:16] = vo._np_unproject(last.pt_uv[:16])
        last.pt_lm[:16] = np.arange(16)
        last.pt_valid[:16] = True
        vo.map.pt_status[:16] = 2
        vo.map.pt_pos[:16] = last.pt_f[:16] * 3.0
        vo.last_frame = last
        seqs.append((vo, build_pyramid(img1, vo.n_levels)))
    vo0 = seqs[0][0]
    atlases = [vo.map.kf_atlas_flat(cfg.pipeline.n_pyr_levels)
               for vo, _ in seqs]
    args = (
        [vo.last_frame.pyr for vo, _ in seqs],
        [torch.stack([p[lv] for _, p in seqs]) for lv in range(vo0.n_levels)],
        atlases[0]._replace(flat=torch.stack([a.flat for a in atlases])),
        [vo._last_blob(vo.last_frame) for vo, _ in seqs],
        [fused.map_tables_from_state(vo.map) for vo, _ in seqs],
        torch.zeros((B, 2), dtype=torch.int32, device=device),
        fused.stack_trees([vo.pt_seeds for vo, _ in seqs]),
        fused.stack_trees([vo.ln_seeds for vo, _ in seqs]),
        cam.fx, cam.fy, cam.cx, cam.cy)
    kwargs = vo0._step_kwargs()
    kwargs.update(update_pt_seeds=True, update_ln_seeds=True, pt_width=128,
                  ln_width=64)
    return args, kwargs


def _first_rows(args, n):
    """The inputs of the first n sequences."""
    from plsvo_torch.parallel.mesh import tree_map

    last_pyrs, cur_pyr, atlas, blobs, mts, bc_fid, pt, ln = args[:8]
    rows = lambda t: tree_map(lambda a: a[:n], t)  # noqa: E731
    return (last_pyrs[:n], rows(cur_pyr), atlas._replace(flat=atlas.flat[:n]),
            blobs[:n], mts[:n], bc_fid[:n], rows(pt), rows(ln)) + args[8:]


def _efficiency(args, kwargs, devices, budgets, reps, shared_card):
    """MULTICHIP_EFFICIENCY's record: the n-shard step against the 1-shard
    step, and the same 1-shard step run on every device at once from n
    host threads (no mesh: the devices' contention alone)."""
    from plsvo_torch.parallel.mesh import Mesh, on_device, tree_map
    from plsvo_torch.pipeline import fused

    n = len(devices)
    mesh = Mesh(devices, ("seq",))
    mesh1 = Mesh(devices[:1], ("seq",))
    one = _first_rows(args, 1)
    t_n = _timed(lambda: fused.track_frame_step_list(
        *_first_rows(args, n), mesh=mesh, mesh_axis="seq", **kwargs),
        devices, reps)
    t_1 = _timed(lambda: fused.track_frame_step_list(
        *one, mesh=mesh1, mesh_axis="seq", **kwargs), devices, reps)

    per_dev = [tree_map(lambda a: a.to(d), one) for d in devices]

    def one_dev(d, a):
        with on_device(d):
            fused.track_frame_step_list(*a, **kwargs)
        _sync([d])

    with cf.ThreadPoolExecutor(max_workers=n) as pool:
        for f in [pool.submit(one_dev, d, a) for d, a in zip(devices, per_dev)]:
            f.result()  # warm
        t_conc = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for f in [pool.submit(one_dev, d, a)
                      for d, a in zip(devices, per_dev)]:
                f.result()
            t_conc = min(t_conc, time.perf_counter() - t0)
    timeshare = t_1 / max(t_conc, 1e-9)
    note = ("timeshare_efficiency = the same 1-shard program run on every "
            "device at once from n host threads, without a mesh; "
            "sharding_overhead_factor = efficiency / timeshare_efficiency")
    if shared_card:
        note += ("; shards share a device and run one after another, so "
                 "these ratios measure the cost of sharding on one device, "
                 "not scaling across devices")
    return {
        "n_devices": n,
        "devices": [str(d) for d in devices],
        "iteration_budgets": budgets,
        "t_step_1dev_ms": t_1 * 1e3,
        "t_step_ndev_ms": t_n * 1e3,
        "efficiency": t_1 / max(t_n, 1e-9),
        "timeshare_efficiency": timeshare,
        "t_concurrent_unsharded_ms": t_conc * 1e3,
        "sharding_overhead_factor": (t_1 / max(t_n, 1e-9)) / max(timeshare,
                                                                   1e-9),
        "note": note,
    }


def map_capacity_problem(caps, n_shards, rng):
    """BA over the map's capacity: max_kfs keyframes on a line,
    max_points + 2 * max_lines landmark rows (padded to the mesh), each
    seen in max_obs_per_landmark keyframes, landmarks perturbed."""
    from plsvo_torch import lie
    from plsvo_torch.parallel import ba

    Kf = caps.max_kfs
    L = caps.max_points + 2 * caps.max_lines
    L += (-L) % n_shards
    O = caps.max_obs_per_landmark
    pos = np.stack([rng.uniform(-2, 2, L), rng.uniform(-2, 2, L),
                    rng.uniform(2, 6, L)], -1).astype(np.float32)
    obs_kf = ((np.arange(L)[:, None] + np.arange(O)[None]) % Kf).astype(np.int32)
    xi = np.zeros((Kf, 6), np.float32)
    xi[:, 0] = 0.05 * np.arange(Kf)
    xi[:, 4] = 0.01 * np.arange(Kf)
    Rk, tk = (a.numpy() for a in lie.se3_exp(torch.as_tensor(xi)))
    xyz = np.einsum("loij,lj->loi", Rk[obs_kf], pos) + tk[obs_kf]
    obs_f = (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(np.float32)
    fixed = np.zeros(Kf, bool)
    fixed[:2] = True
    return ba.BAProblem(
        kf_R=Rk, kf_t=tk, kf_fixed=fixed,
        lm_pos=pos + rng.normal(0, 0.05, pos.shape).astype(np.float32),
        lm_valid=np.ones(L, bool), obs_kf=obs_kf, obs_f=obs_f,
        obs_valid=np.ones((L, O), bool))


def dryrun_multichip(n_shards: int, devices=None, *, width: int = 752,
                     height: int = 480, cfg=None, reps: int = 3):
    """Run the production multi-device programs over an n_shards mesh (on
    `devices`, by default the visible cards in turn: two shards on a host
    with one card share it) and print their records. `width`, `height`
    and `cfg` (default `Config()`) size the frame step and the BA problem;
    `reps` timed calls follow a warm one. Returns {"efficiency": [...],
    "ba_comm_split": {...}, "ba_chi2": {...}}."""
    from plsvo_torch.parallel import distributed

    # the process group comes up before any device work
    distributed.initialize()

    from plsvo_torch.camera import PinholeCamera
    from plsvo_torch.config import Config
    from plsvo_torch.parallel import ba
    from plsvo_torch.parallel.mesh import Mesh, normalize_device

    if devices is None:
        cards = distributed._visible_cards()
        devices = [cards[i % len(cards)] for i in range(n_shards)]
    devices = [normalize_device(d) for d in devices[:n_shards]]
    shared_card = len(set(devices)) < len(devices)
    cfg = cfg or Config()
    rng = np.random.default_rng(0)

    # --- 1. the production frame step, one sequence per shard ---
    cam = PinholeCamera.create(width, height, 460.0 * width / 752,
                               460.0 * width / 752, width / 2, height / 2)
    args, kwargs = _frame_inputs(cam, cfg, n_shards, devices[0], rng)
    kwargs_full = dict(kwargs)
    if n_shards > 2:
        # as the JAX dryrun bounds a wide mesh's iteration budgets (its
        # virtual devices share a few cores); the n = 2 record below keeps
        # the production budgets
        kwargs.update(n_iter_align=2, poseopt_iters=2, poseopt_iters_ref=0,
                      struct_iters=1)
    records = [_efficiency(args, kwargs, devices,
                           "production" if n_shards <= 2 else "bounded",
                           reps, shared_card)]
    if n_shards > 2:
        records.append(_efficiency(args, kwargs_full, devices[:2],
                                   "production", reps,
                                   len(set(devices[:2])) < 2))
    for rec in records:
        print("MULTICHIP_EFFICIENCY " + json.dumps(rec), flush=True)

    # --- 2 + 3. map-capacity distributed BA ---
    prob = map_capacity_problem(cfg.caps, n_shards, rng)
    mesh = Mesh(devices, ("seq",))
    _, stats = ba.bundle_adjust_sharded(prob, mesh, "seq", n_iter=2)
    t_ba = _timed(lambda: ba.bundle_adjust_sharded(prob, mesh, "seq",
                                                   n_iter=2), devices, reps)
    t_nocomm = _timed(lambda: ba.bundle_adjust_sharded(
        prob, mesh, "seq", n_iter=2, comm_identity=True), devices, reps)
    split = {
        "n_devices": n_shards,
        "t_ba_ms": t_ba * 1e3,
        "t_ba_comm_identity_ms": t_nocomm * 1e3,
        "comm_fraction": max(0.0, 1.0 - t_nocomm / max(t_ba, 1e-9)),
        "note": "comm_identity replaces every psum with a local scale "
                "(timing only); comm_fraction = the share of the sharded "
                "BA's wall time spent in its reductions"
                + ("; shards share a device" if shared_card else ""),
    }
    print("MULTICHIP_BA_COMM_SPLIT " + json.dumps(split), flush=True)

    per = n_shards // 2 if n_shards % 2 == 0 else n_shards
    hmesh = distributed.hybrid_mesh(ici_per_host=per, devices=devices)
    _, stats_h = distributed.bundle_adjust_multihost(
        distributed.scatter_problem(prob, hmesh), hmesh, n_iter=2)
    _sync(devices)
    return {"efficiency": records, "ba_comm_split": split,
            "ba_chi2": {"sharded": float(stats.chi2),
                        "hybrid": float(stats_h.chi2),
                        "hybrid_mesh": dict(hmesh.shape)}}


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
