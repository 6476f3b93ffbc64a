"""Batched multi-sequence VO: B full pipelines, one device step per tracked
frame for all of them.

Port of `plsvo_tpu/parallel/multi_vo.py`. Each sequence keeps its own
host-side map and bookkeeping (a `FrameHandlerMono`); the complete frame
step (align -> reproject -> pose opt -> structure opt -> seed update) runs
once for the batch, every op taking a leading batch axis in place of the
JAX package's `vmap`: one stream of launches serves B sequences, and every
K2 call site makes one launch for all of them. The seed tables stay
stacked on the device across frames and are materialized per sequence
only when that sequence leaves the batch.

Pipelined mode (cfg.pipeline.pipelined): batched steps chain on the device
through NextFrameInputs and a stacked map carry fed by one (B, L) delta
upload per frame; results are fetched a window of pipeline_depth frames
at a time in one asynchronous copy, with the keyframe seed detections
(one batched program per 10 requests at 3 levels: one K1 launch for
their 30 pyramid images) and local BA solves (one solve per spec over up
to B queued windows) of every sequence.

Sequences still in bootstrap (FIRST/SECOND) or relocalizing run their own
sync path for that frame; the batch engages only when every sequence is
DEFAULT.

With a mesh (`parallel/mesh.py`) the batched step splits the batch over
one axis (`fused._shard_mapped_step`): the seed tables, NextFrameInputs
and map carry stay per shard on the shard's device between steps, and
every K2 call site launches once per shard. The handlers, their uploads,
the batched keyframe detection and the local BA solves stay on the mesh's
first device, as the JAX package keeps them unsharded; a sequence's rows
move there when its handler reads them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from plsvo_torch.camera import PinholeCamera
from plsvo_torch.config import Config
from plsvo_torch.device import resolve_device
from plsvo_torch.image import build_pyramid
from plsvo_torch.ops import fast_score
from plsvo_torch.parallel import ba as ba_mod
from plsvo_torch.parallel import mesh as mesh_mod
from plsvo_torch.pipeline import fused
from plsvo_torch.pipeline.frame_handler import (
    STAGE_DEFAULT, FrameHandlerMono, _kf_detect_program_batched)
from plsvo_torch.pipeline.state import FrameState


def _row(tree, k):
    """Sequence k's slice of a fetched (numpy) batched result tree."""
    if isinstance(tree, np.ndarray):
        return tree[k]
    if isinstance(tree, (tuple, list)):
        vals = [_row(t, k) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return tree


def _fetch_parts(step):
    """What the host reads of a batched step: its results and seed
    convergence (per shard for a sharded step)."""
    if isinstance(step, mesh_mod.Shards):
        return mesh_mod.Shards(_fetch_parts(p) for p in step)
    return (fused.fetch_view(step.fused), step.pt_conv, step.ln_conv)


class BatchedVO:
    """Drives B sequences on one card or over a device mesh. Two execution
    modes:

    - "vmap" (the default; "auto" resolves to it): one batched device step
      per frame over the whole batch; with `mesh` (a `parallel.mesh.Mesh`)
      split over its axis `axis`. A batch the axis does not divide runs
      unsharded on the mesh's first device, as the JAX package's does
      (counted in `unsharded_steps`).
    - "streams": B independent handlers (pipelined when the config says
      so) whose dispatches interleave on the device queue; for batches the
      batched step cannot express (a different config per stream). It
      takes no mesh.

    With a mesh, `device` is None or the mesh's first device. The camera
    must be a PinholeCamera.
    """

    def __init__(self, cam: PinholeCamera, cfg: Config, n_sequences: int,
                 mesh=None, axis: str = "seq", mode: str = "auto",
                 device=None):
        if mode == "auto":
            mode = "vmap"
        if mode not in ("vmap", "streams"):
            raise ValueError(f"mode {mode!r}: 'auto', 'vmap' or 'streams'")
        if mesh is not None:
            if mode == "streams":
                raise ValueError("mode 'streams' takes no mesh: the batch "
                                 "splits over a mesh in mode 'vmap'")
            if axis not in mesh.axis_names:
                raise ValueError(f"mesh axes {mesh.axis_names} have no axis "
                                 f"{axis!r}")
            mesh.check_spans(axis)
            first = mesh.local_devices[0]
            if device is not None and mesh_mod.normalize_device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {first}")
            device = first
        self.mesh = mesh
        self.axis = axis
        self.unsharded_steps = 0
        self.device = resolve_device(device)
        self.vos = [FrameHandlerMono(cam, cfg, device=self.device)
                    for _ in range(n_sequences)]
        self.cam = cam
        self.cfg = cfg
        self.mode = mode
        self.pipelined = bool(cfg.pipeline.pipelined)
        self.depth = max(1, cfg.pipeline.pipeline_depth)
        for vo in self.vos:
            # vmap mode: a handler that falls out of the batch (bootstrap,
            # relocalization) tracks its frames sync; in pipelined mode its
            # keyframe detection and local BA still ride OUR drain fetch.
            # streams mode: each handler manages itself.
            vo._force_sync = self.mode != "streams"
            vo._defer_seed_init = self.pipelined and self.mode != "streams"
            if vo._defer_seed_init:
                # collect the keyframe detections and local BA solves of
                # every sequence and run each kind as one batched program
                # per drain window
                vo._queue_or_dispatch_detection = (
                    lambda frame, vo=vo: self._queue_detection(vo, frame))
                vo._solve_local_ba = (
                    lambda blob, spec: self._queue_ba(blob, spec))
                # the frame counter moves at dispatch here, so the newest
                # dispatched step is one behind it
                vo._install_frame = lambda vo=vo: vo.frame_id - 1
        self._dev = self.vos[0]._dev
        self._ne = self.vos[0]._mt_ne
        # queued keyframe-detection requests [(frame, occ_uv, occ_ok, ref)]
        self._det_q: List = []
        # queued local BA requests [(blob, spec, ref)]
        self._ba_q: List = []
        # stacked device-resident seed tables of the batch members
        self._seeds_idx: Optional[tuple] = None
        self._pt_stack = None
        self._ln_stack = None
        # the stacked keyframe atlases, rebuilt when a member's changes
        self._atlas = (None, None)
        # stacked device-resident MapTables carry (pipelined vmap mode)
        self._mt_stack = None
        # pipelined mode: in-flight batched steps, fetch windows in flight,
        # finished per-call result lists, and fetched windows whose
        # bookkeeping runs _book_chunk frames per add_images call
        self._bq: List = []  # (default_idx, frames, step)
        self._bfetch_q: List = []
        self._bready: List[list] = []
        self._bbook_q: List = []
        self._book_chunk = 2

    # -- stacked seed tables ---------------------------------------------
    def _materialize_seeds(self):
        """Write the stacked tables back into the member handlers (batch
        membership changes, or a handler leaves for its own path)."""
        if self._seeds_idx is None:
            return
        for k, i in enumerate(self._seeds_idx):
            self.vos[i].pt_seeds = self._seq_row(self._pt_stack, k)
            self.vos[i].ln_seeds = self._seq_row(self._ln_stack, k)
        self._seeds_idx = None
        self._pt_stack = None
        self._ln_stack = None

    def _ensure_stack(self, idx):
        if self._seeds_idx == tuple(idx):
            return
        self._materialize_seeds()
        self._pt_stack = fused.stack_trees([self.vos[i].pt_seeds for i in idx])
        self._ln_stack = fused.stack_trees([self.vos[i].ln_seeds for i in idx])
        self._seeds_idx = tuple(idx)

    def _seq_row(self, stack, k):
        """Sequence k's row of a stacked (or sharded) table, on the
        handlers' device."""
        return mesh_mod.tree_map(lambda a: a.to(self.device),
                                 mesh_mod.row(stack, k))

    def _install_seed_hooks(self, vo: FrameHandlerMono, k: int):
        def get():
            return (self._seq_row(self._pt_stack, k),
                    self._seq_row(self._ln_stack, k))

        def set_(pt, ln):
            self._pt_stack = mesh_mod.set_row(self._pt_stack, k, pt)
            self._ln_stack = mesh_mod.set_row(self._ln_stack, k, ln)

        vo._get_seed_tables = get
        vo._set_seed_tables = set_

    @staticmethod
    def _remove_seed_hooks(vo: FrameHandlerMono):
        for name in ("_get_seed_tables", "_set_seed_tables"):
            vo.__dict__.pop(name, None)

    # -- step inputs -------------------------------------------------------
    def _batch_kwargs(self, default_idx):
        """Step options unified across the batch: both seed stages on (a
        table with no live row changes nothing) and the full seed widths,
        as the JAX package pins them."""
        kwargs = self.vos[default_idx[0]]._step_kwargs()
        kwargs["update_pt_seeds"] = True
        kwargs["update_ln_seeds"] = bool(self.cfg.pipeline.has_ls)
        kwargs["pt_width"] = None
        kwargs["ln_width"] = None
        return kwargs

    def _kf_atlas(self, default_idx):
        """The members' keyframe atlases stacked (B, H, K*Wa); rebuilt only
        when one of them changed (a keyframe install or removal)."""
        n = self.cfg.pipeline.n_pyr_levels
        parts = [self.vos[i].map.kf_atlas_flat(n) for i in default_idx]
        flats, stacked = self._atlas
        if (flats is None or len(flats) != len(parts)
                or any(a is not b.flat for a, b in zip(flats, parts))):
            stacked = parts[0]._replace(
                flat=torch.stack([p.flat for p in parts]))
            self._atlas = (tuple(p.flat for p in parts), stacked)
        return stacked

    def _upload_images(self, imgs, default_idx):
        """One stacked upload of the members' images (uint8 stays uint8)."""
        a = np.stack([np.asarray(imgs[i]) for i in default_idx])
        if a.dtype not in (np.uint8, np.float32):
            a = a.astype(np.float32)
        return self._dev(a)

    def _bc_fid(self, default_idx):
        return self._dev(np.asarray(
            [[self.vos[i].batch_counter, self.vos[i].frame_id]
             for i in default_idx], np.int32))

    def _new_frames(self, default_idx, pyr_b, timestamp):
        """Empty FrameStates of this step, each holding its sequence's
        views into the stacked pyramid (a copy on the handlers' device of a
        shard's rows on another device)."""
        frames = []
        for k, i in enumerate(default_idx):
            vo = self.vos[i]
            last = vo.last_frame
            frames.append(FrameState.empty(
                vo.cfg, vo.frame_id, timestamp,
                [lv.to(self.device) for lv in mesh_mod.row(pyr_b, k)],
                last.R_f_w.copy(), last.t_f_w.copy()))
        return frames

    def _mesh_for(self, default_idx):
        """The mesh, when its axis divides the batch; else None (the step
        runs unsharded on the first device, counted)."""
        if self.mesh is None:
            return None
        if len(default_idx) % self.mesh.shape[self.axis] == 0:
            return self.mesh
        self.unsharded_steps += 1
        return None

    def _full_step(self, default_idx, imgs, timestamp, emit_next: bool):
        """The batched step from host tables and full map uploads (the sync
        mode's step, and the first step of a pipelined chain)."""
        n_levels = self.vos[default_idx[0]].n_levels
        pyr_b = build_pyramid(self._upload_images(imgs, default_idx), n_levels)
        frames = self._new_frames(default_idx, pyr_b, timestamp)
        blobs, mts = [], []
        for i in default_idx:
            vo = self.vos[i]
            # the full upload holds every queued delta
            vo.map.mt_mark_clean()
            blobs.append(vo._last_blob(vo.last_frame))
            mts.append(fused.map_tables_from_state(vo.map))
        cam = self.cam
        step = fused.track_frame_step_list(
            [self.vos[i].last_frame.pyr for i in default_idx], pyr_b,
            self._kf_atlas(default_idx), blobs, mts,
            self._bc_fid(default_idx), self._pt_stack, self._ln_stack,
            cam.fx, cam.fy, cam.cx, cam.cy, emit_next=emit_next,
            mesh=self._mesh_for(default_idx), mesh_axis=self.axis,
            **self._batch_kwargs(default_idx))
        return step, frames

    # -- frames ------------------------------------------------------------
    def add_images(self, imgs: Sequence, timestamp: float):
        """One frame for every sequence. imgs: B images. Returns B results
        (in pipelined mode an earlier frame's, or None)."""
        if self.mode == "streams":
            return [vo.add_image(imgs[i], timestamp)
                    for i, vo in enumerate(self.vos)]
        if self.pipelined:
            return self._add_images_pipelined(imgs, timestamp)
        default_idx = self._default_idx()
        # the batch engages only at full membership (the JAX package's
        # rule: one program variant); until then every sequence tracks
        # through its own path
        if len(default_idx) < len(self.vos):
            self._materialize_seeds()
            return [vo.add_image(imgs[i], timestamp)
                    for i, vo in enumerate(self.vos)]
        self._ensure_stack(default_idx)
        step, frames = self._full_step(default_idx, imgs, timestamp, False)
        self._pt_stack = step.pt_seeds
        self._ln_stack = step.ln_seeds
        # one fetch: every sequence's results and seed convergence
        res_f, pt_conv_b, ln_conv_b = mesh_mod.unshard(
            fused.fetch(_fetch_parts(step)))
        results = [None] * len(self.vos)
        for k, i in enumerate(default_idx):
            vo = self.vos[i]
            r = self._finish_one(vo, k, frames[k], res_f, pt_conv_b, ln_conv_b)
            vo.frame_id += 1
            vo.results.append(r)
            results[i] = r
        return results

    def _default_idx(self):
        return [i for i, vo in enumerate(self.vos) if vo.stage == STAGE_DEFAULT]

    def _finish_one(self, vo, k, frame, res_f, pt_conv_b, ln_conv_b):
        """Sequence k's slice of fetched batch results through its host
        bookkeeping; its keyframe seed installs write row k of the stacked
        tables."""
        vo._apply_harvest(_row(pt_conv_b, k), _row(ln_conv_b, k),
                          result_frame_id=frame.frame_id)
        self._install_seed_hooks(vo, k)
        try:
            return vo._post_fused(frame, _row(res_f, k))
        finally:
            self._remove_seed_hooks(vo)

    # -- pipelined batched mode ---------------------------------------------
    def _add_images_pipelined(self, imgs, timestamp):
        """Dispatch the batched step of this frame, chained on the device
        from the previous one; fetch a window every `depth` frames."""
        B = len(self.vos)
        results = [None] * B
        default_idx = self._default_idx()
        # in-flight steps are valid only for their member set and an
        # unbroken carry: a membership change or a change the deltas cannot
        # carry drains everything first
        if self._bq and (tuple(default_idx) != self._bq[-1][0] or any(
                self.vos[i].map.mt_needs_resync(self._ne) for i in default_idx)):
            self._drain_all_batched()
            default_idx = self._default_idx()
        if len(default_idx) < B:
            if self._bq or self._bfetch_q:
                self._drain_all_batched()
            self._mt_stack = None  # the next batched step uploads in full
            self._materialize_seeds()
            for i in range(B):
                results[i] = self.vos[i].add_image(imgs[i], timestamp)
            return results

        self._ensure_stack(default_idx)
        cam = self.cam
        if not self._bq:
            # chain start: host tables of the last finished frames and full
            # map uploads (the carry's resync)
            step, frames = self._full_step(default_idx, imgs, timestamp, True)
        else:
            kw = self._batch_kwargs(default_idx)
            del kw["specs"]
            # the whole per-frame host->device traffic of B sequences: one
            # image stack, one (B, 2) counter upload, one (B, L) delta
            # upload
            deltas = np.stack([self.vos[i].map.pack_mt_deltas(
                fused.MT_DELTA_DP, fused.MT_DELTA_DL, fused.MT_DELTA_OP,
                fused.MT_DELTA_OL, self._ne) for i in default_idx])
            step = fused.track_frame_step_tables_list(
                self._upload_images(imgs, default_idx),
                self._kf_atlas(default_idx), self._bc_fid(default_idx),
                self._bq[-1][2].next, self._mt_stack, self._dev(deltas),
                self._pt_stack, self._ln_stack, cam.fx, cam.fy, cam.cx,
                cam.cy, n_levels=self.vos[default_idx[0]].n_levels,
                evict_width=self._ne, mesh=self._mesh_for(default_idx),
                mesh_axis=self.axis, **kw)
            frames = self._new_frames(default_idx, step.next.pyr, timestamp)
        self._mt_stack = step.mt
        self._pt_stack = step.pt_seeds
        self._ln_stack = step.ln_seeds
        for k, i in enumerate(default_idx):
            self.vos[i].last_frame = frames[k]
            self.vos[i].frame_id += 1
        self._bq.append((tuple(default_idx), frames, step))
        if len(self._bq) > self.depth:
            self._initiate_drain_batched(keep=1)
        # bookkeep a fetched window only once the next one is submitted
        self._complete_drains_batched(force=len(self._bfetch_q) > 1)
        if self._bready:
            for i, r in enumerate(self._bready.pop(0)):
                if results[i] is None:
                    results[i] = r
        return results

    def _queue_detection(self, vo: FrameHandlerMono, frame):
        """Record a deferred keyframe detection; returns a one-slot ref that
        _flush_detections fills with (stacked result, row)."""
        occ_uv, occ_ok = vo._occupancy_inputs(frame)
        ref = [None]
        self._det_q.append((frame, occ_uv, occ_ok, ref))
        return ref

    def detections_per_program(self) -> int:
        """Keyframe requests per batched detection program: as many as one
        K1 launch scores (its 32 images over the levels each request
        scores)."""
        return max(1, fast_score.MAX_IMAGES // self.cfg.pipeline.n_pyr_levels)

    def _flush_detections(self):
        """Every queued keyframe detection, detections_per_program()
        requests per batched program (one K1 launch each)."""
        pl = self.cfg.pipeline
        n_pyr = max(pl.n_pyr_levels, pl.n_pyr_levels_segs)
        R = self.detections_per_program()
        statics = self.vos[0]._detect_statics()
        while self._det_q:
            reqs, self._det_q = self._det_q[:R], self._det_q[R:]
            pyrs = tuple(torch.stack([r[0].pyr[lv] for r in reqs])
                         for lv in range(n_pyr))
            out = _kf_detect_program_batched(
                pyrs, self._dev(np.stack([r[1] for r in reqs])),
                self._dev(np.stack([r[2] for r in reqs])), **statics)
            for row, r in enumerate(reqs):
                r[3][0] = (out, row)

    def _queue_ba(self, blob, spec):
        """Record a local BA request; _flush_bas fills the ref with
        (stacked result, row)."""
        ref = [None]
        self._ba_q.append((blob, spec, ref))
        return ref

    def _flush_bas(self):
        """Solve the queued local BA problems, up to B same-spec windows
        per batched solve."""
        if not self._ba_q:
            return
        B = len(self.vos)
        pl = self.cfg.pipeline
        by_spec = {}
        for blob, spec, ref in self._ba_q:
            by_spec.setdefault(spec, []).append((blob, ref))
        self._ba_q = []
        for spec, reqs in by_spec.items():
            while reqs:
                batch, reqs = reqs[:B], reqs[B:]
                out, _ = ba_mod.bundle_adjust_blob_batched(
                    self._dev(np.stack([b for b, _ in batch])), spec=spec,
                    n_iter=pl.loba_num_iter, pose_prior=pl.loba_pose_prior,
                    accept_gate=False)
                handles = (out.kf_R, out.kf_t, out.lm_pos)
                for row, (_, ref) in enumerate(batch):
                    ref[0] = (handles, row)

    @staticmethod
    def _route_handles(handles):
        """Split handles into plain device tuples and refs into stacked
        batched results; returns (plain, groups, routes)."""
        plain, groups, gids, routes = [], [], {}, []
        for h in handles:
            if isinstance(h, list):  # a ref -> (stacked result, row)
                obj, row = h[0]
                gid = gids.setdefault(id(obj), len(groups))
                if gid == len(groups):
                    groups.append(obj)
                routes.append(("grp", gid, row))
            else:
                routes.append(("plain", len(plain)))
                plain.append(h)
        return plain, groups, routes

    @staticmethod
    def _resolve_routes(routes, plain_got, groups_got):
        return [plain_got[r[1]] if r[0] == "plain"
                else _row(groups_got[r[1]], r[2]) for r in routes]

    def _initiate_drain_batched(self, keep: int):
        """Stage 1: the oldest in-flight batched steps, the deferred
        keyframe detections and up to 4 local BA results go into ONE flat
        vector whose copy to the host starts now."""
        n = len(self._bq) - keep
        if n <= 0:
            return
        self._flush_detections()
        self._flush_bas()
        take, self._bq = self._bq[:n], self._bq[n:]
        pend, pend_ba = [], []
        for i, vo in enumerate(self.vos):
            pend += [(i, ent) for ent in vo._pending_seed_init]
            vo._pending_seed_init = []
            pend_ba += [(i, ent) for ent in vo._pending_ba]
            vo._pending_ba = []
        # at most 4 BA results per window, as the JAX package folds them;
        # the rest go back to their handler for the next window
        for i, ent in pend_ba[4:]:
            self.vos[i]._pending_ba.append(ent)
        pend_ba = pend_ba[:4]
        plain, det_groups, routes = self._route_handles(
            [ent[3] for _, ent in pend])
        ba_plain, ba_groups, ba_routes = self._route_handles(
            [h for _, (h, _) in pend_ba])
        flat, meta = fused.flatpack((
            [_fetch_parts(s) for _, _, s in take],
            plain, det_groups, ba_plain, ba_groups))
        self._bfetch_q.append(
            ([(didx, frames) for didx, frames, _ in take], pend, routes,
             pend_ba, ba_routes, fused.submit_fetch(flat), meta))

    def _complete_drains_batched(self, force: bool):
        """Stage 2a: unpack an arrived window when forced (exactly when the
        next one has been submitted, so the frame at which map updates land
        does not depend on the wall clock). BA write-backs and seed installs
        apply at once; the per-frame bookkeeping is queued and runs in
        chunks (stage 2b), so the device gets fresh dispatches between
        slices."""
        while self._bfetch_q and force:
            (entries, pend, routes, pend_ba, ba_routes, handle,
             meta) = self._bfetch_q.pop(0)
            got, plain_got, groups_got, ba_plain_got, ba_groups_got = \
                fused.flatunpack(handle.result(), meta)
            got = mesh_mod.unshard(got)
            ba_got = self._resolve_routes(ba_routes, ba_plain_got,
                                          ba_groups_got)
            for (i, (_, bmeta)), (kf_R, kf_t, lm_pos) in zip(pend_ba, ba_got):
                self.vos[i]._write_back_ba(kf_R, kf_t, lm_pos, bmeta)
            init_got = self._resolve_routes(routes, plain_got, groups_got)
            for (i, (kf_slot, dm, dmin, _)), fetched in zip(pend, init_got):
                vo = self.vos[i]
                if self._seeds_idx is not None and i in self._seeds_idx:
                    self._install_seed_hooks(vo, self._seeds_idx.index(i))
                try:
                    vo._complete_seed_init(kf_slot, dm, dmin, *fetched)
                finally:
                    self._remove_seed_hooks(vo)
            for (didx, frames), (res_f, ptc_b, lnc_b) in zip(entries, got):
                self._bbook_q.append((didx, frames, res_f, ptc_b, lnc_b))
            force = False
        self._process_book_chunk(self._book_chunk)

    def _process_book_chunk(self, n: int):
        """Stage 2b: host bookkeeping of up to n fetched frames."""
        while n and self._bbook_q:
            didx, frames, res_f, ptc_b, lnc_b = self._bbook_q.pop(0)
            rs = [None] * len(self.vos)
            for k, i in enumerate(didx):
                vo = self.vos[i]
                if vo.stage != STAGE_DEFAULT:
                    continue  # the successors of a failed frame are dropped
                r = self._finish_one(vo, k, frames[k], res_f, ptc_b, lnc_b)
                vo.results.append(r)
                rs[i] = r
            self._bready.append(rs)
            n -= 1
            if not self._bbook_q and self._bq:
                # _post_fused pointed last_frame at each finished frame;
                # the newest dispatched frame stays the alignment reference
                didx2, frames2 = self._bq[-1][0], self._bq[-1][1]
                for k, i in enumerate(didx2):
                    if self.vos[i].stage == STAGE_DEFAULT:
                        self.vos[i].last_frame = frames2[k]

    def _drain_all_batched(self):
        self._initiate_drain_batched(keep=0)
        while self._bfetch_q:
            self._complete_drains_batched(force=True)
        while self._bbook_q:
            self._process_book_chunk(len(self._bbook_q))

    def flush(self):
        """Finish every frame in flight (call at the end of the sequences).
        Returns the remaining per-call result lists in order."""
        if self.mode == "streams":
            tails = [vo.flush() for vo in self.vos]
            depth = max((len(t) for t in tails), default=0)
            return [[t[d] if d < len(t) else None for t in tails]
                    for d in range(depth)]
        if self._bq or self._bfetch_q:
            self._drain_all_batched()
        # BA results of the last window: one fetch for every sequence's
        self._flush_bas()
        pend = [(vo, ent) for vo in self.vos for ent in vo._pending_ba]
        for vo in self.vos:
            vo._pending_ba = []
        if pend:
            plain, groups, routes = self._route_handles([h for _, (h, _) in pend])
            plain_got, groups_got = fused.fetch((plain, groups))
            fetched = self._resolve_routes(routes, plain_got, groups_got)
            for (vo, (_, meta)), (kf_R, kf_t, lm_pos) in zip(pend, fetched):
                vo._write_back_ba(kf_R, kf_t, lm_pos, meta)
        out, self._bready = self._bready, []
        return out

    def sync_carry(self):
        """Pipelined vmap mode: apply every queued map delta to each
        sequence's row of the stacked carry now (as the next steps would)
        and return the per-sequence carries; after flush() each equals
        fused.map_tables_upload of its sequence's map. Where no chain of
        batched steps is live (before the first; once the batch has let go
        of its members; once a sequence has left DEFAULT, whose dropped
        steps wrote the stacked carry) the next batched step starts from
        full uploads, and so does every carry returned."""
        live = self._mt_stack is not None and all(
            vo.stage == STAGE_DEFAULT for vo in self.vos)
        carries = []
        for k, vo in enumerate(self.vos):
            m = vo.map
            if not live or m.mt_needs_resync(self._ne):
                mt = fused.map_tables_from_state(m)
                m.mt_mark_clean()
            else:
                mt = self._seq_row(self._mt_stack, k)
            while m.mt_dirty_pending():
                mt = fused.apply_mt_deltas(mt, self._dev(m.pack_mt_deltas(
                    fused.MT_DELTA_DP, fused.MT_DELTA_DL, fused.MT_DELTA_OP,
                    fused.MT_DELTA_OL, self._ne)), NE=self._ne)
            carries.append(mt)
        if live:
            self._mt_stack = fused.stack_trees(carries)
        return carries

    @property
    def stages(self):
        return [vo.stage for vo in self.vos]
