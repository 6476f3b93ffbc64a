"""Fixed-capacity SoA state for frames, keyframes and landmarks.

Port of `plsvo_tpu/pipeline/state.py`. Bookkeeping lives on the host in
numpy (copied from the JAX package so the host decisions match, float64
intermediates included); pyramids and the cached device copies of the
tables are torch tensors on the handler's device. In pipelined mode the
map tables live on the device as a carry (`fused.MapTables`), and the host
mutators queue their changes for one packed delta blob per frame
(`MapState.pack_mt_deltas`, applied by `fused.apply_mt_deltas`).

Two divergences from the JAX package, both on the carry path:
- `remove_keyframe` queues every landmark row whose status or anchor the
  eviction changes; the JAX package queues none, so its carry keeps
  deleted rows alive and anchors on the evicted keyframe.
- `pack_mt_deltas` never asserts on the number of queued evictions: the
  handler sizes the eviction list from max(MT_DELTA_NE, max_kfs,
  2 x pipeline_depth) (`fused.mt_evict_width`), which its drains never
  exceed. A narrower list that would spill sets `_mt_overflow`, as
  `transform` does, and the handler then resyncs the carry in full.

Landmark status: 0 = DELETED, 1 = CANDIDATE, 2 = UNKNOWN, 3 = GOOD
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from plsvo_torch.config import Config
from plsvo_torch.device import resolve_device

ST_DELETED = 0
ST_CANDIDATE = 1
ST_UNKNOWN = 2
ST_GOOD = 3


@dataclass
class FrameState:
    """One processed frame (host tables; the pyramid is on the device)."""

    frame_id: int
    timestamp: float
    pyr: List[torch.Tensor]
    R_f_w: np.ndarray
    t_f_w: np.ndarray
    pt_uv: np.ndarray
    pt_f: np.ndarray
    pt_level: np.ndarray
    pt_lm: np.ndarray
    pt_valid: np.ndarray
    seg_suv: np.ndarray
    seg_euv: np.ndarray
    seg_sf: np.ndarray
    seg_ef: np.ndarray
    seg_line: np.ndarray
    seg_level: np.ndarray
    seg_lm: np.ndarray
    seg_valid: np.ndarray
    cov: np.ndarray = field(default_factory=lambda: np.eye(6, dtype=np.float32))
    is_keyframe: bool = False

    @classmethod
    def empty(cls, cfg: Config, frame_id: int, timestamp: float, pyr,
              R: np.ndarray, t: np.ndarray):
        F = cfg.caps.max_fts
        G = cfg.caps.max_segs
        return cls(
            frame_id=frame_id, timestamp=timestamp, pyr=pyr,
            R_f_w=R.astype(np.float32), t_f_w=t.astype(np.float32),
            pt_uv=np.zeros((F, 2), np.float32), pt_f=np.zeros((F, 3), np.float32),
            pt_level=np.zeros(F, np.int32), pt_lm=np.full(F, -1, np.int32),
            pt_valid=np.zeros(F, bool),
            seg_suv=np.zeros((G, 2), np.float32), seg_euv=np.zeros((G, 2), np.float32),
            seg_sf=np.zeros((G, 3), np.float32), seg_ef=np.zeros((G, 3), np.float32),
            seg_line=np.zeros((G, 3), np.float32), seg_level=np.zeros(G, np.int32),
            seg_lm=np.full(G, -1, np.int32), seg_valid=np.zeros(G, bool))

    def cam_center_w(self) -> np.ndarray:
        return -self.R_f_w.T @ self.t_f_w

    def n_pt(self) -> int:
        return int((self.pt_valid & (self.pt_lm >= 0)).sum())

    def n_seg(self) -> int:
        return int((self.seg_valid & (self.seg_lm >= 0)).sum())


@dataclass
class MapState:
    """Keyframes + landmark tables (host numpy) with cached device copies."""

    cfg: Config
    n_levels: int
    img_shape: tuple
    intrinsics: tuple = (1.0, 1.0, 0.0, 0.0)
    device: object = None  # None: the card (resolve_device)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        caps = self.cfg.caps
        K = caps.max_kfs
        P = caps.max_points
        L = caps.max_lines
        O = caps.max_obs_per_landmark
        F = caps.max_fts
        G = caps.max_segs
        H, W = self.img_shape
        self.kf_occupied = np.zeros(K, bool)
        self.kf_frame_id = np.full(K, -1, np.int64)
        self.kf_R = np.tile(np.eye(3, dtype=np.float32)[None], (K, 1, 1))
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_key_lms = np.full((K, 5), -1, np.int32)
        self.kf_pyr: List[torch.Tensor] = [
            torch.zeros((K, H >> l, W >> l), dtype=torch.float32,
                        device=self.device) for l in range(self.n_levels)]
        self.kf_pt_uv = np.zeros((K, F, 2), np.float32)
        self.kf_pt_f = np.zeros((K, F, 3), np.float32)
        self.kf_pt_level = np.zeros((K, F), np.int32)
        self.kf_pt_lm = np.full((K, F), -1, np.int32)
        self.kf_seg_suv = np.zeros((K, G, 2), np.float32)
        self.kf_seg_euv = np.zeros((K, G, 2), np.float32)
        self.kf_seg_sf = np.zeros((K, G, 3), np.float32)
        self.kf_seg_ef = np.zeros((K, G, 3), np.float32)
        self.kf_seg_level = np.zeros((K, G), np.int32)
        self.kf_seg_lm = np.full((K, G), -1, np.int32)

        self.pt_pos = np.zeros((P, 3), np.float32)
        self.pt_status = np.zeros(P, np.int8)
        self.pt_n_succ = np.zeros(P, np.int32)
        self.pt_n_fail = np.zeros(P, np.int32)
        self.pt_last_optim = np.full(P, -1, np.int64)
        self.pt_anchor_kf = np.full(P, -1, np.int32)
        self.pt_anchor_uv = np.zeros((P, 2), np.float32)
        self.pt_anchor_f = np.zeros((P, 3), np.float32)
        self.pt_anchor_level = np.zeros(P, np.int32)
        self.pt_anchor_type = np.zeros(P, np.int32)
        self.pt_anchor_dir = np.zeros((P, 2), np.float32)
        self.pt_obs_kf = np.full((P, O), -1, np.int32)
        self.pt_obs_f = np.zeros((P, O, 3), np.float32)
        self.pt_obs_uv = np.zeros((P, O, 2), np.float32)
        self.pt_obs_level = np.zeros((P, O), np.int32)
        self.pt_obs_ptr = np.zeros(P, np.int32)
        self.pt_obs_stamp = np.full((P, O), -1, np.int64)

        self.ln_spos = np.zeros((L, 3), np.float32)
        self.ln_epos = np.zeros((L, 3), np.float32)
        self.ln_status = np.zeros(L, np.int8)
        self.ln_n_succ = np.zeros(L, np.int32)
        self.ln_n_fail = np.zeros(L, np.int32)
        self.ln_last_optim = np.full(L, -1, np.int64)
        self.ln_anchor_kf = np.full(L, -1, np.int32)
        self.ln_anchor_suv = np.zeros((L, 2), np.float32)
        self.ln_anchor_euv = np.zeros((L, 2), np.float32)
        self.ln_anchor_sf = np.zeros((L, 3), np.float32)
        self.ln_anchor_ef = np.zeros((L, 3), np.float32)
        self.ln_anchor_level = np.zeros(L, np.int32)
        self.ln_obs_kf = np.full((L, O), -1, np.int32)
        self.ln_obs_sf = np.zeros((L, O, 3), np.float32)
        self.ln_obs_ef = np.zeros((L, O, 3), np.float32)
        self.ln_obs_ptr = np.zeros(L, np.int32)
        self.ln_obs_stamp = np.full((L, O), -1, np.int64)

        # device copies of host tables, cached until invalidated; the obs
        # tables sync by dirty rows instead of a full upload
        self._dev: dict = {}
        self._dev_obs: dict = {}
        self._obs_dirty = {"pt": set(), "ln": set()}
        # carry delta queues (pipelined mode): dicts double as ordered sets,
        # so rows ship in the order they were queued
        self._mt_dirty = {"pt": {}, "ln": {}}  # landmark rows to resend whole
        self._mt_obs_delta = {"pt": {}, "ln": {}}  # (row, slot) obs writes
        self._mt_obs_reset = {"pt": set(), "ln": set()}  # rows whose obs clear
        self._mt_evicted: list = []  # evicted keyframe slots
        self._mt_overflow = False  # a change the deltas cannot express

    _OBS_GROUPS = {
        "pt": ("pt_obs_kf", "pt_obs_uv", "pt_obs_f", "pt_obs_level"),
        "ln": ("ln_obs_kf", "ln_obs_sf", "ln_obs_ef"),
    }

    def _to_dev(self, a):
        """A device copy of a host table: always a copy, never a view (on
        the CPU a view would let in-place device edits, such as
        _obs_clear_kf_on_device, write through to the host mirror)."""
        return torch.tensor(np.asarray(a), device=self.device)

    def dev(self, name: str):
        """Device copy of a host table, cached until invalidated."""
        if name not in self._dev:
            self._dev[name] = self._to_dev(getattr(self, name))
        return self._dev[name]

    def _sync_obs(self, group: str):
        names = self._OBS_GROUPS[group]
        if names[0] not in self._dev_obs:
            for n in names:
                self._dev_obs[n] = self._to_dev(getattr(self, n))
            self._obs_dirty[group].clear()
            return
        dirty = self._obs_dirty[group]
        if dirty:
            rows = np.fromiter(dirty, np.int64, len(dirty))
            r = self._to_dev(rows)
            for n in names:
                self._dev_obs[n][r] = self._to_dev(getattr(self, n)[rows])
            dirty.clear()

    def dev_obs(self, name: str):
        """Device copy of an observation table, synced by dirty rows."""
        self._sync_obs("pt" if name.startswith("pt") else "ln")
        return self._dev_obs[name]

    def _obs_clear_kf_on_device(self, slot: int):
        for kf_name in ("pt_obs_kf", "ln_obs_kf"):
            if kf_name in self._dev_obs:
                a = self._dev_obs[kf_name]
                a[a == slot] = -1

    # ---- carry deltas (layout: fused.apply_mt_deltas) ----
    def mark_mt_dirty(self, kind: str, rows):
        """Queue landmark rows ("pt" or "ln") for a whole-row resend to the
        device carry."""
        d = self._mt_dirty[kind]
        for r in np.atleast_1d(np.asarray(rows, np.int64)):
            d[int(r)] = None

    def mt_mark_clean(self):
        """Drop every queued delta: the carry is being rebuilt from a full
        upload of the mirror, which already holds them."""
        for d in self._mt_dirty.values():
            d.clear()
        for d in self._mt_obs_delta.values():
            d.clear()
        for s in self._mt_obs_reset.values():
            s.clear()
        self._mt_evicted = []
        self._mt_overflow = False

    def mt_dirty_pending(self) -> int:
        return (sum(len(d) for d in self._mt_dirty.values())
                + sum(len(d) for d in self._mt_obs_delta.values())
                + len(self._mt_evicted))

    def mt_needs_resync(self, NE: int) -> bool:
        """True when the queued changes cannot ride delta blobs of eviction
        width NE: a map-wide transform, or more evictions than one blob
        holds (a spilled eviction sweep would clear observations that an
        earlier blob installed in a reused slot)."""
        return self._mt_overflow or len(self._mt_evicted) > NE

    def pack_mt_deltas(self, DP: int, DL: int, OP: int, OL: int,
                       NE: int) -> np.ndarray:
        """Drain up to the given widths from the queues into ONE flat f32
        blob, the JAX package's layout. Rows are whole-row snapshots of the
        mirror taken now, so a row that does not fit waits for the next
        blob without harm. Evictions never spill: with more than NE queued
        the blob carries none of them and `_mt_overflow` is set, so the
        handler resyncs the carry in full before its next step."""
        def drain(d, n, skip=None):
            # skip: obs writes of a row whose obs reset has not shipped
            # wait for it, or the later reset would wipe them
            keys = []
            for k in d:
                if len(keys) >= n:
                    break
                if skip is not None and k[0] in skip:
                    continue
                keys.append(k)
            for k in keys:
                del d[k]
            return keys

        ev = np.full(NE, -1, np.float32)
        if len(self._mt_evicted) > NE:
            self._mt_overflow = True
        else:
            ev[:len(self._mt_evicted)] = self._mt_evicted
            self._mt_evicted = []
        parts = [ev, self.kf_R.ravel().astype(np.float32),
                 self.kf_t.ravel().astype(np.float32)]

        def rows_part(kind, width, tables):
            rows = np.asarray(drain(self._mt_dirty[kind], width), np.int64)
            n = len(rows)
            idx = np.zeros(width, np.float32)
            idx[:n] = rows
            mask = np.zeros(width, np.float32)
            mask[:n] = 1.0
            reset = np.zeros(width, np.float32)
            rs = self._mt_obs_reset[kind]
            reset[:n] = [1.0 if int(r) in rs else 0.0 for r in rows]
            rs.difference_update(int(r) for r in rows)
            out = [idx, mask, reset]
            for tab in tables:
                col = np.zeros((width,) + tab.shape[1:], np.float32)
                col[:n] = tab[rows]
                out.append(col.ravel())
            return out

        parts += rows_part("pt", DP, (
            self.pt_pos, self.pt_status, self.pt_anchor_kf, self.pt_anchor_uv,
            self.pt_anchor_f, self.pt_anchor_level, self.pt_anchor_type,
            self.pt_anchor_dir))
        parts += rows_part("ln", DL, (
            self.ln_spos, self.ln_epos, self.ln_status, self.ln_anchor_kf,
            self.ln_anchor_suv, self.ln_anchor_euv, self.ln_anchor_sf,
            self.ln_anchor_ef, self.ln_anchor_level))

        def obs_part(kind, width, tables):
            pairs = drain(self._mt_obs_delta[kind], width,
                          skip=self._mt_obs_reset[kind])
            n = len(pairs)
            r = np.asarray([p[0] for p in pairs], np.int64)
            s = np.asarray([p[1] for p in pairs], np.int64)
            head = np.zeros((3, width), np.float32)
            head[0, :n], head[1, :n], head[2, :n] = r, s, 1.0
            out = list(head)
            for tab in tables:
                col = np.zeros((width,) + tab.shape[2:], np.float32)
                col[:n] = tab[r, s]
                out.append(col.ravel())
            return out

        parts += obs_part("pt", OP, (self.pt_obs_kf, self.pt_obs_uv,
                                     self.pt_obs_f, self.pt_obs_level))
        parts += obs_part("ln", OL, (self.ln_obs_kf, self.ln_obs_sf,
                                     self.ln_obs_ef))
        return np.concatenate(parts)

    def kf_atlas_flat(self, n_levels: int):
        """Flat-packed keyframe pyramid atlas, cached until the next keyframe
        install/removal."""
        key = f"_kf_atlas_flat_{n_levels}"
        if key not in self._dev:
            from plsvo_torch.image import pack_pyramid_atlas_flat

            self._dev[key] = pack_pyramid_atlas_flat(self.kf_pyr[:n_levels])
        return self._dev[key]

    def invalidate(self, *names: str):
        if not names:
            self._dev.clear()
        for n in names:
            self._dev.pop(n, None)

    # ---- keyframe management -------------------------------------------
    def n_keyframes(self) -> int:
        return int(self.kf_occupied.sum())

    def free_kf_slot(self) -> Optional[int]:
        free = np.where(~self.kf_occupied)[0]
        return int(free[0]) if len(free) else None

    def _kf_centers(self, occ):
        return np.stack([-self.kf_R[k].T @ self.kf_t[k] for k in occ])

    def furthest_kf_slot(self, pos_w: np.ndarray) -> Optional[int]:
        occ = np.where(self.kf_occupied)[0]
        if len(occ) == 0:
            return None
        d = np.linalg.norm(self._kf_centers(occ) - pos_w[None], axis=-1)
        return int(occ[np.argmax(d)])

    def closest_kf_slot(self, pos_w: np.ndarray) -> Optional[int]:
        occ = np.where(self.kf_occupied)[0]
        if len(occ) == 0:
            return None
        d = np.linalg.norm(self._kf_centers(occ) - pos_w[None], axis=-1)
        return int(occ[np.argmin(d)])

    def _set_key_landmarks(self, slot: int, frame: FrameState):
        """The 5 key landmarks of a new keyframe: centre-most + the 4
        quadrant extremes by |du*dv|."""
        W2 = self.img_shape[1] / 2.0
        H2 = self.img_shape[0] / 2.0
        self.kf_key_lms[slot] = -1
        sel = (frame.pt_valid & (frame.pt_lm >= 0)
               & ~self._deleted(self.pt_status, frame.pt_lm))
        if not sel.any():
            return
        uv = frame.pt_uv[sel]
        lm = frame.pt_lm[sel]
        du = uv[:, 0] - W2
        dv = uv[:, 1] - H2
        self.kf_key_lms[slot, 0] = lm[np.argmin(np.maximum(np.abs(du),
                                                           np.abs(dv)))]
        quads = [(du >= 0) & (dv >= 0), (du >= 0) & (dv < 0),
                 (du < 0) & (dv < 0), (du < 0) & (dv >= 0)]
        for q, m in enumerate(quads):
            if m.any():
                idx = np.where(m)[0]
                self.kf_key_lms[slot, 1 + q] = lm[idx[np.argmax(du[idx] * dv[idx])]]

    def overlap_kfs(self, R_f_w, t_f_w, fx, fy, cx, cy):
        """[(slot, distance)] of keyframes with a live key landmark that
        projects inside the query frame."""
        H, W = self.img_shape
        pos_q = -R_f_w.T @ t_f_w
        out = []
        for k in np.where(self.kf_occupied)[0]:
            lms = self.kf_key_lms[k]
            lms = lms[(lms >= 0)]
            lms = lms[self.pt_status[lms] > 0] if len(lms) else lms
            if len(lms) == 0:
                continue
            xyz = self.pt_pos[lms] @ R_f_w.T + t_f_w
            z = xyz[:, 2]
            front = z > 0
            zs = np.where(front, z, 1.0)
            u = fx * xyz[:, 0] / zs + cx
            v = fy * xyz[:, 1] / zs + cy
            if (front & (u >= 0) & (v >= 0) & (u < W) & (v < H)).any():
                center_k = -self.kf_R[k].T @ self.kf_t[k]
                out.append((int(k), float(np.linalg.norm(center_k - pos_q))))
        return out

    def closest_overlap_kf_slot(self, R_f_w, t_f_w, fx, fy, cx, cy,
                                exclude_frame_id: int = -1) -> Optional[int]:
        cands = [(k, d) for (k, d) in self.overlap_kfs(R_f_w, t_f_w, fx, fy,
                                                         cx, cy)
                 if self.kf_frame_id[k] != exclude_frame_id]
        if not cands:
            return self.closest_kf_slot(-R_f_w.T @ t_f_w)
        return min(cands, key=lambda kd: kd[1])[0]

    def add_keyframe(self, frame: FrameState) -> int:
        """Install a frame into a free keyframe slot (eviction by caller).

        The eviction that makes room may delete landmarks this frame
        observes (they had no other observation left): the keyframe keeps
        no link to those, as remove_keyframe clears every other keyframe's
        links to them. (The JAX package links them, so a keyframe feature
        can end up on a deleted row, and on an unrelated landmark once the
        row is reused.)"""
        slot = self.free_kf_slot()
        assert slot is not None, "no free keyframe slot — evict first"
        self.kf_occupied[slot] = True
        self.kf_frame_id[slot] = frame.frame_id
        self.kf_R[slot] = frame.R_f_w
        self.kf_t[slot] = frame.t_f_w
        self.invalidate()
        for P, f in zip(self.kf_pyr, frame.pyr[: self.n_levels]):
            P[slot] = f
        self.kf_pt_uv[slot] = frame.pt_uv
        self.kf_pt_f[slot] = frame.pt_f
        self.kf_pt_level[slot] = frame.pt_level
        pt_link = frame.pt_valid & ~self._deleted(self.pt_status, frame.pt_lm)
        seg_link = frame.seg_valid & ~self._deleted(self.ln_status, frame.seg_lm)
        self.kf_pt_lm[slot] = np.where(pt_link, frame.pt_lm, -1)
        self.kf_seg_suv[slot] = frame.seg_suv
        self.kf_seg_euv[slot] = frame.seg_euv
        self.kf_seg_sf[slot] = frame.seg_sf
        self.kf_seg_ef[slot] = frame.seg_ef
        self.kf_seg_level[slot] = frame.seg_level
        self.kf_seg_lm[slot] = np.where(seg_link, frame.seg_lm, -1)

        sel = np.where(pt_link & (frame.pt_lm >= 0))[0]
        if len(sel):
            lm, first = np.unique(frame.pt_lm[sel], return_index=True)
            sel = sel[first]
            slots = self._obs_slots_vec(self.pt_obs_kf[lm], self.pt_obs_stamp[lm])
            self.pt_obs_kf[lm, slots] = slot
            self.pt_obs_f[lm, slots] = frame.pt_f[sel]
            self.pt_obs_uv[lm, slots] = frame.pt_uv[sel]
            self.pt_obs_level[lm, slots] = frame.pt_level[sel]
            self.pt_obs_stamp[lm, slots] = self.pt_obs_ptr[lm]
            self.pt_obs_ptr[lm] += 1
            self.pt_anchor_kf[lm] = slot
            self.pt_anchor_uv[lm] = frame.pt_uv[sel]
            self.pt_anchor_f[lm] = frame.pt_f[sel]
            self.pt_anchor_level[lm] = frame.pt_level[sel]
            self._obs_dirty["pt"].update(lm.tolist())
            self._queue_kf_obs("pt", lm, slots)
        sel = np.where(seg_link & (frame.seg_lm >= 0))[0]
        if len(sel):
            lm, first = np.unique(frame.seg_lm[sel], return_index=True)
            sel = sel[first]
            slots = self._obs_slots_vec(self.ln_obs_kf[lm], self.ln_obs_stamp[lm])
            self.ln_obs_kf[lm, slots] = slot
            self.ln_obs_sf[lm, slots] = frame.seg_sf[sel]
            self.ln_obs_ef[lm, slots] = frame.seg_ef[sel]
            self.ln_obs_stamp[lm, slots] = self.ln_obs_ptr[lm]
            self.ln_obs_ptr[lm] += 1
            self.ln_anchor_kf[lm] = slot
            self.ln_anchor_suv[lm] = frame.seg_suv[sel]
            self.ln_anchor_euv[lm] = frame.seg_euv[sel]
            self.ln_anchor_sf[lm] = frame.seg_sf[sel]
            self.ln_anchor_ef[lm] = frame.seg_ef[sel]
            self.ln_anchor_level[lm] = frame.seg_level[sel]
            self._obs_dirty["ln"].update(lm.tolist())
            self._queue_kf_obs("ln", lm, slots)
        self._set_key_landmarks(slot, frame)
        return slot

    @staticmethod
    def _deleted(status, lm):
        """Features linked to a deleted landmark row."""
        return (lm >= 0) & (status[np.maximum(lm, 0)] == ST_DELETED)

    def _queue_kf_obs(self, kind, rows, slots):
        """Queue a keyframe install's anchor refresh (whole rows) and its
        observation appends for the carry."""
        d, od = self._mt_dirty[kind], self._mt_obs_delta[kind]
        for r, s in zip(rows.tolist(), slots.tolist()):
            d[r] = None
            od[(r, s)] = None

    @staticmethod
    def _obs_slots_vec(obs_kf_rows, stamp_rows):
        """First FREE slot per row, else the oldest live observation."""
        free = obs_kf_rows < 0
        return np.where(free.any(axis=1), np.argmax(free, axis=1),
                        np.argmin(stamp_rows, axis=1))

    def remove_keyframe(self, slot: int):
        """Evict a keyframe with reference-counting landmark deletion; live
        landmarks anchored there re-anchor to their most recent live obs.
        For the carry: one in-graph sweep clears the slot's observations,
        and every landmark row whose status or anchor changes here is
        queued whole (the JAX package queues none of them)."""
        self.kf_occupied[slot] = False
        self.kf_frame_id[slot] = -1
        self.kf_pt_lm[slot] = -1
        self.kf_seg_lm[slot] = -1
        self.kf_key_lms[slot] = -1
        self.invalidate()
        self._obs_clear_kf_on_device(slot)
        self._mt_evicted.append(int(slot))
        # queued obs writes into the dead slot would re-install stale
        # keyframe ids; the mirror already holds -1 there
        for kind, kf_tab in (("pt", self.pt_obs_kf), ("ln", self.ln_obs_kf)):
            dd = self._mt_obs_delta[kind]
            for key in [k for k in dd if kf_tab[k] == slot]:
                del dd[key]
        observed_here = (self.pt_obs_kf == slot).any(axis=1)
        n_obs = (self.pt_obs_kf >= 0).sum(axis=1)
        live = self.pt_status > 0
        dead = live & observed_here & (n_obs <= 2)
        self.pt_status[dead] = ST_DELETED
        self.pt_obs_stamp[self.pt_obs_kf == slot] = -1
        self.pt_obs_kf[self.pt_obs_kf == slot] = -1
        need = live & ~dead & (self.pt_anchor_kf == slot)
        for r in np.where(need)[0]:
            oks = np.where((self.pt_obs_kf[r] >= 0)
                           & self.kf_occupied[np.maximum(self.pt_obs_kf[r], 0)])[0]
            if len(oks) == 0:
                self.pt_status[r] = ST_DELETED
                dead[r] = True
                continue
            o = oks[np.argmax(self.pt_obs_stamp[r, oks])]
            self.pt_anchor_kf[r] = self.pt_obs_kf[r, o]
            self.pt_anchor_uv[r] = self.pt_obs_uv[r, o]
            self.pt_anchor_f[r] = self.pt_obs_f[r, o]
            self.pt_anchor_level[r] = self.pt_obs_level[r, o]
        # lines: the obs store bearings only; the anchor uvs are the
        # endpoints projected into the new anchor keyframe
        lobserved = (self.ln_obs_kf == slot).any(axis=1)
        ln_obs = (self.ln_obs_kf >= 0).sum(axis=1)
        llive = self.ln_status > 0
        ldead = llive & lobserved & (ln_obs <= 2)
        self.ln_status[ldead] = ST_DELETED
        self.ln_obs_stamp[self.ln_obs_kf == slot] = -1
        self.ln_obs_kf[self.ln_obs_kf == slot] = -1
        lneed = llive & ~ldead & (self.ln_anchor_kf == slot)
        fx, fy, cx, cy = self.intrinsics
        for r in np.where(lneed)[0]:
            oks = np.where((self.ln_obs_kf[r] >= 0)
                           & self.kf_occupied[np.maximum(self.ln_obs_kf[r], 0)])[0]
            if len(oks) == 0:
                self.ln_status[r] = ST_DELETED
                ldead[r] = True
                continue
            o = oks[np.argmax(self.ln_obs_stamp[r, oks])]
            k = self.ln_obs_kf[r, o]
            self.ln_anchor_kf[r] = k
            self.ln_anchor_sf[r] = self.ln_obs_sf[r, o]
            self.ln_anchor_ef[r] = self.ln_obs_ef[r, o]
            for pos, tgt in ((self.ln_spos[r], self.ln_anchor_suv),
                             (self.ln_epos[r], self.ln_anchor_euv)):
                xyz = self.kf_R[k] @ pos + self.kf_t[k]
                z = max(float(xyz[2]), 1e-6)
                tgt[r] = (fx * xyz[0] / z + cx, fy * xyz[1] / z + cy)
        # deleted or re-anchored rows (need holds both kinds)
        self.mark_mt_dirty("pt", np.where(dead | need)[0])
        self.mark_mt_dirty("ln", np.where(ldead | lneed)[0])
        if dead.any():
            self.kf_pt_lm[np.isin(self.kf_pt_lm, np.where(dead)[0])] = -1
        if ldead.any():
            self.kf_seg_lm[np.isin(self.kf_seg_lm, np.where(ldead)[0])] = -1

    @staticmethod
    def _obs_slot(obs_kf_row, stamp_row):
        free = np.where(obs_kf_row < 0)[0]
        if len(free):
            return int(free[0])
        return int(np.argmin(stamp_row))

    def _add_pt_obs(self, lm: int, kf_slot: int, f, uv=None, level: int = 0):
        p = self._obs_slot(self.pt_obs_kf[lm], self.pt_obs_stamp[lm])
        self.pt_obs_kf[lm, p] = kf_slot
        self.pt_obs_f[lm, p] = f
        if uv is not None:
            self.pt_obs_uv[lm, p] = uv
        self.pt_obs_level[lm, p] = level
        self.pt_obs_stamp[lm, p] = self.pt_obs_ptr[lm]
        self.pt_obs_ptr[lm] += 1
        self._obs_dirty["pt"].add(int(lm))
        self._mt_obs_delta["pt"][(int(lm), int(p))] = None

    def _add_ln_obs(self, lm: int, kf_slot: int, sf, ef):
        p = self._obs_slot(self.ln_obs_kf[lm], self.ln_obs_stamp[lm])
        self.ln_obs_kf[lm, p] = kf_slot
        self.ln_obs_sf[lm, p] = sf
        self.ln_obs_ef[lm, p] = ef
        self.ln_obs_stamp[lm, p] = self.ln_obs_ptr[lm]
        self.ln_obs_ptr[lm] += 1
        self._obs_dirty["ln"].add(int(lm))
        self._mt_obs_delta["ln"][(int(lm), int(p))] = None

    def alloc_points(self, n: int) -> np.ndarray:
        return np.where(self.pt_status == ST_DELETED)[0][:n]

    def alloc_lines(self, n: int) -> np.ndarray:
        return np.where(self.ln_status == ST_DELETED)[0][:n]

    def new_point(self, pos_w, kf_slot, uv, f, level, status=ST_UNKNOWN,
                  ftype: int = 0, grad_dir=None) -> int:
        rows = self.alloc_points(1)
        if len(rows) == 0:
            return -1
        r = int(rows[0])
        self.pt_pos[r] = pos_w
        self.pt_status[r] = status
        self.pt_n_succ[r] = 0
        self.pt_n_fail[r] = 0
        self.pt_last_optim[r] = -1
        self.pt_anchor_kf[r] = kf_slot
        self.pt_anchor_uv[r] = uv
        self.pt_anchor_f[r] = f
        self.pt_anchor_level[r] = level
        self.pt_anchor_type[r] = ftype
        self.pt_anchor_dir[r] = (0.0, 0.0) if grad_dir is None else grad_dir
        self.pt_obs_kf[r] = -1
        self.pt_obs_stamp[r] = -1
        self.pt_obs_ptr[r] = 0
        self._obs_dirty["pt"].add(r)
        self._mt_dirty["pt"][r] = None
        self._mt_obs_reset["pt"].add(r)
        self._add_pt_obs(r, kf_slot, f, uv, level)
        self.invalidate("pt_pos", "pt_status", "pt_anchor_kf", "pt_anchor_uv",
                        "pt_anchor_f", "pt_anchor_level", "pt_anchor_type",
                        "pt_anchor_dir")
        return r

    def new_line(self, spos_w, epos_w, kf_slot, suv, euv, sf, ef, level,
                 status=ST_UNKNOWN) -> int:
        rows = self.alloc_lines(1)
        if len(rows) == 0:
            return -1
        r = int(rows[0])
        self.ln_spos[r] = spos_w
        self.ln_epos[r] = epos_w
        self.ln_status[r] = status
        self.ln_n_succ[r] = 0
        self.ln_n_fail[r] = 0
        self.ln_last_optim[r] = -1
        self.ln_anchor_kf[r] = kf_slot
        self.ln_anchor_suv[r] = suv
        self.ln_anchor_euv[r] = euv
        self.ln_anchor_sf[r] = sf
        self.ln_anchor_ef[r] = ef
        self.ln_anchor_level[r] = level
        self.ln_obs_kf[r] = -1
        self.ln_obs_stamp[r] = -1
        self.ln_obs_ptr[r] = 0
        self._obs_dirty["ln"].add(r)
        self._mt_dirty["ln"][r] = None
        self._mt_obs_reset["ln"].add(r)
        self._add_ln_obs(r, kf_slot, sf, ef)
        self.invalidate("ln_spos", "ln_epos", "ln_status", "ln_anchor_kf",
                        "ln_anchor_suv", "ln_anchor_euv", "ln_anchor_sf",
                        "ln_anchor_ef", "ln_anchor_level")
        return r

    def scene_depth(self, frame: FrameState):
        """Median + min depth of the frame's landmark observations (points
        and both endpoints of each line)."""
        Rz, tz = frame.R_f_w[2], frame.t_f_w[2]
        parts = []
        pv = frame.pt_valid & (frame.pt_lm >= 0)
        if pv.any():
            z = self.pt_pos[frame.pt_lm[pv]] @ Rz + tz
            parts.append(z[z > 0])
        sv = frame.seg_valid & (frame.seg_lm >= 0)
        if sv.any():
            for tbl in (self.ln_spos, self.ln_epos):
                z = tbl[frame.seg_lm[sv]] @ Rz + tz
                parts.append(z[z > 0])
        d = np.concatenate(parts) if parts else np.zeros(0)
        if len(d) == 0:
            return None, None
        return float(np.median(d)), float(d.min())

    def transform(self, R: np.ndarray, t: np.ndarray, s: float):
        """Similarity transform of the whole map: keyframe poses and live
        landmarks. The carry cannot take it as deltas, so it is resynced."""
        self._mt_overflow = True
        for k in np.where(self.kf_occupied)[0]:
            Rk, tk = self.kf_R[k], self.kf_t[k]
            self.kf_R[k] = Rk @ R.T
            self.kf_t[k] = s * tk - Rk @ R.T @ t
        act = self.pt_status > 0
        self.pt_pos[act] = s * (self.pt_pos[act] @ R.T) + t
        actl = self.ln_status > 0
        self.ln_spos[actl] = s * (self.ln_spos[actl] @ R.T) + t
        self.ln_epos[actl] = s * (self.ln_epos[actl] @ R.T) + t
        self.invalidate()


def validate_map(m: MapState) -> List[str]:
    """Consistency checker; returns violation strings (empty = consistent)."""
    errs = []
    K = m.cfg.caps.max_kfs
    for k in np.where(m.kf_occupied)[0]:
        for i, lm in enumerate(m.kf_pt_lm[k]):
            if lm >= 0 and m.pt_status[lm] == ST_DELETED:
                errs.append(f"kf{k} pt feature {i} -> deleted landmark {lm}")
        for i, lm in enumerate(m.kf_seg_lm[k]):
            if lm >= 0 and m.ln_status[lm] == ST_DELETED:
                errs.append(f"kf{k} seg feature {i} -> deleted landmark {lm}")
    for r in np.where(m.pt_status > 0)[0]:
        a = m.pt_anchor_kf[r]
        if a < 0 or a >= K or not m.kf_occupied[a]:
            errs.append(f"point {r} anchor kf {a} not occupied")
    for r in np.where(m.ln_status > 0)[0]:
        a = m.ln_anchor_kf[r]
        if a < 0 or a >= K or not m.kf_occupied[a]:
            errs.append(f"line {r} anchor kf {a} not occupied")
    for r in np.where(m.pt_status > 0)[0]:
        for k in m.pt_obs_kf[r]:
            if k >= 0 and not m.kf_occupied[k]:
                errs.append(f"point {r} obs kf {k} not occupied")
    if not np.isfinite(m.pt_pos[m.pt_status > 0]).all():
        errs.append("non-finite point positions")
    if not (np.isfinite(m.ln_spos[m.ln_status > 0]).all()
            and np.isfinite(m.ln_epos[m.ln_status > 0]).all()):
        errs.append("non-finite line positions")
    return errs


def map_statistics(m: MapState) -> dict:
    return {
        "n_keyframes": int(m.kf_occupied.sum()),
        "n_points": int((m.pt_status > 0).sum()),
        "n_points_good": int((m.pt_status == ST_GOOD).sum()),
        "n_points_candidate": int((m.pt_status == ST_CANDIDATE).sum()),
        "n_lines": int((m.ln_status > 0).sum()),
        "n_lines_good": int((m.ln_status == ST_GOOD).sum()),
    }
