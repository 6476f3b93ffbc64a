"""FrameHandlerMono: the tracking pipeline stage machine.

Port of `plsvo_tpu/pipeline/frame_handler.py`:

  add_image
    FIRST   -> detect features, first keyframe
    SECOND  -> KLT + homography bootstrap
    DEFAULT -> one device step (align -> reproject -> pose opt -> structure
               opt -> seed update), one result fetch, host bookkeeping,
               keyframe decision; at keyframes new seeds, then windowed
               local BA
    RELOC   -> align against the closest keyframe

Both execution modes run on a pinhole camera, with points, edgelets and
line segments, line-only mode (has_pt=False), use_edgelets=False, the pose
refinement phase and local BA. In pipelined mode (pipeline.pipelined=True)
add_image dispatches frame i before it fetches earlier frames: a
window of pipeline_depth frames is fetched when full and bookkept when
the next one is submitted, so results come back up to 2 x pipeline_depth
calls late (None while the pipeline fills), and flush() drains the rest
at the end of a sequence. The map
lives on the device as a carry updated by one host delta blob per frame,
and a keyframe's seed detection and local BA are dispatched at the
keyframe and fetched with the next drain window. A batch runner
(`parallel.multi_vo.BatchedVO`) drives several handlers through
`_force_sync`, `_defer_seed_init` and per-instance replacements of the
detection, local-BA and seed-table access points. The handler tracks on a
pinhole camera; a distorted camera's images are undistorted on ingest
(`utils.dataset`), and other camera objects raise NotImplementedError.
Host bookkeeping is the JAX package's numpy code, so the host decisions
match.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from plsvo_torch.camera import PinholeCamera
from plsvo_torch.config import Config
from plsvo_torch.device import resolve_device
from plsvo_torch.image import build_pyramid
from plsvo_torch.ops import depth_filter as df
from plsvo_torch.ops import detection, homography
from plsvo_torch.ops import klt as klt_ops
from plsvo_torch.ops import lines as line_ops
from plsvo_torch.ops import sparse_align
from plsvo_torch.parallel import ba
from plsvo_torch.pipeline import fused
from plsvo_torch.pipeline.state import (FrameState, MapState, ST_CANDIDATE,
                                        ST_DELETED, ST_GOOD, ST_UNKNOWN)
from plsvo_torch.utils.profiling import PerformanceMonitor

STAGE_PAUSED = "paused"
STAGE_FIRST = "first"
STAGE_SECOND = "second"
STAGE_DEFAULT = "default"
STAGE_RELOCALIZING = "relocalizing"

QUALITY_GOOD = "good"
QUALITY_INSUFFICIENT = "insufficient"
QUALITY_BAD = "bad"


@dataclass
class FrameResult:
    frame_id: int
    stage: str
    quality: str
    n_pt_matches: int
    n_seg_matches: int
    is_keyframe: bool
    R_f_w: np.ndarray
    t_f_w: np.ndarray


def _detect_segments_levels(pyr, n_levels: int):
    """Raw tiled line candidates of the first n_levels pyramid levels, in
    level-0 pixels (the greedy grid dedup runs on the host after the
    fetch). Levels may carry a leading batch axis of R images."""
    rows = pyr[0].dim() - 2  # the table's row axis
    parts = []
    for lvl in range(n_levels):
        det = line_ops.detect_segments_tiled(pyr[lvl], n_peaks=64,
                                             run_gap_px=3.0, dist_tol=1.2)
        if lvl:
            s = float(1 << lvl)
            det = det._replace(sp=det.sp * s, ep=det.ep * s,
                               length=det.length * s)
        parts.append(det)
    return parts[0] if len(parts) == 1 else line_ops.SegmentTable(
        *[torch.cat(xs, rows) for xs in zip(*parts)])


def _empty_corner_grid(width: int, height: int, cell_size: int, device):
    """The no-op point detector of line-only mode: every cell empty."""
    _, _, n_cells = detection.grid_cells(width, height, cell_size)
    return detection.CornerGrid(
        uv=torch.zeros((n_cells, 2), device=device),
        level=torch.zeros(n_cells, dtype=torch.int32, device=device),
        score=torch.zeros(n_cells, device=device),
        valid=torch.zeros(n_cells, dtype=torch.bool, device=device))


def _kf_detect_program_batched(pyrs, occ_uv, occ_ok, *, use_pt, use_ls,
                               use_edgelets, n_pyr, n_pyr_segs, cell_size,
                               score_threshold, mag_threshold, width, height):
    """Keyframe seed detection of R requests: FAST grid (an empty grid
    without points), edgelets (when use_pt and use_edgelets), tiled line
    segments (raw candidates, when use_ls) and cell occupancy. pyrs are the
    levels stacked (R, h, w), occ_uv (R, C, 2), occ_ok (R, C). K1 scores
    all R x n_pyr images together (one launch per 32 images), the segments
    of all requests go through the detector's batch axis, and the grid
    selection, edgelets and occupancy run per request. Every result
    carries the leading R; a single handler's detection is R = 1."""
    from plsvo_torch.ops.fast_score import fast_score_levels

    R = occ_uv.shape[0]
    if use_pt:
        scored = fast_score_levels([pyrs[lv][r] for r in range(R)
                                    for lv in range(n_pyr)])
        grids = [detection.detect_fast_grid(
            [pyrs[lv][r] for lv in range(n_pyr)], cell_size=cell_size,
            score_threshold=score_threshold,
            scored=scored[r * n_pyr:(r + 1) * n_pyr]) for r in range(R)]
    else:
        grids = [_empty_corner_grid(width, height, cell_size, occ_uv.device)] * R
    egrid = None
    if use_pt and use_edgelets:
        egrid = fused.stack_trees([detection.detect_edgelets_grid(
            pyrs[0][r], cell_size=cell_size, mag_threshold=mag_threshold)
            for r in range(R)])
    segs = _detect_segments_levels(pyrs, n_pyr_segs) if use_ls else None
    occupied = torch.stack([detection.occupancy_from_positions(
        occ_uv[r], occ_ok[r], width, height, cell_size) for r in range(R)])
    return fused.stack_trees(grids), segs, occupied, egrid


def _check_supported(cam, cfg: Config):
    if not isinstance(cam, PinholeCamera):
        raise NotImplementedError(
            f"camera model {type(cam).__name__}: the handler tracks on a "
            "PinholeCamera, as the JAX package's does; undistort the images "
            "once on ingest and track with the ideal pinhole "
            "(utils.dataset.ImageFolderDataset.ideal_camera())")


class FrameHandlerMono:
    """Single-camera pipeline.

    ransac_draws: optional callable (n_valid, n_hyp) -> (n_hyp, 4) indices
    for the bootstrap RANSAC hypotheses (default: drawn from `generator`)."""

    def __init__(self, cam: PinholeCamera, cfg: Config = None, device=None, *,
                 generator: Optional[torch.Generator] = None,
                 ransac_draws: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.cfg = cfg or Config()
        _check_supported(cam, self.cfg)
        self.cam = cam
        pl = self.cfg.pipeline
        self.n_levels = max(pl.n_pyr_levels, pl.klt_max_level + 1)
        self.generator = generator or torch.Generator().manual_seed(0)
        self.ransac_draws = ransac_draws
        self._fx, self._fy, self._cx, self._cy = cam.fx, cam.fy, cam.cx, cam.cy
        self.results: List[FrameResult] = []
        self.permon = PerformanceMonitor()
        self.frame_id = 0
        self.n_relocalizations = 0
        # BatchedVO's controls: _force_sync runs DEFAULT frames through the
        # sync step even in pipelined mode (the batch runner dispatches the
        # pipelined steps itself); _defer_seed_init defers a keyframe's
        # seed detection and local BA to the runner's drain fetch even then
        self._force_sync = False
        self._defer_seed_init = False
        self._reset()

    def _new_map(self):
        return MapState(self.cfg, self.n_levels,
                        (self.cam.height, self.cam.width),
                        intrinsics=(self._fx, self._fy, self._cx, self._cy),
                        device=self.device)

    # ---- host-side (numpy) camera math ----
    def _np_unproject(self, uv: np.ndarray) -> np.ndarray:
        x = (uv[..., 0] - self._cx) / self._fx
        y = (uv[..., 1] - self._cy) / self._fy
        fvec = np.stack([x, y, np.ones_like(x)], -1)
        return (fvec / np.linalg.norm(fvec, axis=-1, keepdims=True)).astype(np.float32)

    @staticmethod
    def _np_line_coeffs(sf: np.ndarray, ef: np.ndarray) -> np.ndarray:
        zs = np.where(np.abs(sf[..., 2:3]) < 1e-10, 1e-10, sf[..., 2:3])
        ze = np.where(np.abs(ef[..., 2:3]) < 1e-10, 1e-10, ef[..., 2:3])
        sp = np.concatenate([sf[..., :2] / zs, np.ones_like(zs)], -1)
        ep = np.concatenate([ef[..., :2] / ze, np.ones_like(ze)], -1)
        line = np.cross(sp, ep)
        n = np.linalg.norm(line[..., :2], axis=-1, keepdims=True)
        return (line / np.maximum(n, 1e-12)).astype(np.float32)

    def _dev(self, a):
        """Upload a host array; on the card through pinned memory without
        waiting (a copy from pageable memory waits for the device queue)."""
        t = torch.as_tensor(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------------------------------------------------------
    def add_image(self, img, timestamp: float) -> Optional[FrameResult]:
        """Track one frame. In pipelined mode the result returned belongs
        to an earlier frame, or is None while the pipeline fills."""
        self.permon.new_frame(self.frame_id)
        with self.permon.installed(), self.permon.timer("tot_time"):
            res = self._add_image(img, timestamp)
        if res is not None:
            self.results.append(res)
        return res

    def _add_image(self, img, timestamp: float) -> Optional[FrameResult]:
        # a DEFAULT frame's pyramid is built where it is tracked
        default = self.stage == STAGE_DEFAULT
        with self.permon.timer("upload" if default else "pyramid_creation"):
            a = img if torch.is_tensor(img) else torch.tensor(np.asarray(img))
            if a.dtype not in (torch.uint8, torch.float32):
                a = a.to(torch.float32)
            # uint8 stays uint8 for the upload (a quarter of the bytes)
            img_dev = (self._dev(a.numpy()) if a.device.type == "cpu"
                       else a.to(self.device))
            pyr = None if default else build_pyramid(img_dev, self.n_levels)
        if self.stage == STAGE_FIRST:
            res = self._process_first(pyr, timestamp)
        elif self.stage == STAGE_SECOND:
            res = self._process_second(pyr, timestamp)
        elif default:
            res = self._process_frame(img_dev, timestamp)
        elif self.stage == STAGE_RELOCALIZING:
            self._harvest_seeds()
            res = self._relocalize(img_dev, pyr, timestamp)
        else:
            raise RuntimeError(f"stage {self.stage}")
        self.frame_id += 1
        return res

    # ------------------------------------------------------------------
    def _detect_features(self, pyr, use_pt: bool, use_ls: bool):
        """FAST grid corners (an empty grid when not use_pt) and raw line
        candidates (when use_ls)."""
        pl = self.cfg.pipeline
        if use_pt:
            grid = detection.detect_fast_grid(
                pyr[: pl.n_pyr_levels], cell_size=pl.grid_size,
                score_threshold=pl.triang_min_corner_score)
        else:
            grid = _empty_corner_grid(self.cam.width, self.cam.height,
                                      pl.grid_size, self.device)
        segs = _detect_segments_levels(pyr, pl.n_pyr_levels_segs) if use_ls else None
        return grid, segs

    def _dedup_segments_host(self, det) -> line_ops.SegmentTable:
        """Grid dedup of a fetched raw candidate table (numpy); the length
        gate is lsd_min_length * H*W/(H+W) px."""
        pl = self.cfg.pipeline
        W, H = self.cam.width, self.cam.height
        min_len = pl.lsd_min_length * (W * H) / (W + H)
        return line_ops.dedup_segments_grid_np(
            det, width=W, height=H, cell_size=pl.grid_size_segs,
            max_segs=self.cfg.caps.max_segs, min_length=min_len)

    def _process_first(self, pyr, ts) -> FrameResult:
        pl = self.cfg.pipeline
        frame = FrameState.empty(self.cfg, self.frame_id, ts, pyr,
                                 np.eye(3, dtype=np.float32),
                                 np.zeros(3, np.float32))
        grid, segs = fused.fetch(self._detect_features(
            pyr, use_pt=pl.has_pt and pl.init_pt,
            use_ls=pl.has_ls and pl.init_ls))
        targets = [grid.uv[grid.valid]]
        if segs is not None:
            # each segment gives KLT targets at its start, middle and end;
            # in line-only mode, where segments are the only targets, at
            # its quarter points too
            segs = self._dedup_segments_host(segs)
            sp, ep = segs.sp[segs.valid], segs.ep[segs.valid]
            alphas = ((0.0, 0.5, 1.0) if pl.has_pt
                      else (0.0, 0.25, 0.5, 0.75, 1.0))
            targets += [sp + a * (ep - sp) for a in alphas]
        targets = np.concatenate(targets, 0)
        if len(targets) < self.cfg.pipeline.init_min_fts:
            return FrameResult(frame.frame_id, self.stage, QUALITY_INSUFFICIENT,
                               0, 0, False, frame.R_f_w, frame.t_f_w)
        cap = self.cfg.caps.max_klt_fts
        n = min(len(targets), cap)
        self._first_uv = np.zeros((cap, 2), np.float32)
        self._first_uv[:n] = targets[:n]
        self._first_ok = np.zeros(cap, bool)
        self._first_ok[:n] = True
        self.first_frame = frame
        frame.is_keyframe = True
        self.stage = STAGE_SECOND
        return FrameResult(frame.frame_id, STAGE_FIRST, QUALITY_GOOD,
                           int(self._first_ok.sum()), 0, True,
                           frame.R_f_w, frame.t_f_w)

    def _process_second(self, pyr, ts) -> FrameResult:
        pl = self.cfg.pipeline
        uv0 = self._first_uv
        uv_cur_d, ok_d, disp_d = klt_ops.track_klt(
            self.first_frame.pyr, pyr, self._dev(uv0), self._dev(self._first_ok))
        uv_cur_np, ok, disp = fused.fetch((uv_cur_d, ok_d, disp_d))
        ok = ok & self._first_ok
        disp_med = float(np.median(disp[ok])) if ok.any() else 0.0
        fail = FrameResult(self.frame_id, self.stage, QUALITY_INSUFFICIENT, 0, 0,
                           False, np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))
        if ok.sum() < pl.init_min_tracked:
            self._reset()
            return fail
        if disp_med < pl.init_min_disparity:
            return fail
        f_ref, f_cur = fused.fetch((self.cam.unproject(self._dev(uv0)),
                                    self.cam.unproject(uv_cur_d)))
        n_hyp = 256
        draws = None
        if self.ransac_draws is not None:
            draws = self.ransac_draws(max(int(ok.sum()), 1), n_hyp)
        hres = homography.homography_init(
            f_ref, f_cur, ok, focal=self._fx, reproj_thresh_px=pl.reproj_thresh,
            min_inliers=pl.init_min_inliers, device=self.device,
            generator=self.generator, draws=draws)
        if not hres.ok or hres.inliers.sum() < pl.init_min_inliers:
            self._reset()
            return fail

        m = hres.inliers & (hres.depths_ref > 1e-6)
        z_med = float(np.median(hres.depths_ref[m] * f_ref[m][:, 2]))
        scale = pl.map_scale / z_med
        R_cr = hres.R_cur_ref.astype(np.float32)
        t_cr = (hres.t_cur_ref * scale).astype(np.float32)
        frame = FrameState.empty(self.cfg, self.frame_id, ts, pyr, R_cr, t_cr)
        frame.is_keyframe = True
        kf0 = self.map.add_keyframe(self.first_frame)
        rows = np.where(m)[0][: self.cfg.caps.max_fts]
        n_pts = 0
        for i in rows:
            pos_w = f_ref[i] * (hres.depths_ref[i] * scale)
            lm = self.map.new_point(pos_w, kf0, uv0[i], f_ref[i], 0)
            if lm < 0:
                break
            frame.pt_uv[n_pts] = uv_cur_np[i]
            frame.pt_f[n_pts] = f_cur[i]
            frame.pt_level[n_pts] = 0
            frame.pt_lm[n_pts] = lm
            frame.pt_valid[n_pts] = True
            self.map.kf_pt_uv[kf0, n_pts] = uv0[i]
            self.map.kf_pt_f[kf0, n_pts] = f_ref[i]
            self.map.kf_pt_lm[kf0, n_pts] = lm
            n_pts += 1
        self.map.add_keyframe(frame)
        d_mean, d_min = self.map.scene_depth(frame)
        self._init_seeds(frame, d_mean, max(d_min * 0.5, 1e-3))
        self.last_frame = frame
        self.stage = STAGE_DEFAULT
        return FrameResult(frame.frame_id, STAGE_SECOND, QUALITY_GOOD,
                           n_pts, 0, True, R_cr, t_cr)

    # ------------------------------------------------------------------
    def _align_inputs_from_frame(self, frame: FrameState):
        center = frame.cam_center_w()
        pv = frame.pt_valid & (frame.pt_lm >= 0)
        lm = np.where(pv, frame.pt_lm, 0)
        alive_lm = pv & (self.map.pt_status[lm] > 0)
        depth = np.linalg.norm(self.map.pt_pos[lm] - center[None], axis=-1)
        pts = sparse_align.AlignPoints(
            xyz_ref=self._dev((frame.pt_f * depth[:, None]).astype(np.float32)),
            uv_ref=self._dev(frame.pt_uv.astype(np.float32)),
            valid=self._dev(alive_lm))
        sv = frame.seg_valid & (frame.seg_lm >= 0)
        slm = np.where(sv, frame.seg_lm, 0)
        alive_s = sv & (self.map.ln_status[slm] > 0)
        s_depth = np.linalg.norm(self.map.ln_spos[slm] - center[None], axis=-1)
        e_depth = np.linalg.norm(self.map.ln_epos[slm] - center[None], axis=-1)
        segs = sparse_align.make_align_segments(
            self._dev(frame.seg_suv), self._dev(frame.seg_euv),
            self._dev(frame.seg_sf), self._dev(frame.seg_ef),
            self._dev(s_depth.astype(np.float32)),
            self._dev(e_depth.astype(np.float32)), self._dev(alive_s),
            n_samples=self.cfg.caps.n_line_samples, fx=self._fx, fy=self._fy,
            cx=self._cx, cy=self._cy)
        return pts, segs

    def _last_blob(self, frame: FrameState) -> torch.Tensor:
        """ONE packed upload of the per-frame host tables (layout
        fused.last_blob_specs)."""
        m = self.map
        center = frame.cam_center_w()
        pv = frame.pt_valid & (frame.pt_lm >= 0)
        lm = np.where(pv, frame.pt_lm, 0)
        alive = pv & (m.pt_status[lm] > 0)
        depth = np.linalg.norm(m.pt_pos[lm] - center[None], axis=-1)
        sv = frame.seg_valid & (frame.seg_lm >= 0)
        slm = np.where(sv, frame.seg_lm, 0)
        alive_s = sv & (m.ln_status[slm] > 0)
        sd = np.linalg.norm(m.ln_spos[slm] - center[None], axis=-1)
        ed = np.linalg.norm(m.ln_epos[slm] - center[None], axis=-1)
        blob = fused.pack_blob_host([
            frame.pt_uv, frame.pt_f, depth, alive,
            frame.seg_suv, frame.seg_euv, frame.seg_sf, frame.seg_ef,
            sd, ed, alive_s, frame.R_f_w, frame.t_f_w,
            np.clip(m.pt_last_optim, -1, 2**24 - 1),
            np.clip(m.ln_last_optim, -1, 2**24 - 1)])
        return self._dev(blob)

    def _fused_kwargs(self):
        pl = self.cfg.pipeline
        return dict(
            levels=tuple(range(pl.klt_max_level, pl.klt_min_level - 1, -1)),
            n_iter_align=pl.img_align_n_iter,
            patch_align=pl.img_align_patch_size,
            cell_size=pl.grid_size, cell_size_segs=pl.grid_size_segs,
            max_pts_out=self.cfg.caps.max_fts,
            max_segs_out=self.cfg.caps.max_segs,
            n_line_samples=self.cfg.caps.n_line_samples,
            poseopt_iters=pl.poseoptim_num_iter,
            poseopt_iters_ref=(pl.poseoptim_num_iter_ref
                               if pl.has_refinement else 0),
            poseopt_thresh=pl.poseoptim_thresh,
            n_pyr_use=pl.n_pyr_levels, has_ls=pl.has_ls,
            has_edgelets=pl.use_edgelets and pl.has_pt,
            n_struct_pts=pl.structureoptim_max_pts,
            n_struct_segs=pl.structureoptim_max_segs,
            struct_iters=pl.structureoptim_num_iter)

    @staticmethod
    def _live_width(alive: np.ndarray, cap: int, floor: int):
        """Power-of-2 prefix width covering all alive rows; None when the
        full capacity is needed."""
        idx = np.where(alive)[0]
        hi = int(idx[-1]) + 1 if len(idx) else 0
        w = floor
        while w < hi:
            w *= 2
        return None if w >= cap else w

    def _step_kwargs(self):
        pl = self.cfg.pipeline
        caps = self.cfg.caps
        return dict(
            specs=fused.last_blob_specs(caps.max_fts, caps.max_segs,
                                        caps.max_points, caps.max_lines),
            update_pt_seeds=bool(self._seed_alive.any()),
            update_ln_seeds=bool(self._lnseed_alive.any()),
            max_seed_kfs=pl.max_seed_kfs,
            sigma_conv_factor=pl.seed_convergence_sigma2_thresh,
            seed_search_budget=pl.seed_search_budget,
            n_epi_steps=pl.epi_max_steps,
            seed_work_budget=pl.seed_work_budget,
            n_pyr_seed=pl.n_pyr_levels,
            pt_width=self._live_width(self._seed_alive, caps.max_seeds, 128),
            ln_width=self._live_width(self._lnseed_alive, caps.max_seed_segs,
                                      64),
            **self._fused_kwargs())

    def _step_inputs(self, pyr):
        last = self.last_frame
        return (last.pyr, pyr, self.map.kf_atlas_flat(self.cfg.pipeline.n_pyr_levels),
                self._last_blob(last), fused.map_tables_from_state(self.map),
                self.pt_seeds, self.ln_seeds, self.batch_counter,
                self._fx, self._fy, self._cx, self._cy)

    def _process_frame(self, img, ts, pyr=None) -> Optional[FrameResult]:
        """Track a DEFAULT-stage frame from its device image (and its
        pyramid, where the caller built one): the one place that picks
        the sync step or, in pipelined mode, the dispatch."""
        if self.cfg.pipeline.pipelined and not self._force_sync:
            return self._process_frame_pipelined(img, ts)
        if pyr is None:
            with self.permon.timer("pyramid_creation"):
                pyr = build_pyramid(img, self.n_levels)
        last = self.last_frame
        frame = FrameState.empty(self.cfg, self.frame_id, ts, pyr,
                                 last.R_f_w.copy(), last.t_f_w.copy())
        # the sync step uploads the whole mirror: no delta is needed
        self.map.mt_mark_clean()
        with self.permon.timer("device_step"):
            step = fused.track_frame_step(*self._step_inputs(pyr),
                                          **self._step_kwargs())
        self.pt_seeds = step.pt_seeds
        self.ln_seeds = step.ln_seeds
        with self.permon.timer("fetch"):
            res, pt_conv, ln_conv = fused.fetch((fused.fetch_view(step.fused),
                                                 step.pt_conv, step.ln_conv))
        # converged seeds become landmarks visible from the next frame
        self._apply_harvest(pt_conv, ln_conv, result_frame_id=frame.frame_id)
        return self._post_fused(frame, res)

    # -- pipelined mode ------------------------------------------------
    def _process_frame_pipelined(self, img, ts) -> Optional[FrameResult]:
        """Dispatch frame i before fetching earlier frames' results, so host
        bookkeeping overlaps device work; returns the oldest finished
        result not yet returned, or None while the pipeline fills. The
        first step of a chain starts from the host tables of the last
        finished frame and a full upload of the map; every later step takes
        the raw image, the previous step's NextFrameInputs and map carry,
        and one delta blob."""
        pl = self.cfg.pipeline
        m = self.map
        if m.mt_needs_resync(self._mt_ne) and self._pipe_q:
            # a change the deltas cannot carry: finish every frame in
            # flight, then restart the chain from a full upload
            self._initiate_drain(keep=0)
            while self._fetch_q:
                self._complete_drains(force=True)
        kwargs = self._step_kwargs()
        atlas = m.kf_atlas_flat(pl.n_pyr_levels)
        cam = (self._fx, self._fy, self._cx, self._cy)
        # a chain restarts from a full upload of the map: the first dispatch
        # after a flush, a failure or a change the deltas cannot carry
        self.permon.count("mt_resync", int(not self._pipe_q))
        with self.permon.timer("device_step"):
            if not self._pipe_q:
                pyr = build_pyramid(img, self.n_levels)
                # the full upload is the carry's resync: it holds every
                # queued delta
                m.mt_mark_clean()
                step = fused.track_frame_step(
                    self.last_frame.pyr, pyr, atlas,
                    self._last_blob(self.last_frame),
                    fused.map_tables_from_state(m), self.pt_seeds,
                    self.ln_seeds, self.batch_counter, *cam, emit_next=True,
                    frame_id=self.frame_id, **kwargs)
            else:
                del kwargs["specs"]
                with self.permon.timer("mt_delta"):
                    delta = self._dev(m.pack_mt_deltas(
                        fused.MT_DELTA_DP, fused.MT_DELTA_DL,
                        fused.MT_DELTA_OP, fused.MT_DELTA_OL, self._mt_ne))
                step = fused.track_frame_step_tables(
                    img, atlas, self._pipe_q[-1][1].next,
                    self._mt_carry, self.pt_seeds, self.ln_seeds,
                    self.batch_counter, *cam, n_levels=self.n_levels,
                    frame_id=self.frame_id, mt_delta=delta,
                    evict_width=self._mt_ne, **kwargs)
        frame = FrameState.empty(self.cfg, self.frame_id, ts,
                                 list(step.next.pyr),
                                 self.last_frame.R_f_w.copy(),
                                 self.last_frame.t_f_w.copy())
        self._mt_carry = step.mt
        self.pt_seeds = step.pt_seeds
        self.ln_seeds = step.ln_seeds
        self._pipe_q.append((frame, step))
        self.last_frame = frame
        if len(self._pipe_q) > max(1, pl.pipeline_depth):
            self._initiate_drain(keep=1)
        # bookkeep a fetched window only once the next one is submitted
        self._complete_drains(force=len(self._fetch_q) > 1)
        # dispatched and not yet bookkept: at most 2 x depth (up to depth
        # frames not yet drained, and the window whose copy is under way)
        self.permon.count("inflight", len(self._pipe_q) + sum(
            len(w[0]) for w in self._fetch_q))
        return self._ready.pop(0) if self._ready else None

    def sync_carry(self):
        """Apply every queued map delta to the device carry now (as the
        next steps would) and return it: after flush() it equals
        fused.map_tables_upload(self.map). Changes that the deltas cannot
        carry (MapState.transform), and a chain that a failed frame broke
        (the next step restarts from a full upload), rebuild it from a
        full upload."""
        m = self.map
        if self._mt_carry is None or m.mt_needs_resync(self._mt_ne):
            self._mt_carry = fused.map_tables_from_state(m)
            m.mt_mark_clean()
        while m.mt_dirty_pending():
            blob = self._dev(m.pack_mt_deltas(
                fused.MT_DELTA_DP, fused.MT_DELTA_DL, fused.MT_DELTA_OP,
                fused.MT_DELTA_OL, self._mt_ne))
            self._mt_carry = fused.apply_mt_deltas(self._mt_carry, blob,
                                                   NE=self._mt_ne)
        return self._mt_carry

    def _initiate_drain(self, keep: int):
        """Stage 1 of a drain: all but the newest `keep` frames in flight,
        the pending keyframe detections and up to two pending local BA
        results (as the JAX package folds them, so write-backs land on the
        same frames) go into ONE flat vector, whose copy to the host starts
        now; _complete_drains bookkeeps it a window later."""
        n = len(self._pipe_q) - keep
        if n <= 0:
            return
        take, self._pipe_q = self._pipe_q[:n], self._pipe_q[n:]
        pending_init, self._pending_seed_init = self._pending_seed_init, []
        pending_ba, self._pending_ba = self._pending_ba[:2], self._pending_ba[2:]
        with self.permon.timer("fetch"), self.permon.timer("drain_submit"):
            flat, meta = fused.flatpack((
                [(fused.fetch_view(s.fused), s.pt_conv, s.ln_conv)
                 for _, s in take],
                [h for *_, h in pending_init], [h for h, _ in pending_ba]))
            handle = fused.submit_fetch(flat)
        self._fetch_q.append(([f for f, _ in take], pending_init, pending_ba,
                              handle, meta))

    def _complete_drains(self, force: bool):
        """Stage 2 of a drain: bookkeep the oldest fetched window when
        forced, which is exactly when the next window has been submitted.
        Deterministic on purpose: finishing windows whenever their copy
        happens to be done would make the frame at which map updates land
        depend on the wall clock. A frame that fails drops its successors
        in flight; their windows' local BA results and seed detections are
        queued again for the next drain (write_back_window and the seed
        harvest guard against slots and rows that changed meanwhile)."""
        while self._fetch_q and force:
            frames, pending_init, pending_ba, handle, meta = self._fetch_q.pop(0)
            newest_frame = self.last_frame
            with self.permon.timer("fetch"), self.permon.timer("drain_wait"):
                got, init_got, ba_got = fused.flatunpack(handle.result(), meta)
            for (_, bmeta), (kf_R, kf_t, lm_pos) in zip(pending_ba, ba_got):
                self._write_back_ba(kf_R, kf_t, lm_pos, bmeta)
            self.permon.count("ba_writebacks", len(ba_got))
            for (kf_slot, dm, dmin, _), fetched in zip(pending_init, init_got):
                self._complete_seed_init(kf_slot, dm, dmin, *fetched)
            n_done = 0
            for frame, (res, pt_c, ln_c) in zip(frames, got):
                if self.stage == STAGE_RELOCALIZING:
                    break  # the successors of a failed frame are dropped
                self._apply_harvest(pt_c, ln_c, result_frame_id=frame.frame_id)
                self._ready.append(self._post_fused(frame, res))
                n_done += 1
            self.permon.count("drained_frames", n_done)
            if self.stage == STAGE_RELOCALIZING:
                for _, q_init, q_ba, _, _ in self._fetch_q:
                    self._pending_ba.extend(q_ba)
                    self._pending_seed_init.extend(q_init)
                self._pipe_q.clear()
                self._fetch_q.clear()
                # the dropped steps wrote their structure updates into the
                # carry, and the host never applies them
                self._mt_carry = None
                return
            # _post_fused points last_frame at each finished frame; the
            # newest dispatched frame stays the alignment reference
            self.last_frame = newest_frame
            force = False

    def flush(self) -> List[FrameResult]:
        """Finish every frame in flight (call at the end of a sequence);
        returns the remaining results in frame order."""
        if self.cfg.pipeline.pipelined and (self._pipe_q or self._fetch_q):
            self._initiate_drain(keep=0)
            while self._fetch_q:
                self._complete_drains(force=True)
        self._complete_pending_ba()
        out, self._ready = self._ready, []
        return out

    def _post_fused(self, frame: FrameState, res) -> FrameResult:
        """Host bookkeeping after the device step: counters, deletion
        rules, table fills, structure-opt write-back, keyframe policy."""
        with self.permon.timer("post_fused"):
            return self._post_fused_body(frame, res)

    def _post_fused_body(self, frame: FrameState, res) -> FrameResult:
        pl = self.cfg.pipeline
        last = self.last_frame
        m = self.map
        # lines that the photometric gate of the alignment dropped lose
        # their landmark link (host width: pipelined align tables are as
        # wide as the reprojection's output)
        last.seg_lm[last.seg_valid
                    & ~res.align_seg_alive[:len(last.seg_valid)]] = -1
        pt = res.pt
        lm = pt.lm_idx
        matched = pt.matched
        sel = pt.selected
        m.pt_n_succ[lm[matched]] += 1
        m.pt_n_fail[lm[sel & ~matched]] += 1
        cand_dead = (m.pt_status == ST_CANDIDATE) & (m.pt_n_fail > 30)
        unk_dead = (m.pt_status == ST_UNKNOWN) & (m.pt_n_fail > 15)
        dead = cand_dead | unk_dead
        m.pt_status[dead] = ST_DELETED
        promote = (m.pt_status == ST_UNKNOWN) & (m.pt_n_succ > 10)
        m.pt_status[promote] = ST_GOOD
        if (dead | promote).any():
            m.invalidate("pt_status")
            m.mark_mt_dirty("pt", np.where(dead | promote)[0])
        if dead.any():
            m.kf_pt_lm[np.isin(m.kf_pt_lm, np.where(dead)[0])] = -1

        n_pt_gate = int(matched.sum())
        keep = matched & res.pt_inlier & (m.pt_status[lm] != ST_DELETED)
        rows = np.where(keep)[0][: self.cfg.caps.max_fts]
        n_pt = len(rows)
        frame.pt_uv[:n_pt] = pt.uv[rows]
        frame.pt_f[:n_pt] = self._np_unproject(pt.uv[rows])
        frame.pt_level[:n_pt] = pt.level[rows]
        frame.pt_lm[:n_pt] = lm[rows]
        frame.pt_valid[:] = False
        frame.pt_valid[:n_pt] = True

        n_seg = n_seg_gate = 0
        if pl.has_ls:
            seg = res.seg
            slm = seg.lm_idx
            smat = seg.matched
            n_seg_gate = int(smat.sum())
            m.ln_n_succ[slm[smat]] += 1
            m.ln_n_fail[slm[seg.selected & ~smat]] += 1
            c_dead = (m.ln_status == ST_CANDIDATE) & (m.ln_n_fail > 30)
            u_dead = (m.ln_status == ST_UNKNOWN) & (m.ln_n_fail > 15)
            ldead = c_dead | u_dead
            m.ln_status[ldead] = ST_DELETED
            lprom = (m.ln_status == ST_UNKNOWN) & (m.ln_n_succ > 10)
            m.ln_status[lprom] = ST_GOOD
            if (ldead | lprom).any():
                m.invalidate("ln_status")
                m.mark_mt_dirty("ln", np.where(ldead | lprom)[0])
            if ldead.any():
                m.kf_seg_lm[np.isin(m.kf_seg_lm, np.where(ldead)[0])] = -1
            skeep = smat & res.seg_inlier & (m.ln_status[slm] != ST_DELETED)
            srows = np.where(skeep)[0][: self.cfg.caps.max_segs]
            n_seg = len(srows)
            frame.seg_suv[:n_seg] = seg.s_uv[srows]
            frame.seg_euv[:n_seg] = seg.e_uv[srows]
            frame.seg_sf[:n_seg] = self._np_unproject(seg.s_uv[srows])
            frame.seg_ef[:n_seg] = self._np_unproject(seg.e_uv[srows])
            frame.seg_line[:n_seg] = self._np_line_coeffs(
                frame.seg_sf[:n_seg], frame.seg_ef[:n_seg])
            frame.seg_level[:n_seg] = seg.level[srows]
            frame.seg_lm[:n_seg] = slm[srows]
            frame.seg_valid[:] = False
            frame.seg_valid[:n_seg] = True

        # the gate counts point and segment matches together
        if n_pt_gate + n_seg_gate < pl.quality_min_fts:
            frame.R_f_w, frame.t_f_w = last.R_f_w.copy(), last.t_f_w.copy()
            self.stage = STAGE_RELOCALIZING
            return FrameResult(frame.frame_id, STAGE_DEFAULT,
                               QUALITY_INSUFFICIENT, n_pt_gate, n_seg, False,
                               frame.R_f_w, frame.t_f_w)

        # accept the optimized pose (host Gram-Schmidt drift control)
        R = res.R_f_w
        x = R[0] / max(np.linalg.norm(R[0]), 1e-12)
        y = R[1] - np.dot(x, R[1]) * x
        y = y / max(np.linalg.norm(y), 1e-12)
        frame.R_f_w = np.stack([x, y, np.cross(x, y)]).astype(np.float32)
        frame.t_f_w = res.t_f_w.astype(np.float32)
        frame.cov = res.cov

        # structure-opt refinements: the carry took them on the device; the
        # rows are queued again all the same, because a delta packed for
        # another change before this fetch carried the older position
        vsel = res.st_pt_valid
        if vsel.any():
            rws = res.st_pt_lm[vsel]
            m.pt_pos[rws] = res.st_pt_pos[vsel]
            m.pt_last_optim[rws] = frame.frame_id
            m.invalidate("pt_pos")
            m.mark_mt_dirty("pt", rws)
        lsel = res.st_ln_valid
        if lsel.any():
            rws = res.st_ln_lm[lsel]
            m.ln_spos[rws] = res.st_ln_spos[lsel]
            m.ln_epos[rws] = res.st_ln_epos[lsel]
            m.ln_last_optim[rws] = frame.frame_id
            m.invalidate("ln_spos", "ln_epos")
            m.mark_mt_dirty("ln", rws)

        quality = self._tracking_quality(n_pt, n_seg)
        if quality == QUALITY_INSUFFICIENT:
            frame.R_f_w, frame.t_f_w = last.R_f_w.copy(), last.t_f_w.copy()
            self.stage = STAGE_RELOCALIZING
            return FrameResult(frame.frame_id, STAGE_DEFAULT,
                               QUALITY_INSUFFICIENT, n_pt, n_seg, False,
                               frame.R_f_w, frame.t_f_w)
        d_mean, d_min = self.map.scene_depth(frame)
        need_kf = (d_mean is not None and self._need_new_kf(frame)
                   and quality == QUALITY_GOOD)
        if need_kf:
            frame.is_keyframe = True
            with self.permon.timer("keyframe_path"):
                self._make_keyframe(frame, d_mean, d_min)
        self.last_frame = frame
        return FrameResult(frame.frame_id, STAGE_DEFAULT, quality, n_pt, n_seg,
                           need_kf, frame.R_f_w, frame.t_f_w)

    # ------------------------------------------------------------------
    def _tracking_quality(self, n_pt: int, n_seg: int) -> str:
        """INSUFFICIENT below quality_min_fts point + segment matches; BAD
        when the point matches drop by more than quality_max_drop_fts (in
        line-only mode: the segment matches by more than
        quality_max_drop_fts_segs)."""
        pl = self.cfg.pipeline
        if n_pt + n_seg < pl.quality_min_fts:
            return QUALITY_INSUFFICIENT
        last = self.results[-1] if self.results else None
        if pl.has_pt:
            last_pt = last.n_pt_matches if last else n_pt
            if min(last_pt, pl.max_fts) - n_pt > pl.quality_max_drop_fts:
                return QUALITY_BAD
        else:
            last_seg = last.n_seg_matches if last else n_seg
            if (min(last_seg, pl.max_fts_segs) - n_seg
                    > pl.quality_max_drop_fts_segs):
                return QUALITY_BAD
        return QUALITY_GOOD

    def _need_new_kf(self, frame: FrameState) -> bool:
        """No new keyframe if any keyframe is within both
        kfselect_mindist_t and kfselect_mindist_r."""
        pl = self.cfg.pipeline
        Rf, tf = frame.R_f_w, frame.t_f_w
        occ = np.where(self.map.kf_occupied)[0]
        if len(occ) == 0:
            return True
        tk = self.map.kf_t[occ]
        dt = np.linalg.norm((tk - tf) @ Rf, axis=1)
        tr = np.einsum("ij,kij->k", Rf, self.map.kf_R[occ])
        dr = np.degrees(np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0)))
        return not bool(np.any((dt < pl.kfselect_mindist_t)
                               & (dr < pl.kfselect_mindist_r)))

    def _make_keyframe(self, frame: FrameState, d_mean, d_min):
        """Promote candidates observed here, install the keyframe (evicting
        the furthest one at capacity), spawn new seeds."""
        m = self.map
        lm = frame.pt_lm[frame.pt_valid & (frame.pt_lm >= 0)]
        m.pt_status[lm[m.pt_status[lm] == ST_CANDIDATE]] = ST_UNKNOWN
        sl = frame.seg_lm[frame.seg_valid & (frame.seg_lm >= 0)]
        m.ln_status[sl[m.ln_status[sl] == ST_CANDIDATE]] = ST_UNKNOWN
        max_kfs = self.cfg.pipeline.max_n_kfs or self.cfg.caps.max_kfs
        max_kfs = min(max_kfs, self.cfg.caps.max_kfs)
        if m.n_keyframes() >= max_kfs:
            slot = m.furthest_kf_slot(frame.cam_center_w())
            if slot is not None:
                m.remove_keyframe(slot)
        with self.permon.timer("kf_install"):
            m.add_keyframe(frame)
        self.batch_counter += 1
        with self.permon.timer("kf_init_seeds"):
            if self._deferred() and d_mean is not None:
                # the detection's fetch rides the next drain window
                kf_slot = int(np.where(m.kf_frame_id == frame.frame_id)[0][0])
                self._pending_seed_init.append(
                    (kf_slot, d_mean, max(d_min * 0.1, 1e-3),
                     self._queue_or_dispatch_detection(frame)))
            else:
                self._init_seeds(frame, d_mean, max(d_min * 0.1, 1e-3))
        if self.cfg.pipeline.loba_enabled:
            with self.permon.timer("local_ba"):
                self._dispatch_local_ba(frame)

    def _dispatch_local_ba(self, frame: FrameState):
        """Windowed BA at a keyframe: core = the new keyframe and its
        core_n_kfs closest FoV-overlapping keyframes, the other keyframes
        fixed. One packed upload and the solve; in sync mode one fetch and
        the guarded write-back, in pipelined mode the result rides the next
        drain window's fetch."""
        m = self.map
        kf_slot = int(np.where(m.kf_frame_id == frame.frame_id)[0][0])
        overl = sorted(m.overlap_kfs(frame.R_f_w, frame.t_f_w, self._fx,
                                     self._fy, self._cx, self._cy),
                       key=lambda kd: kd[1])
        core = {k for k, _ in overl[: self.cfg.pipeline.core_n_kfs]}
        core.add(kf_slot)
        if m.n_keyframes() < 3:
            return  # bootstrap window: nothing to adjust yet
        prob, meta = ba.problem_from_window(m, self.cfg, sorted(core))
        if meta["n_points"] + meta["n_lines"] == 0:
            return
        blob, spec = ba.problem_blob(prob)
        handles = self._solve_local_ba(blob, spec)
        if self._deferred():
            self._pending_ba.append((handles, meta))
        else:
            self._write_back_ba(*fused.fetch(handles), meta)

    def _deferred(self) -> bool:
        """Whether a keyframe's seed detection and local BA ride a later
        drain fetch (pipelined mode, or a batch runner's drain)."""
        return (self._defer_seed_init
                or (self.cfg.pipeline.pipelined and not self._force_sync))

    def _write_back_ba(self, kf_R, kf_t, lm_pos, meta):
        """Guarded write-back of one fetched BA result; logs the keyframes
        and landmarks written."""
        n_kf, n_lm = ba.write_back_window(self.map, kf_R, kf_t, lm_pos, meta)
        self.permon.log("local_ba_kfs", n_kf)
        self.permon.log("local_ba_landmarks", n_lm)

    def _complete_pending_ba(self):
        """Write back the local BA results no drain window took (the end of
        a sequence): one fetch for all of them."""
        if not self._pending_ba:
            return
        pend, self._pending_ba = self._pending_ba, []
        fetched = fused.fetch([h for h, _ in pend])
        for (_, meta), (kf_R, kf_t, lm_pos) in zip(pend, fetched):
            self._write_back_ba(kf_R, kf_t, lm_pos, meta)
        self.permon.count("ba_writebacks", len(fetched))

    def _solve_local_ba(self, blob: np.ndarray, spec):
        """One windowed BA solve on the handler's device; returns device
        tensors (kf_R, kf_t, lm_pos)."""
        pl = self.cfg.pipeline
        out, _ = ba.bundle_adjust_blob(
            self._dev(blob), spec=spec, n_iter=pl.loba_num_iter,
            pose_prior=pl.loba_pose_prior, accept_gate=False)
        return out.kf_R, out.kf_t, out.lm_pos

    # ------------------------------------------------------------------
    def _occupancy_inputs(self, frame: FrameState):
        caps = self.cfg.caps
        cap = caps.max_fts + 2 * caps.max_segs
        occ_uv = np.zeros((cap, 2), np.float32)
        occ_ok = np.zeros(cap, bool)
        parts = np.concatenate([
            frame.pt_uv[frame.pt_valid], frame.seg_suv[frame.seg_valid],
            frame.seg_euv[frame.seg_valid]], 0)
        n_occ = min(len(parts), cap)
        occ_uv[:n_occ] = parts[:n_occ]
        occ_ok[:n_occ] = True
        return occ_uv, occ_ok

    def _queue_or_dispatch_detection(self, frame: FrameState):
        """The deferred keyframe detection's dispatch point (a batched
        handler collects the requests of several sequences here)."""
        return self._dispatch_seed_detection(frame)

    def _detect_statics(self) -> dict:
        pl = self.cfg.pipeline
        return dict(
            use_pt=pl.has_pt, use_ls=pl.has_ls,
            use_edgelets=pl.use_edgelets and pl.has_pt, n_pyr=pl.n_pyr_levels,
            n_pyr_segs=pl.n_pyr_levels_segs, cell_size=pl.grid_size,
            score_threshold=pl.triang_min_corner_score,
            mag_threshold=pl.edgelet_grad_thresh,
            width=self.cam.width, height=self.cam.height)

    def _dispatch_seed_detection(self, frame: FrameState):
        occ_uv, occ_ok = self._occupancy_inputs(frame)
        return fused._first(_kf_detect_program_batched(
            [p[None] for p in frame.pyr], self._dev(occ_uv)[None],
            self._dev(occ_ok)[None], **self._detect_statics()))

    def _init_seeds(self, frame: FrameState, d_mean, d_min):
        """Spawn seeds in grid cells not already holding a feature."""
        if d_mean is None:
            return
        kf_slot = int(np.where(self.map.kf_frame_id == frame.frame_id)[0][0])
        with self.permon.timer("kf_detect"):
            grid, segs, occupied, egrid = fused.fetch(
                self._dispatch_seed_detection(frame))
        self._complete_seed_init(kf_slot, d_mean, d_min, grid, segs, occupied,
                                 egrid)

    def _complete_seed_init(self, kf_slot, d_mean, d_min, grid, segs,
                            occupied, egrid):
        """New point seeds in free cells (corners, then edgelets in the cells
        the corners leave empty, when egrid is given); new line seeds from
        the host-deduplicated segment candidates."""
        with self.permon.timer("seed_install"):
            valid = grid.valid & ~occupied
            uv = grid.uv[valid]
            lvl = grid.level[valid]
            typ = np.zeros(len(uv), np.int32)
            gdir = np.zeros((len(uv), 2), np.float32)
            if egrid is not None:
                e_ok = egrid.valid & ~occupied & ~grid.valid
                uv = np.concatenate([uv, egrid.uv[e_ok]], 0)
                lvl = np.concatenate([lvl, egrid.level[e_ok]], 0)
                typ = np.concatenate([typ, np.ones(int(e_ok.sum()),
                                                   np.int32)])
                gdir = np.concatenate([gdir, egrid.grad_dir[e_ok]], 0)
            f = (self._np_unproject(uv) if len(uv)
                 else np.zeros((0, 3), np.float32))
            mu, sigma2, z_range = df.seed_init_params(d_mean, d_min)
            self._install_point_seeds(kf_slot, uv, f, lvl, typ, gdir, mu,
                                      sigma2, z_range)
            if segs is not None:
                self._install_line_seeds(
                    kf_slot, self._dedup_segments_host(segs), mu, sigma2,
                    z_range)

    def _install_frame(self) -> int:
        """The newest frame whose step was dispatched before a seed install
        now: the harvest keeps the mirror's alive flags for installs at or
        after a result's frame. Here the current frame (add_image counts it
        after its step); a batch runner that counts at dispatch replaces
        this."""
        return self.frame_id

    # The seed tables' access points: a batch runner that keeps every
    # sequence's tables stacked on the device replaces these per instance
    def _get_seed_tables(self):
        return self.pt_seeds, self.ln_seeds

    def _set_seed_tables(self, pt_seeds, ln_seeds):
        self.pt_seeds = pt_seeds
        self.ln_seeds = ln_seeds

    def _install_point_seeds(self, kf_slot, uv, f, lvl, typ, gdir, mu, sigma2,
                             z_range):
        free = np.where(~self._seed_alive)[0][: len(uv)]
        k = len(free)
        if not k:
            return
        sh = self._seed_host
        sh["kf_idx"][free] = kf_slot
        sh["uv"][free] = uv[:k]
        sh["f"][free] = f[:k]
        sh["level"][free] = lvl[:k]
        sh["type"][free] = typ[:k]
        sh["dir"][free] = gdir[:k]
        self._seed_alive[free] = True
        self._seed_install_frame[free] = self._install_frame()
        B = self._bucket(k, self.cfg.caps.max_seeds)
        rows = np.zeros(B, np.float32)
        rows[:k] = free
        mask = np.zeros(B, np.float32)
        mask[:k] = 1.0
        uvp = np.zeros((B, 2), np.float32)
        uvp[:k] = uv[:k]
        fp = np.zeros((B, 3), np.float32)
        fp[:k] = f[:k]
        lv = np.zeros(B, np.float32)
        lv[:k] = lvl[:k]
        blob = np.concatenate([rows, mask, np.full(B, kf_slot, np.float32),
                               uvp.ravel(), fp.ravel(), lv])
        pt_tab, ln_tab = self._get_seed_tables()
        self._set_seed_tables(df.scatter_new_point_seeds_blob(
            pt_tab, self._dev(blob), B=B,
            scalars=(mu, sigma2, z_range, self.batch_counter)), ln_tab)

    def _install_line_seeds(self, kf_slot, segs, mu, sigma2, z_range):
        sp = segs.sp[segs.valid]
        ep = segs.ep[segs.valid]
        free = np.where(~self._lnseed_alive)[0][: len(sp)]
        k = len(free)
        if not k:
            return
        sf = self._np_unproject(sp[:k])
        ef = self._np_unproject(ep[:k])
        lh = self._lnseed_host
        lh["kf_idx"][free] = kf_slot
        lh["s_uv"][free] = sp[:k]
        lh["e_uv"][free] = ep[:k]
        lh["sf"][free] = sf
        lh["ef"][free] = ef
        lh["level"][free] = 0
        self._lnseed_alive[free] = True
        self._lnseed_install_frame[free] = self._install_frame()
        B = self._bucket(k, self.cfg.caps.max_seed_segs)
        rows = np.zeros(B, np.float32)
        rows[:k] = free
        mask = np.zeros(B, np.float32)
        mask[:k] = 1.0
        z2 = np.zeros((B - k, 2), np.float32)
        z3 = np.zeros((B - k, 3), np.float32)
        blob = np.concatenate([
            rows, mask, np.full(B, kf_slot, np.float32),
            np.concatenate([sp[:k], z2]).ravel(),
            np.concatenate([ep[:k], z2]).ravel(),
            np.concatenate([sf, z3]).ravel(), np.concatenate([ef, z3]).ravel(),
            np.zeros(B, np.float32)])
        pt_tab, ln_tab = self._get_seed_tables()
        self._set_seed_tables(pt_tab, df.scatter_new_line_seeds_blob(
            ln_tab, self._dev(blob), B=B,
            scalars=(mu, sigma2, z_range, self.batch_counter)))

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        b = 32
        while b < n and b < cap:
            b *= 2
        return min(b, cap)

    def _update_seeds(self, frame: FrameState):
        """The staged seed update of one frame (the JAX handler's; nothing
        on the tracking path calls it, the fused step updates the seeds):
        the alive rows (host mirrors) compacted into the smallest
        power-of-two bucket that holds them, updated and written back by
        depth_filter.update_*_seeds_bucketed. The results stay on the
        device until _harvest_seeds."""
        pl = self.cfg.pipeline
        m = self.map
        n = pl.n_pyr_levels
        R_w = np.swapaxes(m.kf_R, 1, 2)
        t_w = -np.einsum("kji,kj->ki", m.kf_R, m.kf_t)
        R_w_cur = frame.R_f_w.T
        t_w_cur = -frame.R_f_w.T @ frame.t_f_w
        args = (self._dev(R_w.astype(np.float32)),
                self._dev(t_w.astype(np.float32)), m.kf_atlas_flat(n),
                list(frame.pyr[:n]), self._dev(R_w_cur.astype(np.float32)),
                self._dev(t_w_cur.astype(np.float32)), self._fx, self._fy,
                self._cx, self._cy, self.batch_counter)
        kw = dict(max_seed_kfs=pl.max_seed_kfs,
                  sigma_conv_factor=pl.seed_convergence_sigma2_thresh)

        def bucket(idx, cap):
            B = self._bucket(len(idx), cap)
            rows = np.zeros(B, np.int32)
            rows[:len(idx)] = idx
            return self._dev(rows), self._dev(np.arange(B) < len(idx))

        pt_tab, ln_tab = self._get_seed_tables()
        self._pt_converged_dev = None
        self._pt_rows = np.where(self._seed_alive)[0]
        if len(self._pt_rows):
            pt_tab, res = df.update_point_seeds_bucketed(
                pt_tab, *bucket(self._pt_rows, self.cfg.caps.max_seeds),
                *args, **kw)
            self._pt_converged_dev = (res.converged, res.depth_converged,
                                      res.seeds.alive,
                                      res.skipped.sum().to(torch.int32))
        self._ln_converged_dev = None
        self._ln_rows = np.zeros(0, np.int64)
        if pl.has_ls and self._lnseed_alive.any():
            self._ln_rows = np.where(self._lnseed_alive)[0]
            ln_tab, lres = df.update_line_seeds_bucketed(
                ln_tab, *bucket(self._ln_rows, self.cfg.caps.max_seed_segs),
                *args, **kw)
            self._ln_converged_dev = (lres.converged, lres.depth_s,
                                      lres.depth_e, lres.seeds.alive,
                                      lres.skipped.sum().to(torch.int32))
        self._set_seed_tables(pt_tab, ln_tab)

    def _harvest_seeds(self):
        """Fetch (one copy) and apply the pending results of _update_seeds;
        nothing is pending on the fused path, where this is a no-op."""
        pending = (self._pt_converged_dev, self._ln_converged_dev)
        if pending == (None, None):
            return
        self._apply_harvest(*fused.fetch(pending), result_frame_id=None)

    def _apply_harvest(self, pt_conv, ln_conv, result_frame_id):
        """Converged seeds become CANDIDATE landmarks; the host alive
        mirrors update from the same fetch. Two formats: the fused step's
        compact one (converged rows and depths, bit-packed masks) and the
        staged one of _update_seeds (bucket-space masks, mapped back to
        table rows through _pt_rows / _ln_rows). In the compact format rows
        installed at or after the frame of the step's dispatch keep the
        mirror's value: their install happened after the step was
        dispatched, even in the same add_image, where a drain installs a
        keyframe's seeds after the newest step went out. (The JAX package
        compares with a strict >, so there the newest step's mask marks
        the fresh seeds dead.) Any harvest drops the pending staged
        results, as in the JAX package."""
        self._pt_converged_dev = None
        self._ln_converged_dev = None
        if pt_conv is not None:
            self._harvest_points(pt_conv, result_frame_id)
        if ln_conv is not None:
            self._harvest_lines(ln_conv, result_frame_id)

    def _harvest_points(self, pt_conv, result_frame_id: int):
        m = self.map
        if len(pt_conv) == 4:  # staged bucket-mask format (_update_seeds)
            conv, depth, alive_b, n_starved = pt_conv
            nrows = len(self._pt_rows)
            self._seed_alive[self._pt_rows] = alive_b[:nrows]
            pairs = [(int(self._pt_rows[bi]), float(depth[bi]))
                     for bi in np.where(conv[:nrows])[0]]
        else:
            rows_c, depth_c, n_conv, alive_w, n_starved = pt_conv
            cap = self.cfg.caps.max_seeds
            alive_new = fused.unpack_bits16(alive_w, cap)
            stale = self._seed_install_frame >= result_frame_id
            alive_new[stale] = self._seed_alive[stale]
            self._seed_alive[:] = alive_new
            pairs = [(int(r), float(d)) for r, d in zip(rows_c, depth_c)
                     if r < cap]
            pairs = pairs[: int(n_conv)]
            # converged seeds past the report budget die without a landmark
            # (as in the JAX package); count them
            self.permon.log("seed_conv_dropped",
                            max(int(n_conv) - fused.CONV_BUDGET, 0))
        self.permon.log("seed_starved", int(n_starved))
        sh = self._seed_host
        for i, depth_i in pairs:
            k = sh["kf_idx"][i]
            if not m.kf_occupied[k]:
                continue
            Rk, tk = m.kf_R[k], m.kf_t[k]
            pos_w = Rk.T @ (sh["f"][i] * depth_i - tk)
            m.new_point(pos_w, int(k), sh["uv"][i], sh["f"][i],
                        int(sh["level"][i]), status=ST_CANDIDATE,
                        ftype=int(sh["type"][i]), grad_dir=sh["dir"][i])

    def _harvest_lines(self, ln_conv, result_frame_id: int):
        m = self.map
        if len(ln_conv) == 5:  # staged bucket-mask format (_update_seeds)
            conv, ds, de, alive_b, n_starved = ln_conv
            nrows = len(self._ln_rows)
            self._lnseed_alive[self._ln_rows] = alive_b[:nrows]
            triples = [(int(self._ln_rows[bi]), float(ds[bi]), float(de[bi]))
                       for bi in np.where(conv[:nrows])[0]]
        else:
            rows_c, ds_c, de_c, n_conv, alive_w, n_starved = ln_conv
            cap = self.cfg.caps.max_seed_segs
            alive_new = fused.unpack_bits16(alive_w, cap)
            stale = self._lnseed_install_frame >= result_frame_id
            alive_new[stale] = self._lnseed_alive[stale]
            self._lnseed_alive[:] = alive_new
            triples = [(int(r), float(a), float(b))
                       for r, a, b in zip(rows_c, ds_c, de_c)
                       if r < cap][: int(n_conv)]
        self.permon.log("seed_starved_ln", int(n_starved))
        lh = self._lnseed_host
        for i, ds_i, de_i in triples:
            k = lh["kf_idx"][i]
            if not m.kf_occupied[k]:
                continue
            Rk, tk = m.kf_R[k], m.kf_t[k]
            spos = Rk.T @ (lh["sf"][i] * ds_i - tk)
            epos = Rk.T @ (lh["ef"][i] * de_i - tk)
            m.new_line(spos, epos, int(k), lh["s_uv"][i], lh["e_uv"][i],
                       lh["sf"][i], lh["ef"][i], int(lh["level"][i]),
                       status=ST_CANDIDATE)

    # ------------------------------------------------------------------
    def _relocalize(self, img, pyr, ts) -> FrameResult:
        """Align against the closest FoV-overlapping keyframe."""
        self.n_relocalizations += 1
        frame = FrameState.empty(self.cfg, self.frame_id, ts, pyr,
                                 self.last_frame.R_f_w.copy(),
                                 self.last_frame.t_f_w.copy())
        slot = self.map.closest_overlap_kf_slot(
            self.last_frame.R_f_w, self.last_frame.t_f_w,
            self._fx, self._fy, self._cx, self._cy)
        if slot is None:
            ready = self._ready
            self._reset()
            self._ready = ready
            return self._in_order(FrameResult(
                frame.frame_id, STAGE_RELOCALIZING, QUALITY_INSUFFICIENT, 0,
                0, False, frame.R_f_w, frame.t_f_w))
        kf_frame = self._frame_from_kf(slot, ts)
        pts_in, segs_in = self._align_inputs_from_frame(kf_frame)
        ares = sparse_align.sparse_img_align(
            kf_frame.pyr, pyr, pts_in, segs_in,
            torch.eye(3, device=self.device), torch.zeros(3, device=self.device),
            self._fx, self._fy, self._cx, self._cy,
            levels=tuple(range(self.cfg.pipeline.klt_max_level,
                               self.cfg.pipeline.klt_min_level - 1, -1)),
            n_iter=self.cfg.pipeline.img_align_n_iter)
        n_tr, R_ck, t_ck = fused.fetch((ares.n_tracked_pts, ares.R, ares.t))
        if int(n_tr) > 30:
            frame.R_f_w = (R_ck @ kf_frame.R_f_w).astype(np.float32)
            frame.t_f_w = (R_ck @ kf_frame.t_f_w + t_ck).astype(np.float32)
            self.last_frame = kf_frame
            self.stage = STAGE_DEFAULT
            res = self._process_frame(img, ts, pyr)
            if res is None or res.frame_id != frame.frame_id:
                # pipelined mode: the resumed frame's result comes with a
                # later drain, as a DEFAULT result; what returns now is an
                # earlier frame's, and keeps its stage (the JAX package
                # relabels it as relocalizing)
                return res
            return FrameResult(res.frame_id, STAGE_RELOCALIZING, res.quality,
                               res.n_pt_matches, res.n_seg_matches,
                               res.is_keyframe, res.R_f_w, res.t_f_w)
        return self._in_order(FrameResult(
            frame.frame_id, STAGE_RELOCALIZING, QUALITY_INSUFFICIENT, 0, 0,
            False, frame.R_f_w, frame.t_f_w))

    def _in_order(self, res: FrameResult) -> FrameResult:
        """A result made now, returned after the earlier frames' results
        not yet returned (pipelined mode), so results stay in frame order."""
        if not self._ready:
            return res
        self._ready.append(res)
        return self._ready.pop(0)

    def _frame_from_kf(self, slot: int, ts) -> FrameState:
        m = self.map
        fr = FrameState.empty(self.cfg, int(m.kf_frame_id[slot]), ts,
                              [p[slot] for p in m.kf_pyr],
                              m.kf_R[slot], m.kf_t[slot])
        fr.pt_uv = m.kf_pt_uv[slot].copy()
        fr.pt_f = m.kf_pt_f[slot].copy()
        fr.pt_level = m.kf_pt_level[slot].copy()
        fr.pt_lm = m.kf_pt_lm[slot].copy()
        fr.pt_valid = m.kf_pt_lm[slot] >= 0
        fr.seg_suv = m.kf_seg_suv[slot].copy()
        fr.seg_euv = m.kf_seg_euv[slot].copy()
        fr.seg_sf = m.kf_seg_sf[slot].copy()
        fr.seg_ef = m.kf_seg_ef[slot].copy()
        fr.seg_level = m.kf_seg_level[slot].copy()
        fr.seg_lm = m.kf_seg_lm[slot].copy()
        fr.seg_valid = m.kf_seg_lm[slot] >= 0
        fr.is_keyframe = True
        return fr

    # ------------------------------------------------------------------
    def reset(self):
        """User-triggered full reset (start over from FIRST)."""
        self._reset()

    def start(self):
        """Resume from PAUSED (the handler never pauses itself; kept for the
        reference's interface, FrameHandlerBase::start)."""
        if self.stage == STAGE_PAUSED:
            self.stage = STAGE_FIRST

    def last_processing_time(self) -> float:
        """Seconds spent in the most recent add_image."""
        return float(self.permon.timers.get("tot_time", 0.0))

    def _reset(self):
        caps = self.cfg.caps
        self.stage = STAGE_FIRST
        self.map = self._new_map()
        self.pt_seeds = df.empty_point_seeds(caps.max_seeds, self.device)
        self.ln_seeds = df.empty_line_seeds(caps.max_seed_segs, self.device)
        self.last_frame = None
        self.first_frame = None
        self._first_uv = None
        self.batch_counter = 0
        S = caps.max_seeds
        self._seed_host = {
            "kf_idx": np.zeros(S, np.int32), "uv": np.zeros((S, 2), np.float32),
            "f": np.zeros((S, 3), np.float32), "level": np.zeros(S, np.int32),
            "type": np.zeros(S, np.int32), "dir": np.zeros((S, 2), np.float32)}
        self._seed_alive = np.zeros(S, bool)
        self._seed_install_frame = np.full(S, -1, np.int64)
        SL = caps.max_seed_segs
        self._lnseed_host = {
            "kf_idx": np.zeros(SL, np.int32), "s_uv": np.zeros((SL, 2), np.float32),
            "e_uv": np.zeros((SL, 2), np.float32), "sf": np.zeros((SL, 3), np.float32),
            "ef": np.zeros((SL, 3), np.float32), "level": np.zeros(SL, np.int32)}
        self._lnseed_alive = np.zeros(SL, bool)
        self._lnseed_install_frame = np.full(SL, -1, np.int64)
        # the staged seed update's results awaiting _harvest_seeds, and the
        # table rows of their bucket rows
        self._pt_converged_dev = None
        self._ln_converged_dev = None
        self._pt_rows = np.arange(S)
        self._ln_rows = np.arange(SL)
        # pipelined mode: the map carry, frames in flight [(FrameState,
        # FullStepResult)], fetch windows in flight, finished results not
        # yet returned, and keyframe detections and local BA results whose
        # fetch waits for the next drain window
        self._mt_carry = None
        self._mt_ne = fused.mt_evict_width(caps.max_kfs,
                                           self.cfg.pipeline.pipeline_depth)
        self._pipe_q = []
        self._fetch_q = []
        self._ready = []
        self._pending_seed_init = []
        self._pending_ba = []
