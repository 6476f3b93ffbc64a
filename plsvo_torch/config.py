"""Typed config tree for the whole framework.

Replaces the reference's `Config` singleton of ~40 global parameters
(reference: include/plsvo/config.h:42-176, defaults src/config.cpp:82-126)
with one frozen dataclass passed explicitly — no singletons, jit-safe
(every field that shapes arrays is a static Python int).

Extra fields (capacities, batch sizes, mesh axes) configure the TPU-side
fixed-capacity tables and distributed runs; these have no reference
analogue because the reference uses dynamically sized lists and a single
process (SURVEY §2.3, §7.0).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class PipelineConfig:
    """Tracking-pipeline parameters; names follow src/config.cpp:82-126."""

    # feature classes on/off (reference: has_pt/has_ls, frame_handler_mono.cpp:101-125)
    has_pt: bool = True
    has_ls: bool = True
    # bootstrap detector toggles (reference: initialization.cpp:133-140)
    init_pt: bool = True
    init_ls: bool = True

    # pipelined execution: add_image(i) dispatches frame i BEFORE fetching
    # frame i-1's results, hiding the device-sync latency and overlapping
    # host bookkeeping with device compute. Results are returned one frame
    # late (add_image returns frame i-1's FrameResult; call flush() at end
    # of sequence). Map updates reach the device one frame later than in
    # the synchronous mode — the same asynchrony as the reference's
    # mapping thread.
    pipelined: bool = False
    # how many frames stay in flight before a drain fetches them in one
    # copy. On a local card a fetch costs its copy and the host's wait, no
    # fixed latency, so depth 1 already overlaps the card's step of one
    # frame with the host's bookkeeping of an earlier one (each result
    # arrives two calls after its frame). A larger depth K buys fewer,
    # larger fetches and costs lag: results arrive in bursts of K, about K
    # calls later, and map updates (keyframes, seeds, local BA) reach the
    # card as late.
    pipeline_depth: int = 1

    # pyramid
    n_pyr_levels: int = 3
    n_pyr_levels_segs: int = 1

    # map / keyframes
    core_n_kfs: int = 5
    map_scale: float = 1.0
    max_n_kfs: int = 0  # 0 = unlimited (bounded by capacity MAX_KFS)
    kfselect_mindist_t: float = 0.06
    kfselect_mindist_r: float = 3.0  # degrees

    # edgelet features (C3/C5/C9). The reference DEFINES the EDGELET class
    # with a dominant gradient direction (feature.h:54-73) and routes it
    # through align1D in the matcher (matcher.cpp:191-207), but its
    # detector never creates one — the class is dead there. Here grid
    # cells that FAST leaves empty spawn an edgelet seed at the strongest-
    # gradient pixel (SVO-2 style), and edgelet landmarks refine via the
    # batched align1D along the warped direction.
    use_edgelets: bool = True
    edgelet_grad_thresh: float = 20.0  # min |∇I| for an edgelet cell

    # detection grids
    grid_size: int = 25
    grid_size_segs: int = 25
    triang_min_corner_score: float = 20.0
    # min segment length = lsd_min_length * H*W/(H+W) px
    # (feature_detection.cpp:154; ~44 px at 752x480)
    lsd_min_length: float = 0.15

    # initialization (C6)
    init_min_fts: int = 100  # first-frame feature gate (initialization.cpp:44)
    init_min_disparity: float = 40.0
    init_min_tracked: int = 40
    init_min_inliers: int = 30

    # sparse image alignment (C7)
    klt_max_level: int = 4
    klt_min_level: int = 2
    img_align_n_iter: int = 30
    img_align_patch_size: int = 4

    # subpixel feature alignment (C8)
    subpix_n_iter: int = 10
    triang_half_patch_size: int = 4

    # pose optimizer (C13). has_refinement enables the reference's
    # second-overload inlier-only refinement phase of poseoptim_num_iter_ref
    # iterations (pose_optimizer.cpp:469-563); OFF by default because the
    # reference pipeline calls the first overload
    # (frame_handler_mono.cpp:327-329).
    poseoptim_thresh: float = 2.0
    poseoptim_num_iter: int = 10
    poseoptim_num_iter_ref: int = 3
    has_refinement: bool = False

    # structure optimizer
    structureoptim_max_pts: int = 20
    structureoptim_num_iter: int = 5
    structureoptim_max_segs: int = 20
    structureoptim_num_iter_segs: int = 5

    # reprojection / quality (C10, C14)
    # quality_min_fts gates the COMBINED point+segment count
    # (frame_handler_base.cpp:176); quality_max_drop_fts_segs replaces the
    # point-drop check in line-only mode. (The reference also declares
    # quality_min_fts_segs but marks it "pendiente" and never reads it,
    # config.h:223 — dropped here.)
    reproj_thresh: float = 2.0
    quality_min_fts: int = 20
    quality_max_drop_fts: int = 50
    quality_max_drop_fts_segs: int = 50
    max_fts: int = 100
    max_fts_segs: int = 100

    # depth filter (C12)
    seed_convergence_sigma2_thresh: float = 200.0  # depth_filter.cpp:332
    max_seed_kfs: int = 3  # age-out batches (depth_filter.cpp:289)
    # sliding-search budget per frame: only the N seeds with the longest
    # epipolar bands run the window search; sub-2px bands align directly
    # (reference short-epipolar path, matcher.cpp:325-345); the rest wait
    # (reference's bounded mapping queue drops under load,
    # depth_filter.cpp:116-131). 0 = search every seed.
    seed_search_budget: int = 128
    # device-side WORK-SET budget: at most this many point seeds run the
    # expensive warp/search/align chain per frame (highest priority first,
    # short bands before long, failure-rotated — ops/depth_filter.py
    # update_seeds_combined). 0 = all live seeds. The warp gather and the
    # align GN loop scale with processed rows; mid-sequence live counts
    # (~400+) far exceed the useful per-frame work set.
    seed_work_budget: int = 256

    # windowed local bundle adjustment at keyframes (C16). The reference
    # intends this (#ifdef USE_BUNDLE_ADJUSTMENT ba::localBA,
    # frame_handler_mono.cpp:380-383 / bundle_adjustment.cpp:124-255) but
    # ships it dead (never built); here it is real and ON by default:
    # core = FoV-overlapping keyframes of the new KF (free), all other
    # keyframes fixed, landmarks restricted to the window's observations.
    # In pipelined execution the result write-back is deferred into
    # the next drain window (the reference's asynchronous mapping thread
    # has the same lag).
    loba_enabled: bool = True
    loba_num_iter: int = 3
    # quadratic prior anchoring free poses to their tracked input estimates
    # inside localBA (pins the near-flat monocular manifold on planar /
    # short-baseline windows; measured ATE 0.0039 with vs 0.0144 without
    # on the golden sequence once line residuals landed)
    loba_pose_prior: float = 1.0

    # epipolar search (C9): width of the sliding ZMSSD window in px at the
    # search level. Bands longer than this bump to a coarser pyramid level
    # (halving per level) until they fit, so the WHOLE [mu-sigma, mu+sigma]
    # band is always covered; bands too long even at the coarsest level
    # fail the match with the outlier penalty — the reference walks the
    # full band in ~1px-at-search-level steps (0.7px level-0 steps rounded
    # to integer search-level pixels, matcher.cpp:347-390) and likewise
    # gives up beyond max_epi_search_steps (:352-356).
    epi_max_steps: int = 128


@dataclass(frozen=True)
class CapacityConfig:
    """Fixed table capacities for the SoA state (SURVEY §7.0). All shapes
    downstream derive from these; they are static under jit."""

    max_fts: int = 192  # point-feature rows per frame
    max_segs: int = 96  # line-feature rows per frame
    max_kfs: int = 16  # keyframe ring size
    max_points: int = 4096  # 3D point landmarks in the map
    max_lines: int = 1024  # 3D line-segment landmarks
    max_seeds: int = 512  # depth-filter point seeds
    max_seed_segs: int = 256  # depth-filter line seeds
    n_line_samples: int = 8  # fixed patch samples per segment (vs dynamic
    # setupSampling, src/feature.cpp:160-173)
    max_klt_fts: int = 512  # bootstrap KLT tracks
    max_obs_per_landmark: int = 16  # observation slots per landmark (BA);
    #   >= max_keyframes so one slot per live KF always exists and the
    #   add-observation path only ever recycles slots freed by KF eviction
    #   (reference keeps an unbounded obs list, feature3D.h:62-73)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes for batched VO and distributed BA (new capability,
    BASELINE.json configs 4-5; no reference analogue)."""

    data_axis: str = "seq"  # batched sequences axis
    ba_axis: str = "ba"  # landmark-block sharding axis for Schur BA
    n_seq_shards: int = 1
    n_ba_shards: int = 1


@dataclass(frozen=True)
class Config:
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    caps: CapacityConfig = field(default_factory=CapacityConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        return cls(
            pipeline=PipelineConfig(**d.get("pipeline", {})),
            caps=CapacityConfig(**d.get("caps", {})),
            mesh=MeshConfig(**d.get("mesh", {})),
        )


def default_config() -> Config:
    return Config()


def fast_config() -> Config:
    """Smaller capacities + gates scaled for small test images (320x240)."""
    return Config(
        pipeline=PipelineConfig(
            init_min_fts=50, init_min_tracked=30, init_min_disparity=25.0,
            # below the seed capacity so the CPU e2e tests exercise the
            # device-side work-set compaction path
            seed_work_budget=192,
        ),
        caps=CapacityConfig(
            max_fts=128, max_segs=32, max_kfs=8, max_points=1024,
            max_lines=256, max_seeds=256, max_seed_segs=64,
            n_line_samples=4, max_klt_fts=256,
        )
    )
