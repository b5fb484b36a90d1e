"""Configuration dataclasses (port of visual_slam_tpu/config.py).

The reference hard-codes every constant inline (SURVEY.md §5 "Config / flag
system: none"); this module gathers them, with the reference values and
their file:line provenance as defaults (visual_slam_tpu/config.py:17-141),
and `size_config_for` (visual_slam_tpu/pipeline.py:2380-2400).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

from .models.loop_closure import LoopClosureConfig


@dataclass
class FrontendConfig:
    max_features: int = 1024  # reference allows 3000 corners (frame.py:11)
    quality_level: float = 0.01  # goodFeaturesToTrack quality (frame.py:11)
    nms_radius: int = 3  # minDistance 7 -> radius 3 (frame.py:11)
    match_ratio: float = 0.8  # Lowe ratio (frame.py:20)
    max_hamming: float = 96.0
    cross_check: bool = True


@dataclass
class TwoViewConfig:
    ess_threshold_factor: float = 3.0  # essTh = 3.0/fx (main.py:103)
    ransac_hypotheses: int = 512
    use_model_selection: bool = False  # homography-vs-essential init (v1 slam_test.py:207-218)
    min_matches: int = 100  # skip-frame gate (main.py:97-98)
    min_valid_fraction: float = 0.9  # cheirality gate (main.py:113-114)
    distance_thresh: float = 50.0  # recoverPose distanceThresh (helper_functions.py:176)
    min_init_parallax_deg: float = 1.0  # median-parallax init gate (new; see pipeline.init_step)
    # Below this median match flow the 0.9 validFraction gate cannot be met
    # (lr traj3: validFraction 0.36 at ~87 px), so init_step skips the
    # essential RANSAC and cheirality vote and returns frac = -1.
    min_flow_px: float = 30.0
    # Anchor re-seeding: once the current frame is this many frames past the
    # init anchor, the anchor slides to the current frame. A pathological
    # anchor (a monocular run starting at lr frame 200) otherwise starves
    # init forever; 150 clears the healthy accept horizon (~63 frames).
    reanchor_after: int = 150


@dataclass
class TrackingConfig:
    pnp_hypotheses: int = 128  # extrinsic-guess hypothesis carries tracking; 128 random seeds suffice
    pnp_threshold_px: float = 8.0  # cv2.solvePnPRansac default reprojectionError
    # Gauss-Newton iterations per refine round (the tiered PnP runs TWO
    # re-gated rounds). 10 ≙ the reference's motion-only LM iterations
    # (LocalBA.py:39). DO NOT lower to save time per frame: in the JAX
    # package a 600-frame A/B showed parity (ATE 0.0353 at 5 vs 0.0367 at
    # 10), but the under-converged per-frame poses compound into monocular
    # scale drift that only shows at full length — 1200-frame no-loop ATE
    # 0.048 at 10 vs 0.595 at 5, with the measured map scale exploding past 3x.
    refine_iters: int = 10
    min_tracked_points: int = 10  # hard floor to accept a pose


@dataclass
class KeyframeConfig:
    max_interval: int = 20  # main.py:221
    min_tracked: int = 80  # main.py:221
    tracked_ratio: float = 0.9  # main.py:221
    # Minimum frames between keyframes. The reference has no floor
    # (main.py:221); the JAX package needs a SMALL one because its keyframe
    # insertion is pipelined and the rule chatters in low-texture segments
    # where mining starves (lr traj3 frames ~350-400): floor 0 gave 96
    # keyframes with 1-frame-apart bursts and ATE 0.081; floor 10 BECAME the
    # cadence. 5 suppresses the chatter without ever being the binding
    # constraint on the healthy cadence (10-21 frames).
    min_gap: int = 5
    cull_min_views: int = 3  # main.py:235
    cull_every: int = 4  # main.py:234
    cull_after: int = 6  # main.py:234
    # New-point parallax gate (≙ helper_functions.py:211-267 min_parallax,
    # which the reference's main loop never calls). Off: in the JAX package
    # 0.5° helped a 200-frame run slightly (ATE 0.0086 vs 0.0125) but starved
    # the map into tracking collapse on 600 frames (ATE 0.28 + 59 failures
    # vs 0.037 + 0). min_mined_points protects runs that enable it.
    min_parallax_deg: float = 0.0
    # When the strict parallax gate would mine fewer landmarks than this, the
    # ungated (reprojection + depth) mask is used instead: a starved snapshot
    # cascades into keyframe-every-frame collapse on low-motion segments.
    min_mined_points: int = 40
    max_new_depth: float = 10.0  # cheirality/depth gate for mined points
    triangulation_reproj_px: float = 4.0


@dataclass
class BAConfig:
    iters: int = 10  # optimizer.optimize(10) (LocalBA.py:39)
    cg_iters: int = 12  # truncated CG doubles as a trust region; 12 beats 24 on ATE
    scale_gauge_on_init: bool = True  # median-depth normalize (LocalBA.py:179-190)
    # "cg": implicit-Schur truncated PCG, whose truncation is a trust region
    # that long runs need (JAX package, 1000-frame lr traj3: exact Cholesky
    # steps warp to ATE 0.72, CG-12 holds 0.044). "chol": explicit reduced
    # camera system + dense Cholesky, the exact LM step.
    solver: str = "cg"
    # RGB-D inverse-depth residual weight (models/ba._depth_terms); active in
    # use_depth mode only, 0 disables. The reference never uses depth in BA.
    depth_weight: float = 1.0
    # Full-BA cadence in keyframes; 1 ≙ the reference (global BA on every
    # keyframe, main.py:322-323). Values > 1 skip the BA on intermediate
    # keyframes, whose observations join the next scheduled BA.
    every_n_kf: int = 1


@dataclass
class MapConfig:
    """Fixed capacities of the map's arrays (≙ visual_slam_tpu/models/
    map_state.py:26-35). Sized for a full ICL-NUIM sequence (~60 keyframes
    x ~400 observations); the arrays double when a capacity is reached."""

    max_keyframes: int = 64
    max_points: int = 8192
    max_observations: int = 32768
    track_capacity: int = 2048  # local-snapshot padding (points per keyframe)


@dataclass
class SlamConfig:
    intrinsics: np.ndarray = field(
        default_factory=lambda: np.array([481.20, 480.0, 319.5, 239.5], np.float32)
    )
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    twoview: TwoViewConfig = field(default_factory=TwoViewConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    map: MapConfig = field(default_factory=MapConfig)
    loop: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    seed: int = 0
    use_depth: bool = False  # RGB-D mode: metric init and landmarks from depth


def size_config_for(n_frames: int, config: SlamConfig | None = None) -> SlamConfig:
    """A copy of `config` (default: SlamConfig()) sized for an n-frame run:
    map capacities for ~n/8 keyframes (the keyframe rule's cadence keeps
    them below that), and BA on every 2nd keyframe past 600 frames. The
    JAX package's version mutates the config it is given (ROADMAP Queue C,
    a listed non-fault); this one leaves it as it was."""
    cfg = copy.deepcopy(config) if config is not None else SlamConfig()
    need_kf = max(64, 2 ** int(np.ceil(np.log2(max(n_frames // 8, 1)))))
    if cfg.map.max_keyframes < need_kf:
        cfg.map.max_keyframes = need_kf
        cfg.map.max_points = max(cfg.map.max_points, need_kf * 128)
        cfg.map.max_observations = max(cfg.map.max_observations, need_kf * 512)
    if n_frames > 600 and cfg.ba.every_n_kf == 1:
        # Full-BA cadence on long monocular sequences, set by the JAX
        # package's A/B on the 1200-frame lr traj3 run: every keyframe ATE
        # 0.0738, every 2nd 0.0482, every 3rd 0.0404, every 6th 0.0553; 2
        # is the least departure from the reference's BA on every keyframe
        # (main.py:322-323) on the good side of that curve.
        cfg.ba.every_n_kf = 2
    return cfg
