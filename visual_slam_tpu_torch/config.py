"""Configuration dataclasses (port of visual_slam_tpu/config.py).

The reference hard-codes every constant inline (SURVEY.md §5 "Config / flag
system: none"); this module gathers them, with the reference values and
their file:line provenance as defaults. Only the fields that the ported
slice reads are here (RGB-D init, front-end, PnP tracking, the keyframe
rule); the two-view, BA and loop-closure settings arrive with their modules.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FrontendConfig:
    max_features: int = 1024  # reference allows 3000 corners (frame.py:11)
    quality_level: float = 0.01  # goodFeaturesToTrack quality (frame.py:11)
    nms_radius: int = 3  # minDistance 7 -> radius 3 (frame.py:11)
    match_ratio: float = 0.8  # Lowe ratio (frame.py:20)
    max_hamming: float = 96.0
    cross_check: bool = True


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
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    map: MapConfig = field(default_factory=MapConfig)
    seed: int = 0
    use_depth: bool = False  # RGB-D mode: metric init from depth
