"""The SLAM system's serial frame loop for RGB-D sequences: metric init,
front-end, PnP tracking and the keyframe rule (port of
visual_slam_tpu/pipeline.py:110-164, :651-667, :680-804, :1076-1358,
:3125-3174).

The re-architecture of the reference's main loop `src/v2/main.py:53-353`: the
same stage semantics and gates (SURVEY.md §3.1-3.4), with every per-frame
computation on fixed-shape tensors; the host loop does bookkeeping only.

Stage map (reference -> here):
  map init, RGB-D (main.py:88-148)  -> Slam._initialize_rgbd
  tracking loop (main.py:173-221)   -> Slam._track (track_step)
  keyframe rule (main.py:221)       -> Slam._keyframe_rule

What this slice does not do yet: monocular two-view init, keyframe
insertion with landmark mining and BA, relocalisation, loop closure and
the pipelined frame loop. A frame that the keyframe rule selects is counted in
`stats["kf_candidates"]`, and tracking continues against the first
keyframe's snapshot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .config import SlamConfig
from .models import frontend
from .models.map_state import SlamMap
from .ops import match, pnp
from .utils.profiling import StageTimers


@dataclass
class FrameResult:
    frame_idx: int
    R_cw: np.ndarray
    t_cw: np.ndarray
    n_tracked: int
    is_keyframe: bool


class TrackStep(NamedTuple):
    R: torch.Tensor  # (3,3) world->camera
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (M,) PnP inlier mask over snapshot slots
    n_inliers: torch.Tensor  # () int
    idx2: torch.Tensor  # (M,) best-match feature index per snapshot slot
    used_ransac: bool


def track_step(feats: frontend.Features, snap: dict, prev_R: torch.Tensor,
               prev_t: torch.Tensor, intr: torch.Tensor, *, ratio: float,
               max_hamming: float, threshold_px: float, n_hyps: int,
               refine_iters: int, cross_check: bool = True,
               generator: torch.Generator | None = None,
               ransac_idx: torch.Tensor | None = None) -> TrackStep:
    """One tracking step: match the local map -> tiered PnP.

    ≙ main.py:180-214 (match_features + solvePnPRansac with extrinsic guess
    + motion-only refinement of the current frame). `ransac_idx`, when
    given, replaces the RANSAC minimal sets drawn from `generator`.
    """
    idx2, _, good = match.match_ratio_test(
        snap["desc"], feats.desc, snap["valid"], feats.valid, ratio=ratio,
        max_distance=max_hamming, cross_check=cross_check,
    )
    R, t, inliers, n_in, used_ransac = pnp.solve_pnp_tracked(
        snap["xyz"], feats.uv[idx2], intr, good, prev_R, prev_t,
        idx=ransac_idx, generator=generator, n_hyps=n_hyps,
        threshold_px=threshold_px, refine_iters=refine_iters,
    )
    return TrackStep(R, t, inliers, n_in, idx2, used_ransac)


def _backproject_depth(uv: np.ndarray, depth: np.ndarray, intr: np.ndarray):
    """Backproject pixels through a metric depth map (camera frame).

    Returns (X (N,3) camera-frame points, ok (N,) valid-depth mask)."""
    h, w = depth.shape
    xi = np.clip(uv[:, 0].astype(np.int32), 0, w - 1)
    yi = np.clip(uv[:, 1].astype(np.int32), 0, h - 1)
    z = depth[yi, xi]
    ok = (z > 0.05) & (z < 20.0)
    fx, fy, cx, cy = intr
    X = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z], axis=-1)
    return X.astype(np.float32), ok


class Slam:
    """The SLAM system. Feed frames via `process`; read `trajectory`.

    All tensors live on `device`; a torch.Generator seeded from cfg.seed
    draws the RANSAC minimal sets."""

    def __init__(self, config: SlamConfig | None = None, device="cpu"):
        self.cfg = config or SlamConfig()
        self.device = torch.device(device)
        self.map = SlamMap(self.cfg.map)
        self.intr = torch.as_tensor(self.cfg.intrinsics, dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.cfg.seed)
        self.initialized = False
        self.trajectory: list[FrameResult] = []
        self._snapshot = None
        self._prev_R = None  # host copy of the last accepted pose
        self._prev_t = None
        self._pose_dev = None  # the same pose on the device (seeds the next PnP)
        self._frames_since_kf = 0
        self.stats = {
            "init_frame": None,
            "track_failures": 0,
            "kf_candidates": 0,
            "ransac_frames": 0,
        }
        self.timers = StageTimers(self.device)

    def process(self, frame_idx: int, gray: np.ndarray, depth: np.ndarray | None = None):
        """Process one frame: grayscale float32 (H,W) in [0,1], or uint8
        gray/RGB; `depth` is (H,W) float32 metres."""
        with self.timers.time("extract"):
            feats = frontend.extract(
                torch.as_tensor(gray).to(self.device), self.cfg.frontend.max_features,
                self.cfg.frontend.quality_level, self.cfg.frontend.nms_radius,
            )
        if not self.initialized:
            with self.timers.time("initialize"):
                self._try_initialize(frame_idx, feats, depth)
        else:
            with self.timers.time("track"):
                self._track(frame_idx, feats)

    def _try_initialize(self, frame_idx, feats, depth):
        if not (self.cfg.use_depth and depth is not None):
            raise NotImplementedError(
                "monocular two-view initialisation is not ported yet: use "
                "SlamConfig(use_depth=True) and frames with depth"
            )
        self._initialize_rgbd(frame_idx, feats, depth)

    def _initialize_rgbd(self, frame_idx, feats, depth):
        """RGB-D initialisation: backproject the features through the metric
        depth map, so the map is metric from frame one."""
        kf0 = self.map.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), frame_idx)
        uv = feats.uv.cpu().numpy()
        valid = feats.valid.cpu().numpy()
        X, ok = _backproject_depth(uv, depth, self.cfg.intrinsics)
        sel = np.where(valid & ok)[0]
        pt_ids = self.map.add_points(X[sel], feats.desc.cpu().numpy()[sel])
        self.map.add_observations(kf0, pt_ids, uv[sel], depth=X[sel, 2])
        self._finish_keyframe(kf0)
        self.initialized = True
        self.stats["init_frame"] = frame_idx
        self.trajectory.append(FrameResult(
            frame_idx, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), len(sel), True,
        ))

    def _finish_keyframe(self, kf_id):
        """Reset the tracking state around a new keyframe (≙ main.py:330-345)."""
        self._snapshot = self.map.local_snapshot(kf_id, self.device)
        self._prev_R = self.map.kf_R[kf_id].copy()
        self._prev_t = self.map.kf_t[kf_id].copy()
        self._pose_dev = (
            torch.from_numpy(self._prev_R).to(self.device),
            torch.from_numpy(self._prev_t).to(self.device),
        )
        self._frames_since_kf = 0

    def _track(self, frame_idx, feats):
        cfg = self.cfg
        snap = self._snapshot
        step = track_step(
            feats, snap, *self._pose_dev, self.intr,
            ratio=cfg.frontend.match_ratio, max_hamming=cfg.frontend.max_hamming,
            threshold_px=cfg.tracking.pnp_threshold_px,
            n_hyps=cfg.tracking.pnp_hypotheses, refine_iters=cfg.tracking.refine_iters,
            cross_check=cfg.frontend.cross_check, generator=self.generator,
        )
        self.stats["ransac_frames"] += int(step.used_ransac)
        n_tracked = int(step.n_inliers)
        if n_tracked < cfg.tracking.min_tracked_points:
            # ≙ _handle_track_failure without relocalisation (not ported):
            # keep the previous pose.
            self.stats["track_failures"] += 1
            R_np, t_np = self._prev_R.copy(), self._prev_t.copy()
        else:
            R_np, t_np = step.R.cpu().numpy(), step.t.cpu().numpy()
            self._prev_R, self._prev_t = R_np, t_np
            self._pose_dev = (step.R, step.t)
        self._frames_since_kf += 1
        if self._keyframe_rule(n_tracked, snap["n_valid"]):
            self.stats["kf_candidates"] += 1
        self.trajectory.append(FrameResult(frame_idx, R_np, t_np, n_tracked, False))

    def _keyframe_rule(self, n_tracked: int, n_local: int) -> bool:
        """Keyframe decision ≙ main.py:221, evaluated on the host. The
        threshold is float32 on purpose, as in the JAX package: f64 could
        flip borderline frames."""
        cfg = self.cfg
        want = (
            self._frames_since_kf > cfg.keyframe.max_interval
            or n_tracked < cfg.keyframe.min_tracked
        ) and n_tracked < float(
            np.float32(cfg.keyframe.tracked_ratio) * np.float32(max(n_local, 1))
        )
        want = want and self._frames_since_kf >= cfg.keyframe.min_gap
        return want and n_tracked >= cfg.tracking.min_tracked_points

    def positions(self) -> tuple[np.ndarray, np.ndarray]:
        """(frame_indices (N,), camera centres (N,3)) of the trajectory."""
        idxs = np.array([f.frame_idx for f in self.trajectory])
        R = np.stack([f.R_cw for f in self.trajectory])
        t = np.stack([f.t_cw for f in self.trajectory])
        return idxs, -np.einsum("nji,nj->ni", R, t)


def run_sequence(dataset, config: SlamConfig | None = None, start: int = 0,
                 stop: int | None = None, device="cpu") -> Slam:
    """Run SLAM serially over a dataset (any object with the reader's
    `frames(start, stop)` -> (idx, gray, depth) interface); returns the Slam."""
    slam = Slam(config, device=device)
    for i, gray, depth in dataset.frames(start, stop):
        slam.process(i, gray, depth)
    return slam
