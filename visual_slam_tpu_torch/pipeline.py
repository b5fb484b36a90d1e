"""The SLAM system's serial frame loop: monocular two-view and RGB-D init,
PnP tracking with re-tracking and relocalisation, keyframe insertion with
landmark mining, culling, keyframe-cadence bundle adjustment, loop closure
and the final pose-graph pass (port of visual_slam_tpu/pipeline.py:347-593,
:651-2400, :3125-3174).

The re-architecture of the reference's main loop `src/v2/main.py:53-353`: the
same stage semantics and gates (SURVEY.md §3.1-3.4), with every per-frame
computation on fixed-shape tensors; the host loop does bookkeeping only.

Stage map (reference -> here):
  map init, monocular (main.py:88-148) -> Slam._init_attempt (init_step)
  map init, RGB-D                      -> Slam._initialize_rgbd
  tracking loop (main.py:173-221)      -> Slam._track (track_step)
  keyframe branch (main.py:221-345)    -> Slam._insert_keyframe (mine_step)
  local BA (LocalBA.py:143-190)        -> ba_step via SlamMap.to_ba_problem
  loop closure (new; the reference has none) -> Slam._dispatch_loop_scores,
      _dispatch_loop_verify, _close_loop (models/loop_closure, pose_graph)

A landmark mine applies two frames after its keyframe, a BA three frames
after its dispatch, and a loop scoring pass and its verification two
frames after theirs, as in the JAX package: these fixed apply ages are part
of the semantics (its ATE was tuned on them, and a closure lands on the
same keyframe as there), not a latency workaround. The JAX package's
result-fetch machinery (packed blobs, background fetch pool) is not
ported: on CUDA the work queues asynchronously, and an apply reads its
tensors with `.cpu()`. The batched loop over several sequences is
`multi.run_batched`; the pipelined loop (`run_pipelined`) is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .config import SlamConfig, size_config_for
from .models import ba as ba_mod
from .models import frontend
from .models import loop_closure as lc_mod
from .models import pose_graph as pg
from .models.map_state import SlamMap
from .ops import lie, match, pnp, projection, triangulate, twoview
from .utils.profiling import StageTimers


@dataclass
class FrameResult:
    frame_idx: int
    R_cw: np.ndarray
    t_cw: np.ndarray
    n_tracked: int
    is_keyframe: bool
    # Keyframe the frame tracked against (-1 before init): a frame's pose
    # relative to it is invariant under pose-graph corrections.
    ref_kf: int = -1


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


def _median(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Lower median of x over `keep` (inf when nothing is kept), on the
    device: the JAX package's sort-and-index median."""
    mid = (torch.clamp_min(keep.sum(), 1) - 1) // 2
    return torch.sort(torch.where(keep, x, torch.inf)).values.index_select(0, mid.reshape(1))[0]


class InitStep(NamedTuple):
    n_matches: torch.Tensor  # () int, ratio-test matches
    frac: torch.Tensor  # () cheirality valid fraction; -1 = skipped by the flow floor
    parallax: torch.Tensor  # () median triangulation parallax (degrees)
    R: torch.Tensor  # (3,3) cam0 -> cam1
    t: torch.Tensor  # (3,) unit norm
    idx2: torch.Tensor  # (K,) best-match index into f1 per f0 feature
    cheir: torch.Tensor  # (K,) cheirality-good correspondences
    X1: torch.Tensor  # (K,3) points in the cam-0 frame
    used_H: torch.Tensor  # () bool: the homography won the model selection


def init_step(f0: frontend.Features, f1: frontend.Features, intr: torch.Tensor, *,
              ratio: float, max_hamming: float, ess_threshold: float,
              distance_thresh: float, n_hyps: int, model_selection: bool = False,
              cross_check: bool = True, min_flow_px: float = 0.0,
              generator: torch.Generator | None = None,
              ransac_idx: torch.Tensor | None = None,
              homography_idx: torch.Tensor | None = None) -> InitStep:
    """One two-view initialisation attempt (≙ _init_step; the per-frame body
    of the reference's init loop, main.py:96-114): match -> essential
    RANSAC -> cheirality pose recovery, plus the median parallax of the
    cheirality-good points. The host gates on (n_matches, frac, parallax).

    With `model_selection` the geometry is
    `twoview.estimate_relative_pose_auto`, which also fits a homography and
    keeps the model with the larger inlier support; as in the JAX package it
    runs 512 hypotheses of each at threshold 3/fx, not `n_hyps` and
    `ess_threshold`.

    Below `min_flow_px` median match flow the 0.9 valid-fraction gate is out
    of reach, so the geometry is skipped and frac = -1 (the JAX package's
    lax.cond; here a host branch, one scalar read per attempt).
    `ransac_idx` (n_hyps, 8) and, with model selection, `homography_idx`
    (512, 4), when given, replace the minimal sets drawn from `generator`.
    """
    idx2, _, good = match.match_ratio_test(
        f0.desc, f1.desc, f0.valid, f1.valid, ratio=ratio,
        max_distance=max_hamming, cross_check=cross_check,
    )
    uv1, uv2 = f0.uv, f1.uv[idx2]
    flow = uv2 - uv1
    flow_med = _median(torch.sqrt(torch.sum(flow * flow, dim=-1) + 1e-12), good)
    used_H = torch.zeros((), dtype=torch.bool, device=uv1.device)
    if min_flow_px > 0 and float(flow_med) < min_flow_px:
        K = uv1.shape[0]
        R = torch.eye(3, dtype=uv1.dtype, device=uv1.device)
        t = torch.zeros(3, dtype=uv1.dtype, device=uv1.device)
        X1 = torch.zeros((K, 3), dtype=uv1.dtype, device=uv1.device)
        cheir = torch.zeros(K, dtype=torch.bool, device=uv1.device)
        frac = torch.full((), -1.0, dtype=uv1.dtype, device=uv1.device)
    elif model_selection:
        R, t, X1, cheir, frac, used_H = twoview.estimate_relative_pose_auto(
            uv1, uv2, intr, good, distance_thresh=distance_thresh, idx_E=ransac_idx,
            idx_H=homography_idx, generator=generator)
    else:
        E, inl, _ = twoview.estimate_essential_ransac(
            uv1, uv2, intr, good, threshold=ess_threshold, idx=ransac_idx,
            generator=generator, n_hyps=n_hyps,
        )
        R, t, X1, cheir, frac = twoview.estimate_relative_pose(
            E, uv1, uv2, intr, inl, distance_thresh)
    # Median parallax of the cheirality-good points: a low-parallax pair can
    # pass the valid-fraction gate by luck of the vote and seed a degenerate
    # map, so the host gates on it too (the reference has no such gate).
    C2 = -(R.T @ t)  # cam-1 centre in the cam-0 frame
    r1 = X1 / (torch.linalg.norm(X1, dim=-1, keepdim=True) + 1e-12)
    v2 = X1 - C2
    r2 = v2 / (torch.linalg.norm(v2, dim=-1, keepdim=True) + 1e-12)
    ang = torch.rad2deg(torch.arccos(torch.clamp(torch.sum(r1 * r2, dim=-1), -1.0, 1.0)))
    return InitStep(good.sum(), frac, _median(ang, cheir), R, t, idx2, cheir, X1, used_H)


class MineStep(NamedTuple):
    idx2: torch.Tensor  # (K,) best-match index into the new keyframe's features
    keep: torch.Tensor  # (K,) all gates, parallax included
    keep_loose: torch.Tensor  # (K,) all gates but parallax
    X: torch.Tensor  # (K,3) triangulated world points


def mine_step(prev: frontend.Features, prev_avail: torch.Tensor, cur: frontend.Features,
              R1: torch.Tensor, t1: torch.Tensor, R2: torch.Tensor, t2: torch.Tensor,
              intr: torch.Tensor, *, ratio: float, max_hamming: float,
              reproj_thresh_px: float, max_depth: float, min_parallax_deg: float,
              cross_check: bool = True) -> MineStep:
    """New-landmark mining between two keyframes (≙ _mine_step and
    main.py:237-309): match the previous keyframe's unmapped features,
    DLT-triangulate, gate by cheirality, depth and reprojection, and by the
    parallax gate of the reference's `triangulation` helper
    (helper_functions.py:211-267). Both masks come back: the caller falls
    back to `keep_loose` when the strict yield would starve the map."""
    idx2, _, good = match.match_ratio_test(
        prev.desc, cur.desc, prev_avail, cur.valid, ratio=ratio,
        max_distance=max_hamming, cross_check=cross_check,
    )
    P1 = projection.projection_matrix(lie.make_T(R1, t1), intr)
    P2 = projection.projection_matrix(lie.make_T(R2, t2), intr)
    uv1, uv2 = prev.uv, cur.uv[idx2]
    X = triangulate.dehomogenize(triangulate.triangulate_dlt(P1, P2, uv1, uv2))
    pr1, z1 = projection.project(R1, t1, X, intr)
    pr2, z2 = projection.project(R2, t2, X, intr)
    thr_sq = reproj_thresh_px**2
    reproj_ok = (torch.sum((pr1 - uv1) ** 2, -1) < thr_sq) & (torch.sum((pr2 - uv2) ** 2, -1) < thr_sq)
    depth_ok = (z1 > 0) & (z2 > 0) & (z1 < max_depth) & (z2 < max_depth)
    # Parallax: the angle between the two viewing rays at the point.
    r1 = X + R1.T @ t1  # X - C1
    r2 = X + R2.T @ t2
    r1 = r1 / (torch.linalg.norm(r1, dim=-1, keepdim=True) + 1e-12)
    r2 = r2 / (torch.linalg.norm(r2, dim=-1, keepdim=True) + 1e-12)
    cosang = torch.clamp(torch.sum(r1 * r2, dim=-1), -1.0, 1.0)
    keep_loose = good & reproj_ok & depth_ok
    keep = keep_loose & (torch.rad2deg(torch.arccos(cosang)) >= min_parallax_deg)
    return MineStep(idx2, keep, keep_loose, X)


class BAStep(NamedTuple):
    prob: ba_mod.BAProblem  # the optimised problem
    cost_before: torch.Tensor  # () robust cost before
    cost_after: torch.Tensor  # () and after
    blown: torch.Tensor  # () weighted fraction of observations beyond 3 Huber deltas
    bad: torch.Tensor  # (N,) bool, slots with err > 3 * HUBER_DELTA and w > 0
    behind: torch.Tensor  # () weighted fraction of observations behind their camera


def ba_step(prob: ba_mod.BAProblem, n_iters: int, cg_iters: int, solver: str = "chol",
            use_depth: bool = False) -> BAStep:
    """ba.optimize and its diagnostics (≙ _ba_step, plus `behind`)."""
    cost_before = ba_mod._cost(prob, use_depth=use_depth)
    out, cost_after = ba_mod.optimize(prob, n_iters=n_iters, cg_iters=cg_iters,
                                      solver=solver, use_depth=use_depth)
    r, Xc, _, _, _ = ba_mod._project_planar(out)
    err, w = torch.sqrt(torch.sum(r * r, dim=0)), out.w  # ≙ ba.reproj_errors
    bad = (err > 3.0 * ba_mod.HUBER_DELTA) & (w > 0)
    w_sum = torch.clamp_min(torch.sum(w), 1.0)
    blown = torch.sum(bad.to(w.dtype) * w) / w_sum
    behind = torch.sum((Xc[2] <= 1e-6).to(w.dtype) * w) / w_sum
    return BAStep(out, cost_before, cost_after, blown, bad, behind)


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


def _sample_depth(uv: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """Measured metric depth at pixels, 0 where invalid or out of range
    (feeds the RGB-D inverse-depth BA residual)."""
    h, w = depth.shape
    xi = np.clip(uv[:, 0].astype(np.int32), 0, w - 1)
    yi = np.clip(uv[:, 1].astype(np.int32), 0, h - 1)
    z = depth[yi, xi]
    return np.where((z > 0.05) & (z < 20.0), z, 0.0).astype(np.float32)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _pose_row(step: TrackStep):
    """(R (3,3), t (3,), n_inliers) of a tracking step, in one device read."""
    row = _host(torch.cat([step.R.reshape(9), step.t, step.n_inliers.to(step.R.dtype)[None]]))
    return row[:9].reshape(3, 3), row[9:12].copy(), int(row[12])


_STATS = (
    "keyframes", "ba_runs", "ba_rejected", "ba_dropped_stale", "ba_skipped_interval",
    "culled", "obs_pruned", "obs_compacted", "mine_relaxed", "track_failures",
    "fail_retried_ok", "relocalizations", "kf_retracked", "kf_vetoed_stale",
    "kf_veto_cached", "init_reverify_rejects", "init_rollbacks", "init_reanchors",
    "ransac_frames", "loop_candidates", "loop_verify_fail", "loop_verify_best",
    "loop_rejected_covis", "loop_rejected_unsatisfied", "loop_rejected_warp", "loop_closures",
    "ba_discarded_loop",
)


class Slam:
    """The SLAM system. Feed frames via `process`; read `trajectory`.

    All tensors live on `device`; a torch.Generator seeded from cfg.seed
    draws the RANSAC minimal sets."""

    def __init__(self, config: SlamConfig | None = None, device="cuda"):
        self.cfg = config or SlamConfig()
        self.device = torch.device(device)
        self.map = SlamMap(self.cfg.map)
        self.intr = torch.as_tensor(self.cfg.intrinsics, dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.cfg.seed)
        self.initialized = False
        self.trajectory: list[FrameResult] = []
        self._init_feats = None  # monocular init anchor
        self._init_frame_idx = None
        self._snapshot = None
        self._last_kf_id = None
        self._last_kf_feats = None  # device features of the last keyframe
        self._last_kf_mapped = None  # host bool per feature slot: already a landmark
        self._prev_R = None  # host copy of the last accepted pose
        self._prev_t = None
        self._pose_dev = None  # the last tracking step's pose: seeds the next PnP
        self._frames_since_kf = 0
        # Confirmation-veto cache: a keyframe candidate tracked while a mine
        # was pending is re-tracked against the current map; after a veto,
        # candidates within `_veto_cache_frames` frames skip the re-track
        # while the map state (token) is unchanged. The frame bound matters:
        # in the JAX package an unbounded cache moved full-sequence ATE from
        # 0.0549 to 0.374.
        self._state_token = 0
        self._last_veto_token = -1
        self._last_veto_frame = -(10**9)
        self._veto_cache_frames = 3
        self._pending_ba = None  # dict: BAStep, meta, kf_id, scale_gauge, age
        self._pending_mine = None  # dict: MineStep, keyframe ids and features, age
        self._ba_followup = None  # keyframe needing a BA once the slot frees
        # Loop closure: the keyframe feature store, accepted loop edges
        # (cand, kf, Z_R, Z_t, log relative scale), the cooldown anchor, and
        # the pending scoring pass and verification.
        self._loop_db = lc_mod.KeyframeFeatureDB(
            self.cfg.map.max_keyframes, self.cfg.frontend.max_features, self.device)
        self._loop_edges: list[tuple[int, int, np.ndarray, np.ndarray, float]] = []
        self._last_loop_kf = -(10**9)
        self._pending_loop = None  # dict: scores, kf_id, feats, age
        self._pending_loop_verify = None  # dict: TrackStep, kf_id, cand, feats, snap, age
        # init_model: the two-view model of the accepted monocular init.
        self.stats = {"init_frame": None, "init_model": None, **{k: 0 for k in _STATS},
                      "loop_accepted": [], "loop_rejected_detail": []}
        self.timers = StageTimers(self.device)

    def process(self, frame_idx: int, gray: np.ndarray, depth: np.ndarray | None = None):
        """Process one frame: grayscale float32 (H,W) in [0,1], or uint8
        gray/RGB; `depth` is (H,W) float32 metres."""
        with self.timers.time("extract"):
            feats = frontend.extract(
                torch.as_tensor(gray).to(self.device), self.cfg.frontend.max_features,
                self.cfg.frontend.quality_level, self.cfg.frontend.nms_radius,
            )
        self.consume(frame_idx, feats, depth)

    def consume(self, frame_idx: int, feats: frontend.Features, depth: np.ndarray | None = None):
        """Take one frame's features: an init attempt until the map is
        initialised, then tracking. `process` and the batched loop
        (multi.run_batched) both call it."""
        if not self.initialized:
            with self.timers.time("initialize"):
                self._try_initialize(frame_idx, feats, depth)
        else:
            self._track(frame_idx, feats, depth)

    # ------------------------------------------------------------------ init

    def _try_initialize(self, frame_idx, feats, depth):
        """One frame before initialisation: RGB-D init from the depth map
        where there is one, else a monocular two-view attempt."""
        if self.cfg.use_depth and depth is not None:
            self._initialize_rgbd(frame_idx, feats, depth)
        else:
            self._init_attempt(frame_idx, feats)

    def _init_attempt(self, frame_idx, feats):
        """Monocular init: pair the anchor frame with this one. The first
        frame becomes the anchor; once a frame is `reanchor_after` frames
        past it, the anchor slides to that frame (a pathological anchor
        would otherwise starve init forever)."""
        if self._init_feats is not None and (
            frame_idx - self._init_frame_idx <= self.cfg.twoview.reanchor_after
        ):
            self._try_pair(frame_idx, feats)
            return
        if self._init_feats is not None:
            self.stats["init_reanchors"] += 1
            if self.trajectory and self.trajectory[-1].n_tracked == 0:
                self.trajectory.pop()
        self._init_feats, self._init_frame_idx = feats, frame_idx
        self.trajectory.append(FrameResult(
            frame_idx, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0, True))

    def _init_step(self, f0, f1) -> InitStep:
        cfg = self.cfg
        return init_step(
            f0, f1, self.intr, ratio=cfg.frontend.match_ratio,
            max_hamming=cfg.frontend.max_hamming,
            ess_threshold=cfg.twoview.ess_threshold_factor / float(cfg.intrinsics[0]),
            distance_thresh=cfg.twoview.distance_thresh, n_hyps=cfg.twoview.ransac_hypotheses,
            model_selection=cfg.twoview.use_model_selection,
            cross_check=cfg.frontend.cross_check, min_flow_px=cfg.twoview.min_flow_px,
            generator=self.generator,
        )

    def _try_pair(self, frame_idx, feats, reverified: bool = False) -> bool:
        """Gate one init attempt against the anchor and, on acceptance, build
        the initial map. Returns True when the system becomes initialised."""
        cfg = self.cfg
        f0, anchor_idx = self._init_feats, self._init_frame_idx
        step = self._init_step(f0, feats)
        scal = _host(torch.stack([step.n_matches.to(step.frac.dtype), step.frac, step.parallax,
                                  step.used_H.to(step.frac.dtype)]))
        n_matches = int(scal[0])
        if n_matches < cfg.twoview.min_matches:  # ≙ main.py:97-98
            return False
        if scal[1] < cfg.twoview.min_valid_fraction:  # ≙ main.py:113-114
            return False
        if scal[2] < cfg.twoview.min_init_parallax_deg:
            return False
        if not reverified:
            # validFraction is a high-variance estimator (the RANSAC inlier
            # set jitters across draws): one independent re-estimate with a
            # fresh draw must agree before the pair may build the map.
            if self._try_pair(frame_idx, feats, reverified=True):
                return True
            self.stats["init_reverify_rejects"] += 1
            return False
        R1, t1 = _host(step.R), _host(step.t)
        idx2, good, X = _host(step.idx2), _host(step.cheir), _host(step.X1)
        kf0 = self.map.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), anchor_idx)
        kf1 = self.map.add_keyframe(R1, t1, frame_idx)
        sel = np.where(good)[0]
        pt_ids = self.map.add_points(X[sel], _host(feats.desc)[idx2[sel]])
        self.map.add_observations(kf0, pt_ids, _host(f0.uv)[sel])
        self.map.add_observations(kf1, pt_ids, _host(feats.uv)[idx2[sel]])
        mapped = np.zeros(cfg.frontend.max_features, bool)
        mapped[idx2[sel]] = True
        # Full BA with the monocular median-depth gauge (≙ main.py:145-148).
        self._run_full_ba(scale_gauge=cfg.ba.scale_gauge_on_init)
        # Quality gate (new; the reference accepts any pair that passes the
        # match and cheirality gates): after BA the map must reproject
        # tightly, else roll back and keep searching.
        prob, _ = self.map.to_ba_problem(cfg.intrinsics, device=self.device)
        err, w = (_host(a) for a in ba_mod.reproj_errors(prob))
        n_obs = max(float(w.sum()), 1.0)
        tight_frac = float(((err < 2.0) * w).sum() / n_obs)
        if tight_frac < 0.75 or n_obs < 2 * cfg.twoview.min_matches:
            self.map = SlamMap(cfg.map)
            self.stats["init_rollbacks"] += 1
            return False
        self._loop_db.add(kf0, _host(f0.desc), _host(f0.valid))
        self._loop_db.add(kf1, _host(feats.desc), _host(feats.valid))
        self._finish_keyframe(kf1, feats, mapped, frame_idx)
        self.initialized = True
        self.stats["init_frame"] = frame_idx
        self.stats["init_model"] = "homography" if scal[3] else "essential"
        self.trajectory.append(FrameResult(
            frame_idx, self.map.kf_R[kf1], self.map.kf_t[kf1], n_matches, True))
        return True

    def _initialize_rgbd(self, frame_idx, feats, depth):
        """RGB-D initialisation: backproject the features through the metric
        depth map, so the map is metric from frame one."""
        kf0 = self.map.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), frame_idx)
        uv = _host(feats.uv)
        X, ok = _backproject_depth(uv, depth, self.cfg.intrinsics)
        sel = np.where(_host(feats.valid) & ok)[0]
        pt_ids = self.map.add_points(X[sel], _host(feats.desc)[sel])
        self.map.add_observations(kf0, pt_ids, uv[sel], depth=X[sel, 2])
        mapped = np.zeros(self.cfg.frontend.max_features, bool)
        mapped[sel] = True
        self._loop_db.add(kf0, _host(feats.desc), _host(feats.valid))
        self._finish_keyframe(kf0, feats, mapped, frame_idx)
        self.initialized = True
        self.stats["init_frame"] = frame_idx
        self.trajectory.append(FrameResult(
            frame_idx, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), len(sel), True))

    # ----------------------------------------------------------------- track

    def _track_step(self, feats, snap, R, t) -> TrackStep:
        cfg = self.cfg
        return track_step(
            feats, snap, R, t, self.intr, ratio=cfg.frontend.match_ratio,
            max_hamming=cfg.frontend.max_hamming, threshold_px=cfg.tracking.pnp_threshold_px,
            n_hyps=cfg.tracking.pnp_hypotheses, refine_iters=cfg.tracking.refine_iters,
            cross_check=cfg.frontend.cross_check, generator=self.generator,
        )

    def _dev_pose(self, R_np, t_np):
        return torch.from_numpy(R_np).to(self.device), torch.from_numpy(t_np).to(self.device)

    def _track(self, frame_idx, feats, depth):
        # The pending mine and BA tick once per tracked frame.
        self._apply_pending_ba()
        with self.timers.time("track"):
            cfg = self.cfg
            snap = self._snapshot
            mine_pending = self._pending_mine is not None
            prior = self._pose_dev or self._dev_pose(self._prev_R, self._prev_t)
            step = self._track_step(feats, snap, *prior)
            self._pose_dev = (step.R, step.t)
            self.stats["ransac_frames"] += int(step.used_ransac)
            R_np, t_np, n_tracked = _pose_row(step)
            relocalized = False
            if n_tracked < cfg.tracking.min_tracked_points:
                # Retry once against the current map (pending mine forced
                # in) before declaring a failure.
                step2, snap2 = self._retrack_candidate(feats, self._prev_R, self._prev_t)
                R2, t2, n2 = _pose_row(step2)
                if n2 >= cfg.tracking.min_tracked_points:
                    self.stats["fail_retried_ok"] += 1
                    step, snap, R_np, t_np, n_tracked = step2, snap2, R2, t2, n2
                    self._prev_R, self._prev_t = R_np, t_np
                    self._pose_dev = None  # reseed the next PnP from the host pose
                else:
                    relocalized, R_np, t_np, n_tracked = self._handle_track_failure(feats)
            else:
                self._prev_R, self._prev_t = R_np, t_np
            self._frames_since_kf += 1
            # A relocalised frame's match indices refer to the global
            # snapshot: it is never promoted in the same step.
            is_kf = self._keyframe_rule(n_tracked, snap["n_valid"]) and not relocalized
            if is_kf and mine_pending:
                # Tracked against the pre-mine snapshot, whose small n_local
                # makes the 0.9 rule fire spuriously: re-track against the
                # current map and re-apply the rule.
                if (self._last_veto_token == self._state_token
                        and frame_idx - self._last_veto_frame <= self._veto_cache_frames):
                    is_kf = False
                    self.stats["kf_veto_cached"] += 1
                else:
                    step, snap = self._retrack_candidate(feats, R_np, t_np)
                    R2, t2, n2 = _pose_row(step)
                    if self._keyframe_rule(n2, snap["n_valid"]):
                        R_np, t_np, n_tracked = R2, t2, n2
                        self._prev_R, self._prev_t = R_np, t_np
                        self.stats["kf_retracked"] += 1
                    else:
                        is_kf = False
                        self._last_veto_token = self._state_token
                        self._last_veto_frame = frame_idx
                        self.stats["kf_vetoed_stale"] += 1
            if is_kf:
                self._insert_keyframe(frame_idx, feats, R_np, t_np, step, depth, snap)
            self.trajectory.append(FrameResult(
                frame_idx, R_np, t_np, n_tracked, is_kf,
                ref_kf=self._last_kf_id if self._last_kf_id is not None else -1,
            ))

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

    def _retrack_candidate(self, feats, R_np, t_np):
        """Re-track a frame against the current snapshot, after forcing the
        pending mine in. Returns (step, snap); the caller re-applies its
        rule."""
        self._apply_pending_mine(force=True)
        snap = self._snapshot
        with self.timers.time("retrack"):
            step = self._track_step(feats, snap, *self._dev_pose(R_np, t_np))
        return step, snap

    def _relocalize(self, feats):
        """Global-map PnP after a tracking failure: match the frame against
        the best-observed landmarks of the whole map. Returns (ok, R, t, n)."""
        step = self._track_step(feats, self.map.global_snapshot(self.device),
                                *self._dev_pose(self._prev_R, self._prev_t))
        R_np, t_np, n = _pose_row(step)
        return n >= self.cfg.tracking.min_tracked_points, R_np, t_np, n

    def _handle_track_failure(self, feats):
        """Tracking failure (the reference has no recovery, SURVEY.md §5):
        relocalise against the global map, else keep the previous pose.
        Returns (relocalized, R, t, n)."""
        self.stats["track_failures"] += 1
        ok, R_np, t_np, n = self._relocalize(feats)
        self._pose_dev = None
        if not ok:
            return False, self._prev_R.copy(), self._prev_t.copy(), n
        self.stats["relocalizations"] += 1
        self._prev_R, self._prev_t = R_np, t_np
        return True, R_np, t_np, n

    # -------------------------------------------------------------- keyframe

    def _insert_keyframe(self, frame_idx, feats, R_np, t_np, step: TrackStep, depth, snap):
        """Insert a keyframe (≙ main.py:221-345). `snap` is the snapshot the
        frame was tracked against: its slot order is what step.inliers and
        step.idx2 index, even if a BA apply below rebuilds self._snapshot."""
        cfg = self.cfg
        with self.timers.time("kf_insert"):
            # Land the previous keyframe's mine first: its landmarks must
            # exist before this keyframe's mine bookkeeping.
            self._apply_pending_mine(force=True)
            # A BA dispatched before this keyframe may not apply after it
            # (its pose array would overwrite this keyframe's slot): apply it
            # if it has had a frame of device time, else drop it. The BA
            # dispatched below covers a superset of its problem.
            self._drop_or_apply_pending_ba()
            kf_id = self.map.add_keyframe(R_np, t_np, frame_idx)
            self.stats["keyframes"] += 1
            # Tracked landmarks gain an observation (≙ main.py:232).
            sel = np.where(_host(step.inliers))[0]
            idx2 = _host(step.idx2)[sel]
            uv_cur = _host(feats.uv)[idx2]
            d_cur = _sample_depth(uv_cur, depth) if cfg.use_depth and depth is not None else None
            self.map.add_observations(kf_id, snap["pt_ids_np"][sel], uv_cur,
                                      _host(feats.desc)[idx2], depth=d_cur)
            # Place recognition: score this keyframe against the store now;
            # the scores are read two frames later (_apply_pending_loop).
            loop_scores = self._dispatch_loop_scores(kf_id, feats)
            mapped = np.zeros(cfg.frontend.max_features, bool)
            mapped[idx2] = True
            # Cull weak landmarks every 4th keyframe (≙ main.py:234-235).
            if kf_id >= cfg.keyframe.cull_after and kf_id % cfg.keyframe.cull_every == 0:
                self.stats["culled"] += self.map.cull_points(cfg.keyframe.cull_min_views)
            # Mine new landmarks (≙ main.py:237-318): depth backprojection
            # in RGB-D mode, two-view triangulation applied two frames later
            # in monocular mode.
            if cfg.use_depth and depth is not None:
                self._mine_depth_points(kf_id, feats, mapped, depth)
            else:
                self._dispatch_mine(kf_id, feats, mapped)
            self._finish_keyframe(kf_id, feats, mapped, frame_idx)
            if loop_scores is not None:
                self._pending_loop = dict(kf_id=kf_id, feats=feats, scores=loop_scores, age=0)
        # Full BA over the map (≙ main.py:322-323). It covers this keyframe's
        # tracked observations; the landmarks it mines join the next BA.
        if kf_id % max(cfg.ba.every_n_kf, 1) != 0:
            self.stats["ba_skipped_interval"] += 1
        elif self._pending_ba is None:
            self._dispatch_ba(kf_id, scale_gauge=False)
        else:
            self._ba_followup = kf_id

    def _dispatch_mine(self, kf_id, feats, mapped_cur):
        """Triangulate between the previous and the new keyframe; the result
        is applied by _apply_pending_mine."""
        cfg = self.cfg
        prev_id, prev = self._last_kf_id, self._last_kf_feats
        # Unmapped = detected in the previous keyframe but not yet a landmark
        # (≙ GetListDiff, helper_functions.py:316-326).
        avail = prev.valid & ~torch.from_numpy(self._last_kf_mapped).to(self.device)
        mine = mine_step(
            prev, avail, feats, *self._dev_pose(self.map.kf_R[prev_id], self.map.kf_t[prev_id]),
            *self._dev_pose(self.map.kf_R[kf_id], self.map.kf_t[kf_id]), self.intr,
            ratio=cfg.frontend.match_ratio, max_hamming=cfg.frontend.max_hamming,
            reproj_thresh_px=cfg.keyframe.triangulation_reproj_px,
            max_depth=cfg.keyframe.max_new_depth, min_parallax_deg=cfg.keyframe.min_parallax_deg,
            cross_check=cfg.frontend.cross_check,
        )
        self._pending_mine = dict(mine=mine, kf_id=kf_id, prev_id=prev_id, feats=feats,
                                  prev_uv=prev.uv, mapped=mapped_cur, age=0)

    def _apply_pending_mine(self, force: bool = False, dispatch_ba: bool = False) -> None:
        """Insert a dispatched mine's landmarks at tick age 2 (or now, when
        forced); with dispatch_ba, then run the keyframe's BA as soon as the
        slot is free."""
        h = self._pending_mine
        if h is None:
            return
        if not force and h["age"] < 2:
            h["age"] += 1
            return
        self._pending_mine = None
        cfg = self.cfg
        kf_id, prev_id, mapped_cur = h["kf_id"], h["prev_id"], h["mapped"]
        with self.timers.time("mine_apply"):
            idx2, keep, keep_loose, X = (_host(a) for a in h["mine"])
            fresh = ~mapped_cur[idx2]  # do not re-map features matched to landmarks
            keep = keep & fresh
            if keep.sum() < cfg.keyframe.min_mined_points:
                keep = keep_loose & fresh
                self.stats["mine_relaxed"] += 1
            sel = np.where(keep)[0]
            if len(sel) > 0:
                pt_ids = self.map.add_points(X[sel], _host(h["feats"].desc)[idx2[sel]])
                self.map.add_observations(prev_id, pt_ids, _host(h["prev_uv"])[sel])
                self.map.add_observations(kf_id, pt_ids, _host(h["feats"].uv)[idx2[sel]])
                # In place: this array is the next mine's availability mask.
                mapped_cur[idx2[sel]] = True
                # The mined landmarks join the tracking snapshot, unless a
                # newer keyframe has become the tracking anchor.
                if self._last_kf_id == kf_id:
                    self._snapshot = self.map.local_snapshot(kf_id, self.device)
                self._state_token += 1
        if dispatch_ba:
            if self._pending_ba is None:
                self._dispatch_ba(kf_id, scale_gauge=False)
            else:
                self._ba_followup = kf_id

    def _mine_depth_points(self, kf_id, feats, mapped_cur, depth):
        """Create metric landmarks for unmapped features from the depth map."""
        uv = _host(feats.uv)
        Xc, ok = _backproject_depth(uv, depth, self.cfg.intrinsics)
        sel = np.where(_host(feats.valid) & ~mapped_cur & ok)[0]
        if len(sel) == 0:
            return
        # Camera -> world: X_w = R_cw^T (X_c - t_cw).
        Xw = (Xc[sel] - self.map.kf_t[kf_id]) @ self.map.kf_R[kf_id]
        pt_ids = self.map.add_points(Xw.astype(np.float32), _host(feats.desc)[sel])
        self.map.add_observations(kf_id, pt_ids, uv[sel], depth=Xc[sel, 2])
        mapped_cur[sel] = True

    # -------------------------------------------------------------------- BA

    def _dispatch_ba(self, kf_id: int, scale_gauge: bool) -> None:
        """Run the full BA over the map; the result applies three frames
        later (_consume_pending_ba). Tracking meanwhile continues against
        the pre-BA snapshot, the reference's frozen local-map copy
        (deepcopy at main.py:154,333)."""
        cfg = self.cfg
        use_depth = bool(cfg.use_depth and cfg.ba.depth_weight > 0)
        with self.timers.time("bundle_adjust"):
            prob, meta = self.map.to_ba_problem(
                cfg.intrinsics, depth_weight=cfg.ba.depth_weight if use_depth else 0.0,
                device=self.device)
            with self.timers.time("ba_solve"):
                res = ba_step(prob, n_iters=cfg.ba.iters, cg_iters=cfg.ba.cg_iters,
                              solver=cfg.ba.solver, use_depth=use_depth)
        self._pending_ba = dict(res=res, meta=meta, kf_id=kf_id, scale_gauge=scale_gauge, age=0)

    def _apply_pending_ba(self, force: bool = False) -> None:
        """The per-frame tick of the pending mine, loop scoring and
        verification, and BA, in that order; `force` applies them now. A
        follow-up BA (a keyframe arrived while the slot was taken) is
        dispatched once the slot frees."""
        self._apply_pending_mine(force=force, dispatch_ba=True)
        self._apply_pending_loop(force=force)
        self._apply_pending_loop_verify(force=force)
        self._consume_pending_ba(force=force)
        if self._ba_followup is not None and self._pending_ba is None and self._pending_mine is None:
            kf, self._ba_followup = self._ba_followup, None
            self._dispatch_ba(kf, scale_gauge=False)
            if force:
                self._consume_pending_ba(force=True)

    def _drop_or_apply_pending_ba(self) -> None:
        """Keyframe-insertion policy: a pending BA of age >= 1 applies now, a
        younger one is dropped (the insertion dispatches a fresh BA over a
        superset of its problem)."""
        if self._pending_ba is None:
            return
        if self._pending_ba["age"] >= 1:
            self._consume_pending_ba(force=True)
        else:
            self._pending_ba = None
            self.stats["ba_dropped_stale"] += 1

    def _consume_pending_ba(self, force: bool = False) -> None:
        """Apply the pending BA at tick age 3 (or now, when forced), unless
        it went non-finite, more than doubled the cost, left more than 30%
        of its observations beyond 3 Huber deltas (a falling robust cost
        can still mean a warped map), or put more than 30% of them behind
        their camera. The last rule is not the JAX package's: the cost masks
        points behind a camera, so a step that mirrors the map through the
        cameras (t -> -t, X -> -X: the same pixels, every point behind)
        reads as a near-zero cost, and LM takes it about once in a few
        hundred keyframe BAs when the sums' last bits vary (PERF.md). Then
        prune the observations it cannot explain and compact the
        observation table."""
        h = self._pending_ba
        if h is None:
            return
        if not force and h["age"] < 3:
            # (JAX package, 1200 frames: apply age 2 -> ATE 0.120, 3 -> 0.092.)
            h["age"] += 1
            return
        self._pending_ba = None
        res, meta = h["res"], h["meta"]
        with self.timers.time("bundle_adjust"):
            cost_before, cost_after, blown, behind = _host(
                torch.stack([res.cost_before, res.cost_after, res.blown, res.behind])).tolist()
            if (not np.isfinite(cost_after)
                    or (np.isfinite(cost_before) and cost_after > 2.0 * cost_before)
                    or blown > 0.3 or behind > 0.3):
                self.stats["ba_rejected"] += 1
                return
            prob = res.prob
            if h["scale_gauge"]:
                prob = ba_mod.median_depth_normalize(prob)
            self.map.update_from_ba(prob, meta)
            if h["scale_gauge"]:
                self.map.refresh_scale_meas()
            # Prune what the optimised map cannot explain (≙ the role of
            # g2o's robust kernels, made permanent).
            bad = _host(res.bad)
            if bad.any():
                self.stats["obs_pruned"] += self.map.prune_obs_from_ba(bad, meta)
            # Safe point: no other BA holds observation-row indices now.
            self.stats["obs_compacted"] += self.map.compact_observations()
            self.stats["ba_runs"] += 1
            # The optimised landmarks replace the tracking snapshot; the
            # tracker's previous pose is not rewritten.
            if self._last_kf_id is not None:
                self._snapshot = self.map.local_snapshot(self._last_kf_id, self.device)
        self._state_token += 1

    def _run_full_ba(self, scale_gauge: bool):
        """Synchronous BA (init path): dispatch and apply at once."""
        self._dispatch_ba(self._last_kf_id if self._last_kf_id is not None else 0, scale_gauge)
        self._apply_pending_ba(force=True)

    def ba_iters_per_s(self) -> float:
        """BA iterations per second of bundle-adjustment time."""
        return self.timers.rate("bundle_adjust", self.stats["ba_runs"] * self.cfg.ba.iters)

    def _finish_keyframe(self, kf_id, feats, mapped, frame_idx):
        """Reset the tracking state around a new keyframe (≙ main.py:330-345)
        and give the keyframe's trajectory entry, if it has one, the map's
        pose."""
        self._last_kf_id = kf_id
        self._last_kf_feats = feats
        self._last_kf_mapped = mapped
        self._state_token += 1
        self._snapshot = self.map.local_snapshot(kf_id, self.device)
        self._prev_R = self.map.kf_R[kf_id].copy()
        self._prev_t = self.map.kf_t[kf_id].copy()
        self._frames_since_kf = 0
        for fr in reversed(self.trajectory):
            if fr.frame_idx == frame_idx:
                fr.R_cw = self.map.kf_R[kf_id].copy()
                fr.t_cw = self.map.kf_t[kf_id].copy()
                break

    # ----------------------------------------------------------- loop closure

    def _dispatch_loop_scores(self, kf_id: int, feats):
        """Store the new keyframe's features and score it against every
        stored keyframe (models/loop_closure.score_keyframes). Returns the
        (K,) scores on the device, or None when no scoring applies (loop
        closure off, too few keyframes, or inside the cooldown)."""
        cfg = self.cfg.loop
        self._loop_db.add(kf_id, _host(feats.desc), _host(feats.valid))
        if not cfg.enabled:
            return None
        if kf_id < cfg.min_gap or kf_id - self._last_loop_kf <= cfg.cooldown:
            return None
        db_desc, db_valid = self._loop_db.device_arrays()
        kf_mask = torch.from_numpy(self.map.kf_valid.copy()).to(self.device)
        return lc_mod.score_keyframes(feats.desc, feats.valid, db_desc, db_valid, kf_mask,
                                      cfg.hamming_thresh)

    def _apply_pending_loop(self, force: bool = False) -> None:
        """Read a scoring pass at tick age 2 (or now, when forced) and
        dispatch the verification of its candidate, if any."""
        h = self._pending_loop
        if h is None:
            return
        if not force and h["age"] < 2:
            h["age"] += 1
            return
        self._pending_loop = None
        with self.timers.time("kf_loop"):
            self._dispatch_loop_verify(h["kf_id"], h["feats"], _host(h["scores"]))

    def _dispatch_loop_verify(self, kf_id: int, feats, scores: np.ndarray) -> None:
        """Pick a candidate from the scores and run its geometric
        verification: the tracking step of the keyframe's features against
        the candidate's landmark snapshot, seeded at the candidate's pose.
        The result is read at tick age 2 (_apply_pending_loop_verify). One
        verification is pending at a time."""
        if self._pending_loop_verify is not None:
            return
        cand = lc_mod.find_candidate(scores, kf_id, self.cfg.loop)
        if cand is None:
            return
        # Covisibility-disjointness gate: a genuine loop candidate shares
        # (almost) no live landmarks with the current keyframe. Shared
        # landmarks mean the same neighbourhood reached by continuous
        # tracking, which local BA already governs (in the JAX package a
        # kf15-vs-kf2 "closure" 163 frames apart took full-sequence ATE from
        # 0.064 to 0.121). ORB-SLAM's analog: candidates must be outside the
        # covisibility graph.
        cur_pts, _ = self.map.points_seen_by(kf_id)
        cand_pts, _ = self.map.points_seen_by(cand)
        if len(cur_pts) and len(cand_pts):
            overlap = np.isin(cand_pts, cur_pts).sum() / min(len(cur_pts), len(cand_pts))
            if overlap > 0.05:
                self.stats["loop_rejected_covis"] += 1
                return
        snap = self.map.local_snapshot(cand, self.device)
        # An empty candidate snapshot (culled or pruned points) makes
        # verification impossible: record its size.
        self.stats["loop_cand_nvalid_last"] = snap["n_valid"]
        step = self._track_step(feats, snap, *self._dev_pose(self.map.kf_R[cand].copy(),
                                                             self.map.kf_t[cand].copy()))
        self.stats["loop_candidates"] += 1
        self._pending_loop_verify = dict(kf_id=kf_id, cand=cand, feats=feats, step=step,
                                         snap=snap, age=0)

    def _apply_pending_loop_verify(self, force: bool = False) -> None:
        """Read a verification at tick age 2 (or now, when forced) and, if
        it holds, close the loop."""
        h = self._pending_loop_verify
        if h is None:
            return
        if not force and h["age"] < 2:
            h["age"] += 1
            return
        self._pending_loop_verify = None
        with self.timers.time("kf_loop"):
            self._close_loop(h)

    def _close_loop(self, h: dict) -> None:
        """Gate a verified candidate and apply the closure: a loop edge into
        the pose graph, the corrected poses and re-anchored landmarks, the
        cross-observations, the rewritten trajectory and a fresh BA. A
        closure the optimised graph does not satisfy, or whose correction
        makes the map reproject worse, is rejected and the map left as it
        was, bit for bit."""
        cfg = self.cfg.loop
        kf_id, cand, feats, snap, step = h["kf_id"], h["cand"], h["feats"], h["snap"], h["step"]
        R_corr, t_corr, n_inl = _pose_row(step)
        if n_inl < cfg.verify_min_inliers:
            self.stats["loop_verify_fail"] += 1
            self.stats["loop_verify_best"] = max(self.stats["loop_verify_best"], n_inl)
            return
        inl_host, idx2_host = _host(step.inliers), _host(step.idx2)
        # The pending mine triangulated against the pre-correction poses:
        # land it first (its points are then re-anchored with the rest), but
        # not its BA yet (see _reject_closure).
        mined_kf = self._pending_mine["kf_id"] if self._pending_mine is not None else None
        self._apply_pending_mine(force=True, dispatch_ba=False)
        R_corr, t_corr = R_corr.astype(np.float32), t_corr.astype(np.float32)
        # Cross-observations: the verified matches are sightings of the old
        # landmarks in the new keyframe. Deduplicated against the
        # observations tracking already recorded for this keyframe: a
        # duplicated (kf, landmark) row double-weights that residual in every
        # later BA.
        sel = np.where(inl_host)[0]
        pt_ids = snap["pt_ids_np"][sel]
        m = self.map
        seen = m.obs_pt[: m.n_obs][m.obs_valid[: m.n_obs] & (m.obs_cam[: m.n_obs] == kf_id)]
        fresh = ~np.isin(pt_ids, seen)
        sel, pt_ids = sel[fresh], pt_ids[fresh]
        # (Inserted after the warp validation: on a rejected closure they
        # would poison every later BA.)
        # The loop edge (≙ EdgeSE3 + RobustKernelDCS, LocalBA.py:97-113), and
        # the relative scale for the monocular Sim3 graph: the old landmarks'
        # median depth under the verified pose over the current keyframe's
        # own landmarks' median depth.
        Z_R, Z_t = lc_mod.loop_edge_measurement(m.kf_R[cand], m.kf_t[cand], R_corr, t_corr)
        old_ids = snap["pt_ids_np"][np.where(inl_host)[0]]
        z_old = (m.pt_xyz[old_ids] @ R_corr.T + t_corr)[:, 2]
        cur_ids, _ = m.points_seen_by(kf_id)
        z_new = (m.pt_xyz[cur_ids] @ m.kf_R[kf_id].T + m.kf_t[kf_id])[:, 2]
        z_old = z_old[z_old > 0.05]
        z_new = z_new[z_new > 0.05]
        if len(z_old) >= 5 and len(z_new) >= 5:
            s_m = float(np.clip(np.median(z_old) / np.median(z_new), 1.0 / 3.0, 3.0))
        else:
            s_m = 1.0
        log_s = np.log(s_m)
        self._loop_edges.append((cand, kf_id, Z_R, Z_t, log_s))
        saved = (m.kf_R.copy(), m.kf_t.copy(), m.pt_xyz.copy(), m.kf_scale_meas.copy())
        R_new, t_new, s_new = self._optimize_pose_graph_arrays(cfg.pgo_iters)
        # Edge-satisfaction gate: DCS can down-weight a topologically false
        # edge to ~0, so its "correction" is a near no-op the warp validation
        # cannot catch. A genuine closure's edge is satisfied by the
        # optimised graph; an edge the graph refused to move toward is a
        # rejected hypothesis.
        Rr = R_new[cand] @ R_new[kf_id].T  # realised cand <- cur rotation
        ang = float(np.degrees(np.arccos(np.clip((np.trace(Z_R.T @ Rr) - 1.0) / 2.0, -1.0, 1.0))))
        # The realised relative transform in the graph's parametrisation
        # (Sim3: S_i S_j^-1 has t_rel = t_i - (s_i/s_j) R_rel t_j).
        s_rel = float(s_new[cand] / max(float(s_new[kf_id]), 1e-6)) if s_new is not None else 1.0
        t_hat = t_new[cand] - s_rel * (Rr @ t_new[kf_id])
        scene_scale = max(float(np.median(np.abs(z_old))) if len(z_old) else 1.0, 1e-3)
        t_res = float(np.linalg.norm(Z_t - t_hat)) / scene_scale
        if ang > 5.0 or t_res > 0.15:
            self._reject_closure(mined_kf)
            self.stats["loop_rejected_unsatisfied"] += 1
            self.stats["loop_rejected_detail"].append(dict(
                kf=int(kf_id), cand=int(cand), n_inl=int(n_inl), edge_rot_deg=round(ang, 2),
                edge_t_res=round(t_res, 3)))
            return
        # Warp validation: the correction may not make the map reproject
        # worse. Genuine revisits re-blow 0.004-0.067 of the observations
        # after the correction in the JAX package's runs, false ones
        # 0.17-0.22: the allowance is +0.08.
        blown0 = self._reproj_blown_fraction()
        lc_mod.apply_pose_graph_correction(m, R_new, t_new, s_new)
        blown1 = self._reproj_blown_fraction()
        if blown1 > blown0 + 0.08:
            m.kf_R, m.kf_t, m.pt_xyz, m.kf_scale_meas = saved
            self._reject_closure(mined_kf)
            self.stats["loop_rejected_warp"] += 1
            self.stats["loop_rejected_detail"].append(dict(
                kf=int(kf_id), cand=int(cand), n_inl=int(n_inl), blown_before=round(blown0, 4),
                blown_after=round(blown1, 4), log_s_m=round(float(log_s), 4)))
            return
        # Accepted. A pending BA optimised the pre-correction geometry and
        # would overwrite the corrected poses: discard it, and any follow-up;
        # a fresh BA over the corrected map is dispatched below.
        if self._pending_ba is not None:
            self._pending_ba = None
            self.stats["ba_discarded_loop"] += 1
        self._ba_followup = None
        if len(sel):
            m.add_observations(kf_id, pt_ids, _host(feats.uv)[idx2_host[sel]])
        self._rewrite_keyframe_trajectory(old_R=saved[0], old_t=saved[1])
        # Reset tracking around the corrected map, on the latest keyframe:
        # the verification can land after a newer keyframe was inserted.
        anchor = self._last_kf_id if self._last_kf_id is not None else kf_id
        self._snapshot = m.local_snapshot(anchor, self.device)
        self._state_token += 1
        self._prev_R = m.kf_R[anchor].copy()
        self._prev_t = m.kf_t[anchor].copy()
        self._pose_dev = None
        self._last_loop_kf = kf_id
        self.stats["loop_closures"] += 1
        self.stats["loop_accepted"].append(dict(
            kf=int(kf_id), cand=int(cand), n_inl=int(n_inl), blown_before=round(blown0, 4),
            blown_after=round(blown1, 4)))
        self._dispatch_ba(kf_id, scale_gauge=False)

    def _reject_closure(self, mined_kf: int | None) -> None:
        """Undo a rejected closure's loop edge, and give the mine it forced
        in the BA the tick would have given it (now, or as the follow-up).
        The JAX package discards the pending BA and the follow-up before its
        gates, so there a rejected closure also drops that keyframe's BA
        (ROADMAP Queue C, a listed non-fault); here the BA schedule goes on
        as if no candidate had come."""
        self._loop_edges.pop()
        if mined_kf is not None:
            if self._pending_ba is None:
                self._dispatch_ba(mined_kf, scale_gauge=False)
            else:
                self._ba_followup = mined_kf

    def _padded_loop_edges(self):
        """Loop-edge arrays padded to an 8-edge bucket (zero-weight edges
        0 -> 0), as the JAX package pads them. None when there are none."""
        E = len(self._loop_edges)
        if E == 0:
            return None
        cap = 8 * ((E + 7) // 8)
        e_i = np.zeros(cap, np.int32)
        e_j = np.zeros(cap, np.int32)
        Z_R = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
        Z_t = np.zeros((cap, 3), np.float32)
        Z_ls = np.zeros(cap, np.float32)
        w = np.zeros(cap, np.float32)
        for n, (i, j, zr, zt, ls) in enumerate(self._loop_edges):
            e_i[n], e_j[n] = i, j
            Z_R[n], Z_t[n] = zr, zt
            Z_ls[n] = ls
            w[n] = self.cfg.loop.edge_weight
        return e_i, e_j, Z_R, Z_t, Z_ls, w

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _build_pose_graph(self, include_loops: bool = True) -> pg.PoseGraph:
        """SE3 keyframe chain with scale edges (+ the loop edges). The scale
        edges carry insertion-time relative-translation norms
        (kf_scale_meas ≙ AddScalingEdge, LocalBA.py:115-131)."""
        m = self.map
        g = pg.from_keyframe_chain(self._dev(m.kf_R), self._dev(m.kf_t), self._dev(m.kf_valid),
                                   scale_meas=self._dev(m.kf_scale_meas[1:]))
        edges = self._padded_loop_edges()
        if edges is None or not include_loops:
            return g
        e_i, e_j, Z_R, Z_t, _, w = edges
        return pg.add_edges(g, e_i, e_j, Z_R, Z_t, w)

    def _build_sim3_graph(self) -> pg.Sim3Graph:
        """The 7-DoF keyframe chain with the loop edges and their measured
        relative scales: the monocular pose graph."""
        m = self.map
        g = pg.sim3_from_keyframe_chain(self._dev(m.kf_R), self._dev(m.kf_t), self._dev(m.kf_valid))
        edges = self._padded_loop_edges()
        if edges is None:
            return g
        return pg.sim3_add_edges(g, *edges)

    def _optimize_pose_graph_arrays(self, n_iters: int, final: bool = False):
        """Run the pose graph for this mode; returns host (R, t, s | None).

        RGB-D: the SE3 chain with scale and loop edges. Monocular at a
        closure: the Sim3 graph, the only correction that survives scale
        drift. Monocular final pass (`final`): first the SE3 chain with its
        scale edges and no loop edges, which limits the gauge wander BA
        accumulates (the JAX package measured raw scale drift past 3x and
        ATE 0.58 without it), then, where loop edges exist, a Sim3 polish
        with them on the smoothed chain."""
        use_dcs = bool(self._loop_edges)
        if self.cfg.use_depth:
            R, t, _ = pg.optimize(self._build_pose_graph(), n_iters=n_iters, use_dcs=use_dcs)
            return _host(R), _host(t), None
        if final:
            R, t, _ = pg.optimize(self._build_pose_graph(include_loops=False), n_iters=n_iters,
                                  use_dcs=False)
            if not self._loop_edges:
                return _host(R), _host(t), None
            old_R, old_t = self.map.kf_R.copy(), self.map.kf_t.copy()
            lc_mod.apply_pose_graph_correction(self.map, _host(R), _host(t))
            self._rewrite_keyframe_trajectory(old_R=old_R, old_t=old_t)
        R, t, lam, _ = pg.optimize_sim3(self._build_sim3_graph(), n_iters=n_iters, use_dcs=use_dcs)
        lam = _host(lam)
        self.stats["pgo_max_abs_log_scale"] = round(float(np.max(np.abs(lam))), 4)
        return _host(R), _host(t), np.exp(lam).astype(np.float32)

    def _rewrite_keyframe_trajectory(self, old_R: np.ndarray | None = None,
                                     old_t: np.ndarray | None = None) -> None:
        """Propagate a map correction into the stored trajectory. Keyframe
        entries take their keyframe's corrected pose. Given the
        pre-correction keyframe poses, the other entries move with their
        reference keyframe: a frame's pose relative to it is invariant, so
        T_frame_new = (T_frame_old ∘ T_kf_old⁻¹) ∘ T_kf_new."""
        m = self.map
        kf_by_frame = {int(f): k for k, f in enumerate(m.kf_frame_idx) if m.kf_valid[k]}
        for fr in self.trajectory:
            k = kf_by_frame.get(fr.frame_idx)
            if k is not None:
                fr.R_cw = m.kf_R[k].copy()
                fr.t_cw = m.kf_t[k].copy()
            elif old_R is not None and 0 <= fr.ref_kf < len(old_R):
                a = fr.ref_kf
                if not m.kf_valid[a]:
                    continue
                R_rel = fr.R_cw @ old_R[a].T
                t_rel = fr.t_cw - R_rel @ old_t[a]
                fr.R_cw = (R_rel @ m.kf_R[a]).astype(np.float32)
                fr.t_cw = (R_rel @ m.kf_t[a] + t_rel).astype(np.float32)

    def _reproj_blown_fraction(self) -> float:
        """Weighted fraction of the map's observations beyond 3 Huber
        deltas: the map-consistency measure of the warp validations."""
        prob, _ = self.map.to_ba_problem(self.cfg.intrinsics, device=self.device)
        e, w = (_host(a) for a in ba_mod.reproj_errors(prob))
        thr = 3.0 * ba_mod.HUBER_DELTA
        return float(((e > thr) * w).sum() / max(float(w.sum()), 1.0))

    def optimize_pose_graph(self, n_iters: int = 15) -> None:
        """The final keyframe pose-graph pass, with scale edges and any loop
        edges (≙ the EdgeSE3/EdgeSBAScale chain of LocalBA.py:97-131):
        keyframe poses updated, landmarks re-anchored, the whole trajectory
        rewritten. Skipped when a closure was applied in the run (the JAX
        package measured the re-asserted, gauge-stale loop edges injecting
        error: 1200-frame mono ATE 0.0566 without the pass, 0.0676 with).
        Otherwise reverted when it grows the blown-observation fraction by
        more than 0.005. Sets stats["final_pass"]."""
        # The last keyframe's mine lands with its BA, then everything else.
        self._apply_pending_mine(force=True, dispatch_ba=True)
        self._apply_pending_ba(force=True)
        if self.stats["loop_closures"] > 0:
            self.stats["final_pass"] = "skipped_closures_applied"
            return
        m = self.map
        saved = (m.kf_R.copy(), m.kf_t.copy(), m.pt_xyz.copy(), m.kf_scale_meas.copy(),
                 [(f.R_cw.copy(), f.t_cw.copy()) for f in self.trajectory])
        blown0 = self._reproj_blown_fraction()
        R, t, s = self._optimize_pose_graph_arrays(n_iters, final=True)
        old_R, old_t = m.kf_R.copy(), m.kf_t.copy()
        lc_mod.apply_pose_graph_correction(m, R, t, s)
        self._rewrite_keyframe_trajectory(old_R=old_R, old_t=old_t)
        if self._reproj_blown_fraction() <= blown0 + 0.005:
            self.stats["final_pass"] = "smooth"
            return
        m.kf_R, m.kf_t, m.pt_xyz, m.kf_scale_meas = (a.copy() for a in saved[:4])
        for f, (Rs, ts) in zip(self.trajectory, saved[4]):
            f.R_cw, f.t_cw = Rs.copy(), ts.copy()
        self.stats["final_pass"] = "reverted"
        # No BA after the final correction: in the JAX package it pulled the
        # keyframes back toward the still drift-scaled landmarks (1200-frame
        # mono ATE 0.075 -> 0.083).

    def positions(self) -> tuple[np.ndarray, np.ndarray]:
        """(frame_indices (N,), camera centres (N,3)) of the trajectory."""
        idxs = np.array([f.frame_idx for f in self.trajectory])
        R = np.stack([f.R_cw for f in self.trajectory])
        t = np.stack([f.t_cw for f in self.trajectory])
        return idxs, -np.einsum("nji,nj->ni", R, t)


def run_sequence(dataset, config: SlamConfig | None = None, start: int = 0,
                 stop: int | None = None, device="cuda") -> Slam:
    """Run SLAM serially over a dataset (any object with the reader's
    `frames(start, stop)` -> (idx, gray, depth) interface); returns the Slam.
    Without a config, the capacities are sized to the frame range
    (size_config_for; the range's end is `len(dataset)` when `stop` is
    None)."""
    if config is None:
        config = size_config_for((stop if stop is not None else len(dataset)) - start)
    slam = Slam(config, device=device)
    for i, gray, depth in dataset.frames(start, stop):
        slam.process(i, gray, depth)
    return slam
