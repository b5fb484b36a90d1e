"""Loop-closure detection and correction (port of
visual_slam_tpu/models/loop_closure.py:1-210).

The reference has no loop closure (SURVEY.md §2.3; BASELINE.json config #2
names it as the capability to build). Here, as in the JAX package:

* Place recognition is brute-force keyframe-vs-all-keyframes descriptor
  scoring: a frame's 256-bit descriptors, expanded to ±1, multiplied
  against every stored keyframe's. ±1 products sum to integers of at most
  256 in magnitude, exact in bfloat16 with float32 accumulation, so the
  Hamming distances and hit counts are exact and equal the JAX package's.
* Geometric verification reuses the tracking step against the candidate
  keyframe's landmark snapshot (pipeline.Slam._dispatch_loop_verify).
* Correction: an SE3 (RGB-D) or Sim3 (monocular) loop edge into the pose
  graph (models/pose_graph.py), landmarks re-anchored through their first
  observing keyframe, cross-observations of the verified matches, then a
  full BA (≙ localBundleAdjustement, LocalBA.py:143-190).

`find_candidate`, `loop_edge_measurement`, `point_anchor_keyframes` and
`apply_pose_graph_correction` are NumPy host code, the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import descriptor as desc_mod

SCORE_CHUNK_BYTES = 64 << 20  # a chunk's (chunk,F,F) distance tensor stays under this


@dataclass
class LoopClosureConfig:
    enabled: bool = True
    min_gap: int = 12  # candidate must be at least this many keyframes old
    hamming_thresh: float = 48.0  # a feature "hits" a keyframe below this
    min_score_abs: int = 60  # minimum hit count to consider a candidate
    min_score_rel: float = 0.55  # …and vs the adjacent-keyframe hit count
    # PnP inliers to accept the loop. In the JAX package on full-sequence
    # ICL-NUIM lr traj3, drift shrank genuine revisits to ~20-38 verified
    # inliers; 30 rejected real closures, 20 accepts them. Three guards
    # stand behind this permissive gate: the covisibility-disjointness
    # check, the reprojection warp validation and the DCS-robust edge.
    verify_min_inliers: int = 20
    # Keyframes between closures. Probed by the JAX package on the lr
    # revisit window: 8 allows one closure (ATE 0.091), 3 two (0.075), 2
    # three (0.095, correction churn).
    cooldown: int = 3
    pgo_iters: int = 20
    edge_weight: float = 50.0  # loop-edge weight (DCS still guards it)


class KeyframeFeatureDB:
    """Per-keyframe raw feature store (descriptors and validity).

    Host arrays with a mirror on `device` for the scoring pass, updated one
    row per keyframe insertion. Descriptors are int32 words with the JAX
    package's uint32 bits."""

    def __init__(self, max_keyframes: int, max_features: int, device="cuda"):
        self.device = torch.device(device)
        self.desc = np.zeros((max_keyframes, max_features, 8), np.int32)
        self.valid = np.zeros((max_keyframes, max_features), bool)
        self.n = 0
        self._desc_dev = None
        self._valid_dev = None

    def add(self, kf_id: int, desc: np.ndarray, valid: np.ndarray) -> None:
        while kf_id >= self.desc.shape[0]:
            # Keep pace with SlamMap's keyframe growth (it doubles).
            self.desc = np.concatenate([self.desc, np.zeros_like(self.desc)])
            self.valid = np.concatenate([self.valid, np.zeros_like(self.valid)])
            if self._desc_dev is not None:
                self._desc_dev = torch.cat([self._desc_dev, torch.zeros_like(self._desc_dev)])
                self._valid_dev = torch.cat([self._valid_dev, torch.zeros_like(self._valid_dev)])
        self.desc[kf_id] = desc
        self.valid[kf_id] = valid
        self.n = max(self.n, kf_id + 1)
        if self._desc_dev is None:
            self._desc_dev = torch.from_numpy(self.desc).to(self.device)
            self._valid_dev = torch.from_numpy(self.valid).to(self.device)
        else:
            self._desc_dev[kf_id] = torch.from_numpy(self.desc[kf_id]).to(self.device)
            self._valid_dev[kf_id] = torch.from_numpy(self.valid[kf_id]).to(self.device)

    def device_arrays(self):
        return self._desc_dev, self._valid_dev


def score_keyframes(cur_desc: torch.Tensor, cur_valid: torch.Tensor, db_desc: torch.Tensor,
                    db_valid: torch.Tensor, kf_mask: torch.Tensor,
                    hamming_thresh: float) -> torch.Tensor:
    """Hit count of the current frame's features against every keyframe.

    cur_desc (F,8) int32, cur_valid (F,), db_desc (K,F,8), db_valid (K,F),
    kf_mask (K,): score only these keyframes. A feature hits keyframe k when
    its best Hamming distance into k's descriptors is below
    `hamming_thresh`. Returns (K,) int32 scores, on the inputs' device,
    without a host read. The product runs over chunks of keyframes, each
    chunk's distance tensor under SCORE_CHUNK_BYTES."""
    K, F = db_valid.shape
    a = desc_mod.unpack_pm1(cur_desc, torch.bfloat16)  # (F,256) ±1
    chunk = max(1, SCORE_CHUNK_BYTES // (4 * F * cur_desc.shape[0]))
    out = []
    for k0 in range(0, K, chunk):
        dk = db_desc[k0:k0 + chunk]
        b = desc_mod.unpack_pm1(dk.reshape(-1, 8), torch.bfloat16).reshape(dk.shape[0], F, -1)
        dot = torch.matmul(a, b.transpose(1, 2)).float()  # (chunk,F_cur,F) exact integers
        dist = 0.5 * (desc_mod.N_BITS - dot)
        dist = torch.where(db_valid[k0:k0 + chunk, None, :], dist, 1e9)
        best = torch.amin(dist, dim=2)  # (chunk,F_cur)
        out.append(((best < hamming_thresh) & cur_valid[None]).sum(dim=1))
    scores = torch.cat(out).to(torch.int32)
    return torch.where(kf_mask, scores, 0)


def find_candidate(scores: np.ndarray, cur_kf: int, cfg: LoopClosureConfig) -> int | None:
    """Pick a loop candidate from the score vector (host logic).

    The absolute gate keeps weak matches out; the relative gate compares
    against how well the frame matches its own covisible neighbourhood
    (adjacent keyframes): a genuine revisit scores comparably to the
    frame's own neighbours, incidental overlap does not.
    """
    old = scores[: max(cur_kf - cfg.min_gap + 1, 0)]
    if len(old) == 0:
        return None
    cand = int(np.argmax(old))
    score = int(old[cand])
    lo = max(cur_kf - 3, 0)
    adjacent = scores[lo:cur_kf]
    ref = float(adjacent.max()) if len(adjacent) else float(score)
    if score < cfg.min_score_abs or score < cfg.min_score_rel * ref:
        return None
    return cand


def loop_edge_measurement(R_cand, t_cand, R_corr, t_corr):
    """SE3 edge measurement Z = T_cand ∘ T_corr⁻¹ (cam_cur -> cam_cand),
    matching pose_graph._rel's (i=cand, j=cur) convention."""
    Z_R = R_cand @ R_corr.T
    Z_t = t_cand - Z_R @ t_corr
    return Z_R, Z_t


def point_anchor_keyframes(slam_map) -> np.ndarray:
    """First-observing keyframe id per landmark slot (-1 when none).

    The anchor defines how a landmark moves under a pose-graph correction:
    its camera-frame coordinates in the anchor keyframe are invariant.
    """
    P = slam_map.config.max_points
    anchor = np.full(P, -1, np.int64)
    n = slam_map.n_obs
    # Reverse iteration order + direct assignment keeps the FIRST obs row.
    rows = np.arange(n - 1, -1, -1)
    valid = slam_map.obs_valid[rows]
    anchor[slam_map.obs_pt[rows[valid]]] = slam_map.obs_cam[rows[valid]]
    return anchor


def apply_pose_graph_correction(slam_map, R_new: np.ndarray, t_new: np.ndarray,
                                s_new: np.ndarray | None = None) -> None:
    """Propagate optimised keyframe poses to the landmarks.

    Each landmark's coordinates in its anchor keyframe's camera frame are
    held fixed. SE3 correction: X' = R_new_aᵀ (R_old_a X + t_old_a −
    t_new_a). Sim3 correction (s_new given, the 7-DoF graph's per-keyframe
    scale): the anchor's Sim3 is x_cam = s R x_w + t, so X' = (1/s_a)
    R_new_aᵀ (R_old_a X + t_old_a − t_new_a) and the keyframe's metric SE3
    pose becomes (R_new_k, t_new_k / s_k): reprojection through the anchor
    is preserved exactly (x_cam scales by 1/s, a ray-preserving change).
    """
    anchor = point_anchor_keyframes(slam_map)
    sel = np.where(slam_map.pt_valid & (anchor >= 0))[0]
    if s_new is None:
        s_new = np.ones(len(R_new), np.float32)
    t_metric = (t_new / s_new[:, None]).astype(np.float32)
    if len(sel) == 0:
        slam_map.kf_R = R_new.astype(np.float32)
        slam_map.kf_t = t_metric
        return
    a = anchor[sel]
    X = slam_map.pt_xyz[sel]
    Ro, to = slam_map.kf_R[a], slam_map.kf_t[a]
    Rn, tn = R_new[a], t_new[a]
    Xc = np.einsum("nij,nj->ni", Ro, X) + to  # anchor-camera coords
    Xw = np.einsum("nji,nj->ni", Rn, Xc - tn) / s_new[a][:, None]
    slam_map.pt_xyz[sel] = Xw.astype(np.float32)
    slam_map.kf_R = R_new.astype(np.float32)
    slam_map.kf_t = t_metric
    slam_map.refresh_scale_meas()
