"""SLAM map as host-side structure-of-arrays state (port of the parts of
visual_slam_tpu/models/map_state.py:38-203 that RGB-D init and tracking use).

The replacement for the reference's dict-of-objects data model — `Map`
(src/v2/map.py:6-131), `Frame`, `Point`: preallocated NumPy arrays plus
validity masks, doubling when full. Insertions happen a few times per
keyframe, so this stays NumPy; only `local_snapshot` hands tensors to the
device. Descriptors are int32 words with the JAX package's uint32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import MapConfig


class SlamMap:
    """Keyframes + landmarks + observation table."""

    def __init__(self, config: MapConfig | None = None):
        c = self.config = config or MapConfig()
        K, P, O = c.max_keyframes, c.max_points, c.max_observations
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))  # world->cam
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_valid = np.zeros(K, bool)
        self.kf_frame_idx = np.full(K, -1, np.int64)  # source frame number
        self.pt_xyz = np.zeros((P, 3), np.float32)
        self.pt_desc = np.zeros((P, 8), np.int32)  # latest descriptor
        self.pt_valid = np.zeros(P, bool)
        self.pt_views = np.zeros(P, np.int32)
        self.obs_cam = np.zeros(O, np.int32)
        self.obs_pt = np.zeros(O, np.int32)
        self.obs_uv = np.zeros((O, 2), np.float32)
        # Measured metric depth at the observation (RGB-D mode; 0 = none).
        self.obs_depth = np.zeros(O, np.float32)
        self.obs_valid = np.zeros(O, bool)
        self.n_kf = 0
        self.n_pt = 0
        self.n_obs = 0

    # -- insertion (≙ Map.AddFrame/AddParentAndPose map.py:9-14,114-118,
    #    Map.AddPoint3D map.py:74-80, Point.AddFrame point.py:25-26) --

    def add_keyframe(self, R_cw: np.ndarray, t_cw: np.ndarray, frame_idx: int) -> int:
        k = self.n_kf
        if k >= self.config.max_keyframes:
            eye = np.tile(np.eye(3, dtype=np.float32), (k, 1, 1))
            self.kf_R = np.concatenate([self.kf_R, eye])
            self.kf_t = np.concatenate([self.kf_t, np.zeros_like(self.kf_t)])
            self.kf_valid = np.concatenate([self.kf_valid, np.zeros_like(self.kf_valid)])
            self.kf_frame_idx = np.concatenate([self.kf_frame_idx, np.full(k, -1, np.int64)])
            self.config.max_keyframes = 2 * k
        self.kf_R[k] = R_cw
        self.kf_t[k] = t_cw
        self.kf_valid[k] = True
        self.kf_frame_idx[k] = frame_idx
        self.n_kf += 1
        return k

    def add_points(self, xyz: np.ndarray, desc: np.ndarray) -> np.ndarray:
        """Insert N landmarks; returns their slot ids."""
        n = len(xyz)
        while self.n_pt + n > self.config.max_points:
            P = self.config.max_points
            for name in ("pt_xyz", "pt_desc", "pt_valid", "pt_views"):
                a = getattr(self, name)
                setattr(self, name, np.concatenate([a, np.zeros_like(a)]))
            self.config.max_points = 2 * P
        ids = np.arange(self.n_pt, self.n_pt + n)
        self.pt_xyz[ids] = xyz
        self.pt_desc[ids] = desc
        self.pt_valid[ids] = True
        self.n_pt += n
        return ids

    def add_observations(self, kf_id: int, pt_ids: np.ndarray, uvs: np.ndarray,
                         desc: np.ndarray | None = None,
                         depth: np.ndarray | None = None) -> None:
        """≙ Map.AddPointToFrameCorrespondences (map.py:120-122).

        `depth`: optional (N,) measured metric depth per observation
        (<=0 = no measurement)."""
        n = len(pt_ids)
        while self.n_obs + n > self.config.max_observations:
            O = self.config.max_observations
            for name in ("obs_cam", "obs_pt", "obs_uv", "obs_depth", "obs_valid"):
                a = getattr(self, name)
                setattr(self, name, np.concatenate([a, np.zeros_like(a)]))
            self.config.max_observations = 2 * O
        sl = slice(self.n_obs, self.n_obs + n)
        self.obs_cam[sl] = kf_id
        self.obs_pt[sl] = pt_ids
        self.obs_uv[sl] = uvs
        if depth is not None:
            self.obs_depth[sl] = depth
        self.obs_valid[sl] = True
        self.pt_views[pt_ids] += 1
        if desc is not None:
            self.pt_desc[pt_ids] = desc  # keep the freshest descriptor
        self.n_obs += n

    # -- queries --

    def points_seen_by(self, kf_id: int):
        """(pt_ids, uvs) of valid landmarks observed by a keyframe
        (≙ Map.GetImagePointsWithFrameID, map.py:28-44)."""
        m = self.obs_valid & (self.obs_cam == kf_id) & self.pt_valid[self.obs_pt]
        return self.obs_pt[m], self.obs_uv[m]

    def local_snapshot(self, kf_id: int, device) -> dict:
        """Fixed-shape tracking view of the landmarks a keyframe sees
        (≙ the local-map rebuild at a new keyframe, src/v2/main.py:336-345):
        arrays padded to `track_capacity` with a validity mask, as tensors on
        `device`, plus host copies of the count and the point ids."""
        ids, uvs = self.points_seen_by(kf_id)
        M = self.config.track_capacity
        n = min(len(ids), M)
        xyz = np.zeros((M, 3), np.float32)
        desc = np.zeros((M, 8), np.int32)
        uv = np.zeros((M, 2), np.float32)
        pid = np.zeros(M, np.int32)
        valid = np.zeros(M, bool)
        xyz[:n] = self.pt_xyz[ids[:n]]
        desc[:n] = self.pt_desc[ids[:n]]
        uv[:n] = uvs[:n]
        pid[:n] = ids[:n]
        valid[:n] = True
        return dict(
            xyz=torch.from_numpy(xyz).to(device),
            desc=torch.from_numpy(desc).to(device),
            uv=torch.from_numpy(uv).to(device),
            pt_ids=torch.from_numpy(pid).to(device),
            valid=torch.from_numpy(valid).to(device),
            n_valid=n,  # host-side count: reading it costs no device sync
            pt_ids_np=pid,
        )
