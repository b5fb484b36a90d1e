"""SLAM map as host-side structure-of-arrays state (port of
visual_slam_tpu/models/map_state.py:38-361).

The replacement for the reference's dict-of-objects data model — `Map`
(src/v2/map.py:6-131), `Frame`, `Point`: preallocated NumPy arrays plus
validity masks, doubling when full. Covisibility queries are masked scans of
a flat observation table, culling is a masked write. Insertions happen a few
times per keyframe, so this stays NumPy; `local_snapshot`,
`global_snapshot` and `to_ba_problem` hand tensors to the device.
Descriptors are int32 words with the JAX package's uint32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import MapConfig
from . import ba as ba_mod


_OBS_FIELDS = ("obs_cam", "obs_pt", "obs_uv", "obs_depth", "obs_valid")


class SlamMap:
    """Keyframes + landmarks + observation table."""

    def __init__(self, config: MapConfig | None = None):
        c = self.config = config or MapConfig()
        K, P, O = c.max_keyframes, c.max_points, c.max_observations
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))  # world->cam
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_valid = np.zeros(K, bool)
        self.kf_frame_idx = np.full(K, -1, np.int64)  # source frame number
        # ||t_rel|| to the previous keyframe, captured at insertion: the
        # scale-edge measurement (≙ AddScalingEdge, LocalBA.py:115-131).
        self.kf_scale_meas = np.zeros(K, np.float32)
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

    def _grow(self, names, attr: str) -> None:
        """Double the arrays `names` and the capacity `attr`; new keyframe
        rotations are identities."""
        for name in names:
            a = getattr(self, name)
            pad = np.full_like(a, -1) if name == "kf_frame_idx" else np.zeros_like(a)
            if name == "kf_R":
                pad[:] = np.eye(3, dtype=np.float32)
            setattr(self, name, np.concatenate([a, pad]))
        setattr(self.config, attr, 2 * getattr(self.config, attr))

    def add_keyframe(self, R_cw: np.ndarray, t_cw: np.ndarray, frame_idx: int) -> int:
        k = self.n_kf
        if k >= self.config.max_keyframes:
            self._grow(("kf_R", "kf_t", "kf_valid", "kf_frame_idx", "kf_scale_meas"),
                       "max_keyframes")
        self.kf_R[k] = R_cw
        self.kf_t[k] = t_cw
        self.kf_valid[k] = True
        self.kf_frame_idx[k] = frame_idx
        if k > 0:
            self.kf_scale_meas[k] = self._rel_norm(k)
        self.n_kf += 1
        return k

    def _rel_norm(self, k: int) -> float:
        """||t_rel|| between keyframes k-1 and k."""
        R_rel = self.kf_R[k] @ self.kf_R[k - 1].T
        return np.linalg.norm(self.kf_t[k] - R_rel @ self.kf_t[k - 1])

    def add_points(self, xyz: np.ndarray, desc: np.ndarray) -> np.ndarray:
        """Insert N landmarks; returns their slot ids."""
        n = len(xyz)
        while self.n_pt + n > self.config.max_points:
            self._grow(("pt_xyz", "pt_desc", "pt_valid", "pt_views"), "max_points")
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
            self._grow(_OBS_FIELDS, "max_observations")
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
        return self._snapshot(ids, uvs, device)

    def global_snapshot(self, device) -> dict:
        """The best-observed landmarks of the whole map, for relocalisation:
        the layout of `local_snapshot` (uv zero), points ranked by
        observation count."""
        valid_ids = np.where(self.pt_valid)[0]
        ids = valid_ids[np.argsort(-self.pt_views[valid_ids])]
        return self._snapshot(ids, None, device)

    def _snapshot(self, ids, uvs, device) -> dict:
        M = self.config.track_capacity
        n = min(len(ids), M)
        xyz = np.zeros((M, 3), np.float32)
        desc = np.zeros((M, 8), np.int32)
        uv = np.zeros((M, 2), np.float32)
        pid = np.zeros(M, np.int32)
        valid = np.zeros(M, bool)
        xyz[:n] = self.pt_xyz[ids[:n]]
        desc[:n] = self.pt_desc[ids[:n]]
        if uvs is not None:
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

    def refresh_scale_meas(self) -> None:
        """Re-capture the scale-edge measurements from the current poses.
        Call it after any gauge change (median-depth normalisation divides
        every translation): stale measurements make the next BA fight the
        new gauge and warp the map."""
        for k in range(1, self.n_kf):
            self.kf_scale_meas[k] = self._rel_norm(k)

    def cull_points(self, min_views: int = 3) -> int:
        """Drop landmarks seen by fewer than `min_views` keyframes
        (≙ Map.DiscardOutlierMapPoints, map.py:124-131, called every 4th
        keyframe from main.py:234-235). Returns the number culled."""
        weak = self.pt_valid & (self.pt_views < min_views)
        self.pt_valid[weak] = False
        self.obs_valid &= ~weak[self.obs_pt]
        return int(weak.sum())

    # -- BA interface --

    def to_ba_problem(self, intr: np.ndarray, fix_first: bool = True,
                      scale_edge_weight: float = 10.0, depth_weight: float = 0.0,
                      device="cuda"):
        """The whole map as a planar BAProblem on `device` (≙ the graph build
        of localBundleAdjustement, LocalBA.py:153-172, with the parent->child
        scale-edge chain :159-162). Returns (problem, meta): `meta` maps the
        packed slots and landmark rows back to this map's indexing."""
        K = self.config.max_keyframes
        cam_fixed = ~self.kf_valid.copy()
        if fix_first:
            cam_fixed[0] = True
        w = (self.obs_valid & self.pt_valid[self.obs_pt] & self.kf_valid[self.obs_cam]
             ).astype(np.float32)
        se_i = np.arange(K - 1, dtype=np.int32)
        se_j = se_i + 1
        se_w = (self.kf_valid[se_i] & self.kf_valid[se_j]).astype(np.float32) * scale_edge_weight
        return ba_mod.make_problem(
            R=self.kf_R, t=self.kf_t, X=self.pt_xyz, cam=self.obs_cam, pnt=self.obs_pt,
            uv=self.obs_uv, w=w, intr=intr, cam_fixed=cam_fixed, se_i=se_i, se_j=se_j,
            se_meas=self.kf_scale_meas[1:K], se_w=se_w,
            depth=self.obs_depth if depth_weight > 0 else None, depth_weight=depth_weight,
            device=device,
        )

    def update_from_ba(self, p: ba_mod.BAProblem, meta: ba_mod.BAMeta) -> None:
        """Write back the optimised poses and landmarks
        (≙ Map.UpdatePose/UpdatePoint3D, map.py:82-92)."""
        # New arrays, not writes into the old ones: trajectory entries may
        # hold views of the old poses.
        R, t = p.R.cpu().numpy(), p.t.cpu().numpy()
        self.kf_R = np.concatenate([R, self.kf_R[len(R):]])
        self.kf_t = np.concatenate([t, self.kf_t[len(t):]])
        real = meta.pt_ids >= 0
        self.pt_xyz[meta.pt_ids[real]] = p.X.cpu().numpy()[real]

    def prune_obs_from_ba(self, bad_slots: np.ndarray, meta: ba_mod.BAMeta) -> int:
        """Invalidate the observations whose packed slot the BA flagged bad;
        returns the number pruned. pt_views drops with each pruned live
        sighting, so `cull_points` compares the live observation count
        (≙ Point.GetNVisibleFrames, point.py:58-59)."""
        sel = bad_slots[: len(meta.slot_obs)] & (meta.slot_obs >= 0)
        rows = meta.slot_obs[sel]
        rows = rows[self.obs_valid[rows]]  # a replayed meta prunes nothing twice
        if len(rows) == 0:
            return 0
        self.obs_valid[rows] = False
        np.subtract.at(self.pt_views, self.obs_pt[rows], 1)
        return len(rows)

    def compact_observations(self, min_dead_fraction: float = 0.25) -> int:
        """Rewrite the observation table without its dead rows, once they
        are at least `min_dead_fraction` of it; returns the rows reclaimed.
        Row indices held by any in-flight BA meta become stale: call it only
        when none is in flight."""
        n = self.n_obs
        dead = n - int(self.obs_valid[:n].sum())
        if n == 0 or dead < min_dead_fraction * n:
            return 0
        keep = np.where(self.obs_valid[:n])[0]
        m = len(keep)
        for name in _OBS_FIELDS:
            a = getattr(self, name)
            a[:m] = a[keep]
            a[m:n] = 0
        self.n_obs = m
        return n - m
