"""Map and trajectory checkpoint (port of visual_slam_tpu/utils/checkpoint.py).

The reference has no checkpointing (SURVEY.md §5; its closest artifact is
the g2o graph dump). The SlamMap's arrays serialise to one compressed npz
under the JAX package's keys, so a checkpoint written by either package
loads in the other: descriptors are written as uint32 (the JAX package's
dtype, the same bits as the port's int32) and read back by view. The port
also writes `obs_depth`, the RGB-D observation depths, which the JAX
package's file lacks: a JAX checkpoint loads here with zero depths, and
the JAX loader skips the extra key.
"""
from __future__ import annotations

import numpy as np

from ..config import MapConfig
from ..models.map_state import SlamMap

ARRAYS = (
    "kf_R", "kf_t", "kf_valid", "kf_frame_idx", "kf_scale_meas", "pt_xyz", "pt_desc",
    "pt_valid", "pt_views", "obs_cam", "obs_pt", "obs_uv", "obs_valid",
)
COUNTERS = ("n_kf", "n_pt", "n_obs")


def save_map(path: str, m: SlamMap, trajectory: np.ndarray | None = None) -> None:
    """Write the map (and an optional (N,3) trajectory) to `path` (.npz)."""
    data = {k: getattr(m, k) for k in ARRAYS}
    data["pt_desc"] = np.ascontiguousarray(m.pt_desc).view(np.uint32)
    data["obs_depth"] = m.obs_depth
    data.update({k: np.asarray(getattr(m, k)) for k in COUNTERS})
    c = m.config
    data["config"] = np.asarray([c.max_keyframes, c.max_points, c.max_observations,
                                 c.track_capacity])
    if trajectory is not None:
        data["trajectory"] = trajectory
    np.savez_compressed(path, **data)


def load_map(path: str) -> tuple[SlamMap, np.ndarray | None]:
    """Read a checkpoint of either package: (SlamMap, trajectory or None)."""
    with np.load(path) as z:
        m = SlamMap(MapConfig(*[int(v) for v in z["config"]]))
        for k in ARRAYS:
            setattr(m, k, z[k].copy())
        m.pt_desc = np.ascontiguousarray(m.pt_desc).view(np.int32)
        m.obs_depth = z["obs_depth"].copy() if "obs_depth" in z.files else np.zeros_like(m.obs_depth)
        for k in COUNTERS:
            setattr(m, k, int(z[k]))
        traj = z["trajectory"].copy() if "trajectory" in z.files else None
    return m, traj
