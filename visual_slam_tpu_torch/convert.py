"""Carry state across from the JAX package.

SLAM has no learned weights. What both implementations must share is:
the constant descriptor tables (PATTERN, _D, _WX, _WY), a map snapshot
(xyz, desc, valid), a frame's features (uv, desc, score, valid), poses,
a bundle-adjustment problem (BAProblem), a whole SLAM map (SlamMap), a
pose graph (PoseGraph, Sim3Graph) and a tracking result (TrackStep).
Each `from_jax_*` takes those as NumPy arrays — what `np.asarray` of the
JAX values gives — and returns the port's tensors on `device`.

Descriptors are uint32 words in the JAX package and int32 tensors here
with the same bits: the conversion is `ndarray.view(np.int32)`, never a
value cast.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import MapConfig
from .models.ba import BAProblem
from .models.frontend import Features
from .models.map_state import SlamMap
from .models.pose_graph import PoseGraph, Sim3Graph


def from_jax_desc(desc: np.ndarray, device) -> torch.Tensor:
    """(K,8) uint32 -> (K,8) int32 tensor with the same bit pattern."""
    d = np.ascontiguousarray(desc)
    if d.dtype != np.uint32:
        raise TypeError(f"descriptors must be uint32, got {d.dtype}")
    return torch.from_numpy(d.view(np.int32).copy()).to(device)


def to_jax_desc(desc: torch.Tensor) -> np.ndarray:
    """(K,8) int32 tensor -> (K,8) uint32 NumPy array with the same bits."""
    return np.ascontiguousarray(desc.detach().cpu().numpy()).view(np.uint32)


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def from_jax_tables(pattern, D, wx, wy, device) -> dict[str, torch.Tensor]:
    """The descriptor tables as float32 tensors, keyed as
    ops.descriptor_mxu.tables() keys the port's own."""
    return dict(pattern=_f32(pattern, device), D=_f32(D, device),
                wx=_f32(wx, device), wy=_f32(wy, device))


def from_jax_features(uv, desc, score, valid, device) -> Features:
    return Features(
        uv=_f32(uv, device),
        desc=from_jax_desc(desc, device),
        score=_f32(score, device),
        valid=torch.from_numpy(np.array(valid, bool)).to(device),
    )


def from_jax_snapshot(xyz, desc, valid, device) -> dict:
    """A tracking snapshot in the layout of SlamMap.local_snapshot."""
    valid_np = np.array(valid, bool)
    return dict(
        xyz=_f32(xyz, device),
        desc=from_jax_desc(desc, device),
        valid=torch.from_numpy(valid_np).to(device),
        n_valid=int(valid_np.sum()),
    )


def from_jax_pose(R, t, device) -> tuple[torch.Tensor, torch.Tensor]:
    return _f32(R, device), _f32(t, device)


_BA_INT = {"cam", "se_i", "se_j"}


def from_jax_ba_problem(fields, device) -> BAProblem:
    """A bundle-adjustment problem of the JAX package, given as NumPy arrays
    (a mapping of field name to array, or any NamedTuple with the fields of
    BAProblem, such as `jax.tree.map(np.asarray, prob)`), as the port's
    BAProblem on `device`: the index fields int32, `cam_fixed` bool, the
    rest float32. Both packages then solve the same problem."""
    f = fields._asdict() if hasattr(fields, "_asdict") else dict(fields)
    out = {}
    for name in BAProblem._fields:
        a = np.asarray(f[name])
        dtype = np.int32 if name in _BA_INT else bool if name == "cam_fixed" else np.float32
        out[name] = torch.from_numpy(np.array(a, dtype)).to(device)
    return BAProblem(**out)


def to_numpy_ba_problem(p: BAProblem) -> dict[str, np.ndarray]:
    """The inverse of from_jax_ba_problem: field name -> NumPy array."""
    return {name: getattr(p, name).detach().cpu().numpy() for name in BAProblem._fields}


_MAP_ARRAYS = (
    "kf_R", "kf_t", "kf_valid", "kf_frame_idx", "kf_scale_meas", "pt_xyz", "pt_desc",
    "pt_valid", "pt_views", "obs_cam", "obs_pt", "obs_uv", "obs_depth", "obs_valid",
)
_MAP_COUNTS = ("n_kf", "n_pt", "n_obs")


def from_jax_map(jmap) -> SlamMap:
    """A SlamMap of the JAX package (any object with its array attributes,
    capacities in `config`) as the port's SlamMap: the same arrays, copied;
    descriptors uint32 -> int32 by view."""
    c = jmap.config
    m = SlamMap(MapConfig(c.max_keyframes, c.max_points, c.max_observations, c.track_capacity))
    for name in _MAP_ARRAYS:
        a = np.array(getattr(jmap, name))
        if name == "pt_desc":
            if a.dtype != np.uint32:
                raise TypeError(f"descriptors must be uint32, got {a.dtype}")
            a = a.view(np.int32)
        setattr(m, name, a)
    for name in _MAP_COUNTS:
        setattr(m, name, int(getattr(jmap, name)))
    return m


def to_jax_map_arrays(m: SlamMap) -> dict[str, np.ndarray]:
    """The inverse of from_jax_map: array and count name -> NumPy value,
    descriptors as uint32 with the same bits."""
    out = {name: np.array(getattr(m, name)) for name in _MAP_ARRAYS}
    out["pt_desc"] = out["pt_desc"].view(np.uint32)
    out.update({name: getattr(m, name) for name in _MAP_COUNTS})
    return out


_GRAPH_INT = {"e_i", "e_j", "s_i", "s_j"}


def _graph(cls, fields, device):
    f = fields._asdict() if hasattr(fields, "_asdict") else dict(fields)
    out = {}
    for name in cls._fields:
        dtype = np.int32 if name in _GRAPH_INT else bool if name == "fixed" else np.float32
        out[name] = torch.from_numpy(np.array(np.asarray(f[name]), dtype)).to(device)
    return cls(**out)


def from_jax_pose_graph(fields, device) -> PoseGraph:
    """A PoseGraph of the JAX package (a NamedTuple or mapping of NumPy
    arrays) as the port's on `device`: vertex ids int32, `fixed` bool, the
    rest float32."""
    return _graph(PoseGraph, fields, device)


def from_jax_sim3_graph(fields, device) -> Sim3Graph:
    """A Sim3Graph of the JAX package as the port's, as from_jax_pose_graph."""
    return _graph(Sim3Graph, fields, device)


def from_jax_track_blob(blob: np.ndarray, M: int, K: int, device):
    """A tracking result of the JAX package, its packed blob (`_pack_blob`:
    R (9), t (3), n_inliers, 3 spare, then inliers (M), idx2 (M), uv (K,2),
    valid (K), desc (K,8) as float32 bits), as (TrackStep, Features) on
    `device`: the step the port's track_step would return, and the frame's
    features the blob carries."""
    from .pipeline import TrackStep

    b = np.asarray(blob, np.float32)
    o = 16
    inl, idx2 = b[o:o + M], b[o + M:o + 2 * M]
    o += 2 * M
    uv = b[o:o + 2 * K].reshape(K, 2)
    valid = b[o + 2 * K:o + 3 * K]
    desc = np.ascontiguousarray(b[o + 3 * K:o + 11 * K]).view(np.uint32).reshape(K, 8)
    step = TrackStep(
        R=_f32(b[:9].reshape(3, 3), device), t=_f32(b[9:12], device),
        inliers=torch.from_numpy(inl > 0.5).to(device),
        n_inliers=torch.tensor(int(b[12]), dtype=torch.int64, device=device),
        idx2=torch.from_numpy(idx2.astype(np.int64)).to(device), used_ransac=False,
    )
    feats = Features(uv=_f32(uv, device), desc=from_jax_desc(desc, device),
                     score=torch.zeros(K, dtype=torch.float32, device=device),
                     valid=torch.from_numpy(valid > 0.5).to(device))
    return step, feats
