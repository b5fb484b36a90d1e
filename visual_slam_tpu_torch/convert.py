"""Carry state across from the JAX package.

SLAM has no learned weights. What both implementations must share is:
the constant descriptor tables (PATTERN, _D, _WX, _WY), a map snapshot
(xyz, desc, valid), a frame's features (uv, desc, score, valid), poses,
and a bundle-adjustment problem (BAProblem).
Each `from_jax_*` takes those as NumPy arrays — what `np.asarray` of the
JAX values gives — and returns the port's tensors on `device`.

Descriptors are uint32 words in the JAX package and int32 tensors here
with the same bits: the conversion is `ndarray.view(np.int32)`, never a
value cast.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.ba import BAProblem
from .models.frontend import Features


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
