"""Pinhole-camera projection primitives (port of
visual_slam_tpu/ops/projection.py).

Intrinsics are a 4-vector (fx, fy, cx, cy), distortion-free, matching the
reference (D = 0, src/v2/main.py:54).
"""
from __future__ import annotations

import torch


def intrinsics_matrix(intr: torch.Tensor) -> torch.Tensor:
    """(fx, fy, cx, cy) -> 3x3 K matrix."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]),
                        torch.stack([z, z, o])])


def make_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """(...,N,D) -> (...,N,D+1) with trailing ones (≙ MakeHomogeneous,
    src/v2/helper_functions.py:362-364)."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def projection_matrix(T_cw: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """K @ [R|t] (...,3,4) from a world->camera (...,4,4) transform
    (≙ CameraProjectionMatrix2, src/v2/helper_functions.py:376-378)."""
    return intrinsics_matrix(intr) @ T_cw[..., :3, :4]


def normalize_pixels(uv: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Pixels (...,2) -> normalized image coordinates via K^{-1}
    (≙ cv2.undistortPoints with zero distortion, helper_functions.py:27-28)."""
    x = (uv[..., 0] - intr[2]) / intr[0]
    y = (uv[..., 1] - intr[3]) / intr[1]
    return torch.stack([x, y], dim=-1)


def denormalize(xy: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    u = xy[..., 0] * intr[0] + intr[2]
    v = xy[..., 1] * intr[1] + intr[3]
    return torch.stack([u, v], dim=-1)


def project(R_cw: torch.Tensor, t_cw: torch.Tensor, X_w: torch.Tensor,
            intr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """World points (...,N,3) through the world->camera (R_cw, t_cw) ->
    (pixels (...,N,2), camera-frame depths (...,N))."""
    Xc = X_w @ R_cw.transpose(-1, -2) + t_cw[..., None, :]
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) > 1e-8, z, 1e-8)
    xy = torch.stack([Xc[..., 0] / z_safe, Xc[..., 1] / z_safe], dim=-1)
    return denormalize(xy, intr), z
