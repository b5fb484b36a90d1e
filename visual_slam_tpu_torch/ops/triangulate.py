"""Batched triangulation (port of visual_slam_tpu/ops/triangulate.py).

The replacement for the reference's per-point SVD loops `triangulate`
(src/v2/helper_functions.py:281-291, used at src/v2/main.py:284) and
`triangulate_nviews` (:330-348), and for `triangulateMidPoint` (:90-123):
the DLT systems of all points are solved at once by a batched
eigendecomposition of their 4x4 Gram matrices.
"""
from __future__ import annotations

import torch

from . import linalg as linalg_mod


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """Linear (DLT) two-view triangulation of a batch of correspondences.

    Args:
      P1, P2: (3,4) projection matrices (K @ [R|t], world->pixel), or (N,3,4)
        one a point.
      uv1, uv2: (N,2) pixel coordinates in each view.
    Returns:
      (N,4) unit-norm homogeneous world points (`dehomogenize` for xyz).
    """
    # Rows u * P[2] - P[0], v * P[2] - P[1] per view (Hartley-Zisserman 12.2).
    r1 = uv1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :]
    r2 = uv1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :]
    r3 = uv2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :]
    r4 = uv2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]
    return linalg_mod.solve_homogeneous(torch.stack([r1, r2, r3, r4], dim=-2))


def triangulate_dlt_pairwise(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                             uv2: torch.Tensor) -> torch.Tensor:
    """As `triangulate_dlt` with per-point projection matrices (N,3,4)."""
    return triangulate_dlt(P1, P2, uv1, uv2)


def triangulate_nviews(P: torch.Tensor, uv: torch.Tensor,
                       w: torch.Tensor | None = None) -> torch.Tensor:
    """Batched n-view linear triangulation with per-view weights.

    Each view contributes the two DLT rows u*P[2]-P[0], v*P[2]-P[1]
    (Hartley-Zisserman 12.2): the null space of the reference's 3n x (4+n)
    system without its per-view scale unknowns, so the system stays (2V,4)
    for any view count, with zero-weight rows as padding.

    Args:
      P: (N,V,3,4) per-point, per-view projection matrices (world->pixel),
         or (V,3,4) shared across points.
      uv: (N,V,2) pixel measurements.
      w: optional (N,V) weights; 0 disables a view. Rows are normalized
         before they are weighted, so weights act as per-view confidences.
    Returns:
      (N,4) unit-norm homogeneous world points (`dehomogenize` for xyz).
    """
    if P.dim() == 3:
        P = P[None].expand((uv.shape[0],) + P.shape)
    ru = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]  # (N,V,4)
    rv = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    A = torch.cat([ru, rv], dim=1)  # (N,2V,4)
    if w is None:
        return linalg_mod.solve_homogeneous(A)
    return linalg_mod.solve_weighted_homogeneous(A, torch.cat([w, w], dim=1))


def dehomogenize(Xh: torch.Tensor) -> torch.Tensor:
    """(...,4) homogeneous -> (...,3) euclidean with a safe divide."""
    w = Xh[..., 3:4]
    return Xh[..., :3] / torch.where(torch.abs(w) > 1e-12, w, 1e-12)


def triangulate_midpoint(R1: torch.Tensor, t1: torch.Tensor, R2: torch.Tensor,
                         t2: torch.Tensor, xn1: torch.Tensor, xn2: torch.Tensor) -> torch.Tensor:
    """Mid-point triangulation from normalized image coordinates.

    (R1,t1), (R2,t2) are world->camera transforms; xn1/xn2 (N,2). Returns
    (N,3) world points: the midpoint of the closest approach of the rays.
    """
    c1 = -(R1.T @ t1)
    c2 = -(R2.T @ t2)
    d1 = _ray(xn1) @ R1  # R^T * ray
    d2 = _ray(xn2) @ R2
    # min over (s, t) of |(c1 + s d1) - (c2 + t d2)|^2, per point.
    a = torch.sum(d1 * d1, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    c = torch.sum(d2 * d2, dim=-1)
    w = c2 - c1
    d = torch.sum(d1 * w, dim=-1)
    e = torch.sum(d2 * w, dim=-1)
    denom = a * c - b * b
    denom = torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    s = (c * d - b * e) / denom
    t = (b * d - a * e) / denom
    return 0.5 * ((c1 + s[..., None] * d1) + (c2 + t[..., None] * d2))


def _ray(xn: torch.Tensor) -> torch.Tensor:
    r = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
    return r / torch.linalg.norm(r, dim=-1, keepdim=True)
