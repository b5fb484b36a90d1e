"""Homography estimation, scoring and planar pose recovery (port of
visual_slam_tpu/ops/homography.py:26-239).

The replacement for the reference's homography branch:
  - `estimateHomography` + symmetric-transfer-error scoring
    (src/v2/helper_functions.py:73-88, cv2.findHomography RANSAC),
  - `cv2.decomposeHomographyMat` + realizable-solution selection inside
    `estimateRelativePose(..., "Homographic")` (src/v2/helper_functions.py:
    196-209) and `chooseRealizableSolution` (:125-161).

The decomposition is the Faugeras-Lustman SVD construction (the math behind
cv2.decomposeHomographyMat): 8 (R, t, n) candidates, filtered by a
cheirality vote.

Convention: H maps normalized image-1 coordinates to normalized image-2
coordinates, x2 ~ H x1, with (R, t) the cam1->cam2 transform and n the
plane normal in cam 1 (H = R + t n^T / d).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import linalg, ransac as ransac_mod, triangulate as tri


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _T(s: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """(...,3,3) Hartley normalisation: scale s (...,1) about mu (...,1,2)."""
    sx = s[..., 0]
    zz, oo = torch.zeros_like(sx), torch.ones_like(sx)
    return torch.stack([
        torch.stack([sx, zz, -sx * mu[..., 0, 0]], -1),
        torch.stack([zz, sx, -sx * mu[..., 0, 1]], -1),
        torch.stack([zz, zz, oo], -1),
    ], dim=-2)


def _T_inv(s: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    inv_s = 1.0 / s[..., 0]
    zz, oo = torch.zeros_like(inv_s), torch.ones_like(inv_s)
    return torch.stack([
        torch.stack([inv_s, zz, mu[..., 0, 0]], -1),
        torch.stack([zz, inv_s, mu[..., 0, 1]], -1),
        torch.stack([zz, zz, oo], -1),
    ], dim=-2)


def dlt_homography(xn1: torch.Tensor, xn2: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted normalized-DLT homography from >= 4 correspondences.

    xn1, xn2: (...,N,2). Returns (...,3,3) scaled to H[2,2] = 1."""
    if weights is None:
        weights = torch.ones(xn1.shape[:-1], dtype=xn1.dtype, device=xn1.device)
    w_sum = torch.sum(weights, dim=-1, keepdim=True) + 1e-12
    mu1 = torch.sum(xn1 * weights[..., None], -2, keepdim=True) / w_sum[..., None]
    mu2 = torch.sum(xn2 * weights[..., None], -2, keepdim=True) / w_sum[..., None]
    d1 = torch.sqrt(torch.sum(torch.sum((xn1 - mu1) ** 2, -1) * weights, -1, keepdim=True) / w_sum)
    d2 = torch.sqrt(torch.sum(torch.sum((xn2 - mu2) ** 2, -1) * weights, -1, keepdim=True) / w_sum)
    # A 0-d tensor, not a Python float: a float over a tensor is its
    # reciprocal times the float in torch, one rounding more than JAX's.
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=xn1.dtype)
    s1 = sqrt2 / (d1 + 1e-12)
    s2 = sqrt2 / (d2 + 1e-12)
    p1 = (xn1 - mu1) * s1[..., None]
    p2 = (xn2 - mu2) * s2[..., None]
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    # Rows for h = vec(H) row-major: two equations per correspondence.
    r1 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    r2 = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (...,2N,9)
    w2 = torch.cat([weights, weights], dim=-1)
    h = linalg.solve_weighted_homogeneous(A, torch.sqrt(w2))
    Hn = h.reshape(*h.shape[:-1], 3, 3)
    H = _T_inv(s2, mu2) @ Hn @ _T(s1, mu1)  # H = T2^-1 Hn T1
    return H / (H[..., 2:3, 2:3] + 1e-12)


def symmetric_transfer_error_sq(H: torch.Tensor, xn1: torch.Tensor, xn2: torch.Tensor) -> torch.Tensor:
    """d(x2, H x1)^2 + d(x1, H^-1 x2)^2 (≙ helper_functions.py:80-88).

    H (...,3,3) against points (N,2) or (...,N,2) -> (...,N)."""
    Hx1 = _homog(xn1) @ H.transpose(-1, -2)
    fwd = Hx1[..., :2] / (Hx1[..., 2:3] + 1e-12) - xn2
    # inv_ex: no error check, so no host read on the card; a singular
    # hypothesis gives non-finite errors, and RANSAC never picks it.
    Hinv, _ = torch.linalg.inv_ex(H)
    Hx2 = _homog(xn2) @ Hinv.transpose(-1, -2)
    bwd = Hx2[..., :2] / (Hx2[..., 2:3] + 1e-12) - xn1
    return torch.sum(fwd**2, -1) + torch.sum(bwd**2, -1)


def estimate_homography_ransac(xn1: torch.Tensor, xn2: torch.Tensor, mask: torch.Tensor,
                               threshold: float, *, idx: torch.Tensor | None = None,
                               generator: torch.Generator | None = None, n_hyps: int = 512):
    """Fixed-budget RANSAC + two weighted refits. The 4-point minimal sets
    are `idx` (n_hyps, 4) when given, else drawn from `generator`.
    Returns (H, inliers, n_in)."""
    th = np.float32(threshold)
    th_sq = float(th * th)  # the squared threshold in float32, as the JAX package's
    if idx is None:
        idx = ransac_mod.sample_minimal_sets(generator, n_hyps, 4, mask)

    def solver(ix):
        return dlt_homography(xn1[ix], xn2[ix]).reshape(-1, 9)

    def residual(models):
        return 0.5 * symmetric_transfer_error_sq(models.reshape(-1, 3, 3), xn1, xn2)

    H, inliers, _, _ = ransac_mod.ransac(idx, solver, residual, mask, th_sq)
    for _ in range(2):
        H = dlt_homography(xn1, xn2, inliers.to(xn1.dtype))
        inliers = (0.5 * symmetric_transfer_error_sq(H, xn1, xn2) < th_sq) & mask
    return H, inliers, inliers.sum()


def decompose_homography(H: torch.Tensor):
    """Faugeras-Lustman decomposition: H -> 8 candidate (R, t, n).

    Returns (Rs (8,3,3), ts (8,3), ns (8,3)) on H's device; translations are
    scaled by the unknown plane distance (direction meaningful, like
    decomposeHomographyMat).

    It runs on the host's LAPACK, wherever H lies. An SVD fixes each
    singular pair (u_i, v_i) only up to a common sign; flipping pair 0 or 2
    swaps e1 or e3 below and so reorders the candidates. A planar scene
    leaves two candidates with every point in front of both cameras, and
    the vote takes the first of them: the order decides the pose. The
    host's SVD gives the JAX package's CPU signs, and the card's cuSOLVER
    need not; one 3x3 SVD on the host costs one read of H.
    """
    U, S, Vt = torch.linalg.svd(H.detach().cpu())
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    # Work with H' = H/d2 in the frame of V.
    denom = torch.clamp_min(d1**2 - d3**2, 1e-12)
    x1 = torch.sqrt(torch.clamp((d1**2 - d2**2) / denom, 0.0, 1.0))
    x3 = torch.sqrt(torch.clamp((d2**2 - d3**2) / denom, 0.0, 1.0))
    zero, one = torch.zeros(()), torch.ones(())

    def build(e1, e3, flip):
        if not flip:
            sin_t = (d1 - d3) * x1 * x3 * e1 * e3 / d2
            cos_t = (d1 * x3**2 + d3 * x1**2) / d2
            Rp = torch.stack([torch.stack([cos_t, zero, -sin_t]),
                              torch.stack([zero, one, zero]),
                              torch.stack([sin_t, zero, cos_t])])
            tp = (d1 - d3) * torch.stack([x1 * e1, zero, -x3 * e3])
        else:
            sin_p = (d1 + d3) * x1 * x3 * e1 * e3 / d2
            cos_p = (d3 * x1**2 - d1 * x3**2) / d2
            Rp = torch.stack([torch.stack([cos_p, zero, sin_p]),
                              torch.stack([zero, -one, zero]),
                              torch.stack([sin_p, zero, -cos_p])])
            tp = (d1 + d3) * torch.stack([x1 * e1, zero, x3 * e3])
        n_p = torch.stack([x1 * e1, zero, x3 * e3])
        return s * U @ Rp @ Vt, U @ tp, Vt.T @ n_p

    cands = [build(e1, e3, flip) for flip in (False, True) for e1 in (1.0, -1.0) for e3 in (1.0, -1.0)]
    return tuple(torch.stack(c).to(H.device) for c in zip(*cands))


def recover_pose_homography(H: torch.Tensor, xn1: torch.Tensor, xn2: torch.Tensor,
                            mask: torch.Tensor, distance_thresh: float = 50.0):
    """Cheirality vote over the 8 homography decompositions.

    ≙ `chooseRealizableSolution` (helper_functions.py:125-161) applied to
    the homography branch of estimateRelativePose. The first candidate with
    the most points in front of both cameras wins. Returns (R, t (unit),
    X1 (N,3) cam-1 points, good (N,), valid_fraction)."""
    Rs, ts, _ = decompose_homography(H)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    zero = torch.zeros(3, dtype=H.dtype, device=H.device)
    tns, X1s, goods = [], [], []
    for k in range(8):
        tn = ts[k] / (torch.linalg.norm(ts[k]) + 1e-12)
        X1 = tri.triangulate_midpoint(eye, zero, Rs[k], tn, xn1, xn2)
        z1 = X1[..., 2]
        z2 = (X1 @ Rs[k].T + tn)[..., 2]
        goods.append((z1 > 0) & (z2 > 0) & (z1 < distance_thresh) & mask)
        X1s.append(X1)
        tns.append(tn)
    goods = torch.stack(goods)
    counts = goods.sum(dim=-1)
    best = torch.argmax(counts).reshape(1)  # the first maximum; index_select: no host read

    def pick(a):
        return a.index_select(0, best)[0]

    frac = pick(counts).to(H.dtype) / torch.clamp_min(mask.sum(), 1).to(H.dtype)
    return pick(Rs), pick(torch.stack(tns)), pick(torch.stack(X1s)), pick(goods), frac
