"""Two-view epipolar geometry: essential-matrix estimation, scoring,
refinement, decomposition and cheirality-voted pose recovery (port of
visual_slam_tpu/ops/epipolar.py).

The replacement for the reference's OpenCV calls: `cv2.findEssentialMat` and
its epipolar-line scoring in `estimateEssential` (src/v2/helper_functions.py:
47-70), `cv2.recoverPose` in `estimateRelativePose` (:164-209) and the
4-candidate vote of `chooseRealizableSolution` (:125-161).

Convention: E satisfies xn2^T E xn1 = 0 for normalized image coordinates,
with (R, t) the cam1->cam2 transform (X2 = R X1 + t) and E = [t]x R, as in
cv2.findEssentialMat / recoverPose. E is defined up to sign; eigenvector and
singular-vector signs differ between linear-algebra libraries, so only
sign-free quantities (residuals, the voted R and t) are comparable across
them.
"""
from __future__ import annotations

import math

import torch

from . import lie, linalg as linalg_mod, triangulate as tri


def _homog(xn: torch.Tensor) -> torch.Tensor:
    return torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)


def _so3_uv(U: torch.Tensor, Vt: torch.Tensor):
    """Flip the last singular vectors so that U and Vt are rotations."""
    det_u = torch.linalg.det(U)
    det_v = torch.linalg.det(Vt)
    one = torch.ones_like(det_u)
    U = U * torch.stack([one, one, det_u], dim=-1)[..., None, :]
    Vt = Vt * torch.stack([one, one, det_v], dim=-1)[..., :, None]
    return U, Vt


def eight_point_essential(xn1: torch.Tensor, xn2: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted 8-point essential matrix from normalized coordinates.

    Args:
      xn1, xn2: (...,N,2) normalized image coordinates.
      weights: optional (...,N) non-negative weights / validity mask.
    Returns:
      (...,3,3) essential matrix with singular values (1,1,0).
    """
    if weights is None:
        weights = torch.ones_like(xn1[..., 0])
    # Hartley normalization per set: zero mean, RMS distance sqrt(2). It keeps
    # the squared conditioning of the 9x9 Gram matrix inside float32.
    w_sum = torch.sum(weights, dim=-1, keepdim=True) + 1e-12
    mu1 = torch.sum(xn1 * weights[..., None], dim=-2, keepdim=True) / w_sum[..., None]
    mu2 = torch.sum(xn2 * weights[..., None], dim=-2, keepdim=True) / w_sum[..., None]
    d1 = torch.sqrt(torch.sum(torch.sum((xn1 - mu1) ** 2, -1) * weights, -1, keepdim=True) / w_sum)
    d2 = torch.sqrt(torch.sum(torch.sum((xn2 - mu2) ** 2, -1) * weights, -1, keepdim=True) / w_sum)
    s1 = math.sqrt(2.0) / (d1 + 1e-12)
    s2 = math.sqrt(2.0) / (d2 + 1e-12)
    p1 = (xn1 - mu1) * s1[..., None]
    p2 = (xn2 - mu2) * s2[..., None]
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    # Rows of x2^T E x1 = 0 for vec(E) row-major.
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    e = linalg_mod.solve_weighted_homogeneous(A, torch.sqrt(weights))
    E = e.reshape(e.shape[:-1] + (3, 3))

    # Denormalize: E = T2^T En T1 with Ti = [[si,0,-si*mui_x],[0,si,-si*mui_y],[0,0,1]].
    def _T(s, mu):
        sx = s[..., 0]
        z = torch.zeros_like(sx)
        o = torch.ones_like(sx)
        return torch.stack([
            torch.stack([sx, z, -sx * mu[..., 0, 0]], dim=-1),
            torch.stack([z, sx, -sx * mu[..., 0, 1]], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ], dim=-2)

    E = _T(s2, mu2).transpose(-1, -2) @ E @ _T(s1, mu1)
    # Project onto the essential manifold.
    U, _, Vt = torch.linalg.svd(E)
    U, Vt = _so3_uv(U, Vt)
    S = torch.ones(3, dtype=E.dtype, device=E.device)  # made on the device: no host copy
    S[2] = 0.0
    return (U * S) @ Vt  # U diag(1,1,0) Vt, in the JAX package's arithmetic


def epipolar_distance_sq(E: torch.Tensor, xn1: torch.Tensor, xn2: torch.Tensor) -> torch.Tensor:
    """Symmetric squared point-to-epipolar-line distance (normalized coords,
    ≙ the scoring in estimateEssential, helper_functions.py:55-68): x2 to
    the line E x1 plus x1 to the line E^T x2. E (...,3,3), x (...,N,2)."""
    X1 = _homog(xn1)
    X2 = _homog(xn2)
    l2 = X1 @ E.transpose(-1, -2)  # lines in image 2
    l1 = X2 @ E  # lines in image 1
    num = torch.sum(X2 * l2, dim=-1)
    d2 = num**2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = num**2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    return d1 + d2


def sampson_error_sq(E: torch.Tensor, xn1: torch.Tensor, xn2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) squared error."""
    X1 = _homog(xn1)
    X2 = _homog(xn2)
    Ex1 = X1 @ E.transpose(-1, -2)
    Etx2 = X2 @ E
    num = torch.sum(X2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / (den + 1e-12)


def sampson_residual(R, t, X1, X2):
    """Signed Sampson residual of E = [t]x R over homogeneous points (N,3)."""
    E = lie.hat(t) @ R
    Ex1 = X1 @ E.T
    Etx2 = X2 @ E
    num = torch.sum(X2 * Ex1, dim=-1)
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / torch.sqrt(den + 1e-12)


def params_to_Rt(p, R_base, t_base, B):
    """The pose at 5-DOF parameters p: so(3) on R_base, and t_base moved in the
    tangent basis B (3,2) of S2, renormalised."""
    R = lie.so3_exp(p[:3]) @ R_base
    t = t_base + B @ p[3:5]
    return R, t / (torch.linalg.norm(t) + 1e-12)


def refine_essential_gn(E0: torch.Tensor, xn1: torch.Tensor, xn2: torch.Tensor,
                        weights: torch.Tensor, n_iters: int = 5) -> torch.Tensor:
    """Gauss-Newton on the Sampson error over E's minimal (R, t)
    parameterization: 5 DOF, so(3) x the tangent plane of S2 at t.

    The manifold step lands at the geometric optimum where float32 linear
    refits cannot; the caller's weights make it robust. The Jacobian of the
    residual at p = 0 is taken by forward-mode autodiff (torch.func.jacfwd),
    as the JAX package takes it with jax.jacfwd.
    """
    R, t, _, _, _ = recover_pose(E0, xn1, xn2, weights > 0)
    X1 = _homog(xn1)
    X2 = _homog(xn2)
    # Constants made on the device: a host tensor's copy would wait for it.
    ex, ey, _ = torch.eye(3, dtype=t.dtype, device=t.device)
    eye5 = 1e-8 * torch.eye(5, dtype=t.dtype, device=t.device)
    for _ in range(n_iters):
        # Tangent basis of S2 at t.
        a = torch.where(torch.abs(t[0]) < 0.9, ex, ey)
        b1 = torch.linalg.cross(t, a)
        b1 = b1 / (torch.linalg.norm(b1) + 1e-12)
        b2 = torch.linalg.cross(t, b1)
        B = torch.stack([b1, b2], dim=-1)  # (3,2)

        def res_fn(p, R=R, t=t, B=B):
            return sampson_residual(*params_to_Rt(p, R, t, B), X1, X2)

        p0 = torch.zeros(5, dtype=t.dtype, device=t.device)
        r = res_fn(p0)
        J = torch.func.jacfwd(res_fn)(p0)  # (N,5)
        wJ = J * weights[:, None]
        H = wJ.T @ J + eye5
        g = wJ.T @ r
        p = -torch.linalg.solve_ex(H, g)[0]  # no error check: no device sync
        R, t = params_to_Rt(p, R, t, B)
    return lie.hat(t) @ R


def decompose_essential(E: torch.Tensor):
    """E -> the two rotation candidates (Ra, Rb) and the unit translation t
    (≙ cv2.decomposeEssentialMat inside recoverPose)."""
    U, _, Vt = torch.linalg.svd(E)
    U, Vt = _so3_uv(U, Vt)
    u0, u1, u2 = U[..., :, 0], U[..., :, 1], U[..., :, 2]
    UW = torch.stack([u1, -u0, u2], dim=-1)  # U @ W, W = [[0,-1,0],[1,0,0],[0,0,1]]
    UWt = torch.stack([-u1, u0, u2], dim=-1)  # U @ W^T
    return UW @ Vt, UWt @ Vt, u2


def recover_pose(E: torch.Tensor, xn1: torch.Tensor, xn2: torch.Tensor, mask: torch.Tensor,
                 distance_thresh: float = 50.0):
    """Pick the realizable (R, t) among E's four decompositions by a
    cheirality vote and triangulate the points under the winner
    (≙ cv2.recoverPose(E, ..., distanceThresh=50) in estimateRelativePose).

    Args:
      E (3,3); xn1/xn2 (N,2) normalized coords; mask (N,) bool of valid
      correspondences; distance_thresh: max accepted depth in view 1.
    Returns:
      R (3,3), t (3,) cam1->cam2 with |t| = 1, X1 (N,3) points in the cam-1
      frame, good (N,) cheirality mask, valid_fraction (0-d).
    """
    Ra, Rb, t = decompose_essential(E)
    # Candidate order [Ra,t; Ra,-t; Rb,t; Rb,-t]: argmax breaks ties by it.
    Rs = torch.stack([Ra, Ra, Rb, Rb])
    ts = torch.stack([t, -t, t, -t])
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    zero = torch.zeros(3, dtype=E.dtype, device=E.device)
    X1s, goods = [], []
    for k in range(4):
        X1 = tri.triangulate_midpoint(eye, zero, Rs[k], ts[k], xn1, xn2)
        z2 = (X1 @ Rs[k].T + ts[k])[..., 2]
        z1 = X1[..., 2]
        goods.append((z1 > 0) & (z2 > 0) & (z1 < distance_thresh) & mask)
        X1s.append(X1)
    goods = torch.stack(goods)
    counts = goods.sum(dim=-1)
    best = torch.argmax(counts).reshape(1)  # index_select: no host read of it

    def pick(a):
        return a.index_select(0, best)[0]

    frac = pick(counts).to(E.dtype) / torch.clamp_min(mask.sum(), 1).to(E.dtype)
    return pick(Rs), pick(ts), pick(torch.stack(X1s)), pick(goods), frac
