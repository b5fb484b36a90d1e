"""SO(3) / SE(3) Lie-group operations (port of visual_slam_tpu/ops/lie.py).

The replacement for the reference's `cv2.Rodrigues` usage
(src/v2/helper_functions.py:269-278) and its `Isometry3d` rigid-transform
class (src/v2/main.py:32-51). Functions take arbitrary leading batch
dimensions; se(3) tangents are ordered [omega, v], homogeneous transforms
are (...,4,4).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _coefficients(w: torch.Tensor):
    """theta^2 and the Rodrigues coefficients sin(t)/t, (1-cos(t))/t^2,
    with Taylor fallbacks for small angles."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 <= _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return theta2, small, a, b


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: rotation vector (...,3) -> rotation matrix (...,3,3)."""
    _, _, a, b = _coefficients(w)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> rotation vector (...,3)
    (≙ cv2.Rodrigues(R), src/v2/helper_functions.py:276-278)."""
    cos_t = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    # Generic branch: theta / (2 sin theta) * vee(R - R^T), a series near 0.
    sin_t = torch.sin(theta)
    scale = torch.where(torch.abs(sin_t) > 1e-5, theta / (2.0 * sin_t + _EPS),
                        0.5 + theta * theta / 12.0)
    w = vee(R - R.transpose(-1, -2)) * scale[..., None]
    # Near theta == pi the generic formula degenerates: the axis comes from
    # the diagonal, R = I + 2 sin^2(t/2) (aa^T - I), its signs from the
    # off-diagonal terms (the x axis's sign first).
    near_pi = cos_t < -1.0 + 1e-5
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0) + _EPS)
    sx = torch.where(R[..., 2, 1] - R[..., 1, 2] >= 0, 1.0, -1.0)
    sy = torch.where(R[..., 0, 1] + R[..., 1, 0] >= 0, sx, -sx)
    sz = torch.where(R[..., 0, 2] + R[..., 2, 0] >= 0, sx, -sx)
    w_pi = axis * torch.stack([sx, sy, sz], dim=-1) * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """se(3) tangent (...,6) = [omega, v] -> (R (...,3,3), t (...,3))."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2, small, a, b = _coefficients(w)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    t = (V @ v[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> se(3) tangent (...,6) = [omega, v]."""
    w = so3_log(R)
    theta2, small, a, b = _coefficients(w)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - a / (2.0 * b + _EPS)) / (theta2 + _EPS))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    Vinv = eye - 0.5 * W + coef * (W @ W)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], dim=-1)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R (...,3,3), t (...,3)) -> homogeneous transform (...,4,4)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def split_T(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return T[..., :3, :3], T[..., :3, 3]


def inv_T(T: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse (≙ Isometry3d.inverse, src/v2/main.py:42-43)."""
    R, t = split_T(T)
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -(Rt @ t[..., None])[..., 0])


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    return Ta @ Tb


def transform_points(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply a (...,4,4) rigid transform to points (...,N,3) -> (...,N,3)."""
    R, t = split_T(T)
    return rotate_points(R, X) + t[..., None, :]


def rotate_points(R: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return X @ R.transpose(-1, -2)


def project_so3(M: torch.Tensor) -> torch.Tensor:
    """Project an arbitrary (...,3,3) matrix onto SO(3) via SVD (det +1)."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def scale_edge_terms(R, t, i, j, meas):
    """Closed-form scale-edge residuals and Jacobians (port of
    visual_slam_tpu/ops/lie.py:171-195), used by bundle adjustment.

    g2o's EdgeSBAScale (reference LocalBA.py:115-131): r_e = ||t_rel|| -
    meas with t_rel = t_i - R_i R_j^T t_j. The rotational derivative
    vanishes exactly, so J_i = [0_3, u], J_j = [0_3, -R_rel^T u] with
    u = t_rel / ||t_rel||.

    Args: R (K,3,3), t (K,3), edge endpoints i/j (E,), meas (E,).
    Returns (r (E,), Ji (E,6), Jj (E,6)).
    """
    i, j = i.long(), j.long()
    return scale_edge_terms_at(R[i], t[i], R[j], t[j], meas)


def scale_edge_terms_at(Ri, ti, Rj, tj, meas):
    """scale_edge_terms on poses already gathered per edge: Ri, Rj (E,3,3),
    ti, tj (E,3)."""
    R_rel = torch.einsum("eab,ecb->eac", Ri, Rj)  # R_i R_j^T
    t_rel = ti - torch.einsum("eab,eb->ea", R_rel, tj)
    nrm = torch.sqrt(torch.sum(t_rel * t_rel, dim=-1) + 1e-12)
    r = nrm - meas
    u = t_rel / nrm[:, None]
    zeros = torch.zeros_like(u)
    Ji = torch.cat([zeros, u], dim=-1)
    Jj = torch.cat([zeros, -torch.einsum("eab,ea->eb", R_rel, u)], dim=-1)
    return r, Ji, Jj
