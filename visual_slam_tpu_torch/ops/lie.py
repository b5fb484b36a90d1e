"""SO(3) / SE(3) exponential maps (port of visual_slam_tpu/ops/lie.py:18-51,
:86-102, :126-134, :171-195).

The replacement for the reference's `cv2.Rodrigues` usage
(src/v2/helper_functions.py:269-278). Functions take arbitrary leading
batch dimensions; se(3) tangents are ordered [omega, v].
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


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R (...,3,3), t (...,3)) -> homogeneous transform (...,4,4)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


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
