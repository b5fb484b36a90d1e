"""Large-map bundle adjustment: implicit Schur PCG in channel-major layout
(port of visual_slam_tpu/models/ba_large.py, one device).

The same LM + marginalised-landmark Schur math as models/ba.py, in a form
whose memory is linear in the number of observation slots N, for
BASELINE.json config #5 (about 5k keyframes and 1M landmarks, where the
dense (6,3,K,P) W of the online solver would exceed 100 GB):

  * every per-observation quantity is channel-major: residuals (2,N), pose
    Jacobians (12,N), point Jacobians (6,N), the coupling WO (18,N);
  * slot -> camera gathers go through kernel B5 (`cam_expand`) and camera
    segment sums through kernel B4 (`cam_reduce`), ops/kernels/seg_kernel;
    the tensors' device picks the kernel (CUDA) or its plain version (CPU);
  * point-side reductions are (C,P,Q) reshape-sums: slots are grouped per
    landmark (N = P*Q);
  * the reduced camera system S = U - W V^-1 W^T is never formed:
    block-Jacobi PCG applies it as two per-slot contractions plus one camera
    expand and one camera reduce per matvec.

Per `optimize(n_iters=n, cg_iters=g)` call, B5 runs 1 + n*(g+3) times (the
initial cost, then per LM iteration the projection of the build, g matvecs,
the landmark back-substitution and the candidate's cost) and B4 n*(g+2)
times (the build's 27-row reduce, the right-hand side and g matvecs).

The landmark-sharded form (parallel/sharded_ba.optimize_large_sharded) is
not ported: one H100 holds config #5 whole.
"""
from __future__ import annotations

import torch

from ..ops.kernels import seg_kernel
from .ba import (
    HUBER_DELTA,
    BAProblem,
    _inv6,
    _mask_cam,
    _pcg,
    add_cross_blocks,
    cam_rows,
    huber_rho,
    lm_loop,
    point_expand,
    scale_edge_blocks,
    scale_edge_cost,
)


def _cexp(x_t: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """(C,K) camera table -> (C,N) per-slot rows (B5)."""
    return seg_kernel.cam_expand(x_t.contiguous(), cam)


def _cred(d_t: torch.Tensor, cam: torch.Tensor, K: int, plan) -> torch.Tensor:
    """(C,N) per-slot rows -> (C,K) per-camera sums (B4 over `plan`)."""
    return seg_kernel.cam_reduce(d_t.contiguous(), cam, K, plan)


def _point_sum(d_t: torch.Tensor, P: int) -> torch.Tensor:
    """(C,N) -> (C,P): slots are landmark-grouped (N = P*Q)."""
    C, N = d_t.shape
    return d_t.reshape(C, P, N // P).sum(-1)


_point_expand = point_expand


def _project(p: BAProblem):
    """Channel-major projection: r (2,N), Xc (3,N), Rn (9,N), iz (N,),
    w_irls (N,)."""
    N = p.cam.shape[0]
    fx, fy, cx, cy = p.intr[0], p.intr[1], p.intr[2], p.intr[3]
    Rtn = _cexp(cam_rows(p), p.cam)  # one (12,K) -> (12,N) expand
    Rn, tn = Rtn[:9], Rtn[9:12]  # rows R[i,j] at 3i+j; (3,N)
    Xn = _point_expand(p.X.T, N)
    Xc = torch.stack([
        Rn[3 * i] * Xn[0] + Rn[3 * i + 1] * Xn[1] + Rn[3 * i + 2] * Xn[2] + tn[i]
        for i in range(3)
    ])
    z = Xc[2]
    z_safe = torch.where(torch.abs(z) > 1e-8, z, 1e-8)
    iz = 1.0 / z_safe
    pred_u = fx * Xc[0] * iz + cx
    pred_v = fy * Xc[1] * iz + cy
    r = torch.stack([pred_u, pred_v]) - p.uv
    rn = torch.sqrt(r[0] * r[0] + r[1] * r[1] + 1e-12)
    w_rob = torch.where(rn <= HUBER_DELTA, 1.0, HUBER_DELTA / rn)
    w_irls = p.w * w_rob * (z > 1e-6)
    return r, Xc, Rn, iz, w_irls


def _jacobians(Xc, Rn, iz, intr):
    """Jc (12,N) [row r*6+i], Jp (6,N) [row r*3+j]: the hand-derived
    products of ba._jacobians_planar, channel-major."""
    fx, fy = intr[0], intr[1]
    x, y, z = Xc[0], Xc[1], Xc[2]
    a = fx * iz
    b = -fx * x * iz * iz
    c = fy * iz
    d = -fy * y * iz * iz
    zero = torch.zeros_like(a)
    Jc = torch.stack([
        b * y, a * z - b * x, -a * y, a, zero, b,
        -c * z + d * y, -d * x, c * x, zero, c, d,
    ])
    # Jp[r*3+j] = sum_c J_proj[r,c] * Rn[c*3+j];  J_proj = [[a,0,b],[0,c,d]].
    Jp = torch.stack(
        [a * Rn[j] + b * Rn[6 + j] for j in range(3)]
        + [c * Rn[3 + j] + d * Rn[6 + j] for j in range(3)]
    )
    return Jc, Jp


def _cost(p: BAProblem) -> torch.Tensor:
    """Robust (Huber) total cost, a 0-d tensor."""
    r, Xc, _, _, _ = _project(p)
    zmask = (Xc[2] > 1e-6).to(p.w.dtype)
    cost_obs = torch.sum(p.w * zmask * huber_rho(r[0] * r[0] + r[1] * r[1]))
    return cost_obs + scale_edge_cost(p)


# Upper-triangle index pairs of a 6x6 block (21 entries), and for each of
# the 36 entries of a block the row of its upper-triangle twin.
_TRIU6 = [(i, j) for i in range(6) for j in range(i, 6)]
_SYM36 = [_TRIU6.index((min(i, j), max(i, j))) for i in range(6) for j in range(6)]


def _inv3_rows(V9: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of SPD 3x3 blocks stored as rows:
    (9,P) [i*3+j] -> (9,P)."""
    a, b, c, d, e, f, g, h, i = (V9[k] for k in range(9))
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    return torch.stack([A, B, C, D, E, F, G, H, I]) / det


def _build(p: BAProblem, lm_lambda, plan):
    """Hessian pieces, memory linear in N: U (K,6,6) damped, V_inv (9,P),
    g_c (K,6), g_p (3,P), WO (18,N), H_ij (E,6,6) scale-edge cross blocks.
    `plan`: B4's reduce plan of p.cam, built once per problem by the caller
    (a CPU problem never reads it)."""
    K = p.R.shape[0]
    P = p.X.shape[0]
    r, Xc, Rn, iz, w_irls = _project(p)
    Jc, Jp = _jacobians(Xc, Rn, iz, p.intr)
    wJc = Jc * w_irls[None, :]
    wJp = Jp * w_irls[None, :]

    # Camera side in ONE B4 launch: 21 upper-triangle U entries + 6 gradient
    # rows, stacked (27,N).
    u_rows = [wJc[i] * Jc[j] + wJc[6 + i] * Jc[6 + j] for (i, j) in _TRIU6]
    g_rows = [wJc[i] * r[0] + wJc[6 + i] * r[1] for i in range(6)]
    red = _cred(torch.stack(u_rows + g_rows), p.cam, K, plan)  # (27,K)
    U = torch.stack([red[k] for k in _SYM36], dim=1).reshape(K, 6, 6)
    g_c = red[21:27].T

    # Point side: V (9,P), g_p (3,P).
    v_rows = [wJp[j] * Jp[k] + wJp[3 + j] * Jp[3 + k] for j in range(3) for k in range(3)]
    V9 = _point_sum(torch.stack(v_rows), P)
    g_p = _point_sum(torch.stack([wJp[j] * r[0] + wJp[3 + j] * r[1] for j in range(3)]), P)

    # Coupling, per slot: WO[i*3+j] = sum_r wJc[r*6+i] * Jp[r*3+j].
    WO = torch.stack([
        wJc[i] * Jp[j] + wJc[6 + i] * Jp[3 + j] for i in range(6) for j in range(3)
    ])

    U, g_c, H_ij = scale_edge_blocks(p, U, g_c)
    U = U + lm_lambda * torch.eye(6, dtype=U.dtype, device=U.device)[None]
    V9 = V9.clone()
    V9[0::4] += lm_lambda  # rows 0, 4, 8: + lambda*I per 3x3 block
    return U, _inv3_rows(V9), g_c, g_p, WO, H_ij


def _wt_apply(WO: torch.Tensor, xc6: torch.Tensor) -> torch.Tensor:
    """t1[j] = sum_i WO[i*3+j] * xc6[i]: W^T x per slot, (6,N) -> (3,N)."""
    return torch.stack([sum(WO[3 * i + j] * xc6[i] for i in range(6)) for j in range(3)])


def _w_apply(WO: torch.Tensor, t_n: torch.Tensor) -> torch.Tensor:
    """t3[i] = sum_j WO[i*3+j] * t[j]: W t per slot, (3,N) -> (6,N)."""
    return torch.stack([sum(WO[3 * i + j] * t_n[j] for j in range(3)) for i in range(6)])


def _vinv_apply(V_inv: torch.Tensor, t_p: torch.Tensor) -> torch.Tensor:
    """(9,P) block-diagonal inverse applied to (3,P)."""
    return torch.stack([sum(V_inv[3 * i + j] * t_p[j] for j in range(3)) for i in range(3)])


def _schur_matvec(x, p, U, V_inv, WO, H_ij, plan):
    """y = (U - W V^-1 W^T) x without forming S: a camera expand, two per-slot
    contractions, a point reduce and expand, one camera reduce."""
    K = U.shape[0]
    P = V_inv.shape[1]
    N = WO.shape[1]
    x = _mask_cam(x, p.cam_fixed)
    y = torch.einsum("kij,kj->ki", U, x)
    xc6 = _cexp(x.T, p.cam)  # (6,N)
    t1p = _point_sum(_wt_apply(WO, xc6), P)  # (3,P)
    t2n = _point_expand(_vinv_apply(V_inv, t1p), N)  # (3,N)
    y2 = _cred(_w_apply(WO, t2n), p.cam, K, plan)  # (6,K)
    y = add_cross_blocks(y - y2.T, x, p, H_ij)
    return _mask_cam(y, p.cam_fixed)


def _solve_delta(p, lm_lambda, cg_iters, points_fixed, plan):
    K = p.R.shape[0]
    P = p.X.shape[0]
    N = p.cam.shape[0]
    U, V_inv, g_c, g_p, WO, H_ij = _build(p, lm_lambda, plan)
    g_c = _mask_cam(g_c, p.cam_fixed)
    U_inv = _inv6(U)

    if points_fixed:
        delta_c = -torch.einsum("kij,kj->ki", U_inv, g_c)
        return _mask_cam(delta_c, p.cam_fixed), torch.zeros_like(p.X)

    Vg_n = _point_expand(_vinv_apply(V_inv, g_p), N)
    b_sub = _cred(_w_apply(WO, Vg_n), p.cam, K, plan)  # (6,K)
    b = _mask_cam(-(g_c - b_sub.T), p.cam_fixed)

    def matvec(x):
        return _schur_matvec(x, p, U, V_inv, WO, H_ij, plan)

    def precond(x):
        return _mask_cam(torch.einsum("kij,kj->ki", U_inv, x), p.cam_fixed)

    delta_c = _pcg(matvec, precond, b, cg_iters)
    # Back-substitute landmarks: delta_p = -V^-1 (g_p + W^T delta_c).
    dcn = _cexp(delta_c.T, p.cam)
    back = _point_sum(_wt_apply(WO, dcn), P)
    delta_p = -_vinv_apply(V_inv, g_p + back)
    return delta_c, delta_p.T


def optimize(p: BAProblem, n_iters: int = 10, cg_iters: int = 12,
             points_fixed: bool = False, init_lambda: float = 1e-4):
    """LM loop with the accept/reject structure of ba.optimize and the
    large-map solve. Returns (optimized problem, final cost as a 0-d
    tensor). Branch-free: no host read inside the loop. The camera index is
    fixed, so one B4 reduce plan serves all n*(g+2) reduces."""
    plan = seg_kernel.reduce_plan(p.cam, p.R.shape[0])
    return lm_loop(
        p, n_iters, init_lambda,
        lambda q, lam: _solve_delta(q, lam, cg_iters, points_fixed, plan),
        _cost,
    )
