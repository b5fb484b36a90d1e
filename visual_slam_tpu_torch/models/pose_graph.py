"""Pose-graph optimisation: Gauss-Newton over SE(3) relative-pose edges and
scale edges, and the 7-DoF Sim(3) graph of monocular loop correction (port
of visual_slam_tpu/models/pose_graph.py:1-570; the g2o I/O is utils/g2o_io).

The replacement for the reference's g2o pose-graph pieces:
`add_edge_between_poses` (EdgeSE3 with a DCS robust kernel, LocalBA.py:97-113)
and `AddScalingEdge` (EdgeSBAScale on the relative-translation norm,
LocalBA.py:115-131).

Residuals, for world->camera poses T with (R_rel, t_rel) = T_i T_j^-1:
  SE3 edge (i,j), measurement Z (j-from-i):
      r = [vee(Z^T R_rel - R_rel^T Z)/2, Z^T (t_rel - Z_t)]
  scale edge (i,j), measurement s:  r = ||t_rel|| - s
The chordal rotation residual is zero exactly where so3_log is and stays
smooth at the identity.

Solvers:
  * optimize: analytic per-edge 6x6 Jacobian blocks, the block-sparse normal
    equations, block-Jacobi preconditioned CG, a DCS robust kernel.
  * optimize_dense: torch.func.jacfwd and a dense 6Kx6K solve, the
    small-graph oracle that optimize is held against.
  * optimize_sim3: the 7-DoF graph (per-keyframe log-scale).

Every vertex-indexed sum and gather of optimize and optimize_sim3 runs on
kernels B4 and B5 (ops/kernels/seg_kernel): the edge endpoints are fixed
over the GN and CG iterations, so one B4 plan over the slot ids
[e_i, e_j, s_i, s_j] serves every sum of a call. Per GN step one B5 gathers
the endpoint poses and one B4 sums the 6x6 (Sim3: 7x7) diagonal blocks and
the gradient rows; per CG iteration one B5 gathers the search direction at
the far end of each slot's edge and one B4 sums the off-diagonal products.
Float atomics (`index_add_` on CUDA) would make card runs differ; B4 adds in
the order its plan fixes.

Edge sharding (parallel/sharded_pg.py): with a `group`, each rank holds a
block of the SE3 and scale edge tables and every pose; `optimize` sums the
block diagonal and gradient, each CG matvec's off-diagonal term and the
cost over the group (ba._allreduce, the JAX package's psum points); the
damping and the fixed vertices' masks act once, after the sum.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie
from ..ops.kernels import seg_kernel
from .ba import _allreduce

# The JAX package's defaults (models/pose_graph.py: optimize, optimize_sim3
# and optimize_dense), which no caller changes.
DAMPING = 1e-5  # Levenberg damping on the diagonal blocks
DCS_PHI = 1.0  # DCS kernel width
DENSE_DAMPING = 1e-6  # optimize_dense


class PoseGraph(NamedTuple):
    R: torch.Tensor  # (K,3,3) world->camera
    t: torch.Tensor  # (K,3)
    e_i: torch.Tensor  # (E,) int32 first vertex
    e_j: torch.Tensor  # (E,) int32 second vertex
    Z_R: torch.Tensor  # (E,3,3) measured relative rotation (cam_j -> cam_i)
    Z_t: torch.Tensor  # (E,3) measured relative translation
    w: torch.Tensor  # (E,) edge weights (0 = padding)
    s_i: torch.Tensor  # (S,) int32 scale-edge first vertex
    s_j: torch.Tensor  # (S,) int32 scale-edge second vertex
    s_meas: torch.Tensor  # (S,) measured ||t_rel||
    s_w: torch.Tensor  # (S,) scale-edge weights
    fixed: torch.Tensor  # (K,) bool


class Sim3Graph(NamedTuple):
    R: torch.Tensor  # (K,3,3) world->camera
    t: torch.Tensor  # (K,3)
    lam: torch.Tensor  # (K,) log-scale
    e_i: torch.Tensor  # (E,) int32
    e_j: torch.Tensor  # (E,) int32
    Z_R: torch.Tensor  # (E,3,3)
    Z_t: torch.Tensor  # (E,3)
    Z_ls: torch.Tensor  # (E,) log of the measured relative scale s_i/s_j
    w: torch.Tensor  # (E,) pose-row weights (0 = padding)
    w_lam: torch.Tensor  # (E,) scale-row weights
    fixed: torch.Tensor  # (K,) bool


# so3 generators: G[k] = d[w]x/dw_k.
_GEN = np.zeros((3, 3, 3), np.float32)
_GEN[0, 2, 1] = 1.0
_GEN[0, 1, 2] = -1.0
_GEN[1, 0, 2] = 1.0
_GEN[1, 2, 0] = -1.0
_GEN[2, 1, 0] = 1.0
_GEN[2, 0, 1] = -1.0


def _gen(like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_GEN, dtype=like.dtype, device=like.device)


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _rel_at(Ri, ti, Rj, tj):
    R_rel = Ri @ _T(Rj)
    t_rel = ti - torch.einsum("...ij,...j->...i", R_rel, tj)
    return R_rel, t_rel


def _rel(R, t, i, j):
    """T_i T_j^{-1}: (R_rel, t_rel) mapping cam-j coords into cam-i."""
    i, j = torch.as_tensor(i, device=R.device).long(), torch.as_tensor(j, device=R.device).long()
    return _rel_at(R[i], t[i], R[j], t[j])


def _pose_table(R, t, lam=None) -> torch.Tensor:
    """Channel-major vertex table for B5: (12,K) R entries and t, or
    (13,K) with the log-scale."""
    K = R.shape[0]
    rows = [R.reshape(K, 9).T, t.T] + ([lam[None]] if lam is not None else [])
    return torch.cat(rows).contiguous()


def _ends(table: torch.Tensor, ids: torch.Tensor):
    """Gather the vertex table at slot ids with B5: (R (N,3,3), t (N,3),
    lam (N,) or None)."""
    g = seg_kernel.cam_expand(table, ids)
    lam = g[12] if g.shape[0] == 13 else None
    return g[:9].T.reshape(-1, 3, 3), g[9:12].T, lam


def _slot_ids(*parts) -> torch.Tensor:
    return torch.cat(parts).to(torch.int32).contiguous()


def _se3_residual(g: PoseGraph, R, t):
    R_rel, t_rel = _rel(R, t, g.e_i, g.e_j)
    dR = torch.einsum("eji,ejk->eik", g.Z_R, R_rel)  # Z^T @ R_rel
    dt = torch.einsum("eji,ej->ei", g.Z_R, t_rel - g.Z_t)
    r_rot = lie.vee(dR - _T(dR)) * 0.5
    return torch.cat([r_rot, dt], dim=-1)  # (E,6)


def _scale_residual(g: PoseGraph, R, t):
    _, t_rel = _rel(R, t, g.s_i, g.s_j)
    # Epsilon-safe norm: padded/identity edges sit at t_rel == 0, where the
    # norm's derivative is NaN under jacfwd even at weight 0.
    return torch.sqrt(torch.sum(t_rel * t_rel, dim=-1) + 1e-12) - g.s_meas  # (S,)


def _rot_blocks(Zt, Z_R, R_rel, dRm, G):
    """The rotation rows' 3x3 blocks of both endpoints: L_i[:, k] =
    vee(Z^T G_k R_rel + R_rel^T G_k Z)/2, L_j[:, k] = -vee(Z^T R_rel G_k +
    G_k R_rel^T Z)/2."""
    Rt = _T(R_rel)
    A1 = torch.einsum("eab,kbc,ecd->ekad", Zt, G, R_rel)
    A2 = torch.einsum("eab,kbc,ecd->ekad", Rt, G, Z_R)
    L_i = _T(lie.vee(A1 + A2) * 0.5)  # (E,3,3): rows = residual
    B1 = torch.einsum("eab,kbc->ekac", dRm, G)
    B2 = torch.einsum("kab,ebc->ekac", G, torch.einsum("eab,ebc->eac", Rt, Z_R))
    L_j = _T(lie.vee(B1 + B2) * -0.5)
    return L_i, L_j


def _se3_terms(Ri, ti, Rj, tj, Z_R, Z_t):
    """Residuals r (E,6) and Jacobian blocks J_i, J_j (E,6,6) of SE3 edges
    on their gathered endpoint poses. For left-composed se3 deltas (w, dt):
      d t_rel = [w_i]x t_rel + dt_i - R_rel dt_j          (w_j cancels)
      d R_rel = [w_i]x R_rel - R_rel [w_j]x"""
    R_rel, t_rel = _rel_at(Ri, ti, Rj, tj)
    Zt = _T(Z_R)  # (E,3,3) Z^T
    dRm = torch.einsum("eab,ebc->eac", Zt, R_rel)  # Z^T R_rel
    r_rot = lie.vee(dRm - _T(dRm)) * 0.5
    r_t = torch.einsum("eab,eb->ea", Zt, t_rel - Z_t)
    r = torch.cat([r_rot, r_t], dim=-1)  # (E,6)
    G = _gen(Ri)
    L_i, L_j = _rot_blocks(Zt, Z_R, R_rel, dRm, G)
    # d r_t / d w_i = Z^T [w]x t_rel => column k is Z^T (G_k t_rel).
    Jt_wi = torch.einsum("eab,kbc,ec->eak", Zt, G, t_rel)  # (E,3,3)
    zero3 = torch.zeros_like(L_i)
    J_i = torch.cat([torch.cat([L_i, zero3], dim=-1),
                     torch.cat([Jt_wi, Zt], dim=-1)], dim=-2)  # (E,6,6)
    J_j = torch.cat([torch.cat([L_j, zero3], dim=-1),
                     torch.cat([zero3, -dRm], dim=-1)], dim=-2)
    return r, J_i, J_j


def _se3_edge_blocks(g: PoseGraph, R, t):
    """Analytic per-edge residuals and Jacobian blocks: r (E,6), J_i, J_j
    (E,6,6). The endpoint poses are gathered with B5."""
    E = g.e_i.shape[0]
    Rs, ts, _ = _ends(_pose_table(R, t), _slot_ids(g.e_i, g.e_j))
    return _se3_terms(Rs[:E], ts[:E], Rs[E:], ts[E:], g.Z_R, g.Z_t)


def _scale_edge_blocks(g: PoseGraph, R, t):
    """Closed-form scale-edge residual + Jacobians (ops/lie.py)."""
    return lie.scale_edge_terms(R, t, g.s_i, g.s_j, g.s_meas)


def _dcs_weight(chi2, phi):
    """Dynamic Covariance Scaling (Agarwal et al. 2013): s = min(1,
    2*phi/(phi+chi2)); the IRLS information scale is s^2. Keeps good edges
    at full weight and smoothly anneals gross outliers (bad loop edges)."""
    s = torch.clamp(2.0 * phi / (phi + chi2), max=1.0)
    return s * s


def _apply_delta(R, t, delta):
    dR, dt = lie.se3_exp(delta)
    return dR @ R, torch.einsum("kij,kj->ki", dR, t) + dt


def _block_inverse(D: torch.Tensor) -> torch.Tensor:
    """(n,n,K) planar blocks -> their inverses, planar; linalg.solve(D, I)
    as in the JAX package, without its host-side error check."""
    Dk = D.permute(2, 0, 1)
    eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device).expand(Dk.shape)
    return torch.linalg.solve_ex(Dk, eye)[0].permute(1, 2, 0)


def _pcg(D, D_inv, grad, offb, ids, swap, plan, free, cg_iters, group=None):
    """Block-Jacobi PCG on the normal system, vectors planar (n,K). D,
    D_inv (n,n,K); offb (n,n,N): each slot's off-diagonal block, which
    multiplies the direction at the slot's far endpoint (`swap`) and sums
    into its own vertex (`ids`); with a `group`, summed over its ranks."""
    K = D.shape[-1]

    def mv(A, x):  # planar block products: (n,n,M) x (n,M) -> (n,M)
        return torch.sum(A * x[None], dim=1)

    def matvec(x):
        x = x * free
        xs = seg_kernel.cam_expand(x.contiguous(), swap)  # B5: x at the far ends
        off = _allreduce(seg_kernel.cam_reduce(mv(offb, xs), ids, K, plan), group)
        return (mv(D, x) + off) * free

    def precond(x):
        return mv(D_inv, x) * free

    b = -grad
    x = torch.zeros_like(b)
    rr = b
    z = precond(rr)
    p = z
    for _ in range(cg_iters):
        Ap = matvec(p)
        rz = torch.sum(rr * z)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(denom) > 1e-20, denom, 1e-20)
        x = x + alpha * p
        r_new = rr - alpha * Ap
        z_new = precond(r_new)
        beta = torch.sum(r_new * z_new) / torch.where(torch.abs(rz) > 1e-20, rz, 1e-20)
        rr, z, p = r_new, z_new, z_new + beta * p
    return x * free


def _planar(blocks: torch.Tensor) -> torch.Tensor:
    """(N,n,n) -> (n*n, N) rows for B4."""
    return blocks.reshape(blocks.shape[0], -1).T


def optimize(g: PoseGraph, n_iters: int = 12, cg_iters: int = 32, use_dcs: bool = True,
             group=None):
    """Scalable pose-graph Gauss-Newton: analytic Jacobian blocks +
    block-Jacobi-preconditioned CG on the 6K normal system, with a DCS
    robust kernel on the SE3 edges. Returns (R, t, final cost).

    group: a torch.distributed process group over which the edge tables are
    sharded (parallel/sharded_pg.optimize_sharded), or None."""
    K = g.R.shape[0]
    E, S = g.e_i.shape[0], g.s_i.shape[0]
    free = (~g.fixed).to(g.R.dtype)[None]  # (1,K)
    ids = _slot_ids(g.e_i, g.e_j, g.s_i, g.s_j)
    swap = _slot_ids(g.e_j, g.e_i, g.s_j, g.s_i)
    plan = seg_kernel.reduce_plan(ids, K)
    eye6 = torch.eye(6, dtype=g.R.dtype, device=g.R.device)
    R, t, cost = g.R, g.t, None
    for _ in range(n_iters):
        Rs, ts, _ = _ends(_pose_table(R, t), ids)
        a, b, c = E, 2 * E, 2 * E + S
        r, J_i, J_j = _se3_terms(Rs[:a], ts[:a], Rs[a:b], ts[a:b], g.Z_R, g.Z_t)
        chi2 = g.w * torch.sum(r * r, dim=-1)
        w_e = g.w * (_dcs_weight(chi2, DCS_PHI) if use_dcs else 1.0)
        rs, Si, Sj = lie.scale_edge_terms_at(Rs[b:c], ts[b:c], Rs[c:], ts[c:], g.s_meas)

        wJi = J_i * w_e[:, None, None]
        wJj = J_j * w_e[:, None, None]
        H_ii = torch.einsum("eri,erj->eij", wJi, J_i)  # (E,6,6)
        H_jj = torch.einsum("eri,erj->eij", wJj, J_j)
        H_ij = torch.einsum("eri,erj->eij", wJi, J_j)
        g_i = torch.einsum("eri,er->ei", wJi, r)
        g_j = torch.einsum("eri,er->ei", wJj, r)
        wSi = Si * g.s_w[:, None]
        wSj = Sj * g.s_w[:, None]
        # The block diagonal and the gradient, one B4 over every slot.
        blocks = torch.cat([H_ii, H_jj, torch.einsum("ei,ej->eij", wSi, Si),
                            torch.einsum("ei,ej->eij", wSj, Sj)])
        grads = torch.cat([g_i, g_j, wSi * rs[:, None], wSj * rs[:, None]])
        red = _allreduce(seg_kernel.cam_reduce(torch.cat([_planar(blocks), grads.T]).contiguous(),
                                               ids, K, plan), group)
        D = red[:36].reshape(6, 6, K) + DAMPING * eye6[:, :, None]
        grad = red[36:] * free
        Hs_ij = torch.einsum("ei,ej->eij", wSi, Sj)  # scale cross blocks
        offb = torch.cat([H_ij, _T(H_ij), Hs_ij, _T(Hs_ij)]).permute(1, 2, 0)
        delta = _pcg(D, _block_inverse(D), grad, offb, ids, swap, plan, free, cg_iters, group)
        R, t = _apply_delta(R, t, delta.T)
        cost = _allreduce(torch.sum(w_e * torch.sum(r * r, -1)) + torch.sum(g.s_w * rs * rs),
                          group)
    return R, t, cost


def _total_residuals(g: PoseGraph, delta):
    """Residual vector as a function of per-pose se3 deltas (K,6)."""
    R, t = _apply_delta(g.R, g.t, delta)
    r_se3 = _se3_residual(g, R, t) * torch.sqrt(g.w)[:, None]
    r_s = _scale_residual(g, R, t) * torch.sqrt(g.s_w)
    return torch.cat([r_se3.reshape(-1), r_s])


def optimize_dense(g: PoseGraph, n_iters: int = 10):
    """Dense jacfwd Gauss-Newton (the small-graph oracle for optimize)."""
    K = g.R.shape[0]
    mask = torch.repeat_interleave((~g.fixed).to(g.R.dtype), 6)
    eye = torch.eye(K * 6, dtype=g.R.dtype, device=g.R.device)
    cost = None
    for _ in range(n_iters):
        g_cur = g

        def res_fn(delta):
            return _total_residuals(g_cur, delta.reshape(K, 6))

        d0 = torch.zeros(K * 6, dtype=g.R.dtype, device=g.R.device)
        r = res_fn(d0)
        J = torch.func.jacfwd(res_fn)(d0) * mask[None, :]  # (R, 6K)
        H = J.T @ J + DENSE_DAMPING * eye
        delta = -torch.linalg.solve(H, J.T @ r) * mask
        R_new, t_new = _apply_delta(g.R, g.t, delta.reshape(K, 6))
        g = g._replace(R=R_new, t=t_new)
        cost = torch.sum(r * r)
    return g.R, g.t, cost


# --------------------------------------------------------------------- Sim(3)
#
# Monocular scale drift cannot be absorbed by an SE(3) pose graph: a genuine
# loop whose ends disagree in scale forces a rigid correction that degrades
# reprojection everywhere. The 7-DoF graph gives each keyframe a log-scale
# and spreads the loop's scale discrepancy along the chain (ORB-SLAM's
# monocular loop correction).
#
# Parameterisation (world->cam): S_k = (s_k, R_k, t_k): x_cam = s_k R_k x_w
# + t_k. Relative: S_i S_j^-1 = (s_i/s_j, R_i R_j^T, t_i - (s_i/s_j) R_rel
# t_j). Left-composed delta (w, dt, dl) per node:
#   d t_rel wrt node i = [w_i]x t_rel + dt_i + dl_i * t_rel
#   d t_rel wrt node j = -(s_i/s_j) R_rel dt_j      (w_j, dl_j cancel)
#   r_lam = (lam_i - lam_j) - log Z_s, d = dl_i - dl_j
# Chain edges carry Z_s = 1; loop edges the measured relative scale.


def _sim3_terms(Ri, ti, lam_i, Rj, tj, lam_j, Z_R, Z_t, Z_ls):
    """Residuals (E,7) and 7x7 Jacobian blocks of Sim3 edges on their
    gathered endpoints. Rows: [3 chordal rotation, 3 translation, 1
    log-scale]; delta columns per node: [w(3), dt(3), dl(1)]."""
    s_rel = torch.exp(lam_i) / torch.exp(lam_j)  # (E,)
    R_rel = torch.einsum("eab,ecb->eac", Ri, Rj)  # R_i R_j^T
    t_rel = ti - s_rel[:, None] * torch.einsum("eab,eb->ea", R_rel, tj)
    Zt = _T(Z_R)
    dRm = torch.einsum("eab,ebc->eac", Zt, R_rel)  # Z^T R_rel
    r_rot = lie.vee(dRm - _T(dRm)) * 0.5
    r_t = torch.einsum("eab,eb->ea", Zt, t_rel - Z_t)
    r_lam = lam_i - lam_j - Z_ls  # (E,)
    G = _gen(Ri)
    L_i, L_j = _rot_blocks(Zt, Z_R, R_rel, dRm, G)
    Jt_wi = torch.einsum("eab,kbc,ec->eak", Zt, G, t_rel)  # (E,3,3)
    Jt_li = torch.einsum("eab,eb->ea", Zt, t_rel)[..., None]  # (E,3,1)
    E = L_i.shape[0]
    zero33 = torch.zeros_like(L_i)
    zero31 = torch.zeros_like(Jt_li)
    zero13 = torch.zeros((E, 1, 3), dtype=Ri.dtype, device=Ri.device)
    one11 = torch.ones((E, 1, 1), dtype=Ri.dtype, device=Ri.device)
    J_i = torch.cat([
        torch.cat([L_i, zero33, zero31], dim=-1),
        torch.cat([Jt_wi, Zt, Jt_li], dim=-1),
        torch.cat([zero13, zero13, one11], dim=-1),
    ], dim=-2)  # (E,7,7)
    ZtR = torch.einsum("eab,ebc->eac", Zt, R_rel) * s_rel[:, None, None]
    J_j = torch.cat([
        torch.cat([L_j, zero33, zero31], dim=-1),
        torch.cat([zero33, -ZtR, zero31], dim=-1),
        torch.cat([zero13, zero13, -one11], dim=-1),
    ], dim=-2)
    r = torch.cat([r_rot, r_t, r_lam[:, None]], dim=-1)  # (E,7)
    return r, J_i, J_j


def _sim3_edge_blocks(g: Sim3Graph, R, t, lam):
    """Analytic residuals + 7x7 Jacobian blocks per edge, endpoints
    gathered with B5."""
    E = g.e_i.shape[0]
    Rs, ts, ls = _ends(_pose_table(R, t, lam), _slot_ids(g.e_i, g.e_j))
    return _sim3_terms(Rs[:E], ts[:E], ls[:E], Rs[E:], ts[E:], ls[E:], g.Z_R, g.Z_t, g.Z_ls)


def _apply_sim3_delta(R, t, lam, delta):
    """delta (K,7) = [w, dt, dl], left-composed: S' = exp(delta) S."""
    dR, dt = lie.se3_exp(delta[:, :6])
    dl = delta[:, 6]
    s_d = torch.exp(dl)
    R_new = dR @ R
    t_new = s_d[:, None] * torch.einsum("kij,kj->ki", dR, t) + dt
    return R_new, t_new, lam + dl


def optimize_sim3(g: Sim3Graph, n_iters: int = 12, cg_iters: int = 32, use_dcs: bool = True):
    """7-DoF pose-graph Gauss-Newton (analytic blocks + block-Jacobi PCG,
    DCS on the pose rows). Returns (R, t, lam, final cost)."""
    K = g.R.shape[0]
    E = g.e_i.shape[0]
    free = (~g.fixed).to(g.R.dtype)[None]
    ids = _slot_ids(g.e_i, g.e_j)
    swap = _slot_ids(g.e_j, g.e_i)
    plan = seg_kernel.reduce_plan(ids, K)
    eye7 = torch.eye(7, dtype=g.R.dtype, device=g.R.device)
    R, t, lam, cost = g.R, g.t, g.lam, None
    for _ in range(n_iters):
        Rs, ts, ls = _ends(_pose_table(R, t, lam), ids)
        r, J_i, J_j = _sim3_terms(Rs[:E], ts[:E], ls[:E], Rs[E:], ts[E:], ls[E:],
                                  g.Z_R, g.Z_t, g.Z_ls)
        chi2 = g.w * torch.sum(r[:, :6] * r[:, :6], dim=-1)
        dcs = _dcs_weight(chi2, DCS_PHI) if use_dcs else 1.0
        row_w = torch.cat([(g.w * dcs)[:, None].expand(E, 6), (g.w_lam * dcs)[:, None]], dim=-1)
        wJi = J_i * row_w[:, :, None]
        wJj = J_j * row_w[:, :, None]
        H_ii = torch.einsum("eri,erj->eij", wJi, J_i)
        H_jj = torch.einsum("eri,erj->eij", wJj, J_j)
        H_ij = torch.einsum("eri,erj->eij", wJi, J_j)
        g_i = torch.einsum("eri,er->ei", wJi, r)
        g_j = torch.einsum("eri,er->ei", wJj, r)
        blocks = torch.cat([H_ii, H_jj])
        red = seg_kernel.cam_reduce(torch.cat([_planar(blocks), torch.cat([g_i, g_j]).T]).contiguous(),
                                    ids, K, plan)
        D = red[:49].reshape(7, 7, K) + DAMPING * eye7[:, :, None]
        grad = red[49:] * free
        offb = torch.cat([H_ij, _T(H_ij)]).permute(1, 2, 0)
        delta = _pcg(D, _block_inverse(D), grad, offb, ids, swap, plan, free, cg_iters)
        R, t, lam = _apply_sim3_delta(R, t, lam, delta.T)
        cost = torch.sum(row_w * r * r)
    return R, t, lam, cost


# ------------------------------------------------------------------ builders


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=like.dtype, device=like.device)


def _chain(R, t, valid):
    K = R.shape[0]
    i = torch.arange(K - 1, dtype=torch.int32, device=R.device)
    j = i + 1
    Z_R, Z_t = _rel(R, t, i, j)
    valid = torch.as_tensor(valid, device=R.device)
    w = (valid[:-1] & valid[1:]).to(R.dtype)
    fixed = torch.zeros(K, dtype=torch.bool, device=R.device)
    fixed[0] = True
    return i, j, Z_R, Z_t, w, fixed | ~valid


def from_keyframe_chain(R: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                        scale_meas: torch.Tensor | None = None) -> PoseGraph:
    """Chain pose graph over consecutive keyframes, with scale edges
    (≙ the parent->child AddScalingEdge chain, LocalBA.py:159-162)."""
    i, j, Z_R, Z_t, w, fixed = _chain(R, t, valid)
    if scale_meas is None:
        scale_meas = torch.linalg.norm(Z_t, dim=-1)
    return PoseGraph(R=R, t=t, e_i=i, e_j=j, Z_R=Z_R, Z_t=Z_t, w=w, s_i=i, s_j=j,
                     s_meas=_as(scale_meas, R), s_w=w, fixed=fixed)


def add_edges(g: PoseGraph, e_i, e_j, Z_R, Z_t, w) -> PoseGraph:
    """Append SE3 edges (e.g. verified loop closures) to the graph."""
    return g._replace(
        e_i=torch.cat([g.e_i, _as(e_i, g.e_i)]), e_j=torch.cat([g.e_j, _as(e_j, g.e_j)]),
        Z_R=torch.cat([g.Z_R, _as(Z_R, g.Z_R)]), Z_t=torch.cat([g.Z_t, _as(Z_t, g.Z_t)]),
        w=torch.cat([g.w, _as(w, g.w)]),
    )


def sim3_from_keyframe_chain(R: torch.Tensor, t: torch.Tensor, valid: torch.Tensor) -> Sim3Graph:
    """Chain Sim3 graph: consecutive keyframes, Z from the current relative
    poses, Z_s = 1 (adjacent keyframes share local scale), lam = 0."""
    K = R.shape[0]
    i, j, Z_R, Z_t, w, fixed = _chain(R, t, valid)
    return Sim3Graph(R=R, t=t, lam=torch.zeros(K, dtype=R.dtype, device=R.device), e_i=i, e_j=j,
                     Z_R=Z_R, Z_t=Z_t, Z_ls=torch.zeros(K - 1, dtype=R.dtype, device=R.device),
                     w=w, w_lam=w, fixed=fixed)


def sim3_add_edges(g: Sim3Graph, e_i, e_j, Z_R, Z_t, Z_ls, w) -> Sim3Graph:
    """Append Sim3 loop edges (log relative scale Z_ls per edge)."""
    w = _as(w, g.w)
    return g._replace(
        e_i=torch.cat([g.e_i, _as(e_i, g.e_i)]), e_j=torch.cat([g.e_j, _as(e_j, g.e_j)]),
        Z_R=torch.cat([g.Z_R, _as(Z_R, g.Z_R)]), Z_t=torch.cat([g.Z_t, _as(Z_t, g.Z_t)]),
        Z_ls=torch.cat([g.Z_ls, _as(Z_ls, g.Z_ls)]), w=torch.cat([g.w, w]),
        w_lam=torch.cat([g.w_lam, w]),
    )
