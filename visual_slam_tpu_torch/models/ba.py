"""Bundle adjustment: Levenberg-Marquardt with Schur-complement landmark
elimination (port of visual_slam_tpu/models/ba.py, one device).

The replacement for the reference's g2o back-end (src/v2/LocalBA.py:20-229):
poses + landmarks with the landmarks marginalised (g2o's
`VertexSBAPointXYZ.set_marginalized`, LocalBA.py:72), Huber at sqrt(5.991)
(LocalBA.py:82), scale edges, the optional RGB-D inverse-depth residual and
the median-depth gauge normalisation (LocalBA.py:179-190).

Layout, as in the JAX package: every per-observation quantity is a planar
tensor (d..., N) with N = P*Q slots grouped by landmark (point p owns slots
[p*Q, (p+1)*Q)). Point-side sums are reshape-sums and the landmark gather is
a broadcast. The camera-side gathers R[cam], t[cam] and the per-camera sums
of U and g_c, which the JAX package writes as one-hot matmuls, go through
kernels B5 (`cam_expand`) and B4 (`cam_reduce`) of ops/kernels/seg_kernel.
The coupling W (6,3,K,P) and the explicit reduced camera system with its
dense Cholesky (solver="chol") are plain torch: no Pallas kernel computed
them. The landmark-sharded form (`axis_name`, `_psum`) is not ported.

`optimize` is branch-free like the JAX scan: the LM accept/reject selects
with `torch.where`, so an LM iteration never waits for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie
from ..ops.kernels import seg_kernel

HUBER_DELTA = 2.4477  # sqrt(5.991), reference LocalBA.py:82


class BAProblem(NamedTuple):
    """A fixed-shape bundle-adjustment problem in point-major planar layout
    (the fields and layouts of the JAX package's BAProblem)."""

    R: torch.Tensor  # (K,3,3) world->camera rotations
    t: torch.Tensor  # (K,3) world->camera translations
    X: torch.Tensor  # (P,3) landmarks (compacted; padding rows are zero)
    pt_valid: torch.Tensor  # (P,) float32 1.0 for real landmarks
    cam: torch.Tensor  # (N,) int32 camera index per slot, N = P*Q
    uv: torch.Tensor  # (2,N) measured pixels (planar)
    w: torch.Tensor  # (N,) slot weights (0 = empty slot)
    intr: torch.Tensor  # (4,) fx fy cx cy
    cam_fixed: torch.Tensor  # (K,) bool, poses held constant (gauge)
    se_i: torch.Tensor  # (E,) int32 scale-edge first keyframe
    se_j: torch.Tensor  # (E,) int32 scale-edge second keyframe
    se_meas: torch.Tensor  # (E,) measured ||t_rel||
    se_w: torch.Tensor  # (E,) scale-edge weights (0 = padding)
    dinv: torch.Tensor  # (N,) measured inverse depth per slot (0 = none)
    dw: torch.Tensor  # (N,) depth-residual weights (0 = no constraint)


class BAMeta(NamedTuple):
    """Host-side mapping from packed slots back to the caller's indexing."""

    slot_obs: np.ndarray  # (N,) original observation row per slot, -1 = empty
    pt_ids: np.ndarray  # (P,) original landmark index per packed row, -1 = pad


def _bucket(n: int, floor: int) -> int:
    q = floor
    while q < n:
        q *= 2
    return q


def _plan_layout(pnt, w, min_p=64, min_q=8):
    """Group valid observations by landmark, bucket P and Q to powers of two,
    and give each observation row its planar slot. Returns
    (rows, slot, used, P, Q)."""
    pnt = np.asarray(pnt)
    w = np.asarray(w, np.float32)
    valid = np.where(w > 0)[0]
    vp = pnt[valid]
    used = np.unique(vp)  # sorted original landmark ids with >=1 valid obs
    P = _bucket(max(len(used), 1), min_p)
    counts = np.bincount(np.searchsorted(used, vp), minlength=max(len(used), 1))
    Q = _bucket(int(counts.max()) if counts.size else 1, min_q)
    order = np.argsort(vp, kind="stable")
    rows = valid[order]
    dense_p = np.searchsorted(used, vp[order])
    first = np.searchsorted(dense_p, np.arange(len(used)), side="left")
    slot = (dense_p * Q + (np.arange(len(rows)) - first[dense_p])).astype(np.int32)
    return rows, slot, used, P, Q


def pack_planar(cam, pnt, uv, w, min_p=64, min_q=8):
    """Group O-indexed observations by landmark into the (P, Q) slot layout,
    on the host. Returns (cam_s, uv_s, w_s, pt_valid, pt_ids, meta)."""
    cam = np.asarray(cam)
    uv = np.asarray(uv, np.float32)
    w = np.asarray(w, np.float32)
    rows, slot, used, P, Q = _plan_layout(pnt, w, min_p=min_p, min_q=min_q)
    N = P * Q
    cam_s = np.zeros(N, np.int32)
    uv_s = np.zeros((2, N), np.float32)
    w_s = np.zeros(N, np.float32)
    slot_obs = np.full(N, -1, np.int64)
    cam_s[slot] = cam[rows]
    uv_s[0, slot] = uv[rows, 0]
    uv_s[1, slot] = uv[rows, 1]
    w_s[slot] = w[rows]
    slot_obs[slot] = rows
    pt_ids = np.full(P, -1, np.int64)
    pt_ids[: len(used)] = used
    pt_valid = np.zeros(P, np.float32)
    pt_valid[: len(used)] = 1.0
    return cam_s, uv_s, w_s, pt_valid, pt_ids, BAMeta(slot_obs, pt_ids)


def make_problem(R, t, X, cam, pnt, uv, w, intr, cam_fixed,
                 se_i=None, se_j=None, se_meas=None, se_w=None,
                 min_p=64, min_q=8, depth=None, depth_weight=1.0, device="cuda"):
    """Build a planar BAProblem on `device` from O-indexed observation arrays.

    X is given in the caller's landmark indexing and compacted to the packed
    rows. `depth` (O,) is an optional measured metric depth per observation
    (<= 0 or NaN = none); it becomes the inverse-depth planes (dinv, dw) that
    `optimize(..., use_depth=True)` reads. Only the live observation rows
    travel to the device, where an index write places them in the (N,)
    planes. Returns (problem, meta).
    """
    R = np.asarray(R, np.float32)
    cam = np.asarray(cam)
    uv = np.asarray(uv, np.float32)
    w = np.asarray(w, np.float32)
    rows, slot, used, P, Q = _plan_layout(pnt, w, min_p=min_p, min_q=min_q)
    N = P * Q
    dinv_rows = np.zeros(len(rows), np.float32)
    dw_rows = np.zeros(len(rows), np.float32)
    if depth is not None and depth_weight > 0:
        dvals = np.asarray(depth, np.float32)[rows]
        has_d = np.isfinite(dvals) & (dvals > 1e-3)
        dinv_rows[has_d] = 1.0 / dvals[has_d]
        dw_rows[has_d] = depth_weight

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    slot_t = dev(slot.astype(np.int64))

    def plane(rows_np, dtype):
        out = torch.zeros(N, dtype=dtype, device=device)
        out[slot_t] = dev(rows_np)
        return out

    uvN = torch.zeros((N, 2), dtype=torch.float32, device=device)
    uvN[slot_t] = dev(uv[rows])
    slot_obs = np.full(N, -1, np.int64)
    slot_obs[slot] = rows
    pt_ids = np.full(P, -1, np.int64)
    pt_ids[: len(used)] = used
    pt_valid = np.zeros(P, np.float32)
    pt_valid[: len(used)] = 1.0
    X = np.asarray(X, np.float32)
    Xp = np.zeros((P, 3), np.float32)
    real = pt_ids >= 0
    Xp[real] = X[pt_ids[real]]
    if se_i is None:
        se_i = np.zeros(1, np.int32)
        se_j = np.zeros(1, np.int32)
        se_meas = np.zeros(1, np.float32)
        se_w = np.zeros(1, np.float32)
    prob = BAProblem(
        R=dev(R),
        t=dev(np.asarray(t, np.float32)),
        X=dev(Xp),
        pt_valid=dev(pt_valid),
        cam=plane(cam[rows].astype(np.int32), torch.int32),
        uv=uvN.T.contiguous(),
        w=plane(w[rows], torch.float32),
        intr=dev(np.asarray(intr, np.float32)),
        cam_fixed=dev(np.asarray(cam_fixed, bool)),
        se_i=dev(np.asarray(se_i, np.int32)),
        se_j=dev(np.asarray(se_j, np.int32)),
        se_meas=dev(np.asarray(se_meas, np.float32)),
        se_w=dev(np.asarray(se_w, np.float32)),
        dinv=plane(dinv_rows, torch.float32),
        dw=plane(dw_rows, torch.float32),
    )
    return prob, BAMeta(slot_obs, pt_ids)


def cam_rows(p: BAProblem) -> torch.Tensor:
    """(12,K) camera table: rotation entries R[i,j] at row 3i+j, then t."""
    K = p.R.shape[0]
    return torch.cat([p.R.reshape(K, 9).T, p.t.T], dim=0).contiguous()


def point_expand(d_t: torch.Tensor, N: int) -> torch.Tensor:
    """(C,P) -> (C,N), each landmark's value repeated over its Q slots."""
    C, P = d_t.shape
    return d_t[:, :, None].expand(C, P, N // P).reshape(C, N)


def _project_planar(p: BAProblem):
    """Predicted pixels and the per-slot geometry planes every stage shares:
    (r (2,N), Xc (3,N), Rg (3,3,N), iz (N,), w_irls (N,))."""
    N = p.cam.shape[0]
    fx, fy, cx, cy = p.intr[0], p.intr[1], p.intr[2], p.intr[3]
    Rtn = seg_kernel.cam_expand(cam_rows(p), p.cam)  # B5: R[cam], t[cam]
    Rg = Rtn[:9].reshape(3, 3, N)
    tg = Rtn[9:12]
    Xg = point_expand(p.X.T, N)  # X[pnt] is a broadcast
    Xc = (Rg * Xg[None]).sum(1) + tg  # (3,N)
    z = Xc[2]
    z_safe = torch.where(torch.abs(z) > 1e-8, z, 1e-8)
    iz = 1.0 / z_safe
    pred = torch.stack([fx * Xc[0] * iz + cx, fy * Xc[1] * iz + cy])
    r = pred - p.uv
    rn = torch.sqrt(torch.sum(r * r, dim=0) + 1e-12)
    w_rob = torch.where(rn <= HUBER_DELTA, 1.0, HUBER_DELTA / rn)
    w_irls = p.w * w_rob * (z > 1e-6)
    return r, Xc, Rg, iz, w_irls


def _jacobians_planar(Xc, Rg, iz, intr):
    """Jc (2,6,N) d r / d(camera se3, left-composed), Jp (2,3,N) d r / d X:
    products of J_proj = [[a,0,b],[0,c,d]] with [-hat(Xc) | I] and R_cw."""
    fx, fy = intr[0], intr[1]
    x, y, z = Xc[0], Xc[1], Xc[2]
    a = fx * iz
    b = -fx * x * iz * iz
    c = fy * iz
    d = -fy * y * iz * iz
    zero = torch.zeros_like(a)
    Jc = torch.stack([
        torch.stack([b * y, a * z - b * x, -a * y, a, zero, b]),
        torch.stack([-c * z + d * y, -d * x, c * x, zero, c, d]),
    ])
    J_proj = torch.stack([torch.stack([a, zero, b]), torch.stack([zero, c, d])])
    Jp = (J_proj[:, :, None, :] * Rg[None]).sum(1)  # (2,3,N)
    return Jc, Jp


def _depth_terms(p: BAProblem, Xc, Rg, iz):
    """Inverse-depth residual planes (RGB-D mode): r_d = fx (1/z - 1/z_meas),
    a pseudo-disparity in pixel-like units. Returns (r_d (N,), Jd_c (6,N),
    Jd_p (3,N), wd (N,)), wd robust- and validity-weighted."""
    fx = p.intr[0]
    r_d = fx * (iz - p.dinv)
    s = -fx * iz * iz  # d r_d / d z
    x, y = Xc[0], Xc[1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    Jd_c = s * torch.stack([y, -x, zero, zero, zero, one])
    Jd_p = s * Rg[2]  # d z / d X_w = third row of R_cw
    rn = torch.abs(r_d)
    w_rob = torch.where(rn <= HUBER_DELTA, 1.0, HUBER_DELTA / torch.clamp(rn, min=1e-12))
    wd = p.dw * w_rob * (Xc[2] > 1e-6) * (p.dinv > 0)
    return r_d, Jd_c, Jd_p, wd


def _scale_edge_terms(p: BAProblem):
    """Closed-form scale-edge residuals and Jacobians (ops/lie.py)."""
    return lie.scale_edge_terms(p.R, p.t, p.se_i, p.se_j, p.se_meas)


def huber_rho(rn2: torch.Tensor) -> torch.Tensor:
    """Huber cost of squared residual norms."""
    rn = torch.sqrt(rn2 + 1e-12)
    return torch.where(rn <= HUBER_DELTA, rn2, 2.0 * HUBER_DELTA * rn - HUBER_DELTA**2)


def scale_edge_cost(p: BAProblem) -> torch.Tensor:
    r_s, _, _ = _scale_edge_terms(p)
    return torch.sum(p.se_w * r_s * r_s)


def _cost(p: BAProblem, use_depth: bool = False) -> torch.Tensor:
    """Robust (Huber) total cost, a 0-d tensor."""
    r, Xc, Rg, iz, _ = _project_planar(p)
    zmask = (Xc[2] > 1e-6).to(p.w.dtype)
    cost = torch.sum(p.w * zmask * huber_rho(torch.sum(r * r, dim=0)))
    if use_depth:
        r_d, _, _, _ = _depth_terms(p, Xc, Rg, iz)
        rd_abs = torch.abs(r_d)
        rho_d = torch.where(
            rd_abs <= HUBER_DELTA, r_d * r_d, 2.0 * HUBER_DELTA * rd_abs - HUBER_DELTA**2
        )
        cost = cost + torch.sum(p.dw * zmask * (p.dinv > 0) * rho_d)
    return cost + scale_edge_cost(p)


def reproj_errors(p: BAProblem):
    """Per-slot reprojection error norms and weights: (err (N,), w (N,))."""
    r, _, _, _, _ = _project_planar(p)
    return torch.sqrt(torch.sum(r * r, dim=0)), p.w


def _inv3_planar(V: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (3,3,P) planar SPD blocks."""
    a, b, c = V[0, 0], V[0, 1], V[0, 2]
    d, e, f = V[1, 0], V[1, 1], V[1, 2]
    g, h, i = V[2, 0], V[2, 1], V[2, 2]
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
    rows = torch.stack([torch.stack([A, B, C]), torch.stack([D, E, F]), torch.stack([G, H, I])])
    return rows / det


def _coupling(WO: torch.Tensor, cam: torch.Tensor, K: int, P: int) -> torch.Tensor:
    """Per-slot (6,3,N) coupling blocks -> dense (6,3,K,P) W, summed over each
    landmark's slots of one camera (slots of an out-of-range camera drop)."""
    N = WO.shape[-1]
    pt = torch.arange(N, device=WO.device) // (N // P)
    ok = (cam >= 0) & (cam < K)
    idx = torch.where(ok, cam.long() * P + pt, K * P)
    W = torch.zeros((18, K * P + 1), dtype=WO.dtype, device=WO.device)
    W.index_add_(1, idx, WO.reshape(18, N))
    return W[:, : K * P].reshape(6, 3, K, P)


def scale_edge_blocks(p: BAProblem, U: torch.Tensor, g_c: torch.Tensor):
    """Fold the scale edges into U (K,6,6) and g_c (K,6); return them with
    the (E,6,6) cross blocks H_ij."""
    r_s, Ji, Jj = _scale_edge_terms(p)
    wJi = Ji * p.se_w[:, None]
    wJj = Jj * p.se_w[:, None]
    se_i, se_j = p.se_i.long(), p.se_j.long()
    U = U.index_add(0, se_i, wJi[:, :, None] * Ji[:, None, :])
    U = U.index_add(0, se_j, wJj[:, :, None] * Jj[:, None, :])
    H_ij = wJi[:, :, None] * Jj[:, None, :]
    g_c = g_c.index_add(0, se_i, wJi * r_s[:, None])
    g_c = g_c.index_add(0, se_j, wJj * r_s[:, None])
    return U, g_c, H_ij


def _build_planar(p: BAProblem, lm_lambda, plan, use_depth: bool = False):
    """All Hessian pieces in one pass over the slot planes: U (K,6,6) damped
    (scale edges folded in), V_inv (3,3,P), g_c (K,6), g_p (3,P),
    W (6,3,K,P), H_ij (E,6,6), and the (Jc, Jp, w_irls) planes. `plan`:
    B4's reduce plan of p.cam (seg_kernel.reduce_plan), built once per
    problem by the caller; a CPU problem never reads it (None will do)."""
    K = p.R.shape[0]
    P = p.X.shape[0]
    N = p.cam.shape[0]
    Q = N // P
    r, Xc, Rg, iz, w_irls = _project_planar(p)
    Jc, Jp = _jacobians_planar(Xc, Rg, iz, p.intr)
    wJc = Jc * w_irls
    wJp = Jp * w_irls
    UO = (wJc[:, :, None] * Jc[:, None]).sum(0)  # (6,6,N)
    gcn = (wJc * r[:, None]).sum(0)  # (6,N)
    VO = (wJp[:, :, None] * Jp[:, None]).sum(0)  # (3,3,N)
    gpn = (wJp * r[:, None]).sum(0)  # (3,N)
    WO = (wJc[:, :, None] * Jp[:, None]).sum(0)  # (6,3,N)
    if use_depth:
        r_d, Jd_c, Jd_p, wd = _depth_terms(p, Xc, Rg, iz)
        wJd_c = Jd_c * wd
        wJd_p = Jd_p * wd
        UO = UO + wJd_c[:, None, :] * Jd_c[None, :, :]
        gcn = gcn + wJd_c * r_d
        VO = VO + wJd_p[:, None, :] * Jd_p[None, :, :]
        gpn = gpn + wJd_p * r_d
        WO = WO + wJd_c[:, None, :] * Jd_p[None, :, :]
    # B4: the 36 U entries and 6 gradient rows in one (42,N) -> (42,K) reduce.
    red = seg_kernel.cam_reduce(torch.cat([UO.reshape(36, N), gcn]), p.cam, K, plan)
    U = red[:36].T.reshape(K, 6, 6)
    g_c = red[36:42].T
    V = VO.reshape(3, 3, P, Q).sum(-1)
    g_p = gpn.reshape(3, P, Q).sum(-1)
    W = _coupling(WO, p.cam, K, P)
    U, g_c, H_ij = scale_edge_blocks(p, U, g_c)
    U = U + lm_lambda * torch.eye(6, dtype=U.dtype, device=U.device)[None]
    V = V + lm_lambda * torch.eye(3, dtype=V.dtype, device=V.device)[:, :, None]
    return U, _inv3_planar(V), g_c, g_p, W, H_ij, (Jc, Jp, w_irls)


def _mask_cam(x: torch.Tensor, cam_fixed: torch.Tensor) -> torch.Tensor:
    """Zero the 6-blocks of fixed cameras (gauge fixing, vertex.set_fixed)."""
    return x * (~cam_fixed)[:, None].to(x.dtype)


def _solve_chol(p, U, V_inv, g_c, g_p, W, H_ij):
    """Explicit reduced camera system S = U - W V^-1 W^T, (K,6,K,6), and a
    dense Cholesky solve (the online path, K up to ~128)."""
    K = U.shape[0]
    Y = torch.einsum("dcp,ackp->dakp", V_inv, W)  # (3,6,K,P)
    S_red = torch.einsum("ackp,cblp->kalb", W, Y)  # (K,6,K,6)
    Vg = torch.einsum("dcp,cp->dp", V_inv, g_p)
    b_sub = torch.einsum("ackp,cp->ka", W, Vg)
    eyeK = torch.eye(K, dtype=U.dtype, device=U.device)
    S = U[:, :, None, :] * eyeK[:, None, :, None] - S_red
    # Scale-edge cross blocks into S[i,:,j,:] and their transposes, on the
    # (K,K,6,6) block view.
    Sb = S.permute(0, 2, 1, 3).contiguous()
    se_i, se_j = p.se_i.long(), p.se_j.long()
    Sb = Sb.index_put((se_i, se_j), H_ij, accumulate=True)
    Sb = Sb.index_put((se_j, se_i), H_ij.transpose(-1, -2), accumulate=True)
    S = Sb.permute(0, 2, 1, 3)
    b = -(g_c - b_sub)
    # Gauge: zero fixed cameras' rows and columns, identity diagonal blocks.
    m = (~p.cam_fixed).to(U.dtype)
    S = S * m[:, None, None, None] * m[None, None, :, None]
    fix = 1.0 - m
    fix_blocks = fix[:, None, None] * torch.eye(6, dtype=U.dtype, device=U.device)[None]
    S = S + fix_blocks[:, :, None, :] * eyeK[:, None, :, None]
    b = b * m[:, None]
    D = 6 * K
    L, _ = torch.linalg.cholesky_ex(S.reshape(D, D))
    delta_c = torch.cholesky_solve(b.reshape(D, 1), L).reshape(K, 6)
    return _mask_cam(delta_c, p.cam_fixed)


def _schur_matvec_planar(x, p, U, V_inv, W, H_ij):
    """y = S x applied implicitly (solver="cg"): one W contraction each way."""
    x = _mask_cam(x, p.cam_fixed)
    y = torch.einsum("kij,kj->ki", U, x)
    bp = torch.einsum("ackp,ka->cp", W, x)
    cp = torch.einsum("dcp,cp->dp", V_inv, bp)
    y = y - torch.einsum("ackp,cp->ka", W, cp)
    y = add_cross_blocks(y, x, p, H_ij)
    return _mask_cam(y, p.cam_fixed)


def add_cross_blocks(y, x, p: BAProblem, H_ij):
    """y += the scale edges' off-diagonal blocks applied to x."""
    se_i, se_j = p.se_i.long(), p.se_j.long()
    y = y.index_add(0, se_i, torch.einsum("ekl,el->ek", H_ij, x[se_j]))
    return y.index_add(0, se_j, torch.einsum("elk,el->ek", H_ij, x[se_i]))


def _inv6(M: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 inverse, solved against the identity (no device sync)."""
    eye = torch.eye(6, dtype=M.dtype, device=M.device).expand(M.shape)
    return torch.linalg.solve_ex(M, eye)[0]


def _pcg(matvec, precond, b, n_iters: int):
    """Preconditioned conjugate gradients, a fixed number of iterations,
    with no host read."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    pk = z
    for _ in range(n_iters):
        Ap = matvec(pk)
        rz = torch.sum(r * z)
        denom = torch.sum(pk * Ap)
        alpha = rz / torch.where(torch.abs(denom) > 1e-20, denom, 1e-20)
        x = x + alpha * pk
        r = r - alpha * Ap
        z = precond(r)
        beta = torch.sum(r * z) / torch.where(torch.abs(rz) > 1e-20, rz, 1e-20)
        pk = z + beta * pk
    return x


def _solve_cg(p, U, V_inv, g_c, g_p, W, H_ij, cg_iters):
    Vg = torch.einsum("dcp,cp->dp", V_inv, g_p)
    b_sub = torch.einsum("ackp,cp->ka", W, Vg)
    b = _mask_cam(-(g_c - b_sub), p.cam_fixed)
    U_inv = _inv6(U)

    def matvec(x):
        return _schur_matvec_planar(x, p, U, V_inv, W, H_ij)

    def precond(x):
        return _mask_cam(torch.einsum("kij,kj->ki", U_inv, x), p.cam_fixed)

    return _pcg(matvec, precond, b, cg_iters)


def _solve_delta(p: BAProblem, lm_lambda, cg_iters, points_fixed, plan, solver="chol",
                 use_depth: bool = False):
    """One damped normal-equation solve: (delta_c (K,6), delta_p (P,3))."""
    U, V_inv, g_c, g_p, W, H_ij, _ = _build_planar(p, lm_lambda, plan, use_depth=use_depth)
    g_c = _mask_cam(g_c, p.cam_fixed)
    if points_fixed:
        delta_c = -torch.einsum("kij,kj->ki", _inv6(U), g_c)
        return _mask_cam(delta_c, p.cam_fixed), torch.zeros_like(p.X)
    if solver == "chol":
        delta_c = _solve_chol(p, U, V_inv, g_c, g_p, W, H_ij)
    else:
        delta_c = _solve_cg(p, U, V_inv, g_c, g_p, W, H_ij, cg_iters)
    # Back-substitute landmarks: delta_p = -V^-1 (g_p + W^T delta_c).
    back = torch.einsum("ackp,ka->cp", W, delta_c)
    dp = -torch.einsum("dcp,cp->dp", V_inv, g_p + back)
    return delta_c, dp.T


def _apply(p: BAProblem, delta_c, delta_p) -> BAProblem:
    dR, dt = lie.se3_exp(delta_c)
    R_new = dR @ p.R
    t_new = torch.einsum("kij,kj->ki", dR, p.t) + dt
    return p._replace(R=R_new, t=t_new, X=p.X + delta_p)


def lm_loop(p: BAProblem, n_iters: int, init_lambda: float, solve, cost_fn):
    """The LM accept/reject loop both solvers share, branch-free: a worse
    candidate is dropped with torch.where and the damping grows 4x; a better
    one is kept and the damping halves. Returns (problem, cost)."""
    cost = cost_fn(p)
    lam = torch.full((), init_lambda, dtype=p.R.dtype, device=p.R.device)  # no host copy
    for _ in range(n_iters):
        delta_c, delta_p = solve(p, lam)
        cand = _apply(p, delta_c, delta_p)
        new_cost = cost_fn(cand)
        improved = new_cost < cost
        p = p._replace(
            R=torch.where(improved, cand.R, p.R),
            t=torch.where(improved, cand.t, p.t),
            X=torch.where(improved, cand.X, p.X),
        )
        cost = torch.where(improved, new_cost, cost)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-8, 1e2)
    return p, cost


def optimize(p: BAProblem, n_iters: int = 10, cg_iters: int = 12,
             points_fixed: bool = False, init_lambda: float = 1e-4,
             solver: str = "chol", use_depth: bool = False):
    """Levenberg-Marquardt (optimizer.optimize(10), LocalBA.py:39-42) on a
    fixed iteration count. Returns (optimized problem, final cost).

    solver: "chol" (explicit reduced system, dense Cholesky) or "cg"
    (implicit Schur matvec, block-Jacobi PCG of `cg_iters` steps). The
    camera index is fixed, so one B4 reduce plan serves every iteration."""
    if solver not in ("chol", "cg"):
        raise ValueError(f"solver must be 'chol' or 'cg', not {solver!r}")
    plan = seg_kernel.reduce_plan(p.cam, p.R.shape[0])
    return lm_loop(
        p, n_iters, init_lambda,
        lambda q, lam: _solve_delta(q, lam, cg_iters, points_fixed, plan, solver, use_depth),
        lambda q: _cost(q, use_depth),
    )


def median_depth_normalize(p: BAProblem, point_valid=None) -> BAProblem:
    """Monocular gauge fix: divide translations and landmarks by the median
    landmark norm (reference LocalBA.py:179-190)."""
    if point_valid is None:
        point_valid = p.pt_valid > 0
    norms = torch.linalg.norm(p.X, dim=-1)
    n_valid = torch.clamp(torch.sum(point_valid), min=1)
    sorted_norms = torch.sort(torch.where(point_valid, norms, torch.inf)).values
    med = sorted_norms.index_select(0, ((n_valid - 1) // 2).reshape(1))[0]  # no host read
    scale = torch.where((med > 1e-8) & torch.isfinite(med), med, 1.0)
    return p._replace(t=p.t / scale, X=p.X / scale)
