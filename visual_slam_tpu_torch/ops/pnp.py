"""Perspective-n-Point: batched DLT, Gauss-Newton refinement, RANSAC and the
tiered tracking solver (port of visual_slam_tpu/ops/pnp.py:22-269).

The replacement for `cv2.solvePnPRansac(..., useExtrinsicGuess=True)` as
the reference's tracking loop uses it (src/v2/main.py:191-197). The solved
pose (R_cw, t_cw) is the world->camera transform, OpenCV's (rvec, tvec).
"""
from __future__ import annotations

import torch

from . import lie, linalg as linalg_mod, projection, ransac as ransac_mod


def pnp_dlt(Xw: torch.Tensor, xn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Direct linear transform PnP from >=6 correspondences, batched.

    Args:
      Xw: (...,S,3) world points; xn: (...,S,2) *normalized* image coords.
    Returns:
      (R_cw (...,3,3), t_cw (...,3)); R is projected onto SO(3). Accuracy
      comes from the Gauss-Newton polish; this only seeds RANSAC hypotheses.
    """
    ones = torch.ones_like(Xw[..., :1])
    zeros = torch.zeros_like(torch.cat([Xw, ones], dim=-1))
    Xh = torch.cat([Xw, ones], dim=-1)  # (...,S,4)
    x, y = xn[..., 0:1], xn[..., 1:2]
    rows_u = torch.cat([Xh, zeros, -x * Xh], dim=-1)  # (...,S,12)
    rows_v = torch.cat([zeros, Xh, -y * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (...,2S,12)
    P = linalg_mod.solve_homogeneous(A).reshape(*A.shape[:-2], 3, 4)
    # Sign: the majority of points must have positive depth.
    z = (Xh @ P[..., 2, :, None])[..., 0]
    P = P * torch.sign(torch.sum(torch.sign(z), dim=-1) + 0.5)[..., None, None]
    M = P[..., :3]
    U, s, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (U * D[..., None, :]) @ Vt
    scale = torch.mean(s, dim=-1)
    t = P[..., 3] / torch.where(scale > 1e-12, scale, 1e-12)[..., None]
    return R, t


def reprojection_error_sq(R_cw, t_cw, Xw, uv, intr) -> torch.Tensor:
    """Squared pixel reprojection error (...,N). Points behind the camera -> inf."""
    pred, z = projection.project(R_cw, t_cw, Xw, intr)
    err = torch.sum((pred - uv) ** 2, dim=-1)
    return torch.where(z > 1e-6, err, float("inf"))


def pnp_gauss_newton(R0, t0, Xw, uv, intr, weights, n_iters: int = 10,
                     huber_delta: float = 2.4477):  # sqrt(5.991), ≙ LocalBA.py:82
    """Motion-only Gauss-Newton on the reprojection error.

    The same math as motion-only bundle adjustment with every landmark fixed
    (reference LocalBA.py:195-229) for one camera; the pose is updated by
    left-multiplied se(3) increments. Huber IRLS weights per observation.
    """
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    Xt, uvt = Xw.T, uv.T  # (3,N), (2,N)
    eye6 = 1e-6 * torch.eye(6, dtype=Xw.dtype, device=Xw.device)
    R, t = R0, t0
    for _ in range(n_iters):
        x, y, z0 = R @ Xt + t[:, None]
        z = torch.where(torch.abs(z0) > 1e-8, z0, 1e-8)
        iz = 1.0 / z
        r0 = fx * x * iz + cx - uvt[0]
        r1 = fy * y * iz + cy - uvt[1]
        rn = torch.sqrt(r0 * r0 + r1 * r1 + 1e-12)
        w_rob = torch.where(rn <= huber_delta, 1.0, huber_delta / rn)
        w = weights * w_rob * (z0 > 1e-6)
        a = fx * iz
        b = -fx * x * iz * iz
        c = fy * iz
        d = -fy * y * iz * iz
        zero = torch.zeros_like(a)
        # Jacobian rows for delta = [omega, v] left-composed (dXc = -[Xc]x w + v).
        J0 = torch.stack([b * y, a * z - b * x, -a * y, a, zero, b])  # (6,N)
        J1 = torch.stack([-c * z + d * y, -d * x, c * x, zero, c, d])
        J0w, J1w = J0 * w, J1 * w
        H = J0w @ J0.T + J1w @ J1.T + eye6
        g = J0w @ r0 + J1w @ r1
        delta = -torch.linalg.solve_ex(H, g)[0]  # no error check: no device sync
        dR, dt = lie.se3_exp(delta)
        R, t = dR @ R, dR @ t + dt
    return R, t


def solve_pnp_ransac(Xw, uv, intr, mask, guess_R=None, guess_t=None, *,
                     idx: torch.Tensor | None = None,
                     generator: torch.Generator | None = None,
                     n_hyps: int = 256, threshold_px: float = 8.0,
                     refine_iters: int = 10):
    """Fixed-budget PnP-RANSAC + Gauss-Newton polish.

    ≙ cv2.solvePnPRansac with useExtrinsicGuess=True (src/v2/main.py:
    196-197): the guess pose joins the hypothesis pool. The minimal sets are
    `idx` (n_hyps, 6) when given, else drawn from `generator`.

    Returns (R_cw, t_cw, inlier_mask, n_inliers).
    """
    if idx is None:
        idx = ransac_mod.sample_minimal_sets(generator, n_hyps, 6, mask)
    xn = projection.normalize_pixels(uv, intr)

    def solver(ix):
        R, t = pnp_dlt(Xw[ix], xn[ix])
        return torch.cat([R.reshape(-1, 9), t], dim=-1)

    def residual(models):
        R = models[:, :9].reshape(-1, 3, 3)
        t = models[:, 9:]
        return reprojection_error_sq(R, t, Xw[None], uv[None], intr)

    extra = None
    if guess_R is not None:
        extra = torch.cat([guess_R.reshape(9), guess_t])[None, :]
    model, inliers, _, _ = ransac_mod.ransac(
        idx, solver, residual, mask, threshold_px**2, extra_models=extra
    )
    R, t = model[:9].reshape(3, 3), model[9:]
    R, t = pnp_gauss_newton(R, t, Xw, uv, intr, inliers.to(Xw.dtype), n_iters=refine_iters)
    # Recompute inliers under the polished pose.
    inliers = (reprojection_error_sq(R, t, Xw, uv, intr) < threshold_px**2) & mask
    return R, t, inliers, inliers.sum()


def refine_from_prior(Xw, uv, intr, mask, guess_R, guess_t, *, threshold_px: float = 8.0,
                      refine_iters: int = 10, min_inliers: int = 25,
                      min_inlier_frac: float = 0.25):
    """solve_pnp_tracked's fast branch, all on the device: gate inliers on
    the raw prior, GN-polish on them, re-gate, polish once more. Returns
    (R_cw, t_cw, inlier_mask, n_inliers, need_ransac), the last a 0-d bool
    tensor that the caller reads."""
    thr_sq = threshold_px**2
    inl_p = (reprojection_error_sq(guess_R, guess_t, Xw, uv, intr) < thr_sq) & mask
    R0, t0 = pnp_gauss_newton(guess_R, guess_t, Xw, uv, intr, inl_p.to(Xw.dtype),
                              n_iters=refine_iters)
    inl0 = (reprojection_error_sq(R0, t0, Xw, uv, intr) < thr_sq) & mask
    R1, t1 = pnp_gauss_newton(R0, t0, Xw, uv, intr, inl0.to(Xw.dtype),
                              n_iters=refine_iters)
    inl1 = (reprojection_error_sq(R1, t1, Xw, uv, intr) < thr_sq) & mask
    n1 = inl1.sum()
    n_cand = torch.clamp_min(mask.sum(), 1)
    need_ransac = (n1 < min_inliers) | (
        n1.to(Xw.dtype) < min_inlier_frac * n_cand.to(Xw.dtype)
    )
    return R1, t1, inl1, n1, need_ransac


def solve_pnp_tracked(Xw, uv, intr, mask, guess_R, guess_t, *,
                      idx: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      n_hyps: int = 128, threshold_px: float = 8.0,
                      refine_iters: int = 10, min_inliers: int = 25,
                      min_inlier_frac: float = 0.25):
    """Tiered PnP for tracking: prior-seeded Gauss-Newton first, full
    batched RANSAC only when the refined pose cannot explain the matches.

    The fast branch is solve_pnp_ransac with the prior as the winning
    hypothesis: gate inliers on the RAW prior (as RANSAC scores its models),
    GN-polish on that inlier set, re-gate, polish once more. The JAX package
    decides the branch on the device (lax.cond); here `need_ransac` is read
    on the host, one device sync per frame.

    Returns (R_cw, t_cw, inlier_mask, n_inliers, used_ransac).
    """
    R1, t1, inl1, n1, need_ransac = refine_from_prior(
        Xw, uv, intr, mask, guess_R, guess_t, threshold_px=threshold_px,
        refine_iters=refine_iters, min_inliers=min_inliers, min_inlier_frac=min_inlier_frac)
    if bool(need_ransac):
        R, t, inl, n = solve_pnp_ransac(
            Xw, uv, intr, mask, guess_R, guess_t, idx=idx, generator=generator,
            n_hyps=n_hyps, threshold_px=threshold_px, refine_iters=refine_iters,
        )
        return R, t, inl, n, True
    return R1, t1, inl1, n1, False
