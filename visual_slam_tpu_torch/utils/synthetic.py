"""Synthetic bundle-adjustment problems: the large map of BASELINE.json
config #5 (port of visual_slam_tpu/utils/synthetic.py) and the small arc of
the online-BA tests.

A loop trajectory of K cameras observing P landmarks Q times each, emitted
directly in the packed planar BAProblem layout (point p's Q observation
slots are consecutive). The draws of `np.random.RandomState(seed)` come in
the JAX package's order, so both packages build the same problem from the
same seed; the geometry is NumPy on the host, and the problem is then put
on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.ba import BAProblem, make_problem
from ..ops import lie


def build_loop_map(K: int, P: int, Q: int, seed: int = 0, device="cuda"):
    """Synthetic config-#5 map. Returns (BAProblem on `device`,
    (R_cw, t_cw, X_gt) as NumPy ground truth)."""
    rng = np.random.RandomState(seed)
    # Loop trajectory: cameras on a circle, yawing along it.
    ang = 2 * np.pi * np.arange(K) / K
    radius = 8.0
    t_gt = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang), 0.05 * np.sin(5 * ang)], -1
    ).astype(np.float32)
    # Camera-to-world axes (columns): forward z_cam tangent to the circle.
    yaw = ang + np.pi / 2
    cy, sy = np.cos(yaw), np.sin(yaw)
    zero = np.zeros_like(cy)
    one = np.ones_like(cy)
    x_cam = np.stack([-sy, cy, zero], -1)
    y_cam = np.stack([zero, zero, one], -1)
    z_cam = np.stack([cy, sy, zero], -1)
    R_gt = np.stack([x_cam, y_cam, z_cam], axis=-1).astype(np.float32)
    R_cw = np.transpose(R_gt, (0, 2, 1)).copy()
    t_cw = -np.einsum("kij,kj->ki", R_cw, t_gt).astype(np.float32)
    # Each point is anchored near a camera's frustum and observed by Q
    # cameras strided along the loop (the stride gives triangulation
    # parallax; consecutive cameras are near-identical viewpoints).
    stride = max(1, K // 128)
    base = rng.randint(0, K - Q * stride, P).astype(np.int32)
    C = t_gt[base]
    fwd = np.stack([np.cos(yaw[base]), np.sin(yaw[base]), 0 * yaw[base]], -1)
    X_gt = (C + fwd * rng.uniform(4.0, 9.0, (P, 1)) + rng.normal(0, 0.8, (P, 3))).astype(np.float32)
    cam = (base[:, None] + stride * np.arange(Q)[None, :]).reshape(-1).astype(np.int32)
    intr = np.array([481.2, 480.0, 319.5, 239.5], np.float32)
    Rn = R_cw[cam]
    Xn = np.repeat(X_gt, Q, axis=0)
    Xc = np.einsum("nij,nj->ni", Rn, Xn) + t_cw[cam]
    z = Xc[:, 2]
    uv = np.stack(
        [
            intr[0] * Xc[:, 0] / np.maximum(z, 1e-3) + intr[2],
            intr[1] * Xc[:, 1] / np.maximum(z, 1e-3) + intr[3],
        ],
        -1,
    ).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    w = (z > 0.2).astype(np.float32)  # behind-camera slots are dead weight
    # Perturb the initial estimates.
    dw = rng.normal(0, 0.004, (K, 3)).astype(np.float32)
    dR = lie.so3_exp(torch.from_numpy(dw)).numpy()
    R0 = np.einsum("kij,kjl->kil", dR, R_cw).astype(np.float32)
    t0 = np.einsum("kij,kj->ki", dR, t_cw).astype(np.float32) + rng.normal(
        0, 0.02, (K, 3)
    ).astype(np.float32)
    R0[0], t0[0] = R_cw[0], t_cw[0]
    X0 = X_gt + rng.normal(0, 0.05, X_gt.shape).astype(np.float32)
    cam_fixed = np.zeros(K, bool)
    cam_fixed[0] = True

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    N = len(cam)
    zeros_f = torch.zeros(1, dtype=torch.float32, device=device)
    prob = BAProblem(
        R=dev(R0),
        t=dev(t0),
        X=dev(X0),
        pt_valid=torch.ones(P, dtype=torch.float32, device=device),
        cam=dev(cam),
        uv=dev(uv.T),
        w=dev(w),
        intr=dev(intr),
        cam_fixed=dev(cam_fixed),
        se_i=torch.zeros(1, dtype=torch.int32, device=device),
        se_j=torch.zeros(1, dtype=torch.int32, device=device),
        se_meas=zeros_f,
        se_w=zeros_f.clone(),
        dinv=torch.zeros(N, dtype=torch.float32, device=device),
        dw=torch.zeros(N, dtype=torch.float32, device=device),
    )
    return prob, (R_cw, t_cw, X_gt)


INTR = np.array([481.20, 480.0, 319.5, 239.5], np.float32)  # ICL-NUIM


def arc_problem(K: int = 6, P: int = 300, noise_px: float = 0.0, pose_noise: float = 0.0,
                point_noise: float = 0.0, seed: int = 0, device="cuda"):
    """An online-BA problem: K cameras on an arc (turning 0.04 rad per
    camera) looking at P points, full visibility, built with
    ba.make_problem (port of tests/test_ba.py:synth_problem; the NumPy draws
    of `np.random.default_rng(seed)` come in that helper's order). Camera 0
    is exact and fixed. Returns (BAProblem on `device`, (R_gt, t_gt, X_gt))."""
    rng = np.random.default_rng(seed)
    X = np.stack(
        [rng.uniform(-2, 2, size=P), rng.uniform(-1.5, 1.5, size=P), rng.uniform(4, 8, size=P)],
        axis=-1,
    ).astype(np.float32)

    def rot(w):
        return lie.so3_exp(torch.from_numpy(np.asarray(w, np.float32))).numpy()

    Rs, ts, uvs = [], [], []
    for k in range(K):
        R = rot([0.01 * k, -0.04 * k, 0.015 * k])
        t = np.array([0.25 * k, 0.02 * k, 0.01 * k], dtype=np.float32)
        Rs.append(R)
        ts.append(t)
        Xc = X @ R.T + t
        uv = np.stack([INTR[0] * Xc[:, 0] / Xc[:, 2] + INTR[2],
                       INTR[1] * Xc[:, 1] / Xc[:, 2] + INTR[3]], axis=-1)
        uvs.append(uv + rng.normal(scale=noise_px, size=uv.shape))
    R_gt, t_gt = np.stack(Rs), np.stack(ts)
    R0, t0 = R_gt.copy(), t_gt.copy()
    X0 = X + rng.normal(scale=point_noise, size=X.shape).astype(np.float32)
    for k in range(1, K):
        dw = rng.normal(scale=pose_noise, size=3).astype(np.float32)
        dt = rng.normal(scale=pose_noise, size=3).astype(np.float32)
        dR = rot(dw)
        R0[k] = dR @ R_gt[k]
        t0[k] = dR @ t_gt[k] + dt
    cam_fixed = np.zeros(K, bool)
    cam_fixed[0] = True
    prob, _ = make_problem(
        R=R0, t=t0, X=X0,
        cam=np.repeat(np.arange(K, dtype=np.int32), P),
        pnt=np.tile(np.arange(P, dtype=np.int32), K),
        uv=np.concatenate(uvs).astype(np.float32),
        w=np.ones(K * P, np.float32), intr=INTR, cam_fixed=cam_fixed, device=device,
    )
    return prob, (R_gt, t_gt, X)
