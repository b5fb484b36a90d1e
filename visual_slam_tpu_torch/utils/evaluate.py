"""Trajectory evaluation: Umeyama alignment + ATE RMSE (a NumPy copy of
visual_slam_tpu/utils/evaluate.py, which imports nothing of JAX but sits in
a package whose __init__ does)."""
from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    Args:
      src, dst: (N,3) corresponding point sets.
      with_scale: solve Sim(3) (monocular trajectories) vs SE(3).
    Returns:
      (s, R, t) with dst ≈ s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align_scale: bool = True) -> tuple[float, np.ndarray]:
    """Absolute trajectory error RMSE after Umeyama alignment.

    Args:
      est_positions, gt_positions: (N,3) camera centres, index-aligned.
      align_scale: Sim(3) alignment (monocular, scale-free) vs SE(3).
    Returns:
      (rmse metres, per-frame error array).
    """
    s, R, t = umeyama(est_positions, gt_positions, with_scale=align_scale)
    aligned = (s * (R @ est_positions.T)).T + t
    err = np.linalg.norm(aligned - gt_positions, axis=-1)
    return float(np.sqrt(np.mean(err**2))), err


def positions_from_poses_wc(T_wc: np.ndarray) -> np.ndarray:
    """(N,4,4) cam->world -> (N,3) camera centres."""
    return np.asarray(T_wc)[:, :3, 3]


def positions_from_poses_cw(R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """world->camera (R,t) stacks -> (N,3) camera centres = -R^T t."""
    return -np.einsum("nji,nj->ni", np.asarray(R_cw), np.asarray(t_cw))
