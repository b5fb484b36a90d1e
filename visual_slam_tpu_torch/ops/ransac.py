"""Batched-hypothesis RANSAC (port of visual_slam_tpu/ops/ransac.py:22-80).

The replacement for OpenCV's sequential RANSAC in `cv2.solvePnPRansac`
(reference src/v2/main.py:196): a fixed budget of minimal sets is sampled at
once, every model is solved and scored in batched tensor ops, and the MSAC
score (truncated residual) picks the winner.
"""
from __future__ import annotations

from typing import Callable

import torch


def sample_minimal_sets(generator: torch.Generator, n_hyps: int, set_size: int,
                        mask: torch.Tensor) -> torch.Tensor:
    """(n_hyps, set_size) indices of valid data points: Gumbel top-k over
    masked logits (with replacement across hypotheses, without inside a
    set). Draws from `generator`, which lives on mask's device."""
    n_data = mask.shape[0]
    u = torch.rand((n_hyps, n_data), generator=generator, device=mask.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    scores = torch.where(mask[None, :], gumbel, float("-inf"))
    return torch.topk(scores, set_size, dim=-1).indices


def ransac(
    idx: torch.Tensor,
    solver: Callable[[torch.Tensor], torch.Tensor],
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    mask: torch.Tensor,
    threshold_sq: float,
    extra_models: torch.Tensor | None = None,
):
    """Fixed-budget RANSAC over given minimal sets.

    Args:
      idx: (B, set_size) minimal-set indices (sample_minimal_sets, or a
        test's injected index sets).
      solver: (B, set_size) indices -> (B, P) models, batched.
      residual_fn: (B, P) models -> (B, N) squared residuals, batched.
      mask: (N,) validity of data points.
      threshold_sq: inlier threshold on the squared residual.
      extra_models: optional (M, P) models appended to the pool (e.g. the
        extrinsic-guess pose, ≙ useExtrinsicGuess=True in cv2.solvePnPRansac).
    Returns:
      best_model (P,), inlier_mask (N,), best MSAC score, n_inliers.
    """
    models = solver(idx)
    if extra_models is not None:
        models = torch.cat([models, extra_models], dim=0)
    res = residual_fn(models)  # (B, N)
    res = torch.where(mask[None, :], res, float("inf"))
    capped = torch.clamp_max(res, threshold_sq)
    msac = torch.sum(torch.where(mask[None, :], capped, 0.0), dim=-1)  # (B,)
    msac = torch.where(torch.isfinite(msac), msac, float("inf"))  # NaN models
    best = torch.argmin(msac)
    inliers = (res[best] < threshold_sq) & mask
    return models[best], inliers, msac[best], inliers.sum()
