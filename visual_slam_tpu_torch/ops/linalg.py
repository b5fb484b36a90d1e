"""Homogeneous least squares (port of visual_slam_tpu/ops/linalg.py:16-35)."""
from __future__ import annotations

import torch


def solve_homogeneous(A: torch.Tensor) -> torch.Tensor:
    """argmin_{|x|=1} |A x| for batched A (..., M, N) -> (..., N).

    Rows are normalized to unit length first (equal equation scales, O(1)
    Gram entries), then the eigenvector of the smallest eigenvalue of the
    Gram matrix is taken. Its sign is free: callers fix it.
    """
    rn = torch.linalg.norm(A, dim=-1, keepdim=True)
    A = A / torch.where(rn > 1e-12, rn, 1.0)
    G = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(G)
    return V[..., :, 0]


def solve_weighted_homogeneous(A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """As solve_homogeneous with per-row weights w (..., M): rows are
    normalized first, then weighted."""
    rn = torch.linalg.norm(A, dim=-1, keepdim=True)
    A = A * (w[..., None] / torch.where(rn > 1e-12, rn, 1.0))
    G = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(G)
    return V[..., :, 0]
