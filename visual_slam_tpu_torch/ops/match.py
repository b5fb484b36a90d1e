"""Brute-force binary-descriptor matching (port of
visual_slam_tpu/ops/match.py:33-81).

The replacement for `cv2.BFMatcher().knnMatch(k=2)` + Lowe's ratio test in
the reference's FeatureMatcher (src/v2/frame.py:16-49) and for the
mutual-nearest-neighbour variant in src/slam.py:24-57.

For ±1 vectors a, b of length D, a·b = D - 2*hamming(a,b), so the Hamming
matrix is one matmul of the ±1 expansions. Every value is a small integer,
exact in float32, so the output is bit-equal to the JAX package's, tie
rules included.
"""
from __future__ import annotations

import torch

from . import descriptor as desc_mod


def hamming_matrix(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(K1,8),(K2,8) packed int32 -> (K1,K2) float32 Hamming distances."""
    a = desc_mod.unpack_pm1(desc1)
    b = desc_mod.unpack_pm1(desc2)
    return 0.5 * (desc_mod.N_BITS - a @ b.T)


def match_ratio_test(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    ratio: float = 0.8,
    max_distance: float = 96.0,
    cross_check: bool = True,
):
    """knn(k=2) matching with Lowe's ratio test (ratio 0.8 ≙ frame.py:20).

    One candidate match per query keypoint: returns idx2 (K1,) best-match
    index into set 2, dist (K1,) best Hamming distance, and good (K1,) —
    passes the ratio test, the distance gate, validity and (optionally) the
    mutual-nearest-neighbour check.

    Ties: jax.lax.top_k puts the lower index first and jnp.argmin returns
    the first minimum. torch.argmin returns the first minimum too, so the
    top-2 is argmin, then the minimum with that entry masked out (not
    torch.topk, whose order among equals is unspecified).
    """
    D = hamming_matrix(desc1, desc2)  # (K1,K2)
    D = torch.where(valid1[:, None] & valid2[None, :], D, 1e9)
    rows = torch.arange(D.shape[0], device=D.device)
    idx2 = torch.argmin(D, dim=1)
    d1 = D[rows, idx2]
    d2 = D.index_put((rows, idx2), torch.tensor(float("inf"), device=D.device)).amin(dim=1)
    good = (d1 < ratio * d2) & (d1 < max_distance) & valid1
    if cross_check:
        # Mutual NN: our best match's best match must be us.
        best_for_2 = torch.argmin(D, dim=0)  # (K2,)
        good = good & (best_for_2[idx2] == rows)
    return idx2, d1, good
