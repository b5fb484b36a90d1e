"""Two-view relative pose: RANSAC essential matrix + cheirality pose recovery,
and homography-vs-essential model selection (port of
visual_slam_tpu/ops/twoview.py:16-133).

The equivalent of the reference's `estimateEssential` (src/v2/
helper_functions.py:47-70) and `estimateRelativePose` (:164-209) as the
map-initialisation loop calls them (src/v2/main.py:103-114).
"""
from __future__ import annotations

import numpy as np
import torch

from . import epipolar, homography, projection, ransac as ransac_mod


def estimate_essential_ransac(uv1: torch.Tensor, uv2: torch.Tensor, intr: torch.Tensor,
                              mask: torch.Tensor, threshold: float | None = None, *,
                              idx: torch.Tensor | None = None,
                              generator: torch.Generator | None = None,
                              n_hyps: int = 512):
    """RANSAC essential matrix from pixel correspondences.

    ≙ estimateEssential: normalize by K^-1, fit E robustly, score with the
    symmetric epipolar distance at threshold essTh = 3.0/fx (main.py:103).
    The 8-point minimal sets are `idx` (n_hyps, 8) when given, else drawn
    from `generator`. The winner is polished by three rounds of manifold
    Gauss-Newton + inlier reclassification and one last refine.

    Returns (E, inlier_mask, n_inliers).
    """
    if threshold is None:
        threshold = 3.0 / float(intr[0])
    # The squared threshold in float32, as the JAX package computes it.
    th = np.float32(threshold)
    th_sq = float(th * th)
    if idx is None:
        idx = ransac_mod.sample_minimal_sets(generator, n_hyps, 8, mask)
    xn1 = projection.normalize_pixels(uv1, intr)
    xn2 = projection.normalize_pixels(uv2, intr)

    def solver(ix):
        return epipolar.eight_point_essential(xn1[ix], xn2[ix]).reshape(-1, 9)

    def residual(models):
        # Symmetric epipolar distance; the factor 2 matches scoring both images.
        return 0.5 * epipolar.epipolar_distance_sq(models.reshape(-1, 3, 3), xn1[None], xn2[None])

    model, inliers, _, _ = ransac_mod.ransac(idx, solver, residual, mask, th_sq)
    E = model.reshape(3, 3)
    for _ in range(3):
        E = epipolar.refine_essential_gn(E, xn1, xn2, inliers.to(xn1.dtype), n_iters=4)
        inliers = (0.5 * epipolar.epipolar_distance_sq(E, xn1, xn2) < th_sq) & mask
    E = epipolar.refine_essential_gn(E, xn1, xn2, inliers.to(xn1.dtype), n_iters=4)
    return E, inliers, inliers.sum()


def estimate_relative_pose_auto(uv1: torch.Tensor, uv2: torch.Tensor, intr: torch.Tensor,
                                mask: torch.Tensor, h_ratio_threshold: float = 0.45,
                                distance_thresh: float = 50.0, *,
                                idx_E: torch.Tensor | None = None,
                                idx_H: torch.Tensor | None = None,
                                generator: torch.Generator | None = None):
    """Homography-vs-essential model selection two-view pose.

    ≙ the v1 pipeline's model selection (src/v1/slam_test.py:207-218): fit
    both models at threshold 3/fx with 512 hypotheses each, and take the
    homography when its inliers exceed `h_ratio_threshold` of both models'
    (planar or low-parallax scenes), else the essential matrix. The minimal
    sets are `idx_E` (512, 8) and `idx_H` (512, 4) when given; else both
    are drawn from `generator`, the essential sets first (the JAX package
    splits its key into the two instead).

    Returns (R, t, X1, good, valid_fraction, used_homography (0-d bool)).
    """
    th = 3.0 / float(intr[0])
    if idx_E is None:
        idx_E = ransac_mod.sample_minimal_sets(generator, 512, 8, mask)
    if idx_H is None:
        idx_H = ransac_mod.sample_minimal_sets(generator, 512, 4, mask)
    E, inl_E, n_E = estimate_essential_ransac(uv1, uv2, intr, mask, threshold=th, idx=idx_E)
    xn1 = projection.normalize_pixels(uv1, intr)
    xn2 = projection.normalize_pixels(uv2, intr)
    H, inl_H, n_H = homography.estimate_homography_ransac(xn1, xn2, mask, th, idx=idx_H)
    use_H = n_H.to(torch.float32) > h_ratio_threshold * torch.clamp_min(
        (n_H + n_E).to(torch.float32), 1.0)
    pose_E = epipolar.recover_pose(E, xn1, xn2, inl_E, distance_thresh)
    pose_H = homography.recover_pose_homography(H, xn1, xn2, inl_H, distance_thresh)
    R, t, X1, good, frac = (torch.where(use_H, a, b) for a, b in zip(pose_H, pose_E))
    return R, t, X1, good, frac, use_H


def estimate_relative_pose(E: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                           intr: torch.Tensor, inliers: torch.Tensor,
                           distance_thresh: float = 50.0):
    """E + inlier correspondences -> (R, t, X1, good_mask, valid_fraction).

    ≙ estimateRelativePose(..., "Essential") (helper_functions.py:174-195):
    recoverPose with distanceThresh=50; X1 in the cam-1 frame, and the
    fraction of inliers that pass cheirality (gated at 0.9, main.py:113).
    """
    xn1 = projection.normalize_pixels(uv1, intr)
    xn2 = projection.normalize_pixels(uv2, intr)
    return epipolar.recover_pose(E, xn1, xn2, inliers, distance_thresh)
