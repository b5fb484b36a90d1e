"""Parity of the port's homography path (ops/homography.py) and of
homography-vs-essential model selection (twoview.estimate_relative_pose_auto,
init_step(model_selection=True), the monocular Slam with
use_model_selection) with the JAX package on the CPU.

Every case of tests/test_homography.py runs on the same scene through both
packages. RANSAC gets the JAX package's minimal sets, drawn from its key.
Stated tolerances: H, R and t agree to HOMOG_ATOL / POSE_ATOL (float32
eigh and SVD in two LAPACK builds); points to POINT_RTOL of their range, as
in tests/test_torch_twoview.py; inlier masks, counts and the chosen model
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_homography import INTR, planar_scene
from test_torch_slam import (CENTRE_ATOL, CENTRE_ATOL_BA, HALF_INTR, MONO_FRAMES, MONO_STRIDE,
                             _centres, _configs, _kf_frames, _run)
from torch_parity import n, t

from visual_slam_tpu.ops import homography as jhomog, ransac as jransac, twoview as jtwoview
from visual_slam_tpu.ops import lie as jlie
from visual_slam_tpu.pipeline import Slam as JSlam

from visual_slam_tpu_torch.ops import homography, ransac, twoview
from visual_slam_tpu_torch.pipeline import Slam
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

HOMOG_ATOL = 1e-5  # H scaled to H[2,2] = 1
POSE_ATOL = 1e-4
POINT_RTOL = 2e-4


def _close_points(got, want, rtol=POINT_RTOL):
    err = np.linalg.norm(got - want, axis=-1)
    assert np.all(err <= rtol * np.maximum(np.linalg.norm(want, axis=-1), 1.0)), err.max()


def _pose_outputs_match(got, want):
    """(R, t, X1, good, frac): R and t to POSE_ATOL, the mask and the valid
    fraction exactly, the points of the mask to POINT_RTOL."""
    R, t_, X1, good, frac = (n(a) for a in got)
    Rj, tj, Xj, gj, fj = (np.asarray(a) for a in want)
    np.testing.assert_allclose(R, Rj, atol=POSE_ATOL)
    np.testing.assert_allclose(t_, tj, atol=POSE_ATOL)
    np.testing.assert_array_equal(good, gj)
    assert float(frac) == float(fj)
    _close_points(X1[gj], Xj[gj])


def test_dlt_homography_matches_jax(rng):
    """test_dlt_homography_exact: the DLT fit of a planar scene, against
    the JAX package's and the truth R + t n^T / d."""
    X, xn1, xn2, R, t_ = planar_scene(rng)
    Hj = np.asarray(jhomog.dlt_homography(jnp.asarray(xn1), jnp.asarray(xn2)))
    H = homography.dlt_homography(t(xn1), t(xn2))
    np.testing.assert_allclose(n(H), Hj, atol=HOMOG_ATOL)
    assert float(homography.symmetric_transfer_error_sq(H, t(xn1), t(xn2)).max()) < 1e-8
    H_gt = R + np.outer(t_, [0, 0, 1]) / 4.0
    np.testing.assert_allclose(n(H) / n(H)[2, 2], H_gt / H_gt[2, 2], atol=1e-3)


def test_homography_ransac_matches_jax(rng):
    """test_homography_ransac_outliers: 80 of 300 points replaced by
    outliers, the same 512 minimal sets on both sides; H, the inlier mask
    and its count agree, and the outliers stay out."""
    X, xn1, xn2, R, t_ = planar_scene(rng, n=300, noise=0.3)
    xn2_bad = xn2.copy()
    xn2_bad[:80] = rng.uniform(-0.5, 0.5, (80, 2)).astype(np.float32)
    th = 3.0 / INTR[0]
    key, mask = jax.random.PRNGKey(0), np.ones(300, bool)
    Hj, inl_j, n_j = jhomog.estimate_homography_ransac(
        key, jnp.asarray(xn1), jnp.asarray(xn2_bad), jnp.asarray(mask), threshold=th)
    idx = np.asarray(jransac.sample_minimal_sets(key, 512, 4, 300, jnp.asarray(mask)))
    H, inl, n_in = homography.estimate_homography_ransac(
        t(xn1), t(xn2_bad), t(mask), th, idx=t(idx, torch.int64))
    np.testing.assert_allclose(n(H), np.asarray(Hj), atol=HOMOG_ATOL)
    np.testing.assert_array_equal(n(inl), np.asarray(inl_j))
    assert int(n_in) == int(n_j)
    assert n(inl)[:80].mean() < 0.15 and n(inl)[80:].mean() > 0.85


def test_recover_pose_homography_matches_jax(rng):
    """test_recover_pose_homography: the cheirality vote over the 8
    decompositions of the same H picks the same candidate."""
    X, xn1, xn2, R, t_ = planar_scene(rng, n=150)
    H = np.asarray(jhomog.dlt_homography(jnp.asarray(xn1), jnp.asarray(xn2)))
    want = jhomog.recover_pose_homography(jnp.asarray(H), jnp.asarray(xn1), jnp.asarray(xn2),
                                          jnp.ones(150, bool))
    got = homography.recover_pose_homography(t(H), t(xn1), t(xn2), torch.ones(150, dtype=torch.bool))
    _pose_outputs_match(got, want)
    assert float(got[4]) > 0.95
    np.testing.assert_allclose(n(got[0]), R, atol=5e-3)
    assert abs(np.dot(n(got[1]), t_ / np.linalg.norm(t_))) > 0.995


def test_decompose_matches_jax_and_cv2(rng):
    """test_decompose_matches_cv2: the 8 candidates equal the JAX package's,
    in its order, and the true rotation is among them as among cv2's."""
    cv2 = pytest.importorskip("cv2")
    X, xn1, xn2, R, t_ = planar_scene(rng, n=100)
    H = np.asarray(jhomog.dlt_homography(jnp.asarray(xn1), jnp.asarray(xn2)))
    _, Rs_cv, _, _ = cv2.decomposeHomographyMat(H.astype(np.float64), np.eye(3))
    want = jhomog.decompose_homography(jnp.asarray(H))
    got = homography.decompose_homography(t(H))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=POSE_ATOL)
    assert min(float(np.abs(n(got[0])[k] - R).max()) for k in range(8)) < 5e-3
    assert min(float(np.abs(np.asarray(r) - R).max()) for r in Rs_cv) < 5e-3


def _scene_pixels(rng, planar: bool, n_pts=300, noise_px=0.3):
    """Two views of 300 points with 0.3 px noise, in pixels: on the plane
    z = 4 of planar_scene, or with depths spread over [2, 8] m."""
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                  np.full(n_pts, 4.0) if planar else rng.uniform(2.0, 8.0, n_pts)], -1)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.08, 0.02], jnp.float32)), np.float64)
    X2 = X @ R.T + np.array([0.4, -0.15, 0.25])
    fx, fy, cx, cy = INTR.astype(np.float64)
    uv = [np.stack([fx * P[:, 0] / P[:, 2] + cx, fy * P[:, 1] / P[:, 2] + cy], -1) for P in (X, X2)]
    return [(u + rng.normal(scale=noise_px, size=u.shape)).astype(np.float32) for u in uv]


@pytest.mark.parametrize("planar", [True, False], ids=["planar", "general"])
def test_relative_pose_auto_matches_jax(rng, planar):
    """estimate_relative_pose_auto with the JAX package's minimal sets (its
    key split into the essential and the homography sets): the same model
    wins (the homography on the plane, the essential matrix off it), and R,
    t, the points and the cheirality mask agree."""
    uv1, uv2 = _scene_pixels(rng, planar)
    mask = np.ones(len(uv1), bool)
    mask[::17] = False
    key = jax.random.PRNGKey(3)
    out_j = jtwoview.estimate_relative_pose_auto(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                                 jnp.asarray(INTR), jnp.asarray(mask))
    kE, kH = jax.random.split(key)
    idx_E = np.asarray(jransac.sample_minimal_sets(kE, 512, 8, len(uv1), jnp.asarray(mask)))
    idx_H = np.asarray(jransac.sample_minimal_sets(kH, 512, 4, len(uv1), jnp.asarray(mask)))
    out = twoview.estimate_relative_pose_auto(t(uv1), t(uv2), t(INTR), t(mask),
                                              idx_E=t(idx_E, torch.int64), idx_H=t(idx_H, torch.int64))
    assert bool(out[5]) == bool(out_j[5]) == planar
    _pose_outputs_match(out[:5], out_j[:5])


def test_relative_pose_auto_draws_essential_sets_first(rng):
    """Without injected sets the generator draws the essential sets, then
    the homography sets: the same as injecting those two draws."""
    uv1, uv2 = _scene_pixels(rng, planar=True)
    mask = torch.ones(len(uv1), dtype=torch.bool)
    g = torch.Generator().manual_seed(5)
    idx_E = ransac.sample_minimal_sets(g, 512, 8, mask)
    idx_H = ransac.sample_minimal_sets(g, 512, 4, mask)
    want = twoview.estimate_relative_pose_auto(t(uv1), t(uv2), t(INTR), mask, idx_E=idx_E, idx_H=idx_H)
    got = twoview.estimate_relative_pose_auto(t(uv1), t(uv2), t(INTR), mask,
                                              generator=torch.Generator().manual_seed(5))
    for a, b in zip(got, want):
        assert torch.equal(a, b)



def test_mono_slam_model_selection_matches_jax():
    """The monocular Slam with use_model_selection on the half-size scene,
    with the frames and bars of tests/test_torch_slam.py's monocular case:
    the same init frame (45; the box room's init pair picks the
    homography), keyframe and BA-apply frames, inlier counts, and camera
    centres within CENTRE_ATOL until the second BA applies and
    CENTRE_ATOL_BA after."""
    scene = SyntheticRGBDScene(MONO_FRAMES, 240, 320, intrinsics=HALF_INTR)
    frames = [(i, scene.render(i)[0], None) for i in range(0, MONO_FRAMES, MONO_STRIDE)]
    jcfg, tcfg = _configs(False)
    jcfg.twoview.use_model_selection = tcfg.twoview.use_model_selection = True
    jslam = JSlam(jcfg)
    try:
        jba = _run(jslam, frames, False)
    finally:
        jslam.close()
    tslam = Slam(tcfg, device="cpu")
    tba = _run(tslam, frames, False)
    assert jslam.stats["init_frame"] == tslam.stats["init_frame"] == 45
    assert tslam.stats["init_model"] == "homography"
    assert _kf_frames(jslam) == _kf_frames(tslam)
    assert tba == jba and tba[-1] >= 5
    assert [f.frame_idx for f in tslam.trajectory] == [f.frame_idx for f in jslam.trajectory]
    assert [f.n_tracked for f in tslam.trajectory] == [f.n_tracked for f in jslam.trajectory]
    second_apply = next(k for k, f in enumerate(tslam.trajectory)
                        if f.frame_idx >= MONO_STRIDE * tba.index(2))
    dc = np.linalg.norm(_centres(tslam.trajectory) - _centres(jslam.trajectory), axis=-1)
    assert dc[:second_apply].max() < CENTRE_ATOL
    assert dc.max() < CENTRE_ATOL_BA
