"""Parity of the port's two-view geometry (linalg, projection, lie.make_T,
triangulate, epipolar, twoview) and of the init and mining steps with the
JAX package on the CPU.

E is defined up to sign, and LAPACK, XLA and cuSOLVER may return
eigenvectors and singular vectors of either sign, so essential matrices are
compared up to sign; the voted R and t are sign-free. RANSAC minimal sets are drawn in JAX with the key
its solver uses and injected into the port, as test_torch_match_pnp does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import ICL_INTR, n, t

from visual_slam_tpu.models import frontend as jfrontend
from visual_slam_tpu.ops import epipolar as jepi, lie as jlie, linalg as jlinalg
from visual_slam_tpu.ops import match as jmatch, projection as jproj, ransac as jransac
from visual_slam_tpu.ops import triangulate as jtri, twoview as jtwoview
from visual_slam_tpu.pipeline import _init_step as j_init_step, _unpack_init_blob
from visual_slam_tpu.pipeline import _mine_step as j_mine_step, _unpack_mine_blob

from visual_slam_tpu_torch import convert
from visual_slam_tpu_torch.ops import epipolar, lie, linalg, projection, triangulate, twoview
from visual_slam_tpu_torch.pipeline import init_step, mine_step
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

HALF_INTR = ICL_INTR / 2
POSE_ATOL = 1e-4  # R, t
E_ATOL = 1e-4  # essential matrices up to sign (unit singular values)
# Triangulated points, relative to their norm. The midpoint of two rays ~2
# degrees apart amplifies float32 rounding along the ray: given the same R
# and t, the two packages' midpoints differ by up to 7.6e-5 on the
# init_step pair below.
POINT_RTOL = 2e-4
PARALLAX_ATOL = 1e-3  # degrees
ESS_THRESHOLD = 3.0 / float(HALF_INTR[0])


def _close_E(got, want, atol=E_ATOL):
    """Essential matrices equal up to their free sign."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    sign = np.sign(np.sum(got * want, axis=(-2, -1)))[..., None, None]
    np.testing.assert_allclose(got * sign, want, atol=atol)


def _close_points(got, want, rtol=POINT_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    err = np.linalg.norm(got - want, axis=-1)
    assert np.all(err <= rtol * np.maximum(np.linalg.norm(want, axis=-1), 1.0)), err.max()


def two_views(seed=0, N=300, outlier_frac=0.2, noise_px=0.3):
    """Points 2-6 m in front of camera 1; camera 2 turned ~6 deg and moved
    0.3 m (X2 = R X1 + t). Returns uv1, uv2 (pixels, with noise and
    outliers), R, t, X1 (cam-1 frame), inlier truth."""
    rng = np.random.default_rng(seed)
    X1 = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(2, 6, N)], -1)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.03, -0.1, 0.02], jnp.float32)), np.float64)
    t_ = np.array([0.3, 0.02, -0.05])
    X2 = X1 @ R.T + t_
    fx, fy, cx, cy = ICL_INTR
    uv1 = np.stack([fx * X1[:, 0] / X1[:, 2] + cx, fy * X1[:, 1] / X1[:, 2] + cy], -1)
    uv2 = np.stack([fx * X2[:, 0] / X2[:, 2] + cx, fy * X2[:, 1] / X2[:, 2] + cy], -1)
    uv1 += rng.normal(scale=noise_px, size=uv1.shape)
    uv2 += rng.normal(scale=noise_px, size=uv2.shape)
    out = rng.uniform(size=N) < outlier_frac
    uv2[out] = rng.uniform([0, 0], [640, 480], (int(out.sum()), 2))
    f32 = lambda a: a.astype(np.float32)
    return f32(uv1), f32(uv2), f32(R), f32(t_ / np.linalg.norm(t_)), f32(X1), ~out


@pytest.fixture(scope="module")
def views():
    uv1, uv2, R, t_, X1, inl = two_views()
    xn1 = np.asarray(jproj.normalize_pixels(jnp.asarray(uv1), jnp.asarray(ICL_INTR)))
    xn2 = np.asarray(jproj.normalize_pixels(jnp.asarray(uv2), jnp.asarray(ICL_INTR)))
    return dict(uv1=uv1, uv2=uv2, R=R, t=t_, X1=X1, inl=inl, xn1=xn1, xn2=xn2)


# ------------------------------------------------------------- small pieces


def test_solve_weighted_homogeneous_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 12, 9)).astype(np.float32)
    w = rng.uniform(0, 2, (5, 12)).astype(np.float32)
    w[:, :2] = 0.0
    want = np.asarray(jlinalg.solve_weighted_homogeneous(jnp.asarray(A), jnp.asarray(w)))
    got = n(linalg.solve_weighted_homogeneous(t(A), t(w)))
    got *= np.sign(np.sum(got * want, -1))[:, None]  # eigenvector sign is free
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_projection_matrix_and_make_T_match_jax():
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.2, -0.1, 0.3], jnp.float32)))
    t_ = np.array([0.5, -0.2, 1.5], np.float32)
    T_j = jlie.make_T(jnp.asarray(R), jnp.asarray(t_))
    T_t = lie.make_T(t(R), t(t_))
    np.testing.assert_array_equal(n(T_t), np.asarray(T_j))
    np.testing.assert_array_equal(n(projection.intrinsics_matrix(t(ICL_INTR))),
                                  np.asarray(jproj.intrinsics_matrix(jnp.asarray(ICL_INTR))))
    np.testing.assert_allclose(n(projection.projection_matrix(T_t, t(ICL_INTR))),
                               np.asarray(jproj.projection_matrix(T_j, jnp.asarray(ICL_INTR))),
                               rtol=1e-6)


# ---------------------------------------------------------------- epipolar


@pytest.mark.parametrize("weighted", [False, True])
def test_eight_point_essential_matches_jax(views, weighted):
    """One weighted fit over all noisy points, outliers at weight 0: within
    E_ATOL of the JAX package's. Or minimal sets of noise-free points, where
    float32 defines the null vector only to ~1e-2 in either package (on ten
    such sets each package's E was 0.2 or 0.8 from the float64 solution on
    some set): over 32 sets, the port's median and 90th-percentile
    distances from the float64 solutions are at most twice the JAX
    package's, plus E_ATOL."""
    if weighted:
        a1, a2, w = views["xn1"], views["xn2"], views["inl"].astype(np.float32)
        want = jepi.eight_point_essential(jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(w))
        _close_E(n(epipolar.eight_point_essential(t(a1), t(a2), t(w))), want)
        return
    uv1, uv2 = two_views(seed=2, N=256, outlier_frac=0.0, noise_px=0.0)[:2]
    xn1 = np.asarray(jproj.normalize_pixels(jnp.asarray(uv1), jnp.asarray(ICL_INTR)))
    xn2 = np.asarray(jproj.normalize_pixels(jnp.asarray(uv2), jnp.asarray(ICL_INTR)))
    a1, a2 = xn1.reshape(32, 8, 2), xn2.reshape(32, 8, 2)
    want = np.asarray(jepi.eight_point_essential(jnp.asarray(a1), jnp.asarray(a2)))
    got = n(epipolar.eight_point_essential(t(a1), t(a2)))
    exact = n(epipolar.eight_point_essential(t(a1).double(), t(a2).double()))

    def dist(E):
        sign = np.sign(np.sum(E * exact, axis=(-2, -1)))[:, None, None]
        return np.abs(E * sign - exact).max(axis=(-2, -1))

    for q in (50, 90):
        assert np.percentile(dist(got), q) <= 2 * np.percentile(dist(want), q) + E_ATOL


@pytest.mark.parametrize("fn", ["epipolar_distance_sq", "sampson_error_sq"])
def test_epipolar_errors_match_jax(views, fn):
    E = np.asarray(jepi.eight_point_essential(jnp.asarray(views["xn1"]), jnp.asarray(views["xn2"]),
                                              jnp.asarray(views["inl"], jnp.float32)))
    want = getattr(jepi, fn)(jnp.asarray(E), jnp.asarray(views["xn1"]), jnp.asarray(views["xn2"]))
    got = getattr(epipolar, fn)(t(E), t(views["xn1"]), t(views["xn2"]))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-12)


def test_decompose_and_recover_pose_match_jax(views):
    """The 4-candidate cheirality vote picks the same R and t, cheirality
    mask and valid fraction; the winner's midpoint triangulation agrees."""
    E = np.asarray(jepi.eight_point_essential(jnp.asarray(views["xn1"]), jnp.asarray(views["xn2"]),
                                              jnp.asarray(views["inl"], jnp.float32)))
    mask = views["inl"]
    R_j, t_j, X_j, g_j, f_j = jepi.recover_pose(jnp.asarray(E), jnp.asarray(views["xn1"]),
                                                jnp.asarray(views["xn2"]), jnp.asarray(mask))
    R_t, t_t, X_t, g_t, f_t = epipolar.recover_pose(t(E), t(views["xn1"]), t(views["xn2"]), t(mask))
    np.testing.assert_allclose(n(R_t), np.asarray(R_j), atol=POSE_ATOL)
    np.testing.assert_allclose(n(t_t), np.asarray(t_j), atol=POSE_ATOL)
    np.testing.assert_array_equal(n(g_t), np.asarray(g_j))
    assert float(f_t) == float(f_j) > 0.9
    _close_points(n(X_t)[n(g_t)], np.asarray(X_j)[np.asarray(g_j)])
    # And the vote found the truth.
    np.testing.assert_allclose(n(R_t), views["R"], atol=2e-3)
    np.testing.assert_allclose(n(t_t), views["t"], atol=2e-2)
    # The decomposition's candidate set is the same up to the free signs.
    Ra_j, Rb_j, tt_j = (np.asarray(a) for a in jepi.decompose_essential(jnp.asarray(E)))
    Ra_t, Rb_t, tt_t = (n(a) for a in epipolar.decompose_essential(t(E)))
    same = np.allclose(Ra_t, Ra_j, atol=POSE_ATOL) and np.allclose(Rb_t, Rb_j, atol=POSE_ATOL)
    swapped = np.allclose(Ra_t, Rb_j, atol=POSE_ATOL) and np.allclose(Rb_t, Ra_j, atol=POSE_ATOL)
    assert same or swapped
    np.testing.assert_allclose(np.abs(tt_t), np.abs(tt_j), atol=POSE_ATOL)


def test_refine_essential_gn_matches_jax(views):
    """Manifold Gauss-Newton from a perturbed seed: the port's
    torch.func.jacfwd against jax.jacfwd, same steps."""
    Rp = np.asarray(jlie.so3_exp(jnp.asarray([0.01, -0.008, 0.006], jnp.float32))) @ views["R"]
    tp = views["t"] + np.array([0.05, -0.03, 0.02], np.float32)
    E0 = np.asarray(jlie.hat(jnp.asarray(tp / np.linalg.norm(tp))) @ jnp.asarray(Rp))
    w = views["inl"].astype(np.float32)
    want = jepi.refine_essential_gn(jnp.asarray(E0), jnp.asarray(views["xn1"]),
                                    jnp.asarray(views["xn2"]), jnp.asarray(w), n_iters=4)
    got = epipolar.refine_essential_gn(t(E0), t(views["xn1"]), t(views["xn2"]), t(w), n_iters=4)
    _close_E(n(got), want)
    # It converged: the inliers' Sampson error is at the noise level.
    err = n(epipolar.sampson_error_sq(got, t(views["xn1"]), t(views["xn2"])))[views["inl"]]
    assert np.sqrt(np.median(err)) * ICL_INTR[0] < 0.5


def _jax_minimal_sets(key, n_hyps, mask, size=8):
    return np.asarray(jransac.sample_minimal_sets(key, n_hyps, size, len(mask), jnp.asarray(mask)))


def test_estimate_essential_ransac_matches_jax(views):
    """512 hypotheses with the JAX minimal sets injected: equal inlier sets,
    E within E_ATOL up to sign, the same pose out of it."""
    key = jax.random.PRNGKey(3)
    mask = np.ones(len(views["uv1"]), bool)
    mask[:5] = False
    th = 3.0 / float(ICL_INTR[0])
    E_j, inl_j, n_j = jtwoview.estimate_essential_ransac(
        key, jnp.asarray(views["uv1"]), jnp.asarray(views["uv2"]), jnp.asarray(ICL_INTR),
        jnp.asarray(mask), threshold=th, n_hyps=512)
    E_t, inl_t, n_t = twoview.estimate_essential_ransac(
        t(views["uv1"]), t(views["uv2"]), t(ICL_INTR), t(mask), threshold=th,
        idx=t(_jax_minimal_sets(key, 512, mask)))
    np.testing.assert_array_equal(n(inl_t), np.asarray(inl_j))
    assert int(n_t) == int(n_j) > 200
    _close_E(n(E_t), E_j)
    pose_j = jtwoview.estimate_relative_pose(E_j, jnp.asarray(views["uv1"]), jnp.asarray(views["uv2"]),
                                             jnp.asarray(ICL_INTR), inl_j)
    pose_t = twoview.estimate_relative_pose(E_t, t(views["uv1"]), t(views["uv2"]), t(ICL_INTR), inl_t)
    np.testing.assert_allclose(n(pose_t[0]), np.asarray(pose_j[0]), atol=POSE_ATOL)
    np.testing.assert_allclose(n(pose_t[1]), np.asarray(pose_j[1]), atol=POSE_ATOL)
    np.testing.assert_array_equal(n(pose_t[3]), np.asarray(pose_j[3]))


# ------------------------------------------------------------ triangulate


def test_triangulate_dlt_matches_jax(views):
    R, t_ = views["R"], views["t"] * np.float32(0.3)
    P1 = np.asarray(jproj.projection_matrix(jlie.make_T(jnp.eye(3), jnp.zeros(3)), jnp.asarray(ICL_INTR)))
    P2 = np.asarray(jproj.projection_matrix(jlie.make_T(jnp.asarray(R), jnp.asarray(t_)),
                                            jnp.asarray(ICL_INTR)))
    uv1, uv2 = views["uv1"], views["uv2"]
    want = np.asarray(jtri.dehomogenize(jtri.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2),
                                                             jnp.asarray(uv1), jnp.asarray(uv2))))
    got = n(triangulate.dehomogenize(triangulate.triangulate_dlt(t(P1), t(P2), t(uv1), t(uv2))))
    inl = views["inl"]
    _close_points(got[inl], want[inl])
    # And near the truth (0.3 px noise: far, low-parallax points err most).
    rel = np.linalg.norm(got - views["X1"], axis=-1) / np.linalg.norm(views["X1"], axis=-1)
    assert np.median(rel[inl]) < 0.03


def test_triangulate_midpoint_matches_jax(views):
    R1 = np.asarray(jlie.so3_exp(jnp.asarray([0.05, 0.02, -0.01], jnp.float32)))
    t1 = np.array([0.1, -0.2, 0.05], np.float32)
    R2 = views["R"] @ R1
    t2 = (views["R"] @ t1 + views["t"] * 0.3).astype(np.float32)
    args = (R1, t1, R2, t2, views["xn1"], views["xn2"])
    want = np.asarray(jtri.triangulate_midpoint(*(jnp.asarray(a) for a in args)))
    got = n(triangulate.triangulate_midpoint(*(t(a) for a in args)))
    _close_points(got, want)


# ----------------------------------------------------- init and mine steps


@pytest.fixture(scope="module")
def scene_feats():
    """JAX front-end features of frames 0, 6, 30 and 45 of the half-size
    synthetic scene, with the world->camera truth of each."""
    scene = SyntheticRGBDScene(46, 240, 320, intrinsics=HALF_INTR)
    out = {}
    for i in (0, 6, 30, 45):
        f = jfrontend.extract_pallas(jnp.asarray(scene.render(i)[0]), 256)
        R, t_ = scene.pose_cw(i)
        out[i] = (f, R.astype(np.float32), t_.astype(np.float32))
    return out


def _port_feats(f):
    return convert.from_jax_features(f.uv, f.desc, f.score, f.valid, "cpu")


@pytest.mark.parametrize("pair", [(0, 45), (0, 6)])
def test_init_step_matches_jax(scene_feats, pair):
    """(0, 45) runs the full geometry; (0, 6) is below the 30 px flow floor
    and returns frac = -1 on both sides."""
    f0, f1 = scene_feats[pair[0]][0], scene_feats[pair[1]][0]
    key = jax.random.PRNGKey(11)
    row = np.asarray(j_init_step(
        f0.desc, f0.uv, f0.valid, f1.desc, f1.uv, f1.valid, jnp.asarray(HALF_INTR), key,
        0.8, 96.0, ESS_THRESHOLD, 50.0, n_hyps=512, min_flow_px=30.0))
    scal, R_j, t_j, idx2_j, cheir_j, X_j, _ = _unpack_init_blob(row, 256)
    _, _, good = jmatch.match_ratio_test(f0.desc, f1.desc, f0.valid, f1.valid, ratio=0.8,
                                         max_distance=96.0)
    got = init_step(_port_feats(f0), _port_feats(f1), t(HALF_INTR), ratio=0.8, max_hamming=96.0,
                    ess_threshold=ESS_THRESHOLD, distance_thresh=50.0, n_hyps=512,
                    min_flow_px=30.0, ransac_idx=t(_jax_minimal_sets(key, 512, np.asarray(good))))
    assert int(got.n_matches) == int(scal[0]) > 100
    np.testing.assert_array_equal(n(got.idx2), idx2_j)
    np.testing.assert_array_equal(n(got.cheir), cheir_j)
    assert float(got.frac) == float(scal[1])
    np.testing.assert_allclose(n(got.R), R_j, atol=POSE_ATOL)
    np.testing.assert_allclose(n(got.t), t_j, atol=POSE_ATOL)
    if pair == (0, 6):
        assert float(got.frac) == -1.0 and np.isinf(float(got.parallax)) and np.isinf(scal[2])
        return
    assert float(got.frac) >= 0.9
    assert abs(float(got.parallax) - float(scal[2])) < PARALLAX_ATOL
    _close_points(n(got.X1)[cheir_j], X_j[cheir_j])


def test_mine_step_matches_jax(scene_feats):
    """Mining between frames 0 and 30 at their true poses, a third of the
    first frame's features marked as already mapped."""
    (f0, R1, t1), (f1, R2, t2) = scene_feats[0], scene_feats[30]
    avail = np.asarray(f0.valid) & (np.arange(256) % 3 != 0)
    row = np.asarray(j_mine_step(
        f0.desc, f0.uv, jnp.asarray(avail), f1.desc, f1.uv, f1.valid, jnp.asarray(R1),
        jnp.asarray(t1), jnp.asarray(R2), jnp.asarray(t2), jnp.asarray(HALF_INTR),
        0.8, 96.0, 4.0, 10.0, 3.0))
    idx2_j, keep_j, loose_j, X_j = _unpack_mine_blob(row, 256)
    got = mine_step(_port_feats(f0), t(avail), _port_feats(f1), t(R1), t(t1), t(R2), t(t2),
                    t(HALF_INTR), ratio=0.8, max_hamming=96.0, reproj_thresh_px=4.0,
                    max_depth=10.0, min_parallax_deg=3.0)
    np.testing.assert_array_equal(n(got.idx2), idx2_j)
    np.testing.assert_array_equal(n(got.keep), keep_j)
    np.testing.assert_array_equal(n(got.keep_loose), loose_j)
    assert 0 < keep_j.sum() < loose_j.sum()  # the parallax gate bites
    _close_points(n(got.X)[loose_j], X_j[loose_j])
