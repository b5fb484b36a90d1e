"""Parity of the port's matcher and geometry core (lie, projection, DLT,
Gauss-Newton, RANSAC, tiered PnP) with the JAX package on the CPU.

RANSAC draws its minimal sets with jax.random.gumbel, which torch cannot
replay: the tests draw them in JAX (ransac.sample_minimal_sets with the
same key the JAX solver uses) and inject them into the port.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from torch_parity import ICL_INTR, n, t

from visual_slam_tpu.ops import lie as jlie, match as jmatch, pnp as jpnp
from visual_slam_tpu.ops import projection as jproj, ransac as jransac

from visual_slam_tpu_torch import convert
from visual_slam_tpu_torch.ops import lie, match, pnp, projection

POSE_ATOL = 1e-4  # R and t after the float32 GN polish (sums in another order)


# ------------------------------------------------------------------ matching


def _planted_descriptors(seed=0, K1=96, K2=80):
    """Random descriptors with planted exact duplicates and equidistant
    candidates, so top-2 and argmin meet ties."""
    rng = np.random.default_rng(seed)
    d2 = rng.integers(0, 2**32, size=(K2, 8), dtype=np.uint32)
    d1 = rng.integers(0, 2**32, size=(K1, 8), dtype=np.uint32)
    d2[11] = d2[4]  # duplicate targets: d1 rows near them tie on the best
    d2[40] = d2[4]
    for i in range(20):  # queries close to a target (a few bits flipped)
        j = int(rng.integers(0, K2))
        d1[i] = d2[j] ^ np.uint32(1 << int(rng.integers(0, 32)))
    d1[20] = d2[4]
    d1[21] = d2[4] ^ np.uint32(3)
    d1[30] = d1[31] = d2[7]  # two queries want the same target
    # Equidistant: flip one bit in word 0 vs one bit in word 1.
    d2[50] = d2[60] ^ np.uint32(1)
    d1[40] = d2[60] ^ np.uint32(2)
    return d1, d2


def test_hamming_matrix_bit_exact():
    d1, d2 = _planted_descriptors()
    want = np.asarray(jmatch.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    got = n(match.hamming_matrix(convert.from_jax_desc(d1, "cpu"), convert.from_jax_desc(d2, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_ratio_test_bit_exact(cross_check):
    """idx2, dist and good equal the JAX matcher's, tie rules included."""
    d1, d2 = _planted_descriptors()
    rng = np.random.default_rng(5)
    v1 = rng.uniform(size=len(d1)) > 0.1
    v2 = rng.uniform(size=len(d2)) > 0.1
    v2[[4, 11, 40, 7, 50, 60]] = True
    jo = jmatch.match_ratio_test(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
                                 jnp.asarray(v2), cross_check=cross_check)
    to = match.match_ratio_test(convert.from_jax_desc(d1, "cpu"), convert.from_jax_desc(d2, "cpu"),
                                t(v1), t(v2), cross_check=cross_check)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    assert np.asarray(jo[2]).sum() > 5


def test_match_all_invalid_rows():
    """Rows and columns masked out take the 1e9 fill on both sides."""
    rng = np.random.default_rng(1)
    d1 = rng.integers(0, 2**32, size=(8, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, size=(6, 8), dtype=np.uint32)
    v1 = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    v2 = np.array([0, 1, 0, 0, 0, 0], bool)  # a single valid target
    jo = jmatch.match_ratio_test(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2))
    to = match.match_ratio_test(convert.from_jax_desc(d1, "cpu"), convert.from_jax_desc(d2, "cpu"),
                                t(v1), t(v2))
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(n(a), np.asarray(b))


# ------------------------------------------------------------------ geometry


def test_lie_exp_maps():
    rng = np.random.default_rng(0)
    xi = rng.normal(scale=0.3, size=(32, 6)).astype(np.float32)
    xi[0] = 0.0
    xi[1, :3] = 1e-6  # Taylor branch
    R_j, t_j = jlie.se3_exp(jnp.asarray(xi))
    R_t, t_t = lie.se3_exp(t(xi))
    np.testing.assert_allclose(n(R_t), np.asarray(R_j), atol=1e-6)
    np.testing.assert_allclose(n(t_t), np.asarray(t_j), atol=1e-6)
    np.testing.assert_allclose(n(lie.so3_exp(t(xi[:, :3]))),
                               np.asarray(jlie.so3_exp(jnp.asarray(xi[:, :3]))), atol=1e-6)
    np.testing.assert_array_equal(n(lie.hat(t(xi[:, :3]))), np.asarray(jlie.hat(jnp.asarray(xi[:, :3]))))


def test_projection():
    rng = np.random.default_rng(1)
    X = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    X[:, 2] += 4
    X[0, 2] = -1.0  # behind the camera
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
    tt = np.array([0.2, -0.1, 0.3], np.float32)
    uv_j, z_j = jproj.project(jnp.asarray(R), jnp.asarray(tt), jnp.asarray(X), jnp.asarray(ICL_INTR))
    uv_t, z_t = projection.project(t(R), t(tt), t(X), t(ICL_INTR))
    np.testing.assert_allclose(n(uv_t), np.asarray(uv_j), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(n(z_t), np.asarray(z_j), rtol=1e-6)
    np.testing.assert_array_equal(
        n(projection.normalize_pixels(uv_t, t(ICL_INTR))),
        np.asarray(jproj.normalize_pixels(jnp.asarray(n(uv_t)), jnp.asarray(ICL_INTR))),
    )


def make_scene(rng, n_pts=256, noise=0.3, n_out=60, w=(0.1, 0.2, -0.05), tc=(0.3, -0.2, 0.5)):
    """tests/test_geometry.py-style scene: points 4-10 m ahead, a pose, its
    projections with noise and `n_out` gross outliers."""
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                  rng.uniform(4, 10, n_pts)], -1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(np.array(w, np.float32))))
    t_cw = np.array(tc, np.float32)
    uv = np.array(jproj.project(jnp.asarray(R), jnp.asarray(t_cw), jnp.asarray(X),
                                jnp.asarray(ICL_INTR))[0])
    uv[:n_out] = rng.uniform(0, 640, (n_out, 2))
    uv = (uv + rng.normal(scale=noise, size=uv.shape)).astype(np.float32)
    return X, uv, R, t_cw


def test_pnp_dlt_after_sign_fix():
    """Batched DLT vs JAX's per-set DLT on 16-point sets; the free
    eigenvector sign is fixed inside pnp_dlt, so R and t compare directly.
    (On 6-point minimal sets the float32 Gram matrix is near-singular and
    the two eigh implementations give hypotheses ~1 cm apart; RANSAC's GN
    polish removes that, as the solve_pnp_* tests show.)"""
    rng = np.random.default_rng(2)
    X, uv, R, t_cw = make_scene(rng, n_pts=64, noise=0.0, n_out=0)
    xn = np.asarray(jproj.normalize_pixels(jnp.asarray(uv), jnp.asarray(ICL_INTR)))
    sets = np.stack([rng.choice(64, 16, replace=False) for _ in range(8)])
    R_t, t_t = pnp.pnp_dlt(t(X)[t(sets)], t(xn)[t(sets)])
    for b, s in enumerate(sets):
        R_j, t_j = jpnp.pnp_dlt(jnp.asarray(X[s]), jnp.asarray(xn[s]))
        np.testing.assert_allclose(n(R_t[b]), np.asarray(R_j), atol=1e-3)
        np.testing.assert_allclose(n(t_t[b]), np.asarray(t_j), atol=1e-2)
        np.testing.assert_allclose(n(R_t[b]), R, atol=1e-3)


def test_gauss_newton_matches_jax():
    rng = np.random.default_rng(3)
    X, uv, _, _ = make_scene(rng)
    w = (rng.uniform(size=len(X)) > 0.3).astype(np.float32)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.09, 0.18, -0.04], jnp.float32)))
    t0 = np.array([0.33, -0.17, 0.55], np.float32)
    R_j, t_j = jpnp.pnp_gauss_newton(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X),
                                     jnp.asarray(uv), jnp.asarray(ICL_INTR), jnp.asarray(w))
    R_t, t_t = pnp.pnp_gauss_newton(t(R0), t(t0), t(X), t(uv), t(ICL_INTR), t(w))
    np.testing.assert_allclose(n(R_t), np.asarray(R_j), atol=POSE_ATOL)
    np.testing.assert_allclose(n(t_t), np.asarray(t_j), atol=POSE_ATOL)


def _entry_scene(rng):
    """The __graft_entry__.entry snapshot (M=512 points, identity prior, ICL
    intrinsics) observed from a nearby pose, with noise and outliers."""
    import __graft_entry__

    _, args = __graft_entry__.entry()
    _, _, snap_xyz, snap_valid, prev_R, prev_t, intr, _ = (np.asarray(a) for a in args)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.005], jnp.float32)))
    t_cw = np.array([0.03, -0.01, 0.02], np.float32)
    uv = np.array(jproj.project(jnp.asarray(R), jnp.asarray(t_cw), jnp.asarray(snap_xyz),
                                jnp.asarray(intr))[0])
    uv[:100] = rng.uniform(0, 640, (100, 2))
    uv = (uv + rng.normal(scale=0.5, size=uv.shape)).astype(np.float32)
    return snap_xyz, uv, intr, snap_valid, prev_R, prev_t, R, t_cw


def _cases():
    """(name, X, uv, intr, mask, guess_R, guess_t, key, n_hyps)."""
    rng = np.random.default_rng(4)
    X, uv, R, t_cw = make_scene(rng)
    mask = np.ones(len(X), bool)
    mask[200:210] = False
    good_R = np.asarray(jlie.so3_exp(jnp.asarray([0.098, 0.196, -0.049], jnp.float32)))
    bad_R = np.asarray(jlie.so3_exp(jnp.asarray([2.0, -1.5, 0.8], jnp.float32)))
    e = _entry_scene(rng)
    return {
        "geometry_good_prior": (X, uv, ICL_INTR, mask, good_R, t_cw + 0.01, 1, 128),
        "geometry_bad_prior": (X, uv, ICL_INTR, mask, bad_R, t_cw + [3.0, -2.0, 5.0], 3, 256),
        "entry_identity_prior": (e[0], e[1], e[2], e[3], e[4], e[5], 0, 128),
        "entry_bad_prior": (e[0], e[1], e[2], e[3], bad_R, e[5] + [1.0, 0.5, -2.0], 7, 128),
    }


CASES = _cases()


def _jax_minimal_sets(key, n_hyps, mask):
    return np.asarray(jransac.sample_minimal_sets(
        jax.random.PRNGKey(key), n_hyps, 6, len(mask), jnp.asarray(mask)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_pnp_tracked_matches_jax(name):
    """Tiered PnP: the same branch, R and t within POSE_ATOL, equal inlier
    masks. RANSAC cases run with the JAX minimal sets injected."""
    X, uv, intr, mask, gR, gt, key, n_hyps = CASES[name]
    R_j, t_j, inl_j, n_j = jpnp.solve_pnp_tracked(
        jax.random.PRNGKey(key), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(intr),
        jnp.asarray(mask), jnp.asarray(gR, jnp.float32), jnp.asarray(gt, jnp.float32),
        n_hyps=n_hyps)
    R_t, t_t, inl_t, n_t, used_ransac = pnp.solve_pnp_tracked(
        t(X), t(uv), t(intr), t(mask), t(gR).float(), t(gt).float(),
        idx=t(_jax_minimal_sets(key, n_hyps, mask)), n_hyps=n_hyps)
    assert used_ransac == ("bad_prior" in name)
    np.testing.assert_allclose(n(R_t), np.asarray(R_j), atol=POSE_ATOL)
    np.testing.assert_allclose(n(t_t), np.asarray(t_j), atol=POSE_ATOL)
    np.testing.assert_array_equal(n(inl_t), np.asarray(inl_j))
    assert int(n_t) == int(n_j) > 100


@pytest.mark.parametrize("name", ["geometry_bad_prior", "entry_identity_prior"])
def test_solve_pnp_ransac_matches_jax(name):
    """Plain RANSAC + polish with the JAX minimal sets injected."""
    X, uv, intr, mask, gR, gt, key, n_hyps = CASES[name]
    R_j, t_j, inl_j, n_j = jpnp.solve_pnp_ransac(
        jax.random.PRNGKey(key), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(intr),
        jnp.asarray(mask), jnp.asarray(gR, jnp.float32), jnp.asarray(gt, jnp.float32),
        n_hyps=n_hyps)
    R_t, t_t, inl_t, n_t = pnp.solve_pnp_ransac(
        t(X), t(uv), t(intr), t(mask), t(gR).float(), t(gt).float(),
        idx=t(_jax_minimal_sets(key, n_hyps, mask)), n_hyps=n_hyps)
    np.testing.assert_allclose(n(R_t), np.asarray(R_j), atol=POSE_ATOL)
    np.testing.assert_allclose(n(t_t), np.asarray(t_j), atol=POSE_ATOL)
    np.testing.assert_array_equal(n(inl_t), np.asarray(inl_j))


def test_port_sampler_recovers_pose():
    """The port's own Gumbel sampler (torch.Generator) finds the pose from a
    garbage prior, as test_geometry.test_pnp_tracked_bad_prior_falls_back."""
    import torch

    X, uv, intr, mask, gR, gt, _, n_hyps = CASES["geometry_bad_prior"]
    g = torch.Generator().manual_seed(0)
    R_t, t_t, _, n_t, used_ransac = pnp.solve_pnp_tracked(
        t(X), t(uv), t(intr), t(mask), t(gR).float(), t(gt).float(), generator=g, n_hyps=n_hyps)
    R_true = np.asarray(jlie.so3_exp(jnp.asarray([0.1, 0.2, -0.05], jnp.float32)))
    assert used_ransac
    np.testing.assert_allclose(n(R_t), R_true, atol=2e-3)
    np.testing.assert_allclose(n(t_t), [0.3, -0.2, 0.5], atol=3e-2)
    assert int(n_t) > 150
