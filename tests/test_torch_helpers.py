"""The port's Lie, triangulation, projection, epipolar and evaluation helpers
against the JAX package's, on the inputs of tests/test_lie.py and
tests/test_geometry.py::test_triangulate_nviews, and the trace region.

Tolerances: Lie maps rtol 1e-5 / atol 1e-6 (float32 arithmetic in another
order); project_so3 atol 1e-5 (two SVDs; tests/test_lie.py's own bar);
triangulated points, dehomogenised, 1e-4 of the scene's range (the free
sign of the homogeneous vector cancels there); Sampson residuals rtol 1e-5.
"""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import n, t

from test_geometry import INTR
from test_lie import random_rotvecs

from visual_slam_tpu.ops import epipolar as jepi
from visual_slam_tpu.ops import lie as jlie
from visual_slam_tpu.ops import projection as jproj
from visual_slam_tpu.ops import triangulate as jtri
from visual_slam_tpu.utils import evaluate as jevaluate

from visual_slam_tpu_torch.models import frontend
from visual_slam_tpu_torch.ops import epipolar, lie, projection, triangulate
from visual_slam_tpu_torch.utils import evaluate, profiling

LIE_RTOL, LIE_ATOL = 1e-5, 1e-6
SO3_PROJ_ATOL = 1e-5
POINT_REL = 1e-4  # of the scene's range
SAMPSON_RTOL = 1e-5


def _rotvecs(case):
    """Rotation vectors: test_lie.py's random ones up to pi - 0.2, near pi
    (the axis recovered from the diagonal, every sign pattern), tiny and
    zero (the series)."""
    rng = np.random.default_rng(0)
    if case == "random":
        return random_rotvecs(rng, 64)
    if case == "near_pi":
        axes = rng.normal(size=(32, 3))
        axes[:8] = [[1, 1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, -1], [1, 0, 0], [0, -1, 0],
                    [0, 0, 1], [1, -1, 0]]
        axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
        return (axes * (np.pi - rng.uniform(0, 1e-3, (32, 1)))).astype(np.float32)
    w = rng.normal(size=(16, 3)) * np.logspace(-9, -3, 16)[:, None]
    w[0] = 0.0
    return w.astype(np.float32)


def _close(got, want, rtol=LIE_RTOL, atol=LIE_ATOL):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["random", "near_pi", "small"])
def test_so3_log_matches_jax(case):
    """so3_log on the same rotation matrices (JAX's so3_exp of each case)."""
    R = np.asarray(jlie.so3_exp(jnp.asarray(_rotvecs(case))))
    _close(lie.so3_log(t(R)), jlie.so3_log(jnp.asarray(R)))


@pytest.mark.parametrize("case", ["random", "small"])
def test_se3_log_matches_jax(case):
    """se3_log on test_lie.py's se3_exp round trip and on near-identity poses."""
    rng = np.random.default_rng(1)
    xi = rng.normal(size=(16, 6)).astype(np.float32) * 0.5
    if case == "small":
        xi[:, :3] = _rotvecs("small")
    R, t_ = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi)))
    _close(lie.se3_log(t(R), t(t_)), jlie.se3_log(jnp.asarray(R), jnp.asarray(t_)))


def test_rigid_transforms_match_jax():
    """split_T, inv_T, compose, transform_points and rotate_points on
    test_lie.py's inputs: batched and single transforms."""
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(8, 6)).astype(np.float32)
    T = np.asarray(jlie.make_T(*jlie.se3_exp(jnp.asarray(xi))))
    X = rng.normal(size=(8, 10, 3)).astype(np.float32)
    jT = jnp.asarray(T)
    for got, want in zip(lie.split_T(t(T)), jlie.split_T(jT)):
        np.testing.assert_array_equal(n(got), np.asarray(want))
    _close(lie.inv_T(t(T)), jlie.inv_T(jT))
    _close(lie.compose(t(T), lie.inv_T(t(T))), jlie.compose(jT, jlie.inv_T(jT)))
    _close(lie.transform_points(t(T), t(X)), jlie.transform_points(jT, jnp.asarray(X)))
    _close(lie.transform_points(t(T[0]), t(X[0])), jlie.transform_points(jT[0], jnp.asarray(X[0])))
    _close(lie.rotate_points(t(T[:, :3, :3]), t(X)), jlie.rotate_points(jT[:, :3, :3], jnp.asarray(X)))


def test_project_so3_matches_jax():
    """test_lie.py's random matrices, plus a reflection (det -1)."""
    M = np.random.default_rng(0).normal(size=(6, 3, 3)).astype(np.float32)
    M[5] = np.diag([1.0, 1.0, -1.0]) @ M[4]
    R = n(lie.project_so3(t(M)))
    np.testing.assert_allclose(R, np.asarray(jlie.project_so3(jnp.asarray(M))), atol=SO3_PROJ_ATOL)
    assert (np.linalg.det(R) > 0.99).all()


def _nview_scene():
    """test_geometry.py::test_triangulate_nviews's scene: 40 points ~6 m
    ahead seen by 5 cameras along a baseline, the noise-free and the noisy
    measurements, and its padding: two zero-weight views of random pixels."""
    rng = np.random.default_rng(0)
    n_pts, n_views = 40, 5
    X = rng.uniform(-2, 2, size=(n_pts, 3))
    X[:, 2] += 6.0
    K = np.array([[INTR[0], 0, INTR[2]], [0, INTR[1], INTR[3]], [0, 0, 1]], np.float64)
    Ps, uvs = [], []
    for v in range(n_views):
        Rv = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(scale=0.05, size=3))))
        tv = np.array([0.4 * v - 1.0, 0.1 * v, 0.05 * v])
        Ps.append(K @ np.concatenate([Rv, tv[:, None]], axis=1))
        Xc = X @ Rv.T + tv
        uvs.append(Xc[:, :2] / Xc[:, 2:3] * INTR[:2] + INTR[2:])
    P = np.stack(Ps).astype(np.float32)
    uv = np.stack(uvs, axis=1).astype(np.float32)
    noisy = uv + rng.normal(scale=0.3, size=uv.shape).astype(np.float32)
    P_pad = np.concatenate([P, np.zeros((2, 3, 4), np.float32)])
    uv_pad = np.concatenate([noisy, rng.uniform(0, 640, (n_pts, 2, 2)).astype(np.float32)], axis=1)
    w = np.concatenate([np.ones((n_pts, n_views)), np.zeros((n_pts, 2))], axis=1).astype(np.float32)
    w_soft = w * rng.uniform(0.2, 1.0, w.shape).astype(np.float32)
    return X, P, uv, noisy, P_pad, uv_pad, w, w_soft


def _points_close(got_h, want_h, X):
    got = n(triangulate.dehomogenize(got_h))
    want = np.asarray(jtri.dehomogenize(want_h))
    np.testing.assert_allclose(got, want, rtol=0, atol=POINT_REL * np.ptp(X))


@pytest.mark.parametrize("case", ["exact", "noisy", "padded", "weighted", "per_point"])
def test_triangulate_nviews_matches_jax(case):
    X, P, uv, noisy, P_pad, uv_pad, w, w_soft = _nview_scene()
    args = {"exact": (P, uv, None), "noisy": (P, noisy, None), "padded": (P_pad, uv_pad, w),
            "weighted": (P_pad, uv_pad, w_soft),
            "per_point": (np.broadcast_to(P, (len(X),) + P.shape).copy(), noisy, None)}[case]
    got = triangulate.triangulate_nviews(*(None if a is None else t(a) for a in args))
    want = jtri.triangulate_nviews(*(None if a is None else jnp.asarray(a) for a in args))
    _points_close(got, want, X)
    if case == "padded":  # zero-weight views change nothing
        _points_close(got, jtri.triangulate_nviews(jnp.asarray(P), jnp.asarray(noisy)), X)


def test_triangulate_dlt_pairwise_matches_jax():
    """Per-point projection matrices: each point its own pair of the
    n-view scene's cameras."""
    X, P, _, noisy, *_ = _nview_scene()
    a, b = np.arange(len(X)) % 5, (np.arange(len(X)) + 2) % 5
    args = (P[a], P[b], noisy[np.arange(len(X)), a], noisy[np.arange(len(X)), b])
    _points_close(triangulate.triangulate_dlt_pairwise(*(t(x) for x in args)),
                  jtri.triangulate_dlt_pairwise(*(jnp.asarray(x) for x in args)), X)


def test_make_homogeneous_and_centres_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 2)).astype(np.float32)
    np.testing.assert_array_equal(n(projection.make_homogeneous(t(x))),
                                  np.asarray(jproj.make_homogeneous(jnp.asarray(x))))
    R, t_ = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(rng.normal(size=(9, 6)), jnp.float32)))
    T_wc = np.asarray(jlie.inv_T(jlie.make_T(jnp.asarray(R), jnp.asarray(t_))))
    np.testing.assert_array_equal(evaluate.positions_from_poses_wc(T_wc),
                                  jevaluate.positions_from_poses_wc(T_wc))
    np.testing.assert_array_equal(evaluate.positions_from_poses_cw(R, t_),
                                  jevaluate.positions_from_poses_cw(R, t_))


def test_sampson_residual_and_params_match_jax():
    """sampson_residual squared against JAX's sampson_error_sq of
    E = [t]x R; params_to_Rt against the JAX refinement's composition
    (so3_exp(p[:3]) R, t + B p[3:], renormalised)."""
    rng = np.random.default_rng(3)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02], jnp.float32)))
    t_ = np.array([0.6, 0.1, -0.2], np.float32)
    t_ /= np.linalg.norm(t_)
    xn1, xn2 = (rng.normal(scale=0.4, size=(50, 2)).astype(np.float32) for _ in range(2))
    X1, X2 = (np.concatenate([x, np.ones((50, 1), np.float32)], 1) for x in (xn1, xn2))
    r = n(epipolar.sampson_residual(t(R), t(t_), t(X1), t(X2)))
    E = jlie.hat(jnp.asarray(t_)) @ jnp.asarray(R)
    want = np.asarray(jepi.sampson_error_sq(E, jnp.asarray(xn1), jnp.asarray(xn2)))
    np.testing.assert_allclose(r**2, want, rtol=SAMPSON_RTOL, atol=1e-12)
    p = rng.normal(scale=0.05, size=5).astype(np.float32)
    B = np.linalg.svd(t_[None])[2][1:].T.astype(np.float32)  # (3,2) basis of t's tangent plane
    got_R, got_t = epipolar.params_to_Rt(t(p), t(R), t(t_), t(B))
    want_t = t_ + B @ p[3:]
    _close(got_R, jlie.so3_exp(jnp.asarray(p[:3])) @ jnp.asarray(R))
    _close(got_t, want_t / (np.linalg.norm(want_t) + 1e-12))


def test_extract_rgb_is_extract():
    """extract_rgb on an RGB frame gives extract's features of that frame,
    as the JAX package's alias does."""
    rgb = np.random.default_rng(4).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    torch.set_num_threads(1)
    a, b = frontend.extract_rgb(t(rgb), 64), frontend.extract(t(rgb), 64)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_trace_writes_a_chrome_trace(tmp_path):
    """The trace region writes a Chrome trace into its directory, with the
    region's operators in it."""
    with profiling.trace(str(tmp_path)):
        torch.ones(8).add_(1)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("add_" in e.get("name", "") for e in events)
