"""The bundle-adjustment back-end of visual_slam_tpu_torch (models/ba.py,
models/ba_large.py, utils/synthetic.py, the BAProblem converters and
large_map.py) against the JAX package on the CPU. Problems are built by the
JAX package's test helpers (NumPy draws from a seed) and carried across
with convert.from_jax_ba_problem, so both sides solve the same problem; the
JAX large-map solver runs its XLA segment ops on the CPU, as its own tests
run it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import _synth_with_depth, synth_problem
from torch_parity import ICL_INTR, n, t

from visual_slam_tpu.models import ba as jba
from visual_slam_tpu.models import ba_large as jbl
from visual_slam_tpu.utils import synthetic as jsynthetic

from visual_slam_tpu_torch import convert, large_map
from visual_slam_tpu_torch.models import ba, ba_large
from visual_slam_tpu_torch.utils import synthetic

PIECE_RTOL = 1e-5
# Per-piece absolute floor, as a fraction of the largest magnitude in the
# array compared: f32 sums in another order leave ~1e-5 relative error on
# entries with cancellation inside arrays whose scale reaches 4e7 (U) and
# 6e4 (W).
PIECE_ATOL_SCALE = 1e-5
# One LM step (|delta| up to 0.3) after 10 f32 PCG iterations: the JAX
# package's own two solvers (ba_large and ba with solver="cg") differ by
# 1.0e-5 on this step.
DELTA_ATOL = 5e-5
# The JAX package's own cross-solver bars (tests/test_ba_large.py:24-30).
COST_RTOL, T_ATOL, X_ATOL = 1e-2, 1e-4, 1e-3
R_ATOL = 1e-5
LAMBDA = 1e-3


def _close(got, want, rtol=PIECE_RTOL, atol=None):
    want = np.asarray(want)
    if atol is None:
        atol = PIECE_ATOL_SCALE * float(np.abs(want).max())
    np.testing.assert_allclose(n(got), want, rtol=rtol, atol=atol)


def _with_scale_edges(jp, R_gt, t_gt):
    """Scale edges along the chain 0-1-...-K-1, measuring the true
    ||t_i - R_i R_j^T t_j||, with a weight that pins the scale gauge: H_ij
    is exercised and the solve is well conditioned."""
    K = jp.R.shape[0]
    i, j = np.arange(K - 1), np.arange(1, K)
    t_rel = t_gt[i] - np.einsum("eab,ecb,ec->ea", R_gt[i], R_gt[j], t_gt[j])
    return jp._replace(
        se_i=jnp.asarray(i, jnp.int32),
        se_j=jnp.asarray(j, jnp.int32),
        se_meas=jnp.asarray(np.linalg.norm(t_rel, axis=-1), jnp.float32),
        se_w=jnp.full(K - 1, 1e3, jnp.float32),
    )


def _port(jp):
    return convert.from_jax_ba_problem(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def edged():
    jp, (R_gt, t_gt, _) = synth_problem(np.random.default_rng(0), K=6, P=300, noise_px=0.3,
                                        pose_noise=0.03, point_noise=0.05)
    jp = _with_scale_edges(jp, R_gt, t_gt)
    return jp, _port(jp)


@pytest.mark.parametrize("piece", ["project", "jacobians", "build", "schur_matvec",
                                   "solve_delta", "cost"])
def test_ba_large_pieces_match_jax(edged, piece):
    jp, tp = edged
    if piece == "project":
        for g, w in zip(ba_large._project(tp), jbl._project(jp, False)):
            _close(g, w)
    elif piece == "jacobians":
        _, Xc, Rn, iz, _ = jbl._project(jp, False)
        got = ba_large._jacobians(t(Xc), t(Rn), t(iz), tp.intr)
        for g, w in zip(got, jbl._jacobians(Xc, Rn, iz, jp.intr)):
            _close(g, w)
    elif piece == "build":
        got = ba_large._build(tp, torch.tensor(LAMBDA))
        want = jbl._build(jp, LAMBDA)
        assert float(np.abs(np.asarray(want[5])).max()) > 1.0  # H_ij is live
        for g, w in zip(got, want):
            _close(g, w)
    elif piece == "schur_matvec":
        U, V_inv, _, _, WO, H = jbl._build(jp, LAMBDA)
        x = np.random.default_rng(5).normal(size=(6, 6)).astype(np.float32)
        want = jbl._schur_matvec(jnp.asarray(x), jp, U, V_inv, WO, H, None, False)
        got = ba_large._schur_matvec(t(x), tp, t(U), t(V_inv), t(WO), t(H))
        _close(got, want)
    elif piece == "solve_delta":
        got = ba_large._solve_delta(tp, torch.tensor(LAMBDA), 10, False)
        for g, w in zip(got, jbl._solve_delta(jp, LAMBDA, 10, False)):
            _close(g, w, atol=DELTA_ATOL)
    else:
        _close(ba_large._cost(tp), jbl._cost(jp))


def test_ba_large_optimize_matches_jax(edged):
    jp, tp = edged
    jo, jc = jbl.optimize(jp, n_iters=8, cg_iters=10)
    to, tc = ba_large.optimize(tp, n_iters=8, cg_iters=10)
    assert abs(float(tc) - float(jc)) < COST_RTOL * max(1.0, float(jc))
    np.testing.assert_allclose(n(to.t), np.asarray(jo.t), atol=T_ATOL)
    np.testing.assert_allclose(n(to.X), np.asarray(jo.X), atol=X_ATOL)


def test_ba_large_matches_port_online_cg():
    """The port's two solvers agree: same math, segment kernels vs dense W."""
    jp, _ = synth_problem(np.random.default_rng(1), K=6, P=300, noise_px=0.3,
                          pose_noise=0.03, point_noise=0.05)
    tp = _port(jp)
    o1, c1 = ba.optimize(tp, n_iters=8, cg_iters=10, solver="cg")
    o2, c2 = ba_large.optimize(tp, n_iters=8, cg_iters=10)
    assert abs(float(c1) - float(c2)) < COST_RTOL * max(1.0, float(c1))
    np.testing.assert_allclose(n(o1.t), n(o2.t), atol=T_ATOL)
    np.testing.assert_allclose(n(o1.X), n(o2.X), atol=X_ATOL)


def test_ba_large_converges_medium_scale():
    """256 keyframes x 16k landmarks (64k observations), port only: the cost
    falls to the noise floor and the poses tighten (tests/test_ba_large.py:49-63)."""
    prob, gt = synthetic.build_loop_map(256, 16384, 4)
    res, out = large_map.run(prob, gt, n_iters=6, cg_iters=8, lm_lambda=1e-2)
    large_map.check(res)
    assert res["cost_after"] == res["cost_after_first"]  # CPU sums repeat
    assert res["launches_per_optimize"] == {"cam_reduce": 0, "cam_expand": 0}  # no card
    assert np.isfinite(n(out.X)).all()


def test_build_loop_map_matches_jax():
    jp, jgt = jsynthetic.build_loop_map(64, 2048, 4, seed=3)
    tp, tgt = synthetic.build_loop_map(64, 2048, 4, seed=3)
    for name in ("cam", "uv", "w", "X", "cam_fixed", "pt_valid", "dinv", "dw"):
        np.testing.assert_array_equal(n(getattr(tp, name)), np.asarray(getattr(jp, name)), err_msg=name)
    np.testing.assert_allclose(n(tp.R), np.asarray(jp.R), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(tp.t), np.asarray(jp.t), rtol=0, atol=1e-6)
    for g, w in zip(tgt, jgt):
        np.testing.assert_array_equal(g, w)


def test_make_problem_matches_jax():
    """The planar layout, the depth planes and the meta are equal, and so
    are the host packer's outputs."""
    rng = np.random.default_rng(4)
    O, K, Pn = 700, 5, 120
    cam = rng.integers(0, K, O).astype(np.int32)
    pnt = rng.integers(0, Pn, O).astype(np.int32)
    uv = rng.uniform(0, 600, (O, 2)).astype(np.float32)
    w = (rng.uniform(size=O) > 0.15).astype(np.float32)
    depth = rng.uniform(0.5, 8, O).astype(np.float32)
    depth[::9] = np.nan
    X = rng.normal(size=(Pn, 3)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    tr = rng.normal(size=(K, 3)).astype(np.float32)
    fixed = np.arange(K) == 0
    args = dict(R=R, t=tr, X=X, cam=cam, pnt=pnt, uv=uv, w=w, intr=ICL_INTR,
                cam_fixed=fixed, depth=depth, depth_weight=0.7)
    jp, jmeta = jba.make_problem(**args)
    tp, tmeta = ba.make_problem(**args)
    for name in jba.BAProblem._fields:
        np.testing.assert_array_equal(n(getattr(tp, name)), np.asarray(getattr(jp, name)), err_msg=name)
    np.testing.assert_array_equal(tmeta.slot_obs, jmeta.slot_obs)
    np.testing.assert_array_equal(tmeta.pt_ids, jmeta.pt_ids)
    for g, w in zip(ba.pack_planar(cam, pnt, uv, w), jba.pack_planar(cam, pnt, uv, w)):
        for a, b in zip(g if isinstance(g, tuple) else [g], w if isinstance(w, tuple) else [w]):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("mode", ["chol", "cg", "depth"])
def test_ba_optimize_matches_jax(edged, mode):
    """The online solver (B4/B5 in place of the one-hot contractions): the
    Cholesky and CG paths on the scale-edged problem, and the RGB-D
    inverse-depth residual on the scale-ambiguous depth problem."""
    if mode == "depth":
        jp, _, _ = _synth_with_depth(np.random.default_rng(2))
        jo, jc = jba.optimize(jp, n_iters=15, use_depth=True)
        to, tc = ba.optimize(_port(jp), n_iters=15, use_depth=True)
    else:
        jp, tp = edged
        jo, jc = jba.optimize(jp, n_iters=8, cg_iters=10, solver=mode)
        to, tc = ba.optimize(tp, n_iters=8, cg_iters=10, solver=mode)
    assert abs(float(tc) - float(jc)) < COST_RTOL * max(1.0, float(jc))
    np.testing.assert_allclose(n(to.R), np.asarray(jo.R), atol=R_ATOL)
    np.testing.assert_allclose(n(to.t), np.asarray(jo.t), atol=T_ATOL)
    np.testing.assert_allclose(n(to.X), np.asarray(jo.X), atol=X_ATOL)


def test_online_pieces_match_jax(edged):
    """The online build (U and g_c through B4) and the reprojection errors."""
    jp, tp = edged
    C_T = jba._onehot(jp)
    want = jba._build_planar(jp, LAMBDA, C_T)
    got = ba._build_planar(tp, torch.tensor(LAMBDA))
    for g, w in zip(got[:6], want[:6]):
        _close(g, w)
    for g, w in zip(ba.reproj_errors(tp), jba.reproj_errors(jp)):
        _close(g, w)


def test_median_depth_normalize_matches_jax(edged):
    jp, tp = edged
    want = jba.median_depth_normalize(jp)
    got = ba.median_depth_normalize(tp)
    np.testing.assert_array_equal(n(got.t), np.asarray(want.t))
    np.testing.assert_array_equal(n(got.X), np.asarray(want.X))


def test_ba_problem_round_trip(edged):
    jp, tp = edged
    fields = convert.to_numpy_ba_problem(tp)
    for name in jba.BAProblem._fields:
        np.testing.assert_array_equal(fields[name], np.asarray(getattr(jp, name)), err_msg=name)
        assert fields[name].dtype == np.asarray(getattr(jp, name)).dtype, name
    back = convert.from_jax_ba_problem(fields, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, tp))


def test_large_map_cli_needs_a_card():
    """No CUDA card here: the measurement refuses to run on the CPU."""
    assert large_map.main(["--kf", "16", "--pts", "64"]) != 0


def test_arc_problem_matches_test_helper():
    """utils/synthetic.arc_problem is tests/test_ba.py:synth_problem: the
    same draws; poses from the port's so3_exp agree to 1e-6, so the
    projected pixels agree to 1e-3 px."""
    jp, jgt = synth_problem(np.random.default_rng(7), K=5, P=120, noise_px=0.3,
                            pose_noise=0.02, point_noise=0.03)
    tp, tgt = synthetic.arc_problem(5, 120, 0.3, 0.02, 0.03, seed=7)
    for name in ("cam", "w", "X", "cam_fixed", "pt_valid", "se_w"):
        np.testing.assert_array_equal(n(getattr(tp, name)), np.asarray(getattr(jp, name)), err_msg=name)
    np.testing.assert_allclose(n(tp.R), np.asarray(jp.R), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(tp.t), np.asarray(jp.t), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(tp.uv), np.asarray(jp.uv), rtol=0, atol=1e-3)
    for g, w in zip(tgt, jgt):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
