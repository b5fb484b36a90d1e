"""The port's pose graph (visual_slam_tpu_torch/models/pose_graph.py)
against the JAX package's on the CPU: the same graphs, built with NumPy from
a seed, through both. On the CPU the port's B4/B5 calls take their plain
versions (index_add_, index_select).

Tolerances: residuals and Jacobian blocks rtol 1e-5 (atol 1e-6 for the
entries near zero); analytic blocks against torch.func.jacfwd atol 1e-4, the
JAX package's own bar (tests/test_sim3.py); optimised R, t and log-scales
1e-4 (float32 sums in another order, over up to 25 GN steps); final costs
rtol 1e-3 with atol 1e-9 (a converged cost is a sum of float32 round-off).
The 5,000-keyframe graph: t 2e-4, R 2e-5, cost rtol 1e-3 (8 GN x 40 CG
float32 iterations on 20,012 slots; the JAX package's sharded-identity test
holds its own two solvers to 2e-3 / 2e-4 at this size)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n

from test_pose_graph import make_chain
from test_sim3 import _drifted_loop, _random_graph
from visual_slam_tpu.models import pose_graph as jpg
from visual_slam_tpu.ops import lie as jlie

from visual_slam_tpu_torch import convert
from visual_slam_tpu_torch.models import pose_graph as pg
from visual_slam_tpu_torch.ops import lie
from visual_slam_tpu_torch.utils.synthetic import big_pose_graph

BLOCK_RTOL, BLOCK_ATOL = 1e-5, 1e-6
JACFWD_ATOL = 1e-4
POSE_ATOL = 1e-4
COST_RTOL, COST_ATOL = 1e-3, 1e-9
BIG_T_ATOL, BIG_R_ATOL = 2e-4, 2e-5


def _np(g):
    return jax.tree.map(np.asarray, g)


def _port(g):
    conv = convert.from_jax_sim3_graph if isinstance(g, jpg.Sim3Graph) else convert.from_jax_pose_graph
    return conv(_np(g), "cpu")


def _chain_graph(rng, K=10, loop=True):
    """A perturbed chain measured from its ground truth, with a loop edge."""
    R_gt, t_gt, R0, t0 = make_chain(rng, K)
    g = jpg.from_keyframe_chain(jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.ones(K, bool))
    g = g._replace(R=jnp.asarray(R0), t=jnp.asarray(t0))
    if loop:
        Z_R, Z_t = jpg._rel(jnp.asarray(R_gt), jnp.asarray(t_gt), np.array([0]), np.array([K - 1]))
        g = jpg.add_edges(g, [0], [K - 1], Z_R, Z_t, [50.0])
    return g, R_gt, t_gt


def _close(a, b, rtol=BLOCK_RTOL, atol=BLOCK_ATOL, msg=""):
    np.testing.assert_allclose(n(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=msg)


def _same_solution(port, jx, atol=POSE_ATOL, r_atol=None):
    """Optimised (R, t[, lam], cost) of both sides."""
    *arrays, cost = port
    *jarrays, jcost = jx
    for k, (a, b) in enumerate(zip(arrays, jarrays)):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=r_atol if (k == 0 and r_atol) else atol,
                                   err_msg=f"output {k}")
    np.testing.assert_allclose(float(cost), float(jcost), rtol=COST_RTOL, atol=COST_ATOL)


def test_vee_matches_jax(rng):
    W = rng.normal(size=(5, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(n(lie.vee(torch.from_numpy(W))), np.asarray(jlie.vee(jnp.asarray(W))))


def test_builders_match_jax(rng):
    """from_keyframe_chain (with and without scale measurements, an invalid
    keyframe), add_edges, sim3_from_keyframe_chain and sim3_add_edges build
    the JAX package's graphs."""
    K = 7
    R_gt, t_gt, _, _ = make_chain(rng, K)
    valid = np.ones(K, bool)
    valid[4] = False
    meas = rng.uniform(0.1, 1.0, K - 1).astype(np.float32)
    e = (np.array([0, 2]), np.array([6, 5]), np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
         rng.normal(size=(2, 3)).astype(np.float32))
    R, t = torch.from_numpy(R_gt), torch.from_numpy(t_gt)
    pairs = []
    for sm in (None, meas):
        g = pg.add_edges(pg.from_keyframe_chain(R, t, torch.from_numpy(valid), sm), *e, [50.0, 5.0])
        jg = jpg.add_edges(jpg.from_keyframe_chain(jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.asarray(valid),
                                                   None if sm is None else jnp.asarray(sm)),
                           *e, [50.0, 5.0])
        pairs.append((g, jg))
    s3 = pg.sim3_add_edges(pg.sim3_from_keyframe_chain(R, t, torch.from_numpy(valid)), *e,
                           np.array([0.1, -0.2], np.float32), [50.0, 5.0])
    js3 = jpg.sim3_add_edges(jpg.sim3_from_keyframe_chain(jnp.asarray(R_gt), jnp.asarray(t_gt),
                                                          jnp.asarray(valid)),
                             *e, np.array([0.1, -0.2], np.float32), np.array([50.0, 5.0], np.float32))
    pairs.append((s3, js3))
    for g, jg in pairs:
        assert g._fields == jg._fields
        for name in g._fields:
            a, b = n(getattr(g, name)), np.asarray(getattr(jg, name))
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=BLOCK_RTOL, atol=BLOCK_ATOL, err_msg=name)
        assert g.e_i.dtype == torch.int32 and g.fixed.dtype == torch.bool


def test_edge_blocks_and_residuals_match_jax(rng):
    """SE3 residuals, scale residuals and both edges' analytic blocks, on a
    perturbed chain with a loop edge."""
    g, _, _ = _chain_graph(rng)
    tg = _port(g)
    for port, jx in ((pg._se3_residual(tg, tg.R, tg.t), jpg._se3_residual(g, g.R, g.t)),
                     (pg._scale_residual(tg, tg.R, tg.t), jpg._scale_residual(g, g.R, g.t))):
        _close(port, jx)
    for name, port, jx in (("se3", pg._se3_edge_blocks(tg, tg.R, tg.t), jpg._se3_edge_blocks(g, g.R, g.t)),
                           ("scale", pg._scale_edge_blocks(tg, tg.R, tg.t),
                            jpg._scale_edge_blocks(g, g.R, g.t))):
        for k, (a, b) in enumerate(zip(port, jx)):
            _close(a, b, msg=f"{name} output {k}")


def test_dcs_weight_and_delta_match_jax(rng):
    chi2 = np.concatenate([[0.0, 1.0, 3.0], rng.uniform(0, 100, 20)]).astype(np.float32)
    _close(pg._dcs_weight(torch.from_numpy(chi2), 1.0), jpg._dcs_weight(jnp.asarray(chi2), 1.0))
    R_gt, t_gt, _, _ = make_chain(rng, 6)
    delta = rng.normal(scale=0.1, size=(6, 6)).astype(np.float32)
    for a, b in zip(pg._apply_delta(torch.from_numpy(R_gt), torch.from_numpy(t_gt), torch.from_numpy(delta)),
                    jpg._apply_delta(jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.asarray(delta))):
        _close(a, b)


@pytest.mark.parametrize("use_dcs", [True, False])
def test_optimize_matches_jax(rng, use_dcs):
    """SE3 GN with block-Jacobi PCG, DCS on and off, on a perturbed chain
    with a loop edge."""
    g, _, _ = _chain_graph(rng)
    kw = dict(n_iters=10, cg_iters=32, use_dcs=use_dcs)
    _same_solution(pg.optimize(_port(g), **kw), jpg.optimize(g, **kw))


def test_analytic_matches_dense_oracle(rng):
    """The analytic CG solver against the port's jacfwd dense solver (as
    test_pose_graph.py holds the JAX package's), and the dense solver
    against the JAX package's."""
    g, _, _ = _chain_graph(rng, loop=False)
    tg = _port(g)
    R_a, t_a, _ = pg.optimize(tg, n_iters=10, cg_iters=60, use_dcs=False)
    dense = pg.optimize_dense(tg, n_iters=10)
    np.testing.assert_allclose(n(R_a), n(dense[0]), atol=1e-4)
    np.testing.assert_allclose(n(t_a), n(dense[1]), atol=1e-3)
    _same_solution(dense, jpg.optimize_dense(g, n_iters=10))


def test_pose_graph_converges_to_measurements(rng):
    """test_pose_graph.py's scene: exact chain measurements, perturbed
    start, pose 0 fixed: the chain snaps back to ground truth."""
    K = 8
    R_gt, t_gt, R0, t0 = make_chain(rng, K)
    g = jpg.from_keyframe_chain(jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.ones(K, bool))
    g = g._replace(R=jnp.asarray(R0), t=jnp.asarray(t0))
    port = pg.optimize(_port(g), n_iters=15)
    _same_solution(port, jpg.optimize(g, n_iters=15))
    np.testing.assert_allclose(n(port[0]), R_gt, atol=1e-3)
    np.testing.assert_allclose(n(port[1]), t_gt, atol=1e-2)
    assert float(port[2]) < 1e-6


def test_pose_graph_respects_fixed(rng):
    K = 6
    R_gt, t_gt, R0, t0 = make_chain(rng, K)
    g = jpg.from_keyframe_chain(jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.ones(K, bool))
    g = g._replace(R=jnp.asarray(R0), t=jnp.asarray(t0))
    port = pg.optimize(_port(g), n_iters=5)
    _same_solution(port, jpg.optimize(g, n_iters=5))
    np.testing.assert_allclose(n(port[0][0]), R0[0], atol=1e-7)
    np.testing.assert_allclose(n(port[1][0]), t0[0], atol=1e-7)


def test_scale_edges_fix_scale_drift(rng):
    """Scale edges with corrected measurements restore a drifted chain's
    scale (≙ AddScalingEdge)."""
    K = 6
    R_gt, t_gt, _, _ = make_chain(rng, K, drift=0.0)
    scales = np.linspace(1.0, 1.6, K).astype(np.float32)
    t_drift = (t_gt * scales[:, None]).astype(np.float32)
    g = jpg.from_keyframe_chain(jnp.asarray(R_gt), jnp.asarray(t_drift), jnp.ones(K, bool))
    R_rel, t_rel = jpg._rel(jnp.asarray(R_gt), jnp.asarray(t_gt), np.arange(K - 1), np.arange(1, K))
    g = g._replace(s_meas=jnp.linalg.norm(t_rel, axis=-1), Z_t=t_rel, Z_R=R_rel)
    port = pg.optimize(_port(g), n_iters=20)
    _same_solution(port, jpg.optimize(g, n_iters=20))
    np.testing.assert_allclose(n(port[1]), t_gt, atol=2e-2)


def test_loop_edge_corrects_drift(rng):
    """A loop edge with the true relative pose pulls an accumulated-drift
    chain back toward ground truth."""
    K = 30
    R_gt, t_gt, _, _ = make_chain(rng, K, drift=0.0)
    R0, t0 = R_gt.copy(), t_gt.copy()
    for k in range(1, K):
        dR = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.004 * k, 0.0], dtype=jnp.float32)))
        R0[k] = dR @ R_gt[k]
        t0[k] = t_gt[k] + np.array([0.01 * k, 0, 0.008 * k], np.float32)
    g = jpg.from_keyframe_chain(jnp.asarray(R0), jnp.asarray(t0), jnp.ones(K, bool))
    Z_R, Z_t = jpg._rel(jnp.asarray(R_gt), jnp.asarray(t_gt), np.array([0]), np.array([K - 1]))
    g = jpg.add_edges(g, [0], [K - 1], Z_R, Z_t, [50.0])
    port = pg.optimize(_port(g), n_iters=25, cg_iters=60)
    _same_solution(port, jpg.optimize(g, n_iters=25, cg_iters=60))
    err0 = np.linalg.norm(t0[-1] - t_gt[-1])
    assert np.linalg.norm(n(port[1])[-1] - t_gt[-1]) < 0.35 * err0


def test_dcs_rejects_bad_loop_edge(rng):
    """A grossly wrong loop edge does not warp the graph with DCS on, and
    does without it."""
    K = 12
    R_gt, t_gt, _, _ = make_chain(rng, K, drift=0.0)
    g = jpg.from_keyframe_chain(jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.ones(K, bool))
    g_bad = jpg.add_edges(g, [0], [K - 1], np.eye(3, dtype=np.float32)[None],
                          np.array([[5.0, 0.0, 0.0]], np.float32), [10.0])
    for use_dcs in (True, False):
        port = pg.optimize(_port(g_bad), n_iters=15, use_dcs=use_dcs)
        _same_solution(port, jpg.optimize(g_bad, n_iters=15, use_dcs=use_dcs))
        if use_dcs:
            np.testing.assert_allclose(n(port[1]), t_gt, atol=0.05)
        else:
            assert np.abs(n(port[1]) - t_gt).max() > 0.2


def test_pose_graph_5k_matches_jax():
    """test_pose_graph.py's 5,000-keyframe chain with long-range loop edges
    (its make_big_graph's draws, built by the port's big_pose_graph; 20,012
    slots a B4 call): the port's solve against the JAX package's on that
    graph, and within its 0.05 m of ground truth."""
    tg, (_, t_gt) = big_pose_graph(5000, device="cpu")
    g = jpg.PoseGraph(**{k: jnp.asarray(n(v)) for k, v in tg._asdict().items()})
    port = pg.optimize(tg, n_iters=8, cg_iters=40)
    _same_solution(port, jpg.optimize(g, n_iters=8, cg_iters=40), atol=BIG_T_ATOL, r_atol=BIG_R_ATOL)
    assert np.abs(n(port[1]) - t_gt).max() < 0.05


def test_sim3_blocks_match_autodiff_and_jax(rng):
    """Analytic 7x7 Sim3 blocks == torch.func.jacfwd of the residual under
    left-composed per-node Sim3 deltas, and == the JAX package's blocks."""
    g = _random_graph(rng)
    tg = _port(g)
    K = tg.R.shape[0]

    def residual(deltas):
        R, t, lam = pg._apply_sim3_delta(tg.R, tg.t, tg.lam, deltas)
        return pg._sim3_edge_blocks(tg, R, t, lam)[0]

    r0, J_i, J_j = pg._sim3_edge_blocks(tg, tg.R, tg.t, tg.lam)
    J = torch.func.jacfwd(residual)(torch.zeros((K, 7)))  # (E,7,K,7)
    for e, (i, j) in enumerate(zip(n(tg.e_i), n(tg.e_j))):
        np.testing.assert_allclose(n(J[e, :, i]), n(J_i[e]), atol=JACFWD_ATOL, err_msg=f"edge {e} J_i")
        np.testing.assert_allclose(n(J[e, :, j]), n(J_j[e]), atol=JACFWD_ATOL, err_msg=f"edge {e} J_j")
    for k, (a, b) in enumerate(zip((r0, J_i, J_j), jpg._sim3_edge_blocks(g, g.R, g.t, g.lam))):
        _close(a, b, msg=f"output {k}")
    delta = rng.normal(scale=0.1, size=(K, 7)).astype(np.float32)
    for a, b in zip(pg._apply_sim3_delta(tg.R, tg.t, tg.lam, torch.from_numpy(delta)),
                    jpg._apply_sim3_delta(g.R, g.t, g.lam, jnp.asarray(delta))):
        _close(a, b)


@pytest.mark.parametrize("use_dcs", [True, False])
def test_optimize_sim3_matches_jax(rng, use_dcs):
    g = _random_graph(rng)
    kw = dict(n_iters=8, cg_iters=16, use_dcs=use_dcs)
    _same_solution(pg.optimize_sim3(_port(g), **kw), jpg.optimize_sim3(g, **kw))


def test_sim3_zero_residual_is_fixed_point(rng):
    """A chain graph measured from its own poses is at the optimum."""
    w = rng.normal(0, 0.4, (6, 3)).astype(np.float32)
    R = jnp.asarray(np.asarray(jax.vmap(jlie.so3_exp)(jnp.asarray(w))))
    t = jnp.asarray(rng.normal(0, 1.0, (6, 3)).astype(np.float32))
    g = jpg.sim3_from_keyframe_chain(R, t, jnp.ones(6, bool))
    port = pg.optimize_sim3(_port(g), n_iters=5, cg_iters=10)
    _same_solution(port, jpg.optimize_sim3(g, n_iters=5, cg_iters=10))
    np.testing.assert_allclose(n(port[0]), np.asarray(R), atol=1e-5)
    np.testing.assert_allclose(n(port[1]), np.asarray(t), atol=1e-4)
    np.testing.assert_allclose(n(port[2]), 0.0, atol=1e-5)
    assert float(port[3]) < 1e-8


def test_sim3_closes_scale_drifted_loop():
    """Compounding monocular scale drift around a circle: a loop edge with
    the measured relative scale lets the 7-DoF graph recover the geometry,
    and the per-node log-scales track the drift."""
    K, drift = 24, 0.02
    gt_R, gt_t, est_R, est_t = _drifted_loop(K, drift)
    g = jpg.sim3_from_keyframe_chain(jnp.asarray(est_R), jnp.asarray(est_t), jnp.ones(K, bool))
    R_rel = gt_R[0] @ gt_R[K - 1].T
    t_rel = gt_t[0] - R_rel @ gt_t[K - 1]
    s_m = 1.0 / (1.0 + drift) ** (K - 1)
    g = jpg.sim3_add_edges(g, np.array([0], np.int32), np.array([K - 1], np.int32), R_rel[None],
                           t_rel[None], np.array([np.log(s_m)], np.float32),
                           np.array([50.0], np.float32))
    kw = dict(n_iters=25, cg_iters=32, use_dcs=False)
    port = pg.optimize_sim3(_port(g), **kw)
    _same_solution(port, jpg.optimize_sim3(g, **kw))
    R2, t2, lam2 = (n(a) for a in port[:3])
    s2 = np.exp(lam2)
    C_est = -np.einsum("kji,kj->ki", R2, t2 / s2[:, None])
    C_gt = -np.einsum("kji,kj->ki", gt_R, gt_t)
    C_drift = -np.einsum("kji,kj->ki", est_R, est_t)
    err_before = np.linalg.norm(C_drift - C_gt, axis=-1).max()
    assert np.linalg.norm(C_est - C_gt, axis=-1).max() < 0.35 * err_before
    assert np.corrcoef(lam2, np.log(1.0 + drift) * np.arange(K))[0, 1] > 0.9
