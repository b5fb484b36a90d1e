"""The port's entry module (visual_slam_tpu_torch/entry.py) against the JAX
package's __graft_entry__.py, on the CPU.

The JAX step's front-end is `extract_fused`, the XLA conv/gather route,
which the port does not have; inside these tests only it is replaced by
`extract_pallas`, the JAX production route the port's kernels mirror (Pallas
in interpret mode). RANSAC's minimal sets are drawn in JAX from the step's
key and injected into the port.

Tolerances, each the bar of the module's own parity test: the front-end as
tests/test_torch_frontend.py (uv and valid equal, score rtol 1e-5, at least
99.5% of descriptor bits); matching exact; the step's R and t 1e-4; the
dry run's chain pose graph as tests/test_torch_sharded.py (t 1e-4, R 1e-5)
and its Sim3 graph as tests/test_torch_pose_graph.py (R, t and log-scales
1e-4); its bundle adjustments as below.

entry()'s own step is degenerate: its snapshot descriptors are random, so
no match passes the ratio test, both packages fall back to RANSAC on an
empty set, and every hypothesis is the DLT of the first six snapshot points.
That 6-point float32 Gram matrix has its two smallest eigenvalues ~1e-5 and
~3e-3 apart, so float32 eigensolvers disagree on its null vector: the JAX
step lands 3.4e-4 from the float64 solve of the same set. There the port is
held to the float64 solve at 1e-4 and to no more than JAX's own distance
from it; the 1e-4 bar against JAX is held on the same frame tracked against
a snapshot of its own features (entry.matched_snapshot), where the
prior-seeded GN decides the pose.

The dry run's bundle adjustment is degenerate too: its four cameras sit
within 2 cm of the origin with identity rotations, so no baseline fixes the
landmarks' depths and one fixed camera leaves the scale free. Two float32
LM iterations there move by more than the sharded bars under a 1e-7
relative change of the input: the port's R by 3e-3, t by 4e-2, X by 10.
So the BA and large-map solves are held to the port's unsharded solve bit
for bit (a world of one rank), to a cost below the starting cost, and to
JAX's output within SPREAD_FACTOR x the port's own spread: the farthest
the same solve moves when the translations are scaled by 1 + k PERTURB, k =
+-1 .. +-PERTURB_STEPS, as chip_smoke.py's phase 22 holds config #5's
landmarks.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from torch_parity import desc_bits, n, t

from visual_slam_tpu.models import frontend as jfrontend
from visual_slam_tpu.models import pose_graph as jpg
from visual_slam_tpu.ops import match as jmatch
from visual_slam_tpu.ops import ransac as jransac
from visual_slam_tpu.parallel import sharded_ba as jsharded_ba
from visual_slam_tpu.parallel import sharded_pg as jsharded_pg

from visual_slam_tpu_torch import convert, entry
from visual_slam_tpu_torch.models import ba, ba_large, frontend
from visual_slam_tpu_torch.models import pose_graph as pg
from visual_slam_tpu_torch.ops import match

SCORE_RTOL, MIN_DESC_BIT_AGREEMENT = 1e-5, 0.995
STEP_ATOL = 1e-4
CHAIN_T_ATOL, CHAIN_R_ATOL = 1e-4, 1e-5
SIM3_ATOL = 1e-4
PERTURB, PERTURB_STEPS, SPREAD_FACTOR = 1e-7, 4, 2.0


def _np_tree(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


# ------------------------------------------------------------------ the step


def test_entry_arrays_equal_jax():
    """entry(device="cpu")'s arguments hold the JAX entry's bits; the key's
    place is taken by a CPU generator seeded 0."""
    _, jargs = graft.entry()
    _, targs = entry.entry(device="cpu")
    *tensors, gen = targs
    for i, (a, b) in enumerate(zip(tensors, jargs[:7])):
        b = np.asarray(b)
        a = n(a).view(np.uint32) if b.dtype == np.uint32 else n(a)
        assert a.dtype == b.dtype and np.array_equal(a, b), i
    assert gen.device.type == "cpu" and gen.initial_seed() == 0


def _dlt64(X, xn):
    """ops/pnp.pnp_dlt in float64 NumPy: the null vector of the row-
    normalised DLT system by SVD, the majority-depth sign, R projected onto
    SO(3), t over the mean singular value."""
    Xh = np.concatenate([X, np.ones((len(X), 1))], 1)
    z = np.zeros_like(Xh)
    A = np.concatenate([np.concatenate([Xh, z, -xn[:, :1] * Xh], 1),
                        np.concatenate([z, Xh, -xn[:, 1:] * Xh], 1)])
    A = A / np.linalg.norm(A, axis=1, keepdims=True)
    P = np.linalg.svd(A)[2][-1].reshape(3, 4)
    P = P * np.sign(np.sum(np.sign(Xh @ P[2])) + 0.5)
    U, s, Vt = np.linalg.svd(P[:, :3])
    R = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
    return R, P[:, 3] / s.mean()


@pytest.fixture(scope="module")
def steps():
    """{case: (JAX features, JAX (idx2, good), JAX (R, t, n_in), port
    features, port (idx2, good), port (R, t, n_in), the snapshot)} for
    entry()'s own arguments and for its frame against a snapshot of its own
    features, each with the JAX step's minimal sets injected."""
    fn, jargs = graft.entry()
    gray, snap_desc, snap_xyz, snap_valid, prev_R, prev_t, intr, key = jargs
    torch.set_num_threads(1)
    jf = jfrontend.extract_pallas(gray, max_features=entry.STEP_FEATURES)
    tf = frontend.extract(t(gray), max_features=entry.STEP_FEATURES)
    out = {}
    own = tuple(n(a).view(np.uint32) if a.dtype == torch.int32 else n(a)
                for a in entry.matched_snapshot(tf, t(intr)))
    for case, snap in (("entry", (snap_desc, snap_xyz, snap_valid)), ("matched", own)):
        sd, sx, sv = (jnp.asarray(a) for a in snap)
        jm = jmatch.match_ratio_test(sd, jf.desc, sv, jf.valid)[::2]
        sets = np.asarray(jransac.sample_minimal_sets(key, entry.STEP_HYPS, 6, len(sv), jm[1]))
        with pytest.MonkeyPatch.context() as mp:  # the kernel route, in this test only
            mp.setattr(jfrontend, "extract_fused", jfrontend.extract_pallas)
            jo = fn(gray, sd, sx, sv, prev_R, prev_t, intr, key)
        sd_t = convert.from_jax_desc(np.asarray(sd), "cpu")
        tm = match.match_ratio_test(sd_t, tf.desc, t(sv), tf.valid)[::2]
        to = entry.track_step(t(gray), sd_t, t(sx), t(sv), t(prev_R), t(prev_t), t(intr),
                              torch.Generator().manual_seed(0), idx=t(sets))
        out[case] = (jf, [np.asarray(a) for a in jm], [np.asarray(a) for a in jo], tf,
                     [n(a) for a in tm], [n(a) for a in to], (np.asarray(sx), sets))
    return out


def test_entry_front_end_matches_jax(steps):
    jf, _, _, tf, _, _, _ = steps["entry"]
    np.testing.assert_array_equal(n(tf.uv), np.asarray(jf.uv))
    np.testing.assert_array_equal(n(tf.valid), np.asarray(jf.valid))
    np.testing.assert_allclose(n(tf.score), np.asarray(jf.score), rtol=SCORE_RTOL, atol=0)
    v = np.asarray(jf.valid)
    agree = desc_bits(convert.to_jax_desc(tf.desc))[v] == desc_bits(np.asarray(jf.desc))[v]
    assert v.sum() > 400 and agree.mean() >= MIN_DESC_BIT_AGREEMENT


@pytest.mark.parametrize("case", ["entry", "matched"])
def test_entry_step_matches_jax(steps, case):
    """idx2 and good equal, n_in equal; R and t within 1e-4 of JAX's on the
    matched snapshot, and of the float64 solve on entry()'s own (see the
    module's docstring)."""
    _, jm, (jR, jt, jn), tf, tm, (R, t_, n_in), (xyz, sets) = steps[case]
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)
    assert int(n_in) == int(jn)
    if case == "matched":
        assert int(jn) > 400
        np.testing.assert_allclose(R, jR, atol=STEP_ATOL)
        np.testing.assert_allclose(t_, jt, atol=STEP_ATOL)
        return
    assert not jm[1].any() and int(jn) == 0 and (sets == np.arange(6)).all()
    uv = n(tf.uv)[tm[0][:6]].astype(np.float64)
    intr = np.asarray(entry.ICL_INTR, np.float64)
    R64, t64 = _dlt64(xyz[:6].astype(np.float64), (uv - intr[2:]) / intr[:2])
    port_err = max(np.abs(R - R64).max(), np.abs(t_ - t64).max())
    jax_err = max(np.abs(jR - R64).max(), np.abs(jt - t64).max())
    assert port_err <= STEP_ATOL and port_err <= max(jax_err, 1e-5), (port_err, jax_err)


# ------------------------------------------------------------------ the dry run


@pytest.fixture(scope="module")
def dry():
    """JAX's dryrun_multichip(1): the problems it hands its solvers and what
    they return, captured by wrapping them; and the port's
    dryrun_multichip(1, "cpu") on a gloo world of one."""
    mp = pytest.MonkeyPatch()
    handed, returned = {}, []

    def capture(name, fn, arg=0):
        def wrapped(*a, **k):
            handed[name] = a[arg]
            return fn(*a, **k)
        return wrapped

    real_bur, real_put = jax.block_until_ready, jax.device_put
    mp.setattr(jsharded_ba, "optimize_sharded", capture("ba", jsharded_ba.optimize_sharded))
    mp.setattr(jsharded_ba, "optimize_large_sharded",
               capture("large", jsharded_ba.optimize_large_sharded))
    mp.setattr(jsharded_pg, "optimize_sharded", capture("pg", jsharded_pg.optimize_sharded))
    mp.setattr(jpg, "optimize_sim3", capture("sim3", jpg.optimize_sim3))
    mp.setattr(jax, "device_put", capture("imgs", real_put))
    mp.setattr(jax, "block_until_ready", lambda x: returned.append(real_bur(x)) or x)
    try:
        graft.dryrun_multichip(1)
    finally:
        mp.undo()
    torch.set_num_threads(1)
    ours, = entry.dryrun_multichip(1, device="cpu")
    jax_out = dict(zip(("ba", "large", "frontend", "pg", "sim3"), returned))
    return handed, jax_out, ours


def test_dryrun_problems_equal_jax(dry):
    """The problems the port's dry run builds hold the bits of those JAX's
    dryrun_multichip(1) hands its solvers."""
    handed, _, _ = dry
    probs = entry.dryrun_problems(1)
    port_ba, _ = ba.make_problem(**probs["ba"], device="cpu")
    for name in ("ba", "large"):
        want = _np_tree(handed[name])
        for f in port_ba._fields:
            np.testing.assert_array_equal(n(getattr(port_ba, f)), want[f], err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(probs["imgs"], np.asarray(handed["imgs"]))
    R, t_, valid = (torch.from_numpy(probs["chain"][k]) for k in ("R", "t", "valid"))
    graphs = {"pg": pg.from_keyframe_chain(R, t_, valid),
              "sim3": pg.sim3_add_edges(pg.sim3_from_keyframe_chain(R, t_, valid), **probs["loop"])}
    for name, g in graphs.items():
        want = _np_tree(handed[name])
        for f in g._fields:
            np.testing.assert_array_equal(n(getattr(g, f)), want[f].astype(n(getattr(g, f)).dtype),
                                          err_msg=f"{name}.{f}")


@pytest.mark.parametrize("solve", ["ba", "large", "frontend", "pg", "sim3"])
def test_dryrun_matches_jax(dry, solve):
    """Each of the port's five dry-run solves against JAX's on the same
    problem, at the module's bars."""
    _, jo, ours = dry
    if solve in ("ba", "large"):
        p, _ = ba.make_problem(**entry.dryrun_problems(1)["ba"], device="cpu")
        fn = ba.optimize if solve == "ba" else ba_large.optimize
        torch.set_num_threads(1)

        def run(prob):
            out, cost = fn(prob, n_iters=entry.DRY_ITERS, cg_iters=entry.DRY_CG)
            return dict(R=n(out.R), t=n(out.t), X=n(out.X), cost=n(cost))

        base = run(p)
        moved = [run(p._replace(t=p.t * (1 + s * k * PERTURB))) for k in range(1, PERTURB_STEPS + 1)
                 for s in (1, -1)]
        spread = {k: max(np.abs(m[k] - v).max() for m in moved) for k, v in base.items()}
        out, cost = jo[solve]
        want = dict(R=np.asarray(out.R), t=np.asarray(out.t), X=np.asarray(out.X), cost=np.asarray(cost))
        start = float(ba._cost(p))
        for k in base:
            assert np.array_equal(ours[f"{solve}_{k}"], base[k]), k
            gap = np.abs(ours[f"{solve}_{k}"] - want[k]).max()
            assert gap <= SPREAD_FACTOR * spread[k], (k, gap, spread[k])
        assert float(base["cost"]) < start and float(want["cost"]) < start
    elif solve == "frontend":
        f = jo["frontend"]
        np.testing.assert_array_equal(ours["fe_uv"], np.asarray(f.uv))
        np.testing.assert_array_equal(ours["fe_valid"], np.asarray(f.valid))
        np.testing.assert_allclose(ours["fe_score"], np.asarray(f.score), rtol=SCORE_RTOL, atol=0)
        v = np.asarray(f.valid)
        agree = desc_bits(ours["fe_desc"][0].view(np.uint32))[v[0]] == desc_bits(
            np.asarray(f.desc)[0])[v[0]]
        assert v.sum() > 20 and agree.mean() >= MIN_DESC_BIT_AGREEMENT
    elif solve == "pg":
        R, t_, _ = jo["pg"]
        np.testing.assert_allclose(ours["pg_t"], np.asarray(t_), atol=CHAIN_T_ATOL)
        np.testing.assert_allclose(ours["pg_R"], np.asarray(R), atol=CHAIN_R_ATOL)
    else:
        R, t_, lam, _ = jo["sim3"]
        for k, want in (("sim3_R", R), ("sim3_t", t_), ("sim3_lam", lam)):
            np.testing.assert_allclose(ours[k], np.asarray(want), atol=SIM3_ATOL, err_msg=k)


def test_dryrun_two_gloo_ranks_agree():
    """dryrun_multichip(2, "cpu"): a fleet of two gloo ranks completes, both
    ranks hold the same bits of every replicated result, each rank's
    landmark block and frame sit at its offset, and its features are its
    frame's own (`extract` on that frame)."""
    ranks = entry.dryrun_multichip(2, device="cpu")
    assert len(ranks) == 2
    for k in entry.REPLICATED:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    imgs = entry.dryrun_problems(2)["imgs"]
    torch.set_num_threads(1)
    for r, res in enumerate(ranks):
        assert res["ba_X"].shape == res["large_X"].shape == (32, 3)
        f = frontend.extract(t(imgs[r]), entry.DRY_FEATURES)
        np.testing.assert_array_equal(res["fe_uv"][0], n(f.uv))
        np.testing.assert_array_equal(res["fe_desc"][0], n(f.desc))


def test_dryrun_multihost_gloo():
    """dryrun_multihost(2, 1, "cpu"): two rank processes form the (hosts,
    ranks a host) groups (one machine: one host of two ranks) and solve the
    multi-process test's BA; both ranks hold the same R, t and cost, and
    their landmark blocks tile the problem."""
    ranks = entry.dryrun_multihost(2, 1, device="cpu")
    assert [(int(r["host_ranks"]), int(r["cross_ranks"])) for r in ranks] == [(2, 1), (2, 1)]
    for k in ("R", "t", "cost"):
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    assert [int(r["shard_start"]) for r in ranks] == [0, ranks[0]["X"].shape[0]]
