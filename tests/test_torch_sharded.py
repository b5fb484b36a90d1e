"""The port's sharded solvers on torch.distributed (parallel/), on the CPU.

Two gloo fleets, of 2 and of 4 ranks, are spawned once for the module
through multihost.spawn_worker_fleet; each rank imports only the port and
runs every job of the module's job file (parallel/worker.py). The JAX
package's sharded solvers run in the test process on meshes of the same
sizes over the suite's 8 virtual CPU devices. Problems are built here from
seeds with the JAX tests' helpers and handed to the ranks as npz files.

Stated tolerances are the JAX tests' own between a sharded and an
unsharded solve: tests/test_parallel.py:16-31 for `optimize_sharded` (R
1e-4, t 1e-3 after aligning the monocular scale, cost rtol 1e-3 with a
1e-6 floor), tests/test_ba_large.py:33-45 for `optimize_large_sharded`
(cost 1e-2 relative, t 1e-3, X 1e-3), tests/test_pose_graph.py:203-245 for
the pose graph (5k graph: t 2e-3, R 2e-4, cost 1e-3 relative; the odd
9-edge chain: t 1e-4, R 1e-5) and tests/test_multihost.py:27-60 for the
two-process fleet (R, t 2e-5, cost 1e-2 relative, X 2e-4). A world of one
rank is the unsharded solve bit for bit.
"""
import concurrent.futures
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_ba import _synth_with_depth, synth_problem
from test_pose_graph import make_chain

from visual_slam_tpu.models import ba as jba
from visual_slam_tpu.models import pose_graph as jpg
from visual_slam_tpu.parallel import mesh as jmesh
from visual_slam_tpu.parallel import sharded_ba as jsharded_ba
from visual_slam_tpu.parallel import sharded_pg as jsharded_pg

from visual_slam_tpu_torch import convert, multi
from visual_slam_tpu_torch.models import ba, ba_large, pose_graph
from visual_slam_tpu_torch.parallel import mesh, multihost, sharded_ba, sharded_pg
from visual_slam_tpu_torch.utils import synthetic
from visual_slam_tpu_torch.utils.dataset import WindowView
from visual_slam_tpu_torch.utils.scene import FrameSequence, SyntheticRGBDScene

from test_torch_slam import HALF_INTR, _configs

WORLDS = (2, 4)
BA_R_ATOL, BA_T_ATOL, BA_COST_RTOL, BA_COST_ATOL = 1e-4, 1e-3, 1e-3, 1e-6
LARGE_COST_RTOL, LARGE_T_ATOL, LARGE_X_ATOL = 1e-2, 1e-3, 1e-3
PG5K_T_ATOL, PG5K_R_ATOL, PG5K_COST_RTOL = 2e-3, 2e-4, 1e-3
CHAIN_T_ATOL, CHAIN_R_ATOL = 1e-4, 1e-5
MH_POSE_ATOL, MH_COST_RTOL, MH_X_ATOL = 2e-5, 1e-2, 2e-4
WORKER = ["-m", "visual_slam_tpu_torch.parallel.worker", "--backend", "gloo", "--device", "cpu"]


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _edged(rng):
    """The arc with scale edges along the chain (weight 1e3, the true
    ||t_rel||) and cameras 0 and 1 fixed: a scale-edge block or a gauge mask
    added on every rank in place of once shows as a factor of the world."""
    jp, (R_gt, t_gt, _) = synth_problem(rng, K=6, P=300, noise_px=0.3, pose_noise=0.03,
                                        point_noise=0.05)
    K = jp.R.shape[0]
    i, j = np.arange(K - 1), np.arange(1, K)
    t_rel = t_gt[i] - np.einsum("eab,ecb,ec->ea", R_gt[i], R_gt[j], t_gt[j])
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    return jp._replace(se_i=jnp.asarray(i, jnp.int32), se_j=jnp.asarray(j, jnp.int32),
                       se_meas=jnp.asarray(np.linalg.norm(t_rel, axis=-1), jnp.float32),
                       se_w=jnp.full(K - 1, 1e3, jnp.float32), cam_fixed=jnp.asarray(fixed))


def _big_graph():
    """make_big_graph(5000)'s graph, built by the port's vectorised copy
    (utils/synthetic.big_pose_graph: the same draws) and carried to JAX."""
    g, _ = synthetic.big_pose_graph(5000, device="cpu")
    return jpg.PoseGraph(**{k: jnp.asarray(getattr(g, k).numpy()) for k in g._fields})


def _chain9():
    """The odd graph of test_sharded_pose_graph_identity_small: 10
    keyframes, 9 chain edges (not a multiple of 4)."""
    K = 10
    R_gt, t_gt, R0, t0 = make_chain(np.random.default_rng(0), K)
    return jpg.from_keyframe_chain(jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.ones(K, bool))._replace(
        R=jnp.asarray(R0), t=jnp.asarray(t0))


# name -> (kind, the JAX problem's maker, solver options, mono scale alignment)
CASES = {
    "chol": ("ba", lambda: synth_problem(np.random.default_rng(0), K=5, P=200, pose_noise=0.02,
                                         point_noise=0.03)[0], dict(n_iters=6), True),
    "cg": ("ba", lambda: synth_problem(np.random.default_rng(0), K=5, P=200, pose_noise=0.02,
                                       point_noise=0.03)[0],
           dict(n_iters=6, cg_iters=24, solver="cg"), True),
    "depth": ("ba", lambda: _synth_with_depth(np.random.default_rng(0))[0],
              dict(n_iters=8, use_depth=True), False),
    "edged_chol": ("ba", lambda: _edged(np.random.default_rng(0)), dict(n_iters=6), False),
    "edged_cg": ("ba", lambda: _edged(np.random.default_rng(0)),
                 dict(n_iters=6, cg_iters=24, solver="cg"), False),
    "large": ("large", lambda: synth_problem(np.random.default_rng(0), K=6, P=256, noise_px=0.3,
                                             pose_noise=0.03, point_noise=0.05)[0],
              dict(n_iters=6, cg_iters=8), False),
    "edged_large": ("large", lambda: _edged(np.random.default_rng(0)), dict(n_iters=6, cg_iters=8),
                    False),
    "pg5k": ("pg", _big_graph, dict(n_iters=6, cg_iters=32), False),
    "chain9": ("pg", _chain9, dict(n_iters=10), False),
}


@functools.cache
def _problem(name):
    """Case `name`'s JAX problem and its arrays, built once."""
    jp = CASES[name][1]()
    return jp, _np(jp)


def _jax_sharded(kind, jp, opts, world):
    m = jmesh.make_mesh(world, "shard")
    if kind == "ba":
        out, cost = jsharded_ba.optimize_sharded(jp, m, **opts)
    elif kind == "large":
        out, cost = jsharded_ba.optimize_large_sharded(jp, m, **opts)
    else:
        R, t, cost = jsharded_pg.optimize_sharded(jp, m, **opts)
        return dict(R=np.asarray(R), t=np.asarray(t), cost=float(cost))
    return dict(R=np.asarray(out.R), t=np.asarray(out.t), X=np.asarray(out.X), cost=float(cost))


def _port_unsharded(kind, arrays, opts):
    if kind == "pg":
        R, t, cost = pose_graph.optimize(convert.from_jax_pose_graph(arrays, "cpu"), **opts)
        return dict(R=R.numpy(), t=t.numpy(), cost=float(cost))
    p = convert.from_jax_ba_problem(arrays, "cpu")
    out, cost = (ba.optimize if kind == "ba" else ba_large.optimize)(p, **opts)
    return dict(R=out.R.numpy(), t=out.t.numpy(), X=out.X.numpy(), cost=float(cost))


def _read_fleet(out_dir, name, world):
    ranks = [dict(np.load(os.path.join(out_dir, f"{name}.r{r}.npz"))) for r in range(world)]
    res = dict(R=ranks[0]["R"], t=ranks[0]["t"], cost=float(ranks[0]["cost"]), ranks=ranks)
    if "X" in ranks[0]:
        res["X"] = np.concatenate([r["X"] for r in ranks])
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: {case: (fleet, JAX sharded, port unsharded)}}, plus the
    multihost job of the 2-rank fleet under "multihost"."""
    root = tmp_path_factory.mktemp("sharded")
    jobs = []
    for name, (kind, _, opts, _) in CASES.items():
        path = str(root / f"{name}.npz")
        np.savez(path, **_problem(name)[1])
        jobs.append(dict(name=name, kind=kind, problem={"npz": path}, opts=opts))
    jobs.append(dict(name="multihost", kind="ba", problem={"synthetic": "multihost"},
                     opts=dict(n_iters=6, cg_iters=8, solver="cg")))
    spec = root / "jobs.json"
    spec.write_text(json.dumps({"jobs": jobs}))
    outs = {w: root / f"world{w}" for w in WORLDS}
    for d in outs.values():
        d.mkdir()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        fleets = {w: pool.submit(multihost.spawn_worker_fleet, w, [*WORKER, str(spec), str(outs[w])])
                  for w in WORLDS}
        torch.set_num_threads(1)
        unsharded = {name: _port_unsharded(kind, _problem(name)[1], opts)
                     for name, (kind, _, opts, _) in CASES.items()}
        jax_sh = {w: {name: _jax_sharded(kind, _problem(name)[0], opts, w)
                      for name, (kind, _, opts, _) in CASES.items()} for w in WORLDS}
        logs = {w: f.result() for w, f in fleets.items()}
    out = {w: {name: (_read_fleet(outs[w], name, w), jax_sh[w][name], unsharded[name])
               for name in CASES} for w in WORLDS}
    out["multihost"] = _read_fleet(outs[2], "multihost", 2)
    out["logs"] = logs
    return out


def _check(got, want, kind, mono, rtol_scale=1.0):
    """Assert `got` matches `want` at the case's bars."""
    if kind == "pg":
        big = got["t"].shape[0] > 100
        t_atol, r_atol = (PG5K_T_ATOL, PG5K_R_ATOL) if big else (CHAIN_T_ATOL, CHAIN_R_ATOL)
        np.testing.assert_allclose(got["t"], want["t"], atol=t_atol)
        np.testing.assert_allclose(got["R"], want["R"], atol=r_atol)
        if big:
            assert abs(got["cost"] - want["cost"]) <= PG5K_COST_RTOL * max(1.0, abs(want["cost"]))
        return
    if kind == "large":
        assert abs(got["cost"] - want["cost"]) < LARGE_COST_RTOL * max(1.0, want["cost"])
        np.testing.assert_allclose(got["t"], want["t"], atol=LARGE_T_ATOL)
        np.testing.assert_allclose(got["X"], want["X"], atol=LARGE_X_ATOL)
        return
    np.testing.assert_allclose(got["R"], want["R"], atol=BA_R_ATOL)
    s = np.linalg.norm(got["t"][1]) / np.linalg.norm(want["t"][1]) if mono else 1.0
    np.testing.assert_allclose(got["t"] / s, want["t"], atol=BA_T_ATOL)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=BA_COST_RTOL, atol=BA_COST_ATOL)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax_sharded(runs, world, name):
    """The port's fleet of `world` gloo ranks against the JAX package's
    sharded solver on a mesh of `world` virtual devices."""
    fleet, jax_sharded, _ = runs[world][name]
    kind, _, _, mono = CASES[name]
    _check(fleet, jax_sharded, kind, mono)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_unsharded(runs, world, name):
    """The port's fleet against the port's own unsharded solve."""
    fleet, _, unsharded = runs[world][name]
    kind, _, _, mono = CASES[name]
    _check(fleet, unsharded, kind, mono)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree_and_each_plans_its_own_slots(runs, world):
    """Every rank ends on the same poses and cost, bit for bit (the LM and
    GN decisions are taken on a summed cost), and each rank's X block sits
    at its rank's offset; every rank all-reduced the same bytes, and its
    profiled solve recorded a span for each of its all-reduces."""
    for name in CASES:
        ranks = runs[world][name][0]["ranks"]
        for r in ranks[1:]:
            assert np.array_equal(r["R"], ranks[0]["R"]) and np.array_equal(r["t"], ranks[0]["t"])
            assert r["cost"] == ranks[0]["cost"]
            assert r["allreduce_bytes"] == ranks[0]["allreduce_bytes"] > 0
        for r in ranks:  # the profiled solve saw each all-reduce
            assert r["allreduce_spans"] == r["allreduce_calls"] and r["allreduce_ms"] > 0
        if "X" in ranks[0]:
            per = ranks[0]["X"].shape[0]
            assert [int(r["shard_start"]) for r in ranks] == [k * per for k in range(world)]


def test_multihost_fleet_matches_single_process(runs):
    """The two-process fleet on the multi-process test's problem against the
    single-process solvers of both packages (tests/test_multihost.py's
    bars)."""
    got = runs["multihost"]
    assert [int(r["world"]) for r in got["ranks"]] == [2, 2]
    ours, our_cost = ba.optimize(synthetic.multihost_problem(device="cpu"), n_iters=6, cg_iters=8,
                                 solver="cg")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "mh_worker", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "scripts", "multihost_ba_worker.py"))
    mh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mh)
    jref, jcost = jba.optimize(mh.synthetic_problem(), n_iters=6, cg_iters=8, solver="cg")
    for R, t, X, cost in ((ours.R.numpy(), ours.t.numpy(), ours.X.numpy(), float(our_cost)),
                          (np.asarray(jref.R), np.asarray(jref.t), np.asarray(jref.X),
                           float(jcost))):
        np.testing.assert_allclose(got["R"], R, atol=MH_POSE_ATOL)
        np.testing.assert_allclose(got["t"], t, atol=MH_POSE_ATOL)
        assert abs(got["cost"] - cost) < MH_COST_RTOL * max(1.0, cost)
        for r in got["ranks"]:
            s, n = int(r["shard_start"]), r["X"].shape[0]
            np.testing.assert_allclose(r["X"], X[s:s + n], atol=MH_X_ATOL)


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo process group of one rank in the test process."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{multihost.free_port()}",
                            world_size=1, rank=0)
    try:
        yield mesh.make_group(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["chol", "cg", "depth", "edged_cg", "edged_large", "pg5k"])
def test_world_of_one_is_the_unsharded_solve(world_of_one, name):
    """One rank: the sharded entry points are the unsharded solves, bit for
    bit (phase 22(a) of chip_smoke.py holds the same on the card over
    NCCL)."""
    kind, _, opts, _ = CASES[name]
    arrays = _problem(name)[1]
    torch.set_num_threads(1)
    want = _port_unsharded(kind, arrays, opts)
    if kind == "pg":
        R, t, cost = sharded_pg.optimize_sharded(convert.from_jax_pose_graph(arrays, "cpu"),
                                                 world_of_one, **opts)
        got = dict(R=R.numpy(), t=t.numpy(), cost=float(cost))
    else:
        fn = sharded_ba.optimize_sharded if kind == "ba" else sharded_ba.optimize_large_sharded
        out, cost = fn(convert.from_jax_ba_problem(arrays, "cpu"), world_of_one, **opts)
        got = dict(R=out.R.numpy(), t=out.t.numpy(), X=out.X.numpy(), cost=float(cost))
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_group_helpers_in_a_world_of_one(world_of_one):
    """make_global_problem / gather_shards cut and label the whole problem;
    the host grid of one rank is one host of one rank."""
    p = convert.from_jax_ba_problem(_problem("chol")[1], "cpu")
    local = multihost.make_global_problem(p, multihost.global_group())
    for f in p._fields:
        assert torch.equal(getattr(local, f), getattr(p, f)), f
    ((rows,), data), = multihost.gather_shards(local.X, world_of_one)
    assert (rows.start, rows.stop) == (0, p.X.shape[0]) and np.array_equal(data, p.X.numpy())
    host, cross = multihost.host_device_groups()
    assert dist.get_world_size(host) == dist.get_world_size(cross) == 1


def test_shard_problem_blocks_and_divisibility():
    """The rank blocks tile the landmarks and their slots in order, the
    camera side stays whole, and a landmark count the world does not divide
    raises the JAX package's error."""
    p = convert.from_jax_ba_problem(_problem("edged_chol")[1], "cpu")
    blocks = [sharded_ba.shard_problem(p, r, 4) for r in range(4)]
    for f in ("X", "pt_valid", "cam", "w", "dinv", "dw"):
        assert torch.equal(torch.cat([getattr(b, f) for b in blocks]), getattr(p, f)), f
    assert torch.equal(torch.cat([b.uv for b in blocks], dim=1), p.uv)
    for f in ("R", "t", "intr", "cam_fixed", "se_i", "se_j", "se_meas", "se_w"):
        assert all(getattr(b, f) is getattr(p, f) for b in blocks), f
    with pytest.raises(ValueError, match="landmark count 512 not divisible by world size 3"):
        sharded_ba.shard_problem(p, 0, 3)
    with pytest.raises(ValueError, match="landmark count 512 not divisible by mesh size 3"):
        jsharded_ba.optimize_sharded(_problem("edged_chol")[0], jmesh.make_mesh(3, "p"))


def test_pad_edges_matches_jax():
    """pad_edges on the odd 9-edge chain at 4 ranks equals the JAX
    package's, and the padded graph solves as the unpadded one."""
    jg, arrays = _problem("chain9")
    ours = sharded_pg.pad_edges(convert.from_jax_pose_graph(arrays, "cpu"), 4)
    theirs = jsharded_pg.pad_edges(jg, 4)
    for f in ours._fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(theirs, f)), f)
    assert ours.e_i.shape[0] == 12 and ours.s_i.shape[0] == 12
    torch.set_num_threads(1)
    R0, t0, c0 = pose_graph.optimize(convert.from_jax_pose_graph(arrays, "cpu"), n_iters=10)
    R1, t1, c1 = pose_graph.optimize(ours, n_iters=10)
    np.testing.assert_allclose(t1.numpy(), t0.numpy(), atol=CHAIN_T_ATOL)
    np.testing.assert_allclose(R1.numpy(), R0.numpy(), atol=CHAIN_R_ATOL)


def test_allreduce_without_a_group_is_the_tensor():
    """group=None: _allreduce returns its argument and counts nothing."""
    x = torch.arange(6.0)
    calls, nbytes = ba.allreduce_calls, ba.allreduce_bytes
    assert ba._allreduce(x, None) is x
    assert (ba.allreduce_calls, ba.allreduce_bytes) == (calls, nbytes)


def test_initialize_from_env():
    """Without the VSLAM_* variables it is a no-op that returns 0; the
    backend is named, never guessed."""
    env = {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("VSLAM_")}
    try:
        assert multihost.initialize_from_env("gloo") == 0
        with pytest.raises(ValueError, match="backend"):
            multihost.initialize_from_env("auto")
    finally:
        os.environ.update(env)


def test_pad_to_multiple_matches_jax():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    for m, axis in ((4, 0), (3, 1), (5, 0)):
        np.testing.assert_array_equal(mesh.pad_to_multiple(x, m, axis, fill=-1),
                                      jmesh.pad_to_multiple(x, m, axis, fill=-1))


def test_run_batched_over_devices_equals_one_device():
    """run_batched(devices=["cpu", "cpu"]) over 3 RGB-D windows (the stack
    padded to 4 and cut in two) equals devices=None bit for bit, through a
    keyframe BA, and records 2 front-end devices."""
    scene = SyntheticRGBDScene(50, 240, 320, intrinsics=HALF_INTR)
    base = FrameSequence(list(scene.frames()), scene.ground_truth())
    views = [WindowView(base, 0, length=26), WindowView(base, 20, length=26, reverse=True),
             WindowView(base, 10, length=26)]
    _, cfg = _configs(True)
    torch.set_num_threads(1)
    one = multi.run_batched(views, cfg, device="cpu")
    two = multi.run_batched(views, cfg, devices=["cpu", "cpu"])
    for a, b in zip(one, two):
        assert a.stats["frontend_devices"] == 1 and b.stats["frontend_devices"] == 2
        assert [(f.frame_idx, f.is_keyframe) for f in a.trajectory] == [
            (f.frame_idx, f.is_keyframe) for f in b.trajectory]
        for fa, fb in zip(a.trajectory, b.trajectory):
            assert np.array_equal(fa.R_cw, fb.R_cw) and np.array_equal(fa.t_cw, fb.t_cw)
        assert np.array_equal(a.map.pt_xyz, b.map.pt_xyz)
    assert all(s.stats["ba_runs"] >= 1 for s in one)
