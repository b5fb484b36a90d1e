"""Parity of the port's map bookkeeping (models/map_state.SlamMap), its BA
step (pipeline.ba_step) and the map converter with the JAX package on the
CPU. Both maps receive the same calls with the same NumPy inputs; the BA
problems they pack are solved by each package's own BA step."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import ICL_INTR, n

from visual_slam_tpu.models.map_state import MapConfig as JMapConfig, SlamMap as JSlamMap
from visual_slam_tpu.ops import lie as jlie
from visual_slam_tpu.pipeline import _ba_step as j_ba_step

from visual_slam_tpu_torch import convert
from visual_slam_tpu_torch.config import MapConfig, SlamConfig
from visual_slam_tpu_torch.models import ba
from visual_slam_tpu_torch.models.map_state import SlamMap
from visual_slam_tpu_torch.pipeline import Slam, ba_step

# The BA bars of the online solver's parity tests (tests/test_torch_ba.py):
# the JAX package's own cross-solver bars.
COST_RTOL, R_ATOL, T_ATOL, X_ATOL = 1e-2, 1e-5, 1e-4, 1e-3
MAP_ARRAYS = ("kf_R", "kf_t", "kf_valid", "kf_frame_idx", "kf_scale_meas", "pt_xyz", "pt_valid",
              "pt_views", "obs_cam", "obs_pt", "obs_uv", "obs_depth", "obs_valid")


def assert_maps_equal(tm: SlamMap, jm: JSlamMap, atol=0.0):
    for name in MAP_ARRAYS:
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name), atol=atol, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(tm.pt_desc.view(np.uint32), jm.pt_desc)
    assert (tm.n_kf, tm.n_pt, tm.n_obs) == (jm.n_kf, jm.n_pt, jm.n_obs)
    assert tm.config.max_keyframes == jm.config.max_keyframes
    assert tm.config.max_observations == jm.config.max_observations


def _pose(k, rng, noise):
    """Keyframe k on an arc (0.25 m apart) looking at the landmarks,
    perturbed by `noise` (rad, m)."""
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.01 * k, -0.04 * k, 0.015 * k], jnp.float32)))
    t = np.array([0.25 * k, 0.02 * k, 0.01 * k], np.float32)
    if k and noise:
        dR = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(scale=noise, size=3), jnp.float32)))
        R, t = dR @ R, dR @ t + rng.normal(scale=noise, size=3).astype(np.float32)
    return R.astype(np.float32), t.astype(np.float32)


def build_maps(seed=0, K=6, P=400, capacity=(4, 256, 512), outliers=12):
    """The same call sequence on a JAX and a port SlamMap, past every
    capacity: K keyframes, P landmarks 4-8 m away, each seen by 3-6
    keyframes with 0.5 px noise, `outliers` observations 20 px off, measured
    depth on every other observation. Returns (port map, JAX map, truth X)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P), rng.uniform(4, 8, P)],
                 -1).astype(np.float32)
    desc = rng.integers(0, 2**32, size=(P, 8), dtype=np.uint32)
    kf, pf, of = capacity
    jm = JSlamMap(JMapConfig(max_keyframes=kf, max_points=pf, max_observations=of, track_capacity=256))
    tm = SlamMap(MapConfig(max_keyframes=kf, max_points=pf, max_observations=of, track_capacity=256))
    X0 = X + rng.normal(scale=0.03, size=X.shape).astype(np.float32)
    assert (jm.add_points(X0, desc) == tm.add_points(X0, desc.view(np.int32))).all()
    seen_by = rng.integers(3, 7, P)
    bad_done = 0
    for k in range(K):
        R_true, t_true = _pose(k, rng, 0.0)
        R0, t0 = _pose(k, rng, 0.01)
        assert jm.add_keyframe(R0, t0, 10 * k) == tm.add_keyframe(R0, t0, 10 * k) == k
        ids = np.where(seen_by > k)[0]
        Xc = X[ids] @ R_true.T + t_true
        fx, fy, cx, cy = ICL_INTR
        uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy], -1)
        uv = (uv + rng.normal(scale=0.5, size=uv.shape)).astype(np.float32)
        if k >= 2 and bad_done < outliers:
            uv[: outliers // 4] += 20.0
            bad_done += outliers // 4
        depth = np.where(np.arange(len(ids)) % 2 == 0, Xc[:, 2], 0.0).astype(np.float32)
        d_new = desc[ids] ^ np.uint32(k)
        jm.add_observations(k, ids, uv, d_new, depth=depth)
        tm.add_observations(k, ids, uv, d_new.view(np.int32), depth=depth)
    return tm, jm, X


@pytest.fixture(scope="module")
def maps():
    return build_maps()


def test_kf_scale_meas_matches_jax():
    """The scale-edge measurements recorded at insertion, through two
    doublings of the keyframe capacity."""
    rng = np.random.default_rng(3)
    jm = JSlamMap(JMapConfig(max_keyframes=2))
    tm = SlamMap(MapConfig(max_keyframes=2))
    for k in range(7):
        R, t = _pose(k, rng, 0.02)
        jm.add_keyframe(R, t, k)
        tm.add_keyframe(R, t, k)
    assert tm.config.max_keyframes == 8
    assert (tm.kf_scale_meas[1:7] > 0.1).all()
    for name in ("kf_R", "kf_t", "kf_valid", "kf_frame_idx", "kf_scale_meas"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)


def test_built_maps_match(maps):
    tm, jm, _ = maps
    assert tm.config.max_points == 512 and tm.config.max_keyframes == 8
    assert_maps_equal(tm, jm)


def test_global_snapshot_matches_jax(maps):
    tm, jm, _ = maps
    js, ts = jm.global_snapshot(), tm.global_snapshot("cpu")
    assert ts["n_valid"] == js["n_valid"] == 256
    for k in ("xyz", "uv", "pt_ids", "valid"):
        np.testing.assert_array_equal(n(ts[k]), np.asarray(js[k]), err_msg=k)
    np.testing.assert_array_equal(ts["pt_ids_np"], js["pt_ids_np"])
    np.testing.assert_array_equal(convert.to_jax_desc(ts["desc"]), np.asarray(js["desc"]))


@pytest.mark.parametrize("depth_weight", [0.0, 1.0])
def test_to_ba_problem_matches_jax(maps, depth_weight):
    tm, jm, _ = maps
    jp = jm.to_ba_problem(ICL_INTR, depth_weight=depth_weight)
    tp, meta = tm.to_ba_problem(ICL_INTR, depth_weight=depth_weight, device="cpu")
    for name in ba.BAProblem._fields:
        np.testing.assert_array_equal(n(getattr(tp, name)), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(meta.slot_obs, jm.ba_meta.slot_obs)
    np.testing.assert_array_equal(meta.pt_ids, jm.ba_meta.pt_ids)
    assert (np.asarray(jp.se_w) > 0).sum() == 5


@pytest.fixture(scope="module")
def ba_results(maps):
    """Each package's BA step on its own map's problem, RGB-D and monocular."""
    tm, jm, _ = maps
    out = {}
    for mode, dw in (("mono", 0.0), ("rgbd", 1.0)):
        jp = jm.to_ba_problem(ICL_INTR, depth_weight=dw)
        j_out, j_diag, j_bad = j_ba_step(jp, n_iters=10, cg_iters=12, solver="cg", use_depth=dw > 0)
        tp, meta = tm.to_ba_problem(ICL_INTR, depth_weight=dw, device="cpu")
        res = ba_step(tp, n_iters=10, cg_iters=12, solver="cg", use_depth=dw > 0)
        j_bad = np.unpackbits(np.asarray(j_bad))[: len(meta.slot_obs)].astype(bool)
        out[mode] = (res, meta, j_out, np.asarray(j_diag), j_bad, jm.ba_meta)
    return out


@pytest.mark.parametrize("mode", ["mono", "rgbd"])
def test_ba_step_matches_jax(ba_results, mode):
    """ba_step against _ba_step: costs within COST_RTOL, the optimised R, t
    and X within the online solver's bars, the same bad-observation mask
    (the planted outliers) and blown fraction."""
    res, _, j_out, j_diag, j_bad, _ = ba_results[mode]
    got = np.array([float(res.cost_before), float(res.cost_after), float(res.blown)])
    np.testing.assert_allclose(got[:2], j_diag[:2], rtol=COST_RTOL)
    assert got[1] < 0.2 * got[0]
    np.testing.assert_allclose(n(res.prob.R), np.asarray(j_out.R), atol=R_ATOL)
    np.testing.assert_allclose(n(res.prob.t), np.asarray(j_out.t), atol=T_ATOL)
    np.testing.assert_allclose(n(res.prob.X), np.asarray(j_out.X), atol=X_ATOL)
    np.testing.assert_array_equal(n(res.bad), j_bad)
    assert 0 < j_bad.sum() <= 12
    assert abs(got[2] - j_diag[2]) < 1e-6


@pytest.mark.parametrize("mirrored", [False, True])
def test_mirrored_ba_is_rejected(maps, ba_results, mirrored):
    """A BA result mirrored through the cameras (t -> -t, X -> -X) puts every
    landmark behind its cameras at the same pixels: its masked cost is the
    scale edges' alone and its blown fraction the solved map's, so only the
    `behind` rule keeps it out of the map. The solved map itself applies."""
    res, meta = ba_results["mono"][:2]
    prob = res.prob._replace(t=-res.prob.t, X=-res.prob.X) if mirrored else res.prob
    step = ba_step(prob, n_iters=0, cg_iters=12, solver="cg")
    assert float(step.blown) == float(res.blown) > 0
    assert float(step.behind) == (1.0 if mirrored else 0.0)
    slam = Slam(SlamConfig(), device="cpu")
    slam.map = copy.deepcopy(maps[0])
    kf_t = slam.map.kf_t.copy()
    slam._pending_ba = dict(res=step, meta=meta, kf_id=slam.map.n_kf - 1, scale_gauge=False, age=3)
    slam._consume_pending_ba()
    assert (slam.stats["ba_rejected"], slam.stats["ba_runs"]) == ((1, 0) if mirrored else (0, 1))
    if mirrored:
        np.testing.assert_array_equal(slam.map.kf_t, kf_t)


def _apply_ba(tm, jm, ba_results, mode="rgbd"):
    res, meta, j_out, _, j_bad, j_meta = ba_results[mode]
    # Both maps take the JAX package's result, so the write-back is compared
    # on the same numbers.
    tp = convert.from_jax_ba_problem(
        {f: np.asarray(getattr(j_out, f)) for f in ba.BAProblem._fields}, "cpu")
    jm.update_from_ba(j_out, j_meta)
    tm.update_from_ba(tp, meta)
    return j_bad, meta, j_meta


@pytest.mark.parametrize("op", ["update_from_ba", "prune_obs_from_ba", "compact_observations",
                                "cull_points", "refresh_scale_meas"])
def test_map_updates_match_jax(maps, ba_results, op):
    """The BA write-back and the map's maintenance operations, each applied
    in pipeline order on copies of the two maps, leave equal maps."""
    tm, jm = copy.deepcopy(maps[0]), copy.deepcopy(maps[1])
    j_bad, meta, j_meta = _apply_ba(tm, jm, ba_results)
    if op != "update_from_ba":
        n_j = jm.prune_obs_from_ba(j_bad, j_meta)
        assert tm.prune_obs_from_ba(j_bad, meta) == n_j > 0
        # A replayed mask prunes nothing twice.
        assert tm.prune_obs_from_ba(j_bad, meta) == jm.prune_obs_from_ba(j_bad, j_meta) == 0
    if op == "compact_observations":
        n_obs = tm.n_obs
        for frac in (0.25, 0.0):
            assert tm.compact_observations(frac) == jm.compact_observations(frac)
        assert tm.n_obs == int(tm.obs_valid.sum()) < n_obs
    elif op == "cull_points":
        assert tm.cull_points(4) == jm.cull_points(4) > 0
    elif op == "refresh_scale_meas":
        before = tm.kf_scale_meas.copy()
        for m in (tm, jm):
            m.kf_t[:m.n_kf] *= np.float32(0.7)  # a gauge change
            m.refresh_scale_meas()
        assert not np.allclose(tm.kf_scale_meas[1:6], before[1:6], rtol=0.1)
    assert_maps_equal(tm, jm)


def test_from_jax_map_round_trips(maps):
    """convert.from_jax_map copies every array (descriptors by bit view) and
    the result packs the same BA problem; to_jax_map_arrays inverts it."""
    _, jm, _ = maps
    tm = convert.from_jax_map(jm)
    assert_maps_equal(tm, jm)
    back = convert.to_jax_map_arrays(tm)
    for name in MAP_ARRAYS + ("pt_desc",):
        np.testing.assert_array_equal(back[name], getattr(jm, name), err_msg=name)
        assert back[name].dtype == getattr(jm, name).dtype
    assert (back["n_kf"], back["n_pt"], back["n_obs"]) == (jm.n_kf, jm.n_pt, jm.n_obs)
    tp, _ = tm.to_ba_problem(ICL_INTR, device="cpu")
    jp = jm.to_ba_problem(ICL_INTR)
    np.testing.assert_array_equal(n(tp.uv), np.asarray(jp.uv))
    with pytest.raises(TypeError):
        jm2 = copy.deepcopy(jm)
        jm2.pt_desc = jm2.pt_desc.view(np.int32)
        convert.from_jax_map(jm2)
