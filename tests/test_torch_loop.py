"""The port's loop closure (visual_slam_tpu_torch/models/loop_closure.py and
the Slam side of pipeline.py) against the JAX package's on the CPU: the
scenes of tests/test_loop_closure.py and every case of
tests/test_loop_operating_point.py, on the same inputs made with NumPy from
a seed.

Tolerances: keyframe scores, candidates, anchors and every decision and
counter exact (integers and host NumPy); NumPy corrections of equal maps
bit-equal; a closure's corrected keyframe poses and landmarks 1e-4 (the
pose graph's float32 sums in another order, tests/test_torch_pose_graph.py);
in the records of accepted and rejected closures, integers equal and the
rounded blown fractions and edge residuals within 2e-3 (a value on a
rounding boundary may round apart on the two sides)."""
import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n

from test_loop_operating_point import RingScene as JRingScene
from visual_slam_tpu import pipeline as jpl
from visual_slam_tpu.config import SlamConfig as JSlamConfig
from visual_slam_tpu.models import loop_closure as jlc
from visual_slam_tpu.models import pose_graph as jpg
from visual_slam_tpu.models.map_state import MapConfig as JMapConfig, SlamMap as JSlamMap
from visual_slam_tpu.ops import lie as jlie

from visual_slam_tpu_torch import convert
from visual_slam_tpu_torch.config import MapConfig, SlamConfig, size_config_for
from visual_slam_tpu_torch.models import loop_closure as lc
from visual_slam_tpu_torch.models import pose_graph as pg
from visual_slam_tpu_torch.models.map_state import SlamMap
from visual_slam_tpu_torch.utils.synthetic import RingScene

POSE_ATOL = 1e-4
DETAIL_ATOL = 2e-3


def _rand_desc(rng, n_):
    return rng.integers(0, 2**32, size=(n_, 8), dtype=np.uint32)


def _scores(cur, db, hamming, valid=None, mask=None, cur_valid=None):
    """Both sides' scores of `cur` (F,8) uint32 against db (K,F,8)."""
    K, F, _ = db.shape
    valid = np.ones((K, F), bool) if valid is None else valid
    mask = np.ones(K, bool) if mask is None else mask
    cur_valid = np.ones(F, bool) if cur_valid is None else cur_valid
    port = lc.score_keyframes(convert.from_jax_desc(cur, "cpu"), torch.from_numpy(cur_valid),
                              torch.from_numpy(db.view(np.int32).copy()), torch.from_numpy(valid),
                              torch.from_numpy(mask), hamming)
    jx = jlc.score_keyframes(jnp.asarray(cur), jnp.asarray(cur_valid), jnp.asarray(db),
                             jnp.asarray(valid), jnp.asarray(mask), jnp.float32(hamming))
    assert port.dtype == torch.int32
    return n(port), np.asarray(jx)


def _flip_few_bits(rng, d):
    flips = rng.integers(0, 2**32, size=d.shape, dtype=np.uint32)
    return d ^ (flips & (flips >> 1) & (flips >> 2) & (flips >> 3) & (flips >> 4)
                & (flips >> 5)).astype(np.uint32)


# ------------------------------------------------------------------ scoring


def test_revisited_keyframe_scores_highest(rng):
    F, K = 128, 6
    db = np.stack([_rand_desc(rng, F) for _ in range(K)])
    flips = rng.integers(0, 2**32, size=(F, 8), dtype=np.uint32)
    cur = db[1] ^ (flips & np.uint32(0x1))
    port, jx = _scores(cur, db, 48.0)
    np.testing.assert_array_equal(port, jx)
    assert port[1] == F and port[1] > 2 * port.max(initial=0, where=np.arange(K) != 1)


def test_kf_mask_and_validity_match_jax(rng):
    """Masked keyframes score 0; invalid stored and current features take
    no part; a K larger than one chunk (SCORE_CHUNK_BYTES shrunk to take 3
    keyframes a chunk, over 10) gives the same scores."""
    F, K = 64, 10
    db = np.stack([_rand_desc(rng, F) for _ in range(K)])
    db[3, :20] = _flip_few_bits(rng, db[0, :20])
    mask = rng.uniform(size=K) < 0.7
    mask[0] = True
    valid = rng.uniform(size=(K, F)) < 0.8
    cur_valid = rng.uniform(size=F) < 0.9
    port, jx = _scores(db[0], db, 48.0, valid, mask, cur_valid)
    np.testing.assert_array_equal(port, jx)
    assert (port[~mask] == 0).all() and port[0] == (valid[0] & cur_valid).sum()
    old = lc.SCORE_CHUNK_BYTES
    lc.SCORE_CHUNK_BYTES = 3 * 4 * F * F
    try:
        chunked, _ = _scores(db[0], db, 48.0, valid, mask, cur_valid)
    finally:
        lc.SCORE_CHUNK_BYTES = old
    np.testing.assert_array_equal(chunked, jx)


def _corridor_db(rng, K=30, F=256, share=0.5):
    """tests/test_loop_closure.py's non-revisiting corridor."""
    n_share = int(F * share)
    descs = [_rand_desc(rng, F)]
    for _ in range(1, K):
        keep = rng.permutation(F)[:n_share]
        d = _rand_desc(rng, F)
        d[:n_share] = descs[-1][keep]
        descs.append(d)
    return np.stack(descs)


def _score_all(db, ham):
    """Every keyframe against the whole store, both sides; asserts equal."""
    out = []
    for k in range(db.shape[0]):
        port, jx = _scores(db[k], db, ham)
        np.testing.assert_array_equal(port, jx)
        out.append(port)
    return out


def test_gates_on_corridor_and_revisit_match_jax(rng):
    """The production gates: no candidate on the corridor, keyframe 0 on a
    revisit of it, across the JAX package's band of hamming_thresh x
    min_score_abs, with both sides' candidates equal."""
    base = lc.LoopClosureConfig()
    db = _corridor_db(rng)
    db_tp = db.copy()
    db_tp[29] = _flip_few_bits(rng, db[0])
    for ham in (40.0, 48.0, 56.0):
        fp, tp = _score_all(db, ham), _score_all(db_tp, ham)
        for msa in (40, 60, 80):
            kw = dict(hamming_thresh=ham, min_score_abs=msa, min_gap=base.min_gap,
                      min_score_rel=base.min_score_rel)
            cfg, jcfg = lc.LoopClosureConfig(**kw), jlc.LoopClosureConfig(**kw)
            for k in range(cfg.min_gap, 30):
                assert lc.find_candidate(fp[k], k, cfg) is None is jlc.find_candidate(fp[k], k, jcfg)
            assert lc.find_candidate(tp[29], 29, cfg) == 0 == jlc.find_candidate(tp[29], 29, jcfg)


def test_find_candidate_matches_jax(rng):
    """test_loop_closure.py's four gate cases, and 200 random score
    vectors and configurations, through both."""
    cases = []
    for kw, hits, cur in ((dict(min_gap=5, min_score_abs=50, min_score_rel=0.5), {2: 300, 18: 500}, 19),
                          (dict(min_gap=5, min_score_abs=100, min_score_rel=0.1), {2: 60}, 19),
                          (dict(min_gap=5, min_score_abs=50, min_score_rel=0.8), {2: 100, 18: 400}, 19),
                          (dict(min_gap=10, min_score_abs=10, min_score_rel=0.0), {15: 1000}, 19)):
        s = np.zeros(20, np.int32)
        for k, v in hits.items():
            s[k] = v
        cases.append((kw, s, cur))
    for _ in range(200):
        K = int(rng.integers(1, 40))
        kw = dict(min_gap=int(rng.integers(1, 15)), min_score_abs=int(rng.integers(0, 120)),
                  min_score_rel=float(rng.uniform(0, 1)))
        cases.append((kw, rng.integers(0, 256, K).astype(np.int32), int(rng.integers(0, K))))
    got = [lc.find_candidate(s, cur, lc.LoopClosureConfig(**kw)) for kw, s, cur in cases]
    assert got == [jlc.find_candidate(s, cur, jlc.LoopClosureConfig(**kw)) for kw, s, cur in cases]
    assert got[:4] == [2, None, None, None] and sum(c is not None for c in got) > 20


def test_feature_db_matches_jax(rng):
    """KeyframeFeatureDB: rows, growth past its capacity (with SlamMap's
    doubling), and the device mirror."""
    F = 16
    db, jdb = lc.KeyframeFeatureDB(4, F, "cpu"), jlc.KeyframeFeatureDB(4, F)
    for k in (0, 1, 3, 2, 9, 5):
        d, v = _rand_desc(rng, F), rng.uniform(size=F) < 0.7
        db.add(k, d.view(np.int32), v)
        jdb.add(k, d, v)
    assert db.n == jdb.n == 10 and db.desc.shape == (16, F, 8)
    np.testing.assert_array_equal(db.desc.view(np.uint32), jdb.desc)
    np.testing.assert_array_equal(db.valid, jdb.valid)
    dd, dv = db.device_arrays()
    np.testing.assert_array_equal(n(dd), db.desc)
    np.testing.assert_array_equal(n(dv), db.valid)


# --------------------------------------------------------------- correction


def _two_maps(cap):
    return SlamMap(MapConfig(**cap)), JSlamMap(JMapConfig(**cap))


def _same_map(m, jm):
    for name, a in convert.to_jax_map_arrays(m).items():
        np.testing.assert_array_equal(np.asarray(a), np.asarray(getattr(jm, name)), err_msg=name)


def test_landmarks_follow_anchor_keyframe(rng):
    """A corrected keyframe carries its anchored landmarks, bit for bit as
    the JAX package's."""
    m, jm = _two_maps(dict(max_keyframes=4, max_points=32, max_observations=64))
    X = rng.normal(size=(8, 3)).astype(np.float32) + [0, 0, 5]
    desc = _rand_desc(rng, 8)
    dR = np.asarray(jlie.so3_exp(jnp.asarray(np.array([0, 0, np.deg2rad(10)], np.float32))))
    for mm, d in ((m, desc.view(np.int32)), (jm, desc)):
        mm.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0)
        mm.add_keyframe(np.eye(3, dtype=np.float32), np.array([1, 0, 0], np.float32), 1)
        ids = mm.add_points(X, d)
        mm.add_observations(1, ids, np.zeros((8, 2), np.float32))
    R_new = np.concatenate([np.stack([np.eye(3), dR @ m.kf_R[1]]), m.kf_R[2:]]).astype(np.float32)
    t_new = np.concatenate([np.stack([np.zeros(3), dR @ m.kf_t[1] + [0.1, 0, 0]]), m.kf_t[2:]]
                           ).astype(np.float32)
    Xc_before = np.einsum("ij,nj->ni", m.kf_R[1], X) + m.kf_t[1]
    lc.apply_pose_graph_correction(m, R_new, t_new)
    jlc.apply_pose_graph_correction(jm, R_new, t_new)
    _same_map(m, jm)
    np.testing.assert_allclose(np.einsum("ij,nj->ni", m.kf_R[1], m.pt_xyz[ids]) + m.kf_t[1], Xc_before,
                               atol=1e-5)


def test_anchor_and_sim3_correction_match_jax(rng):
    """point_anchor_keyframes (first observer, pruned rows skipped) and the
    Sim3 correction with per-keyframe scales, on equal maps."""
    m, jm = _two_maps(dict(max_keyframes=4, max_points=16, max_observations=64))
    X = rng.normal(size=(6, 3)).astype(np.float32) + [0, 0, 4]
    desc = _rand_desc(rng, 6)
    for mm, d in ((m, desc.view(np.int32)), (jm, desc)):
        for k in range(3):
            mm.add_keyframe(np.eye(3, dtype=np.float32), np.array([0.3 * k, 0, 0], np.float32), k)
        ids = mm.add_points(X, d)
        mm.add_observations(1, ids, np.zeros((6, 2), np.float32))
        mm.add_observations(2, ids, np.zeros((6, 2), np.float32))
        mm.obs_valid[0] = False  # landmark 0's first row pruned: its anchor is keyframe 2
    anchor = lc.point_anchor_keyframes(m)
    np.testing.assert_array_equal(anchor, jlc.point_anchor_keyframes(jm))
    assert anchor[ids[0]] == 2 and (anchor[ids[1:]] == 1).all()
    R_new = np.stack([np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(scale=0.1, size=3).astype(np.float32))))
                      for _ in range(4)])
    t_new = rng.normal(size=(4, 3)).astype(np.float32)
    s_new = rng.uniform(0.8, 1.2, 4).astype(np.float32)
    lc.apply_pose_graph_correction(m, R_new, t_new, s_new)
    jlc.apply_pose_graph_correction(jm, R_new, t_new, s_new)
    _same_map(m, jm)


def test_loop_edge_measurement_matches_jax_and_rel(rng):
    w = rng.normal(size=(2, 3)).astype(np.float32) * 0.3
    Rs = [np.asarray(jlie.so3_exp(jnp.asarray(x))) for x in w]
    ts = [rng.normal(size=3).astype(np.float32) for _ in range(2)]
    Z = lc.loop_edge_measurement(Rs[0], ts[0], Rs[1], ts[1])
    for a, b in zip(Z, jlc.loop_edge_measurement(Rs[0], ts[0], Rs[1], ts[1])):
        np.testing.assert_array_equal(a, b)
    R_rel, t_rel = pg._rel(torch.from_numpy(np.stack(Rs)), torch.from_numpy(np.stack(ts)), [0], [1])
    np.testing.assert_allclose(n(R_rel)[0], Z[0], atol=1e-5)
    np.testing.assert_allclose(n(t_rel)[0], Z[1], atol=1e-5)


def test_drifted_loop_snaps_back(rng):
    """test_loop_closure.py's 40-keyframe circle with a rotational drift
    bias and one true loop edge, through the port's pose graph and
    correction and the JAX package's: poses and landmarks agree, the
    endpoint error shrinks more than 5x, anchored landmarks follow."""
    K = 40
    ang = np.linspace(0, 2 * np.pi, K).astype(np.float32)
    centers = np.stack([np.cos(ang), np.sin(ang), 0 * ang], -1) * 3.0
    R_gt = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t_gt = -np.einsum("kij,kj->ki", R_gt, centers).astype(np.float32)
    bias = np.asarray(jlie.so3_exp(jnp.asarray(np.array([0, 0, 0.01], np.float32))))
    R_est, t_est = [R_gt[0]], [t_gt[0]]
    for k in range(1, K):
        R_rel = R_gt[k] @ R_gt[k - 1].T
        t_rel = t_gt[k] - R_rel @ t_gt[k - 1]
        R_est.append(((bias @ R_rel) @ R_est[-1]).astype(np.float32))
        t_est.append(((bias @ R_rel) @ t_est[-1] + bias @ t_rel).astype(np.float32))
    m, jm = _two_maps(dict(max_keyframes=K, max_points=64, max_observations=256))
    X = rng.normal(size=(32, 3)).astype(np.float32) * 2
    desc = _rand_desc(rng, 32)
    for mm, d in ((m, desc.view(np.int32)), (jm, desc)):
        for k in range(K):
            mm.add_keyframe(R_est[k], t_est[k], k)
        ids = mm.add_points(X, d)
        mm.add_observations(K // 2, ids, np.zeros((32, 2), np.float32))
    err_before = np.linalg.norm(-R_est[-1].T @ t_est[-1] - centers[-1])
    Z_R, Z_t = lc.loop_edge_measurement(R_gt[0], t_gt[0], R_gt[-1], t_gt[-1])
    edge = (np.array([0]), np.array([K - 1]), Z_R[None], Z_t[None], np.array([50.0], np.float32))
    g = pg.add_edges(pg.from_keyframe_chain(torch.from_numpy(m.kf_R), torch.from_numpy(m.kf_t),
                                            torch.from_numpy(m.kf_valid),
                                            torch.from_numpy(m.kf_scale_meas[1:])), *edge)
    jg = jpg.add_edges(jpg.from_keyframe_chain(jnp.asarray(jm.kf_R), jnp.asarray(jm.kf_t),
                                               jnp.asarray(jm.kf_valid),
                                               scale_meas=jnp.asarray(jm.kf_scale_meas[1:])), *edge)
    R_new, t_new, _ = pg.optimize(g, n_iters=25, use_dcs=True)
    jR, jt, _ = jpg.optimize(jg, n_iters=25, use_dcs=True)
    Xc_before = np.einsum("ij,nj->ni", m.kf_R[K // 2], m.pt_xyz[ids]) + m.kf_t[K // 2]
    lc.apply_pose_graph_correction(m, n(R_new), n(t_new))
    jlc.apply_pose_graph_correction(jm, np.asarray(jR), np.asarray(jt))
    for name in ("kf_R", "kf_t", "pt_xyz", "kf_scale_meas"):
        np.testing.assert_allclose(getattr(m, name), getattr(jm, name), atol=POSE_ATOL, err_msg=name)
    assert np.linalg.norm(-m.kf_R[-1].T @ m.kf_t[-1] - centers[-1]) < err_before / 5
    np.testing.assert_allclose(np.einsum("ij,nj->ni", m.kf_R[K // 2], m.pt_xyz[ids]) + m.kf_t[K // 2],
                               Xc_before, atol=1e-4)


def test_size_config_for_matches_jax_and_copies():
    """size_config_for sizes as the JAX package's (given a fresh config
    each, as that one mutates its argument) and leaves its argument as it
    was."""
    for n_frames in (60, 300, 601, 1200, 5000):
        cfg = SlamConfig()
        out = size_config_for(n_frames, cfg)
        jout = jpl.size_config_for(n_frames, JSlamConfig())
        assert (out.map.max_keyframes, out.map.max_points, out.map.max_observations,
                out.ba.every_n_kf) == (jout.map.max_keyframes, jout.map.max_points,
                                       jout.map.max_observations, jout.ba.every_n_kf)
        assert out is not cfg and (cfg.map, cfg.ba) == (SlamConfig().map, SlamConfig().ba)
    assert size_config_for(1200).ba.every_n_kf == 2 and size_config_for(600).ba.every_n_kf == 1


# ----------------------------------------------------- operating point


def _port_handle(scene: RingScene, jh):
    """The JAX handle's verification blob as the port's TrackStep and
    features, with the candidate snapshot of the port's own map."""
    (blob,) = jh["fut"].result()
    M, F = scene.cfg.map.track_capacity, scene.cfg.frontend.max_features
    step, feats = convert.from_jax_track_blob(blob, M, F, "cpu")
    return dict(kf_id=jh["kf_id"], cand=jh["cand"], feats=feats, step=step,
                snap=scene.slam.map.local_snapshot(jh["cand"], "cpu"))


def _scenes(seed, **kw):
    """The JAX RingScene and the port's, from the same draws; their maps
    equal array for array."""
    js, ts = JRingScene(np.random.default_rng(seed), **kw), RingScene(np.random.default_rng(seed),
                                                                       device="cpu", **kw)
    _same_map(ts.slam.map, js.slam.map)
    np.testing.assert_array_equal(ts.pt_ids, js.pt_ids)
    return js, ts


_LOOP_KEYS = ("loop_closures", "loop_verify_fail", "loop_verify_best", "loop_rejected_warp",
              "loop_rejected_unsatisfied", "loop_rejected_covis", "ba_discarded_loop")


def _same_detail(a: list, b: list):
    """Accepted / rejected records: the same keys and integers; the rounded
    fractions within DETAIL_ATOL (a rounding boundary may split them)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], int):
                assert x[k] == y[k], k
            else:
                assert abs(x[k] - y[k]) <= DETAIL_ATOL, (k, x[k], y[k])


def _close_both(js, ts, jh):
    """_close_loop on both sides; decisions, stats and maps compared."""
    th = _port_handle(ts, jh)
    js.slam._close_loop(jh)
    ts.slam._close_loop(th)
    jst, tst = js.slam.stats, ts.slam.stats
    for k in _LOOP_KEYS:
        assert tst[k] == jst.get(k, 0), k
    _same_detail(tst["loop_accepted"], jst.get("loop_accepted", []))
    _same_detail(tst["loop_rejected_detail"], jst.get("loop_rejected_detail", []))
    assert len(ts.slam._loop_edges) == len(js.slam._loop_edges)
    m, jm = ts.slam.map, js.slam.map
    for name in ("kf_R", "kf_t", "pt_xyz"):
        np.testing.assert_allclose(getattr(m, name), getattr(jm, name), atol=POSE_ATOL, err_msg=name)
    assert (m.n_obs, m.n_pt) == (jm.n_obs, jm.n_pt)
    np.testing.assert_array_equal(m.obs_pt[: m.n_obs], jm.obs_pt[: jm.n_obs])
    if tst["loop_closures"]:
        assert ts.slam._pending_ba is not None and js.slam._pending_ba is not None
        for ft, fj in zip(ts.slam.trajectory, js.slam.trajectory, strict=True):
            np.testing.assert_allclose(ft.R_cw, fj.R_cw, atol=POSE_ATOL)
            np.testing.assert_allclose(ft.t_cw, fj.t_cw, atol=POSE_ATOL)
    return tst


def test_ring_verify_handle_matches_jax():
    """The port's RingScene.verify_handle crafts the JAX scene's
    verification, converted from its blob: the same step and features."""
    js, ts = _scenes(7)
    jh = js.make_verify_handle(39, 0, n_inl=25)
    a, b = _port_handle(ts, jh), ts.verify_handle(39, 0, n_inl=25)
    for x, y in ((a["step"], b["step"]), (a["feats"], b["feats"])):
        for name, u in x._asdict().items():
            v = getattr(y, name)
            assert u == v if isinstance(u, bool) else torch.equal(u, v), name


def test_accepts_and_corrects_scale_drift():
    """A genuine closure under 1.15x scale drift with 25 inliers: accepted
    on both sides, the endpoint error halved, real scale in the edge."""
    js, ts = _scenes(7, drift_scale=1.15)
    err0 = ts.endpoint_error()
    st = _close_both(js, ts, js.make_verify_handle(39, 0, n_inl=25))
    assert st["loop_closures"] == 1 and st["loop_rejected_warp"] == 0
    assert ts.endpoint_error() < 0.5 * err0
    assert abs(ts.slam._loop_edges[-1][4]) > 0.05
    np.testing.assert_allclose(ts.slam._loop_edges[-1][4], js.slam._loop_edges[-1][4], atol=1e-6)


@pytest.mark.parametrize("drift_scale,drift_yaw", [(1.08, 0.0), (1.12, 2.0), (1.18, 4.0)])
def test_acceptance_band(drift_scale, drift_yaw):
    js, ts = _scenes(7, drift_scale=drift_scale, drift_yaw_deg=drift_yaw)
    err0 = ts.endpoint_error()
    st = _close_both(js, ts, js.make_verify_handle(39, 0, n_inl=22))
    assert st["loop_closures"] == 1 and ts.endpoint_error() < err0


def test_inlier_floor_rejects_below_20():
    js, ts = _scenes(7, drift_scale=1.15)
    st = _close_both(js, ts, js.make_verify_handle(39, 0, n_inl=19))
    assert st["loop_closures"] == 0 and st["loop_verify_fail"] == 1 and st["loop_verify_best"] == 19


def _restored(ts, before):
    m = ts.slam.map
    for name, a in before.items():
        np.testing.assert_array_equal(getattr(m, name), a, err_msg=name)


def test_rejects_lucky_inliers_topologically_false():
    """25 'verified' matches against the keyframe opposite on the ring:
    rejected (by the edge-satisfaction gate or the warp validation) on both
    sides, the map bit for bit unchanged."""
    js, ts = _scenes(7, drift_scale=1.12)
    m = ts.slam.map
    before = dict(kf_R=m.kf_R.copy(), kf_t=m.kf_t.copy(), pt_xyz=m.pt_xyz.copy())
    st = _close_both(js, ts, js.make_verify_handle(39, 20, n_inl=25, true_pose=False))
    assert st["loop_closures"] == 0 and len(ts.slam._loop_edges) == 0
    assert st["loop_rejected_warp"] + st["loop_rejected_unsatisfied"] == 1
    _restored(ts, before)


def test_rejects_garbage_pnp_pose():
    """A false verification with a random SE3 error on its pose."""
    from scipy.spatial.transform import Rotation

    js, ts = _scenes(7, drift_scale=1.12)
    m = ts.slam.map
    before = dict(kf_R=m.kf_R.copy(), pt_xyz=m.pt_xyz.copy())
    jh = js.make_verify_handle(39, 20, n_inl=25, true_pose=False)
    blob = jh["fut"].result()[0]
    Rg = Rotation.from_euler("xyz", [12, 8, -15], degrees=True).as_matrix().astype(np.float32)
    blob[:9] = (Rg @ blob[:9].reshape(3, 3)).reshape(9)
    blob[9:12] += np.array([0.4, -0.3, 0.5], np.float32)
    fut = concurrent.futures.Future()
    fut.set_result((blob,))
    jh["fut"] = fut
    st = _close_both(js, ts, jh)
    assert st["loop_closures"] == 0 and len(ts.slam._loop_edges) == 0
    _restored(ts, before)


@pytest.mark.parametrize("drift_scale,drift_yaw", [(1.25, 5.0), (1.45, 8.0), (1.7, 12.0)])
def test_closure_helps_or_is_a_clean_no_op(drift_scale, drift_yaw):
    """Past the tuned regime: a closure is accepted and improves the
    endpoint, or is rejected with the map bit for bit unchanged; the same
    decision on both sides."""
    js, ts = _scenes(7, drift_scale=drift_scale, drift_yaw_deg=drift_yaw)
    m = ts.slam.map
    err0 = ts.endpoint_error()
    before = dict(kf_R=m.kf_R.copy(), pt_xyz=m.pt_xyz.copy())
    st = _close_both(js, ts, js.make_verify_handle(39, 0, n_inl=25))
    if st["loop_closures"] == 1:
        assert ts.endpoint_error() < err0
    else:
        _restored(ts, before)


def test_dispatch_suppressed_within_cooldown():
    """The cooldown gate: no scoring pass within `cooldown` keyframes of the
    last closure, one after it, with scores equal to the JAX package's."""
    js, ts = _scenes(7, K=20)
    rng = np.random.default_rng(8)
    F = ts.cfg.frontend.max_features
    desc = _rand_desc(rng, F)
    valid = np.ones(F, bool)
    for k in range(18):
        ts.slam._loop_db.add(k, desc.view(np.int32), valid)
        js.slam._loop_db.add(k, desc, valid)
    feats = convert.from_jax_features(np.zeros((F, 2), np.float32), desc, np.zeros(F, np.float32),
                                      valid, "cpu")
    jfeats = jpl.frontend.Features(uv=np.zeros((F, 2), np.float32), desc=desc,
                                   score=np.zeros(F, np.float32), valid=valid)
    ts.slam._last_loop_kf = js.slam._last_loop_kf = 14
    assert ts.slam._dispatch_loop_scores(17, feats) is None
    assert js.slam._dispatch_loop_scores(17, jfeats) is None
    ts.slam._last_loop_kf = js.slam._last_loop_kf = 13
    out = ts.slam._dispatch_loop_scores(17, feats)
    jout = js.slam._dispatch_loop_scores(17, jfeats)
    assert out is not None
    np.testing.assert_array_equal(n(out), np.asarray(jout))


@pytest.mark.parametrize("genuine", [False, True], ids=["rejected", "accepted"])
def test_pending_ba_across_a_closure(genuine):
    """A BA pending when a closure is decided. Accepted: discarded on both
    sides, and a fresh BA dispatched. Rejected: the JAX package has dropped
    it anyway (it discards before its gates; ROADMAP Queue C lists this as
    a non-fault of the reference); the port keeps its BA schedule, so the
    BA stays pending."""
    js, ts = _scenes(7, drift_scale=1.15 if genuine else 1.12)
    for slam in (js.slam, ts.slam):
        slam._dispatch_ba(38, scale_gauge=False)
    jh = js.make_verify_handle(39, 0 if genuine else 20, n_inl=25, true_pose=genuine)
    th = _port_handle(ts, jh)
    js.slam._close_loop(jh)
    ts.slam._close_loop(th)
    assert ts.slam.stats["loop_closures"] == js.slam.stats.get("loop_closures", 0) == int(genuine)
    assert js.slam.stats.get("ba_discarded_loop", 0) == 1
    assert ts.slam.stats["ba_discarded_loop"] == int(genuine)
    assert ts.slam._pending_ba is not None
    assert (ts.slam._pending_ba["kf_id"] == 39) == genuine
    assert (js.slam._pending_ba is not None) == genuine
