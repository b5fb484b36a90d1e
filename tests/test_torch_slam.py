"""The port's whole SLAM loop against the JAX package's Slam on the CPU, on
the half-size synthetic scene (320x240, halved intrinsics, K=256, M=512):
RGB-D over 60 frames, monocular on every 3rd frame, the failure,
relocalisation and keyframe-veto paths, and the monocular final pose-graph
pass. Both sides run loop closure with its defaults: under 12 keyframes it
stores features and never scores (tests/test_torch_loop_slam.py closes a
loop).

The torch.Generator cannot replay JAX's RANSAC draws, but the scene is
noise-free, so the refined essential matrix, its inlier set and every gate
agree: init, keyframe and BA-apply frames are compared exactly.

Monocular poses agree to 1e-5 until the second BA applies; after it they
agree to 1e-2 only. That BA (3 keyframes, 2 free) is ill-conditioned in
float32: given the same input, the JAX package's and the port's optimised
translations differ by 1.5e-3 m, the float64 solution is 4e-3 m from both,
and a one-ulp change of the landmarks moves the JAX package's own result by
up to 5.4e-3 m. The keyframe frames after it are exact here but fragile: a
last-bit change in the 8-point solver (U[:, :2] @ Vt[:2] in place of the
JAX package's (U * diag(1,1,0)) @ Vt) moved the fifth keyframe from frame
156 to 150. Keep the port's arithmetic the reference's where it can be.
"""
import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ICL_INTR

from visual_slam_tpu.config import SlamConfig as JSlamConfig
from visual_slam_tpu.pipeline import FrameResult as JFrameResult, Slam as JSlam

from visual_slam_tpu_torch.config import SlamConfig
from visual_slam_tpu_torch.ops import lie
from visual_slam_tpu_torch.pipeline import FrameResult, Slam
from visual_slam_tpu_torch.utils import evaluate
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

HALF_INTR = ICL_INTR / 2
POSE_ATOL = 1e-4  # R, t before the first BA applies (RGB-D)
POSE_ATOL_BA = 1e-3  # R, t after it (RGB-D)
CENTRE_ATOL = 1e-4  # monocular camera centres before the second BA applies
CENTRE_ATOL_BA = 1e-2  # and after it: see the module docstring
N_TRACKED_TOL = 2
ATE_LIMIT_M = 0.02
MONO_STRIDE, MONO_FRAMES = 3, 178


def _configs(use_depth, **keyframe):
    """The same small configuration for both sides: K=256, M=512."""
    out = []
    for cls in (JSlamConfig, SlamConfig):
        cfg = cls(use_depth=use_depth, intrinsics=HALF_INTR.copy())
        cfg.frontend.max_features = 256
        cfg.map.track_capacity = 512
        for k, v in keyframe.items():
            setattr(cfg.keyframe, k, v)
        out.append(cfg)
    return out


def _run(slam, frames, use_depth):
    """Process frames; return the BA-apply count after each."""
    ba_runs = []
    for i, gray, depth in frames:
        slam.process(i, gray, depth if use_depth else None)
        ba_runs.append(slam.stats["ba_runs"])
    return ba_runs


def _both(frames, use_depth, **keyframe):
    jcfg, tcfg = _configs(use_depth, **keyframe)
    jslam = JSlam(jcfg)
    try:
        jba = _run(jslam, frames, use_depth)
    finally:
        jslam.close()
    tslam = Slam(tcfg, device="cpu")
    tba = _run(tslam, frames, use_depth)
    return jslam, tslam, jba, tba


@pytest.fixture(scope="module")
def rgbd():
    scene = SyntheticRGBDScene(60, 240, 320, intrinsics=HALF_INTR)
    return (scene, *_both(list(scene.frames()), True))


@pytest.fixture(scope="module")
def mono_scene():
    scene = SyntheticRGBDScene(MONO_FRAMES, 240, 320, intrinsics=HALF_INTR)
    frames = [(i, scene.render(i)[0], None) for i in range(0, MONO_FRAMES, MONO_STRIDE)]
    return scene, frames


@pytest.fixture(scope="module")
def mono(mono_scene):
    scene, frames = mono_scene
    return (scene, *_both(frames, False))


def _kf_frames(slam):
    return [f.frame_idx for f in slam.trajectory if f.is_keyframe]


def _centres(traj):
    return np.stack([-f.R_cw.T @ f.t_cw for f in traj])


def test_rgbd_slam_matches_jax(rgbd):
    """60 RGB-D frames: keyframes at 0, 21, 42 with depth mining, BAs
    applied on the same frames, R and t within POSE_ATOL until the first BA
    applies and POSE_ATOL_BA after, and ATE < 2 cm."""
    scene, jslam, tslam, jba, tba = rgbd
    assert _kf_frames(jslam) == _kf_frames(tslam) == [0, 21, 42]
    assert tba == jba and tba[-1] == 2
    for k in ("keyframes", "ba_runs", "culled", "init_frame", "track_failures"):
        assert tslam.stats[k] == jslam.stats.get(k, 0), k
    assert tslam.map.n_pt == jslam.map.n_pt and tslam.map.n_obs == jslam.map.n_obs
    first_apply = tba.index(1)
    for k, (fj, ft) in enumerate(zip(jslam.trajectory, tslam.trajectory, strict=True)):
        atol = POSE_ATOL if k < first_apply else POSE_ATOL_BA
        assert ft.frame_idx == fj.frame_idx
        np.testing.assert_allclose(ft.R_cw, fj.R_cw, atol=atol)
        np.testing.assert_allclose(ft.t_cw, fj.t_cw, atol=atol)
        assert abs(ft.n_tracked - fj.n_tracked) <= N_TRACKED_TOL
    idxs, est = tslam.positions()
    ate, _ = evaluate.ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=False)
    assert ate < ATE_LIMIT_M
    assert tslam.ba_iters_per_s() > 0


def test_mono_slam_matches_jax(mono):
    """Every 3rd frame, 60 processed: two-view init at frame 45, keyframes
    at 0/45/90/108/156 with triangulated mining, 6 BAs applied on the same
    frames, equal inlier counts, and camera centres within CENTRE_ATOL
    until the second BA applies and CENTRE_ATOL_BA after."""
    scene, jslam, tslam, jba, tba = mono
    assert jslam.stats["init_frame"] == tslam.stats["init_frame"] == 45
    assert _kf_frames(jslam) == _kf_frames(tslam) == [0, 45, 90, 108, 156]
    assert tba == jba and tba[-1] == 6
    for k in ("keyframes", "mine_relaxed", "culled", "track_failures"):
        assert tslam.stats[k] == jslam.stats.get(k, 0), k
    assert [f.frame_idx for f in tslam.trajectory] == [f.frame_idx for f in jslam.trajectory]
    assert [f.n_tracked for f in tslam.trajectory] == [f.n_tracked for f in jslam.trajectory]
    # Trajectory entries: the anchor, then one per processed frame from 45.
    # A BA applies at the top of a frame's step: the first trajectory entry
    # after the second apply is that frame's.
    second_apply = next(k for k, f in enumerate(tslam.trajectory)
                        if f.frame_idx >= MONO_STRIDE * tba.index(2))
    dc = np.linalg.norm(_centres(tslam.trajectory) - _centres(jslam.trajectory), axis=-1)
    assert dc[:second_apply].max() < CENTRE_ATOL
    assert dc.max() < CENTRE_ATOL_BA
    idxs, est = tslam.positions()
    ate_t, _ = evaluate.ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=True)
    ate_j, _ = evaluate.ate_rmse(_centres(jslam.trajectory), scene.ground_truth()[idxs, :3, 3],
                                 align_scale=True)
    assert abs(ate_t - ate_j) < 0.01 and ate_t < 0.04


@pytest.mark.parametrize("mode", ["rgbd", "mono"])
def test_ref_kf_matches_jax(request, mode):
    """Each frame records the keyframe it tracked against (-1 for the init
    frames), as the JAX FrameResult does."""
    _, jslam, tslam, _, _ = request.getfixturevalue(mode)
    assert [f.ref_kf for f in tslam.trajectory] == [f.ref_kf for f in jslam.trajectory]
    assert max(f.ref_kf for f in tslam.trajectory) >= 2


def test_finish_keyframe_rewrites_trajectory_entry():
    """_finish_keyframe gives a keyframe's existing trajectory entry the
    map's (BA-optimised) pose, as the JAX Slam does."""
    scene = SyntheticRGBDScene(2, 120, 160, intrinsics=ICL_INTR / 4)
    (i0, g0, d0), = scene.frames(0, 1)
    R = lie.so3_exp(torch.tensor([0.01, 0.02, -0.03])).numpy()
    t = np.array([0.1, -0.05, 0.2], np.float32)
    for slam_cls, cfg_cls, fr_cls in ((JSlam, JSlamConfig, JFrameResult), (Slam, SlamConfig, FrameResult)):
        cfg = cfg_cls(use_depth=True, intrinsics=ICL_INTR / 4)
        cfg.frontend.max_features = 64
        slam = slam_cls(cfg) if slam_cls is JSlam else slam_cls(cfg, device="cpu")
        slam.process(i0, g0, d0)
        slam.trajectory.append(fr_cls(7, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 50, True))
        kf = slam.map.add_keyframe(R, t, 7)
        slam.map.kf_t[kf] += 0.01  # as a BA apply would move it
        slam._finish_keyframe(kf, slam._last_kf_feats, slam._last_kf_mapped, 7)
        np.testing.assert_array_equal(slam.trajectory[-1].R_cw, R)
        np.testing.assert_array_equal(slam.trajectory[-1].t_cw, t + np.float32(0.01))
        np.testing.assert_array_equal(slam.trajectory[0].t_cw, np.zeros(3))
        if slam_cls is JSlam:
            slam.close()


def _empty_snapshot(snap, like):
    snap = dict(snap)
    snap["valid"] = like(snap["valid"])
    snap["n_valid"] = 0
    return snap


@pytest.mark.parametrize("case", ["empty_snapshot", "blank_frame"])
def test_failure_paths_match_jax(rgbd, case):
    """A tracking failure on both sides. With the local snapshot emptied,
    re-tracking fails and relocalisation against the global map succeeds;
    on a blank frame both fail and the previous pose is kept. Poses, counts
    and the next frame's recovery agree."""
    scene = rgbd[0]
    frames = list(scene.frames(0, 9))
    jcfg, tcfg = _configs(True)
    jslam, tslam = JSlam(jcfg), Slam(tcfg, device="cpu")
    try:
        for slam in (jslam, tslam):
            _run(slam, frames[:6], True)
        if case == "empty_snapshot":
            jslam._snapshot = _empty_snapshot(jslam._snapshot, jnp.zeros_like)
            tslam._snapshot = _empty_snapshot(tslam._snapshot, torch.zeros_like)
            rest = frames[6:8]
        else:
            i, gray, depth = frames[6]
            rest = [(i, np.zeros_like(gray), depth), frames[7], frames[8]]
        for slam in (jslam, tslam):
            _run(slam, rest, True)
    finally:
        jslam.close()
    for k in ("track_failures", "relocalizations", "fail_retried_ok"):
        assert tslam.stats[k] == jslam.stats.get(k, 0), k
    assert tslam.stats["track_failures"] >= 1
    assert tslam.stats["relocalizations"] == (2 if case == "empty_snapshot" else 0)
    for fj, ft in zip(jslam.trajectory, tslam.trajectory, strict=True):
        np.testing.assert_allclose(ft.R_cw, fj.R_cw, atol=POSE_ATOL)
        np.testing.assert_allclose(ft.t_cw, fj.t_cw, atol=POSE_ATOL)
        assert abs(ft.n_tracked - fj.n_tracked) <= N_TRACKED_TOL
        assert not ft.is_keyframe or ft.frame_idx == 0


def test_keyframe_veto_paths_match_jax(mono_scene):
    """Monocular with a 1-frame keyframe gap and a 3-frame interval, to
    frame 132: keyframe candidates tracked while a mine is pending are
    re-tracked and vetoed, pending BAs are dropped at insertion, culling
    runs at keyframe 8. The discrete history agrees with the JAX Slam:
    keyframe frames, BA-apply frames, vetoes, drops, culls and relaxed
    mines. Poses are not compared: this run applies 7 ill-conditioned
    monocular BAs (see the module docstring)."""
    _, frames = mono_scene
    jslam, tslam, jba, tba = _both(frames[:45], False, min_gap=1, max_interval=3)
    assert _kf_frames(tslam) == _kf_frames(jslam) == [0, 45] + list(range(57, 130, 12))
    assert tba == jba
    for k in ("keyframes", "ba_runs", "kf_vetoed_stale", "kf_retracked", "kf_veto_cached",
              "ba_dropped_stale", "culled", "mine_relaxed", "track_failures"):
        assert tslam.stats[k] == jslam.stats.get(k, 0), k
    assert tslam.stats["kf_vetoed_stale"] >= 1
    assert tslam.stats["ba_dropped_stale"] >= 5
    assert tslam.stats["culled"] > 100


def test_final_pose_graph_pass_matches_jax(mono):
    """The monocular final pass after the run (no closure): the SE3 chain
    with its scale edges, kept or reverted on the blown-fraction rule, the
    same way on both sides; the rewritten camera centres within
    CENTRE_ATOL_BA, as the run's (the pass starts from them)."""
    scene, jslam, tslam, _, _ = mono
    # _both closed the JAX Slam's fetch pool; the pass may dispatch a BA.
    jslam._fetch_pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    try:
        for slam in (jslam, tslam):
            slam.optimize_pose_graph()
    finally:
        jslam.close()
    assert tslam.stats["final_pass"] == jslam.stats["final_pass"]
    assert tslam.stats["final_pass"] in ("smooth", "reverted")
    assert tslam.stats["ba_runs"] == jslam.stats["ba_runs"]
    dc = np.linalg.norm(_centres(tslam.trajectory) - _centres(jslam.trajectory), axis=-1)
    assert dc.max() < CENTRE_ATOL_BA
    idxs, est = tslam.positions()
    ate, _ = evaluate.ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=True)
    assert np.isfinite(ate) and ate < 0.04
