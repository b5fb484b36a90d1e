"""The port's whole RGB-D SLAM loop with loop closure on, against the JAX
package's Slam on the CPU, on the revisiting synthetic scene at half size
(320x240, halved intrinsics, K=256, M=512): 240 frames of a full turn in
the box room that returns to frame 0's view at frame 215.

To keep the file's time down, both sides run with keyframe.max_interval 10
(default 20) and loop.min_gap 8 (default 12), alike: the turn then needs
240 frames, not 320, for 9 keyframes before the return. Every other
setting, the loop gates included, is the default.

Compared: keyframe, BA-apply and closure frames exactly; the loop counters
and the accepted closure's record exactly; R and t per frame within
POSE_ATOL until the first BA applies and POSE_ATOL_BA after (the RGB-D bars
of tests/test_torch_slam.py); PnP inlier counts within N_TRACKED_TOL. A
verification that fails may fall to RANSAC, whose draws differ between the
packages (a torch.Generator cannot replay JAX's keys), so the best inlier
count of the failed verifications (loop_verify_best) is not compared
exactly: both sides must have it below the inlier floor that counted them
as failures, and within VERIFY_BEST_TOL of each other. Last, the final
pose-graph pass is skipped on both sides, as a closure was applied."""
import numpy as np
import pytest

from torch_parity import ICL_INTR

from visual_slam_tpu.config import SlamConfig as JSlamConfig
from visual_slam_tpu.pipeline import Slam as JSlam

from visual_slam_tpu_torch.config import SlamConfig
from visual_slam_tpu_torch.pipeline import Slam
from visual_slam_tpu_torch.utils import evaluate
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

HALF_INTR = ICL_INTR / 2
N_FRAMES = 240
POSE_ATOL = 1e-4
POSE_ATOL_BA = 1e-3
N_TRACKED_TOL = 2
# loop_verify_best: the largest inlier count of a failed verification. Where
# that verification fell to RANSAC, each package's best consensus comes from
# its own minimal sets: a quarter of the floor (verify_min_inliers 20) apart.
VERIFY_BEST_TOL = 5
ATE_LIMIT_M = 0.02
LOOP_KEYS = ("keyframes", "ba_runs", "culled", "obs_compacted", "track_failures", "init_frame",
             "loop_candidates", "loop_verify_fail", "loop_rejected_covis",
             "loop_rejected_unsatisfied", "loop_rejected_warp", "loop_closures", "ba_discarded_loop")


def _config(cls):
    cfg = cls(use_depth=True, intrinsics=HALF_INTR.copy())
    cfg.frontend.max_features = 256
    cfg.map.track_capacity = 512
    cfg.keyframe.max_interval = 10
    cfg.loop.min_gap = 8
    return cfg


def _run(slam, frames):
    """Process the frames; per frame the BA-apply and closure counts."""
    history = []
    for i, gray, depth in frames:
        slam.process(i, gray, depth)
        history.append((slam.stats["ba_runs"], slam.stats.get("loop_closures", 0)))
    return history


@pytest.fixture(scope="module")
def revisit():
    scene = SyntheticRGBDScene(N_FRAMES, 240, 320, intrinsics=HALF_INTR, trajectory="revisit")
    frames = list(scene.frames())
    jslam = JSlam(_config(JSlamConfig))
    try:
        jh = _run(jslam, frames)
        tslam = Slam(_config(SlamConfig), device="cpu")
        yield scene, jslam, tslam, jh, _run(tslam, frames)
    finally:
        jslam.close()  # after the last test: its final pass may dispatch a BA


def test_revisit_history_matches_jax(revisit):
    """The same keyframes, BA applies and closure, frame by frame, and the
    same loop counters and acceptance record; one closure, on the return."""
    _, jslam, tslam, jh, th = revisit
    kf = [f.frame_idx for f in tslam.trajectory if f.is_keyframe]
    assert kf == [f.frame_idx for f in jslam.trajectory if f.is_keyframe]
    assert th == jh
    for k in LOOP_KEYS:
        assert tslam.stats[k] == jslam.stats.get(k, 0), k
    best = (tslam.stats["loop_verify_best"], jslam.stats.get("loop_verify_best", 0))
    assert all(0 <= b < tslam.cfg.loop.verify_min_inliers for b in best), best
    assert abs(best[0] - best[1]) <= VERIFY_BEST_TOL, best
    assert tslam.stats["loop_accepted"] == jslam.stats["loop_accepted"]
    assert tslam.stats["loop_rejected_detail"] == jslam.stats.get("loop_rejected_detail", [])
    assert tslam.stats["loop_closures"] == 1 and len(kf) >= tslam.cfg.loop.min_gap + 1
    closed_at = [h[1] for h in th].index(1)
    assert closed_at > 0.85 * N_FRAMES  # on the return, not before
    (a,) = tslam.stats["loop_accepted"]
    assert a["kf"] - a["cand"] >= tslam.cfg.loop.min_gap
    assert tslam._loop_edges[0][:2] == jslam._loop_edges[0][:2]
    assert (tslam.map.n_pt, tslam.map.n_obs) == (jslam.map.n_pt, jslam.map.n_obs)


def test_revisit_poses_match_jax(revisit):
    """Per-frame R, t at the RGB-D bars, inlier counts within 2, and
    ATE < 2 cm on both sides, through the closure's trajectory rewrite."""
    scene, jslam, tslam, _, th = revisit
    first_apply = [h[0] for h in th].index(1)
    for k, (fj, ft) in enumerate(zip(jslam.trajectory, tslam.trajectory, strict=True)):
        atol = POSE_ATOL if k < first_apply else POSE_ATOL_BA
        assert ft.frame_idx == fj.frame_idx and ft.ref_kf == fj.ref_kf
        np.testing.assert_allclose(ft.R_cw, fj.R_cw, atol=atol)
        np.testing.assert_allclose(ft.t_cw, fj.t_cw, atol=atol)
        assert abs(ft.n_tracked - fj.n_tracked) <= N_TRACKED_TOL
    gt = scene.ground_truth()
    for slam in (tslam, jslam):
        idxs, est = slam.positions()
        ate, _ = evaluate.ate_rmse(est, gt[idxs, :3, 3], align_scale=False)
        assert ate < ATE_LIMIT_M
    np.testing.assert_allclose(tslam.map.kf_t, jslam.map.kf_t, atol=POSE_ATOL_BA)
    np.testing.assert_allclose(tslam.map.pt_xyz, jslam.map.pt_xyz, atol=POSE_ATOL_BA)


def test_final_pass_skipped_after_a_closure(revisit):
    """optimize_pose_graph lands the pending work and skips the pass on
    both sides (a closure was applied in the run)."""
    _, jslam, tslam, _, _ = revisit
    for slam in (jslam, tslam):
        slam.optimize_pose_graph()
    assert tslam.stats["final_pass"] == jslam.stats["final_pass"] == "skipped_closures_applied"
    assert tslam.stats["ba_runs"] == jslam.stats["ba_runs"]
    np.testing.assert_allclose(tslam.map.kf_t, jslam.map.kf_t, atol=POSE_ATOL_BA)
