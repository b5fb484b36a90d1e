"""The port's RGB-D slice as a whole against the JAX package's Slam on the
CPU, plus the synthetic scene, the numpy utilities, and the port's
isolation from JAX (no import of it, no CPU fallback in chip_smoke.py)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import ICL_INTR, n, t

from visual_slam_tpu.config import SlamConfig as JSlamConfig
from visual_slam_tpu.models import frontend as jfrontend
from visual_slam_tpu.models.map_state import MapConfig as JMapConfig, SlamMap as JSlamMap
from visual_slam_tpu.pipeline import Slam as JSlam, _backproject_depth as j_backproject
from visual_slam_tpu.pipeline import _track_step as j_track_step, _unpack_blob
from visual_slam_tpu.utils import evaluate as jevaluate

from visual_slam_tpu_torch import convert
from visual_slam_tpu_torch.config import SlamConfig
from visual_slam_tpu_torch.pipeline import Slam, _backproject_depth, run_sequence, track_step
from visual_slam_tpu_torch.utils import evaluate
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALF_INTR = ICL_INTR / 2  # 320x240 with halved intrinsics
POSE_ATOL = 1e-4  # per-frame R and t (float32 PnP, sums in another order)
N_TRACKED_TOL = 2  # per-frame PnP inlier count


def _configs():
    """The same small RGB-D configuration for both sides: K=256, M=512."""
    out = []
    for cls in (JSlamConfig, SlamConfig):
        cfg = cls(use_depth=True, intrinsics=HALF_INTR.copy())
        cfg.frontend.max_features = 256
        cfg.map.track_capacity = 512
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def scene8():
    scene = SyntheticRGBDScene(8, 240, 320, intrinsics=HALF_INTR)
    return scene, list(scene.frames())


def test_slice_matches_jax(scene8):
    """8 frames of the RGB-D slice: per-frame R and t within POSE_ATOL,
    n_tracked within N_TRACKED_TOL, and no keyframe inserted on either side
    (tests/test_torch_slam.py runs the keyframe path)."""
    scene, frames = scene8
    jcfg, tcfg = _configs()
    jslam = JSlam(jcfg)
    try:
        for i, gray, depth in frames:
            jslam.process(i, gray, depth)
    finally:
        jslam.close()
    assert jslam.stats["keyframes"] == 0
    assert not any(f.is_keyframe for f in jslam.trajectory[1:])
    assert jslam.stats.get("track_failures", 0) == 0

    tslam = run_sequence(scene, tcfg, 0, 8, device="cpu")
    assert tslam.stats["keyframes"] == 0
    assert tslam.stats["track_failures"] == 0
    assert tslam.stats["ransac_frames"] == 0
    assert len(tslam.trajectory) == len(jslam.trajectory) == 8
    assert tslam.map.n_pt == jslam.map.n_pt
    for fj, ft in zip(jslam.trajectory, tslam.trajectory):
        assert ft.frame_idx == fj.frame_idx
        np.testing.assert_allclose(ft.R_cw, fj.R_cw, atol=POSE_ATOL)
        np.testing.assert_allclose(ft.t_cw, fj.t_cw, atol=POSE_ATOL)
        assert abs(ft.n_tracked - fj.n_tracked) <= N_TRACKED_TOL
    # And both track the truth.
    idxs, est = tslam.positions()
    rmse, _ = evaluate.ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=False)
    assert rmse < 0.02


def test_track_step_on_converted_jax_state(scene8):
    """The port's track_step on the JAX front-end's features and the JAX
    map's snapshot, carried over by convert.from_jax_*, agrees with the JAX
    _track_step: equal match indices, inlier mask and count; R, t within
    POSE_ATOL."""
    _, frames = scene8
    (_, g0, d0), (_, g3, _) = frames[0], frames[3]
    f0 = jfrontend.extract_pallas(jnp.asarray(g0), 256)
    f3 = jfrontend.extract_pallas(jnp.asarray(g3), 256)
    # The first keyframe's snapshot, built as the JAX _initialize_rgbd does.
    jmap = JSlamMap(JMapConfig(track_capacity=512))
    kf = jmap.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0)
    uv0 = np.asarray(f0.uv)
    X, ok = j_backproject(uv0, d0, HALF_INTR)
    sel = np.where(np.asarray(f0.valid) & ok)[0]
    jmap.add_observations(kf, jmap.add_points(X[sel], np.asarray(f0.desc)[sel]), uv0[sel])
    snap = jmap.local_snapshot(kf)
    blob, R_j, t_j = j_track_step(
        f3.desc, f3.uv, f3.valid, snap["desc"], snap["xyz"], snap["valid"],
        jnp.eye(3), jnp.zeros(3), jnp.asarray(HALF_INTR), jax.random.PRNGKey(0),
        0.8, 96.0, 8.0, n_hyps=128, refine_iters=10,
    )
    blob = np.asarray(blob)
    inl_j, idx2_j, _ = _unpack_blob(blob, 512, 256)

    R0, t0 = convert.from_jax_pose(np.eye(3), np.zeros(3), "cpu")
    step = track_step(
        convert.from_jax_features(f3.uv, f3.desc, f3.score, f3.valid, "cpu"),
        convert.from_jax_snapshot(snap["xyz"], snap["desc"], snap["valid"], "cpu"),
        R0, t0, t(HALF_INTR), ratio=0.8, max_hamming=96.0, threshold_px=8.0,
        n_hyps=128, refine_iters=10,
    )
    assert not step.used_ransac
    np.testing.assert_array_equal(n(step.idx2), idx2_j)
    np.testing.assert_array_equal(n(step.inliers), inl_j)
    assert int(step.n_inliers) == int(blob[12]) > 100
    np.testing.assert_allclose(n(step.R), np.asarray(R_j), atol=POSE_ATOL)
    np.testing.assert_allclose(n(step.t), np.asarray(t_j), atol=POSE_ATOL)


def test_map_matches_jax():
    """The port's SlamMap subset against the JAX SlamMap, past every
    capacity (the arrays double) and through local_snapshot."""
    from visual_slam_tpu_torch.config import MapConfig
    from visual_slam_tpu_torch.models.map_state import SlamMap

    rng = np.random.default_rng(2)
    jm = JSlamMap(JMapConfig(max_keyframes=2, max_points=4, max_observations=8, track_capacity=6))
    tm = SlamMap(MapConfig(max_keyframes=2, max_points=4, max_observations=8, track_capacity=6))
    for k in range(3):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        pose = (R, rng.normal(size=3).astype(np.float32), 10 * k)
        assert jm.add_keyframe(*pose) == tm.add_keyframe(*pose)
        xyz = rng.normal(size=(5, 3)).astype(np.float32)
        desc = rng.integers(0, 2**32, size=(5, 8), dtype=np.uint32)
        ids = jm.add_points(xyz, desc)
        np.testing.assert_array_equal(tm.add_points(xyz, desc.view(np.int32)), ids)
        uv = rng.uniform(0, 640, (5, 2)).astype(np.float32)
        depth = rng.uniform(1, 3, 5).astype(np.float32)
        jm.add_observations(k, ids, uv, depth=depth)
        tm.add_observations(k, ids, uv, depth=depth)
    for name in ("kf_R", "kf_t", "kf_valid", "kf_frame_idx", "pt_xyz", "pt_valid",
                 "pt_views", "obs_cam", "obs_pt", "obs_uv", "obs_depth", "obs_valid"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    np.testing.assert_array_equal(tm.pt_desc.view(np.uint32), jm.pt_desc)
    js, ts = jm.local_snapshot(1), tm.local_snapshot(1, "cpu")
    assert ts["n_valid"] == js["n_valid"] == 5
    for k in ("xyz", "uv", "pt_ids", "valid"):
        np.testing.assert_array_equal(n(ts[k]), np.asarray(js[k]), err_msg=k)
    np.testing.assert_array_equal(convert.to_jax_desc(ts["desc"]), np.asarray(js["desc"]))


def test_backproject_depth_matches_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 4.0, (48, 64)).astype(np.float32)
    depth[0, 0] = 0.0  # missing
    depth[5, 5] = 30.0  # out of range
    uv = np.concatenate([rng.uniform(-2, 66, (40, 2)), [[0, 0], [5.5, 5.2]]]).astype(np.float32)
    X, ok = _backproject_depth(uv, depth, ICL_INTR)
    Xj, okj = j_backproject(uv, depth, ICL_INTR)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(ok, okj)
    assert not ok[-1] and not ok[-2]


def test_evaluate_matches_jax():
    rng = np.random.default_rng(1)
    gt = rng.normal(size=(50, 3))
    est = 1.7 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.3 + rng.normal(scale=0.01, size=gt.shape)
    for align_scale in (True, False):
        a = evaluate.ate_rmse(est, gt, align_scale)
        b = jevaluate.ate_rmse(est, gt, align_scale)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])


def test_scene_depth_is_consistent_with_poses():
    """A pixel back-projected with frame 0's depth and reprojected with the
    ground-truth pose of frame 5 lands where frame 5's depth agrees, on the
    default trajectory and on the revisiting one; the revisiting one comes
    back to frame 0's pose and image at 90% of its frames."""
    for trajectory, n_frames in (("default", 6), ("revisit", 481)):
        scene = SyntheticRGBDScene(n_frames, 120, 160, intrinsics=ICL_INTR / 4, trajectory=trajectory)
        (_, g0, d0), (_, g5, d5) = (next(scene.frames(i, i + 1)) for i in (0, 5))
        assert g0.dtype == d0.dtype == np.float32
        assert 0.0 <= g0.min() and g0.max() <= 1.0 and g0.std() > 0.05
        assert 1.0 < d0.min() and d0.max() <= 4.0
        fx, fy, cx, cy = scene.intrinsics
        v, u = np.mgrid[20:100:7, 20:140:7].reshape(2, -1)
        z = d0[v, u]
        Xw = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)  # world = frame 0
        R5, t5 = scene.pose_cw(5)
        Xc = Xw @ R5.T + t5
        u5, v5 = fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy
        inside = (u5 > 1) & (u5 < 158) & (v5 > 1) & (v5 < 118)
        assert inside.mean() > 0.9
        z5 = d5[np.round(v5[inside]).astype(int), np.round(u5[inside]).astype(int)]
        assert np.median(np.abs(z5 - Xc[inside, 2])) < 0.01
        # Deterministic from the seed.
        again = SyntheticRGBDScene(n_frames, 120, 160, intrinsics=ICL_INTR / 4, trajectory=trajectory)
        np.testing.assert_array_equal(again.render(5)[0], g5)
    back = int(scene.REVISIT_TURN * (n_frames - 1))
    R, t = scene.pose_cw(back)
    np.testing.assert_allclose(R, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(t, 0.0, atol=1e-12)
    np.testing.assert_allclose(scene.render(back)[0], g0, atol=1e-6)
    # Half way round the camera looks back at the wall behind frame 0.
    R_half, _ = scene.pose_cw(back // 2)
    assert R_half[2, 2] < -0.99


def test_monocular_init_is_not_ported():
    """Frames without depth no longer raise: the first frame becomes the
    init anchor (an identity entry), and a frame with no texture to match
    initialises nothing. The name dates from when monocular input raised;
    it is kept so that the test's record carries on."""
    slam = Slam(SlamConfig(use_depth=False), device="cpu")
    for i in range(2):
        slam.process(i, np.zeros((64, 96), np.float32))
    assert not slam.initialized and slam.stats["init_frame"] is None
    assert [(f.frame_idx, f.is_keyframe) for f in slam.trajectory] == [(0, True)]


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax, the sharded
    solvers (parallel/*, the rank worker), the command line's outputs, the
    entry module, the roofline and the benchmark among them; and neither does
    running the command line's lazily imported writers, its argument parser,
    the entry's arrays and its main, the roofline's table, nor the
    benchmark's argument parser."""
    code = (
        "import contextlib, importlib, io, pkgutil, sys, tempfile\n"
        "import numpy as np\n"
        "import visual_slam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'visual_slam_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) >= 20, mods\n"
        "need = ['parallel.mesh', 'parallel.multihost', 'parallel.sharded_ba', 'parallel.sharded_pg',\n"
        "        'parallel.worker', 'utils.checkpoint', 'utils.g2o_io', 'utils.viz', 'utils.live_viewer',\n"
        "        'entry', 'utils.roofline', 'bench']\n"
        "assert all('visual_slam_tpu_torch.' + m in mods for m in need), mods\n"
        "from visual_slam_tpu_torch import pipeline\n"
        "from visual_slam_tpu_torch.models.map_state import SlamMap\n"
        "from visual_slam_tpu_torch.parallel import worker\n"
        "from visual_slam_tpu_torch.utils import checkpoint, g2o_io, viz\n"
        "d = tempfile.mkdtemp()\n"
        "checkpoint.load_map(checkpoint.save_map(d + '/m.npz', SlamMap()) or d + '/m.npz')\n"
        "g2o_io.save_pose_graph(d + '/g.g2o', np.eye(3)[None], np.zeros((1, 3)), [True])\n"
        "viz.save_ply(d + '/m.ply', np.zeros((2, 3)))\n"
        "viz._overlay_image(np.zeros((4, 4)), None, np.ones((1, 2)))\n"
        "from visual_slam_tpu_torch import entry\n"
        "from visual_slam_tpu_torch.utils import roofline\n"
        "entry.entry_arrays(), entry.dryrun_problems(2), entry.entry('cpu')\n"
        "roofline.stage_table(roofline.stage_costs(), {'patches': 1.0})\n"
        "with contextlib.redirect_stderr(io.StringIO()):\n"
        "    assert entry.main() == (0 if __import__('torch').cuda.is_available() else 1)\n"
        "from visual_slam_tpu_torch import bench\n"
        "for main in (pipeline.main, worker.main, bench.main):\n"
        "    with contextlib.redirect_stdout(io.StringIO()), contextlib.suppress(SystemExit):\n"
        "        main(['--help'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'visual_slam_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    res = _run([sys.executable, "-c", code], REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_fails_without_cuda():
    """No CUDA card here: chip_smoke.py must exit non-zero and print no
    result line — there is no CPU fallback."""
    res = _run([sys.executable, "chip_smoke.py"], REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the package beside it fails too."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    res = _run([sys.executable, "chip_smoke.py"], tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
