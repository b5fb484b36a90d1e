"""The port's command line (pipeline.main) and its outputs (utils/checkpoint,
utils/g2o_io, utils/viz, utils/live_viewer) on the CPU.

The writers are held to the JAX package's on the same inputs: the g2o and
PLY files byte for byte, checkpoints array for array and loaded across
both ways, the match overlay pixel for pixel. `LiveView` is checked as
tests/test_pipeline.py:100-130 checks the JAX one, and beside it. `main()`
runs on a synthetic sequence written to disk in the ICL-NUIM layout and
must equal `run_sequence` over the same directory bit for bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from visual_slam_tpu.models import map_state as jmap_state
from visual_slam_tpu.utils import checkpoint as jcheckpoint
from visual_slam_tpu.utils import g2o_io as jg2o
from visual_slam_tpu.utils import viz as jviz

from visual_slam_tpu_torch import convert, pipeline
from visual_slam_tpu_torch.config import MapConfig, size_config_for
from visual_slam_tpu_torch.models.map_state import SlamMap
from visual_slam_tpu_torch.pipeline import run_sequence
from visual_slam_tpu_torch.utils import checkpoint, g2o_io, live_viewer, viz
from visual_slam_tpu_torch.utils.dataset import ICLNUIMDataset, write_icl_nuim
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

from test_torch_slam import HALF_INTR, _configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G2O_ATOL = 1e-6  # poses printed with 9 decimals, then a quaternion round trip
CLI_FRAMES, CLI_FEATURES = 26, 512


def _random_map(rng) -> SlamMap:
    """A port SlamMap with every array filled from `rng`."""
    m = SlamMap(MapConfig(8, 64, 256, 32))
    for name in convert._MAP_ARRAYS:
        a = getattr(m, name)
        if a.dtype == bool:
            v = rng.random(a.shape) < 0.6
        elif a.dtype.kind == "f":
            v = rng.normal(size=a.shape).astype(a.dtype)
        else:
            v = rng.integers(-(2**31), 2**31 - 1, a.shape).astype(a.dtype)
        setattr(m, name, v)
    m.n_kf, m.n_pt, m.n_obs = 5, 40, 200
    return m


def _jax_map(m: SlamMap):
    c = m.config
    jm = jmap_state.SlamMap(jmap_state.MapConfig(c.max_keyframes, c.max_points,
                                                 c.max_observations, c.track_capacity))
    for name, v in convert.to_jax_map_arrays(m).items():
        setattr(jm, name, v)
    return jm


def _same_map(a, b, obs_depth=True):
    """Equal arrays (descriptors as bits), counts and capacities."""
    for name in convert._MAP_ARRAYS:
        if name == "obs_depth" and not obs_depth:
            continue
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.shape == y.shape and np.array_equal(x.view(np.int32) if x.dtype == np.uint32 else x,
                                                     y.view(np.int32) if y.dtype == np.uint32 else y), name
    for name in ("n_kf", "n_pt", "n_obs"):
        assert int(getattr(a, name)) == int(getattr(b, name)), name
    assert [getattr(a.config, k) for k in ("max_keyframes", "max_points", "max_observations",
                                           "track_capacity")] == [
        getattr(b.config, k) for k in ("max_keyframes", "max_points", "max_observations",
                                       "track_capacity")]


def test_checkpoint_matches_jax_and_loads_across(tmp_path):
    """The port's file holds the JAX package's keys with equal arrays (plus
    obs_depth); each package loads the other's file into an equal map."""
    m = _random_map(np.random.default_rng(0))
    traj = np.random.default_rng(1).normal(size=(9, 3))
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    checkpoint.save_map(ours, m, traj)
    jcheckpoint.save_map(theirs, _jax_map(m), traj)
    with np.load(ours) as a, np.load(theirs) as b:
        assert set(a.files) == set(b.files) | {"obs_depth"}
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    m1, t1 = checkpoint.load_map(ours)
    _same_map(m1, m)
    assert np.array_equal(t1, traj) and m1.pt_desc.dtype == np.int32
    m2, t2 = checkpoint.load_map(theirs)
    _same_map(m2, m, obs_depth=False)
    assert not m2.obs_depth.any() and np.array_equal(t2, traj)
    jm, jt = jcheckpoint.load_map(ours)
    _same_map(jm, m, obs_depth=False)
    assert jm.pt_desc.dtype == np.uint32 and np.array_equal(jt, traj)


def _graph_inputs(rng, K=6, n_pts=7):
    w = rng.normal(scale=0.5, size=(K, 3))
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(K)])
    R *= np.sign(np.linalg.det(R))[:, None, None]
    R[2] = np.diag([1.0, -1.0, -1.0])  # trace < 0: the quaternion's other branches
    t = rng.normal(size=(K, 3)) + w
    valid = np.ones(K, bool)
    valid[3] = False
    edges = [(i, i + 1, R[i] @ R[i + 1].T, rng.normal(size=3)) for i in range(K - 1)]
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32)
    return R.astype(np.float32), t.astype(np.float32), valid, edges, pts, np.arange(n_pts) % 3 > 0


def test_g2o_text_matches_jax_and_loads_across(tmp_path):
    """The same text as the JAX writer, with and without edges and points;
    both readers read both files alike."""
    R, t, valid, edges, pts, pv = _graph_inputs(np.random.default_rng(2))
    for kw in (dict(), dict(edges=edges, points=pts, point_valid=pv)):
        ours, theirs = tmp_path / "ours.g2o", tmp_path / "theirs.g2o"
        g2o_io.save_pose_graph(str(ours), R, t, valid, **kw)
        jg2o.save_pose_graph(str(theirs), R, t, valid, **kw)
        assert ours.read_bytes() == theirs.read_bytes()
        for path in (ours, theirs):
            a, b = g2o_io.load_pose_graph(str(path)), jg2o.load_pose_graph(str(path))
            assert a[0].keys() == b[0].keys() and a[1].keys() == b[1].keys()
            for k in a[0]:
                assert all(np.array_equal(x, y) for x, y in zip(a[0][k], b[0][k]))
            assert all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
            assert len(a[2]) == len(b[2]) == len(kw.get("edges", []))
    poses, points, _ = g2o_io.load_pose_graph(str(ours))
    for k in np.where(valid)[0]:
        R_wc, t_wc = poses[int(k)]
        np.testing.assert_allclose(R_wc, R[k].T, atol=G2O_ATOL)
        np.testing.assert_allclose(t_wc, -R[k].T @ t[k], atol=G2O_ATOL)
    assert sorted(points) == [len(R) + p for p in np.where(pv)[0]]


def test_ply_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (50, 3))
    valid = rng.random(50) < 0.7
    for kw in (dict(), dict(valid=valid), dict(colors=colors, valid=valid)):
        viz.save_ply(str(tmp_path / "a.ply"), pts, **kw)
        jviz.save_ply(str(tmp_path / "b.ply"), pts, **kw)
        assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    assert f"element vertex {int(valid.sum())}" in (tmp_path / "a.ply").read_text()


def test_plots_and_overlay(tmp_path):
    """The match overlay equals the JAX package's pixel for pixel; the
    trajectory and match plots write PNG files."""
    rng = np.random.default_rng(4)
    gray = rng.random((48, 64)).astype(np.float32)
    uv0, uv1 = rng.uniform(0, 60, (9, 2)), rng.uniform(0, 44, (9, 2))
    for args in ((gray, uv0, uv1), (gray, None, uv1), ((gray * 255).astype(np.uint8), None, None)):
        assert np.array_equal(np.asarray(viz._overlay_image(*args)),
                              np.asarray(jviz._overlay_image(*args)))
    est = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    viz.plot_trajectory(est, est + 0.1, str(tmp_path / "traj.png"))
    viz.draw_matches(gray, uv0, gray, uv1, np.arange(9) % 2 == 0, str(tmp_path / "m.png"))
    for name in ("traj.png", "m.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_live_view_dump(tmp_path):
    """LiveView writes complete, current artifacts during a run (the checks
    of tests/test_pipeline.py's test_live_view_dump), and the JAX LiveView
    fed the same Slam writes the same state, trajectory and map."""
    scene = SyntheticRGBDScene(40, 240, 320, intrinsics=HALF_INTR)
    _, cfg = _configs(True)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    gt = scene.ground_truth()[:, :3, 3]
    live = viz.LiveView(str(ours), every=10, gt_positions=gt, plot=True)
    jlive = jviz.LiveView(str(theirs), every=10, gt_positions=gt, plot=False)
    torch.set_num_threads(1)

    def both(slam, i):
        live(slam, i)
        jlive(slam, i)

    run_sequence(scene, cfg, device="cpu", on_frame=both)
    assert live.n_updates == jlive.n_updates == 4
    state = json.loads((ours / "state.json").read_text())
    assert state["frame"] >= 30 and state["initialized"] and state["points"] > 50
    assert (ours / "trajectory.png").stat().st_size > 0
    ply = (ours / "map.ply").read_text().splitlines()
    assert ply[0] == "ply"
    n_vertex = int([ln for ln in ply if ln.startswith("element vertex")][0].split()[-1])
    assert n_vertex == state["points"]
    traj = json.loads((ours / "trajectory.json").read_text())
    assert len(traj["positions"]) == state["trajectory_len"]
    assert all(len(p) == 3 for p in traj["positions"][:3])
    for name in ("state.json", "trajectory.json", "map.ply"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    html = open(live_viewer.VIEWER_HTML).read()
    assert "trajectory.json" in html and "parsePly" in html
    assert not [p for p in os.listdir(ours) if p.startswith(".tmp.")]
    live(None, state["frame"] + 1)  # inside the period: nothing is read or written
    assert live.n_updates == 4
    # A caller that passes the frame gets frame.png, the JAX overlay's pixels.
    gray = scene.gray(5)
    uv = np.random.default_rng(5).uniform(20, 200, (2, 12, 2))
    slam = run_sequence(scene, cfg, 0, 2, device="cpu")
    for view in (live, jlive):
        view(slam, 100, gray=gray, uv_prev=uv[0], uv_cur=uv[1])
    from PIL import Image

    assert np.array_equal(np.asarray(Image.open(ours / "frame.png")),
                          np.asarray(Image.open(theirs / "frame.png")))
    assert not [p for p in os.listdir(ours) if p.startswith(".tmp.")]


@pytest.fixture(scope="module")
def icl_dir(tmp_path_factory):
    """CLI_FRAMES frames of the box room at 640x480 in the ICL-NUIM layout."""
    scene = SyntheticRGBDScene(CLI_FRAMES)
    return write_icl_nuim(str(tmp_path_factory.mktemp("icl")), scene.frames(), scene.ground_truth())


def test_writer_round_trips_through_the_reader(icl_dir):
    """What write_icl_nuim wrote reads back within its quantisation: gray
    to 1/255 (rounded), depth to 1/DEPTH_SCALE, poses to float rounding."""
    scene = SyntheticRGBDScene(CLI_FRAMES)
    ds = ICLNUIMDataset(icl_dir)
    assert len(ds) == CLI_FRAMES
    for i in (0, CLI_FRAMES - 1):
        assert np.abs(ds.gray(i) - scene.gray(i)).max() <= 0.5 / 255 + 1e-6
        assert np.abs(ds.depth(i) - scene.depth(i)).max() <= 0.5 / 5000 + 1e-6
    np.testing.assert_allclose(ds.ground_truth(), scene.ground_truth(), atol=1e-9)


def test_main_equals_run_sequence(icl_dir, tmp_path, capsys):
    """main() with --device cpu prints what run_sequence over the same
    directory gives, bit for bit, and its artifacts load back: the
    checkpoint as the run's map, the g2o file as its keyframe poses, the
    PLY with a vertex a valid point."""
    art = {k: str(tmp_path / v) for k, v in (("ply", "map.ply"), ("g2o", "graph.g2o"),
                                             ("ckpt", "map.npz"), ("traj", "traj.png"))}
    torch.set_num_threads(1)
    out = pipeline.main(["--data", icl_dir, "--frames", str(CLI_FRAMES), "--rgbd", "--pose-graph",
                         "--device", "cpu", "--features", str(CLI_FEATURES), "--verbose",
                         "--export-ply", art["ply"], "--export-g2o", art["g2o"],
                         "--checkpoint", art["ckpt"], "--export-traj", art["traj"],
                         "--live-dump", str(tmp_path / "live"), "--live-every", "10"])
    printed = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in printed[:-1]] == ["frame 0", "frame 25"]
    assert json.loads(printed[-1]) == out
    cfg = size_config_for(CLI_FRAMES)
    cfg.frontend.max_features = CLI_FEATURES
    cfg.use_depth = True
    slam = run_sequence(ICLNUIMDataset(icl_dir), cfg, 0, CLI_FRAMES, device="cpu")
    slam.optimize_pose_graph()
    idxs, est = slam.positions()
    assert out["frames"] == len(idxs) == CLI_FRAMES
    assert (out["keyframes"], out["init_frame"], out["points"]) == (
        slam.stats["keyframes"], slam.stats["init_frame"], int(slam.map.pt_valid.sum()))
    assert slam.stats["keyframes"] >= 1 and slam.stats["ba_runs"] >= 1
    assert out["ate_rmse_m"] < 0.02
    assert (out["map_ply"], out["g2o"], out["checkpoint"], out["trajectory_png"]) == (
        art["ply"], art["g2o"], art["ckpt"], art["traj"])
    m, traj = checkpoint.load_map(art["ckpt"])
    _same_map(m, slam.map)
    assert np.array_equal(traj, est)
    poses, points, _ = g2o_io.load_pose_graph(art["g2o"])
    kf = np.where(slam.map.kf_valid)[0]
    assert sorted(poses) == list(kf) and len(points) == out["points"]
    for k in kf:
        np.testing.assert_allclose(poses[int(k)][1], -slam.map.kf_R[k].T @ slam.map.kf_t[k],
                                   atol=G2O_ATOL)
        np.testing.assert_allclose(poses[int(k)][0], slam.map.kf_R[k].T, atol=G2O_ATOL)
    header = open(art["ply"]).read().split("end_header\n")
    assert f"element vertex {out['points']}" in header[0]
    assert len(header[1].splitlines()) == out["points"]
    assert json.loads((tmp_path / "live" / "state.json").read_text())["frame"] == 20


def test_cli_module_entry():
    """`python -m visual_slam_tpu_torch.pipeline` parses the JAX command
    line's flags, with --device for --platform and no --windowed."""
    res = subprocess.run([sys.executable, "-m", "visual_slam_tpu_torch.pipeline", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--data", "--frames", "--start", "--features", "--device", "--verbose", "--rgbd",
                 "--pose-graph", "--live-dump", "--live-every", "--export-traj", "--export-ply",
                 "--export-g2o", "--checkpoint"):
        assert flag in res.stdout, flag
    assert "--windowed" not in res.stdout and "--platform" not in res.stdout
