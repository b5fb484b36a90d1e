"""The port's pipelined driver (run_pipelined) against the JAX package's on
the CPU, on the half-size scene and configuration of test_torch_slam.py
(320x240, halved intrinsics, K=256, M=512): RGB-D over 60 frames and
monocular on every 3rd frame of 178, at pipeline depth 8.

The JAX driver consumes a prepared chunk of init attempts when its fetch
future reports done(), or when two chunks wait. The port decides by the
count alone. So in this file only, the JAX run gets a stand-in for
concurrent.futures.ThreadPoolExecutor whose futures report done() False
and compute their value when result() is first called: the JAX driver then
takes the branch the port always takes. Nothing of visual_slam_tpu changes.
The pipelined paths put PnP on RANSAC (a chain reseeded from a host pose
6-12 frames old, the orphan's far prior), where a torch.Generator cannot
replay JAX's draws and the two drivers' centres part by up to 3.4e-2; so in
the parity runs each tracking step's minimal sets are drawn from the key of
the JAX step of the same rank, as tests/test_torch_match_pnp.py injects
them. The port's own runs (mono_plain) draw from its generator.

The monocular run reaches both backfills on both sides: the 40-deep init
queue re-anchors at frame 153 before the accept of the pair (0, 45) lands
(at the end of the stream), so frame 153 is the orphan anchor, tracked
once against the new map; frames 48 and 51, consumed while the pair's
confirmation was pending, get poses on a side chain. The JAX package
appends them out of frame order; the port keeps its trajectory sorted, and
the JAX one is sorted before the comparison. Poses are held as in
test_torch_slam.py: R, t within 1e-4 until the first BA applies and 1e-3
after (RGB-D); monocular centres within 1e-4 until the second BA applies,
then 1e-2 (that docstring says why).
"""
import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ICL_INTR

from visual_slam_tpu import pipeline as jpipeline
from visual_slam_tpu.config import SlamConfig as JSlamConfig
from visual_slam_tpu.ops import ransac as jransac
from visual_slam_tpu.pipeline import Slam as JSlam, run_pipelined as j_run_pipelined

from visual_slam_tpu_torch.config import SlamConfig
from visual_slam_tpu_torch.ops import pnp
from visual_slam_tpu_torch.pipeline import HostRows, Slam, run_pipelined, run_sequence
from visual_slam_tpu_torch.utils import evaluate
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

HALF_INTR = ICL_INTR / 2
POSE_ATOL, POSE_ATOL_BA = 1e-4, 1e-3  # RGB-D R, t before / after the first BA applies
CENTRE_ATOL, CENTRE_ATOL_BA = 1e-4, 1e-2  # monocular centres before / after the second
N_TRACKED_TOL = 2
MONO_STRIDE, MONO_FRAMES = 3, 178
DEPTH = 8
STATS = ("keyframes", "ba_runs", "ba_dropped_stale", "kf_retracked", "kf_vetoed_stale",
         "kf_veto_cached", "track_failures")


class _LazyFuture:
    """A future that is never done until its result is asked for."""

    def __init__(self, fn, args, kwargs):
        self._call = (fn, args, kwargs)
        self._value = None

    def done(self):
        return False

    def result(self, timeout=None):
        if self._call is not None:
            fn, args, kwargs = self._call
            self._value, self._call = fn(*args, **kwargs), None
        return self._value


class _LazyExecutor:
    def __init__(self, *args, **kwargs):
        pass

    def submit(self, fn, *args, **kwargs):
        return _LazyFuture(fn, args, kwargs)

    def shutdown(self, wait=True, **kwargs):
        pass


class _Recorded(list):
    """A trajectory that notes, for each entry, the applied-BA count when it
    was recorded (the JAX Slam appends; the port appends or inserts)."""

    def __init__(self, slam):
        super().__init__()
        self.slam, self.ba_at = slam, {}

    def _note(self, fr):
        self.ba_at[fr.frame_idx] = self.slam.stats["ba_runs"]

    def append(self, fr):
        self._note(fr)
        super().append(fr)

    def insert(self, k, fr):
        self._note(fr)
        super().insert(k, fr)


def _config(cls, use_depth):
    cfg = cls(use_depth=use_depth, intrinsics=HALF_INTR.copy())
    cfg.frontend.max_features = 256
    cfg.map.track_capacity = 512
    return cfg


def _run_jax(frames, use_depth):
    """The JAX run, and the PRNG key of each of its tracking steps in call
    order."""
    keys = []
    step = jpipeline._track_step

    def keyed(*args, **kwargs):
        keys.append(args[9])
        return step(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(concurrent.futures, "ThreadPoolExecutor", _LazyExecutor)
        mp.setattr(jpipeline, "_track_step", keyed)
        slam = JSlam(_config(JSlamConfig, use_depth))
        slam.trajectory = _Recorded(slam)
        j_run_pipelined(slam, iter(frames), DEPTH)
    return slam, keys


def _run_port(frames, use_depth, jax_keys=None, **kw):
    """The port's run; with `jax_keys`, each tracking step's PnP-RANSAC
    minimal sets are the JAX run's, drawn from the key of the JAX step of
    the same rank (the two drivers make their tracking steps in the same
    order), as tests/test_torch_match_pnp.py injects them."""
    slam = Slam(_config(SlamConfig, use_depth), device="cpu")
    slam.trajectory = _Recorded(slam)
    if jax_keys is None:
        return run_pipelined(slam, iter(frames), DEPTH, **kw)
    keys = iter(jax_keys)
    solve = pnp.solve_pnp_tracked

    def replayed(Xw, uv, intr, mask, guess_R, guess_t, *, n_hyps, **kwargs):
        idx = jransac.sample_minimal_sets(next(keys), n_hyps, 6, len(mask), jnp.asarray(mask.numpy()))
        return solve(Xw, uv, intr, mask, guess_R, guess_t, n_hyps=n_hyps,
                     **{**kwargs, "idx": torch.from_numpy(np.array(idx))})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pnp, "solve_pnp_tracked", replayed)
        run_pipelined(slam, iter(frames), DEPTH, **kw)
    assert next(keys, None) is None  # as many tracking steps as the JAX run
    return slam


@pytest.fixture(scope="module")
def rgbd():
    scene = SyntheticRGBDScene(60, 240, 320, intrinsics=HALF_INTR)
    frames = list(scene.frames())
    jslam, keys = _run_jax(frames, True)
    return scene, jslam, _run_port(frames, True, keys)


@pytest.fixture(scope="module")
def mono_frames():
    scene = SyntheticRGBDScene(MONO_FRAMES, 240, 320, intrinsics=HALF_INTR)
    return scene, [(i, scene.render(i)[0], None) for i in range(0, MONO_FRAMES, MONO_STRIDE)]


@pytest.fixture(scope="module")
def mono(mono_frames):
    scene, frames = mono_frames
    jslam, keys = _run_jax(frames, False)
    return scene, jslam, _run_port(frames, False, keys)


class _Frames:
    def __init__(self, frames):
        self._frames = frames

    def frames(self, start=0, stop=None):
        return iter(self._frames[start:stop])


@pytest.fixture(scope="module")
def mono_plain(mono_frames):
    """The port's pipelined mono run, its RANSAC sets from its generator."""
    return run_sequence(_Frames(mono_frames[1]), _config(SlamConfig, False), device="cpu",
                        pipelined=True)


def _kf_frames(traj):
    return [f.frame_idx for f in traj if f.is_keyframe]


def _sorted(traj):
    return sorted(traj, key=lambda f: f.frame_idx)


def _centres(traj):
    return np.stack([-f.R_cw.T @ f.t_cw for f in traj])


def _check_history(jslam, tslam):
    for k in STATS:
        assert tslam.stats[k] == jslam.stats.get(k, 0), k
    assert tslam.map.n_pt == jslam.map.n_pt and tslam.map.n_obs == jslam.map.n_obs
    # The same applied-BA count when each frame's pose was recorded.
    assert tslam.trajectory.ba_at == jslam.trajectory.ba_at


def test_rgbd_pipelined_matches_jax(rgbd):
    """60 RGB-D frames: keyframes at 0/21/42, the same BA, veto and failure
    counts, map size and BA timeline; R and t within POSE_ATOL of the JAX
    run's until the first BA applies, POSE_ATOL_BA after; ATE < 2 cm."""
    scene, jslam, tslam = rgbd
    assert _kf_frames(jslam.trajectory) == _kf_frames(tslam.trajectory) == [0, 21, 42]
    _check_history(jslam, tslam)
    assert tslam.stats["ba_runs"] == 2 and tslam.stats["track_failures"] == 0
    assert [f.frame_idx for f in tslam.trajectory] == [f.frame_idx for f in jslam.trajectory]
    for fj, ft in zip(jslam.trajectory, tslam.trajectory, strict=True):
        atol = POSE_ATOL if tslam.trajectory.ba_at[ft.frame_idx] < 1 else POSE_ATOL_BA
        np.testing.assert_allclose(ft.R_cw, fj.R_cw, atol=atol)
        np.testing.assert_allclose(ft.t_cw, fj.t_cw, atol=atol)
        assert abs(ft.n_tracked - fj.n_tracked) <= N_TRACKED_TOL
    assert sum(v < 1 for v in tslam.trajectory.ba_at.values()) >= 20  # at the tight bar
    idxs, est = tslam.positions()
    ate, _ = evaluate.ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=False)
    assert ate < 0.02


def test_mono_pipelined_matches_jax(mono):
    """Every 3rd frame: init at 45 after one re-anchor (at 153), the same
    re-verification rejects, keyframes at 0/45/90/111/162, the stats and map
    size of the RGB-D case; every processed frame once in the trajectory,
    the orphan anchor and the side-chain frames included; centres within
    CENTRE_ATOL until the second BA applies, CENTRE_ATOL_BA after."""
    scene, jslam, tslam = mono
    assert jslam.stats["init_frame"] == tslam.stats["init_frame"] == 45
    assert jslam.stats.get("init_reanchors", 0) == tslam.stats["init_reanchors"] == 1
    assert tslam.stats["init_reverify_rejects"] == jslam.stats.get("init_reverify_rejects", 0)
    assert _kf_frames(_sorted(jslam.trajectory)) == _kf_frames(tslam.trajectory) == [0, 45, 90, 111, 162]
    _check_history(jslam, tslam)
    frames = [f.frame_idx for f in tslam.trajectory]
    assert frames == sorted(frames) == [0] + list(range(45, MONO_FRAMES, MONO_STRIDE))
    assert frames == [f.frame_idx for f in _sorted(jslam.trajectory)]
    # The JAX package records the orphan right after the accepted frame.
    assert [f.frame_idx for f in jslam.trajectory][:3] == [0, 45, 153]
    jt = _sorted(jslam.trajectory)
    assert [f.n_tracked for f in tslam.trajectory] == [f.n_tracked for f in jt]
    dc = np.linalg.norm(_centres(tslam.trajectory) - _centres(jt), axis=-1)
    tight = np.array([tslam.trajectory.ba_at[f] < 2 for f in frames])
    assert tight.sum() >= 10
    assert dc[tight].max() < CENTRE_ATOL
    assert dc.max() < CENTRE_ATOL_BA
    # Sim3 ATE ~0.067 m on both sides: the accept lands after the stream,
    # and its backlog of ~40 frames is tracked from a two-keyframe map.
    gt = scene.ground_truth()[frames, :3, 3]
    ate_t, _ = evaluate.ate_rmse(_centres(tslam.trajectory), gt, align_scale=True)
    ate_j, _ = evaluate.ate_rmse(_centres(jt), gt, align_scale=True)
    assert abs(ate_t - ate_j) < 0.01


def test_mono_pipelined_backfills(mono):
    """The orphan anchor (153) is tracked against the new map, a pose with
    the accepted keyframe as its reference; the side-chain frames (48, 51)
    are no keyframes and hold the JAX run's poses."""
    _, jslam, tslam = mono
    by_frame = {f.frame_idx: f for f in tslam.trajectory}
    j_by_frame = {f.frame_idx: f for f in jslam.trajectory}
    orphan = by_frame[153]
    assert not orphan.is_keyframe and orphan.ref_kf == 1 and orphan.n_tracked > 0
    assert tslam.stats["init_orphan_frames"] == 1 and tslam.stats["init_side_chain_frames"] == 2
    for i in (48, 51, 153):
        assert not by_frame[i].is_keyframe and by_frame[i].ref_kf == j_by_frame[i].ref_kf
        np.testing.assert_allclose(_centres([by_frame[i]]), _centres([j_by_frame[i]]),
                                   atol=CENTRE_ATOL)


def test_live_stream_equal_without_side_chain_backfill(mono_frames, mono_plain, monkeypatch):
    """The port's mono run again with the side-chain backfill given an empty
    buffer: every other frame's pose bit for bit, and the same history. The
    side chain saves and restores the live pose chain and the generator."""
    orig = Slam._dispatch_backfill
    seen = []

    def empty(self, handles):
        seen.extend(h["frame_idx"] for h in handles)
        return orig(self, [])

    monkeypatch.setattr(Slam, "_dispatch_backfill", empty)
    bare = _run_port(mono_frames[1], False)
    assert seen == [48, 51]
    want = [f for f in mono_plain.trajectory if f.frame_idx not in seen]
    assert [f.frame_idx for f in bare.trajectory] == [f.frame_idx for f in want]
    for fa, fb in zip(bare.trajectory, want):
        assert fa.is_keyframe == fb.is_keyframe and fa.n_tracked == fb.n_tracked
        assert np.array_equal(fa.R_cw, fb.R_cw) and np.array_equal(fa.t_cw, fb.t_cw)
    side = ("ransac_frames", "init_side_chain_frames")  # the side chain's own counts
    assert {k: v for k, v in bare.stats.items() if k not in side} == \
        {k: v for k, v in mono_plain.stats.items() if k not in side}
    assert (bare.stats["init_side_chain_frames"], mono_plain.stats["init_side_chain_frames"]) == (0, 2)
    assert np.array_equal(bare.map.pt_xyz, mono_plain.map.pt_xyz)


@pytest.mark.parametrize("pipelined,keyframes", [(False, [0, 45, 90, 108, 156]),
                                                 (True, [0, 45, 90, 111, 162])])
def test_mono_keyframes_by_driver(mono, mono_frames, mono_plain, pipelined, keyframes):
    """run_sequence picks the driver: the serial loop keeps its keyframes
    and its Sim3 ATE bar (test_torch_slam.py); the pipelined one, with its
    own RANSAC draws, the parity run's keyframes and history, and an ATE
    within 0.01 of the JAX pipelined run's."""
    scene, jslam = mono_frames[0], mono[1]
    if pipelined:
        slam = mono_plain
    else:
        slam = run_sequence(_Frames(mono_frames[1]), _config(SlamConfig, False), device="cpu")
    assert _kf_frames(slam.trajectory) == keyframes
    assert not slam._async_init_verify and slam._pending_init_verify is None
    gt = scene.ground_truth()
    idxs, est = slam.positions()
    ate, _ = evaluate.ate_rmse(est, gt[idxs, :3, 3], align_scale=True)
    if pipelined:
        for k in STATS + ("init_frame", "init_reanchors", "init_reverify_rejects"):
            assert slam.stats[k] == mono[2].stats[k], k
        jt = _sorted(jslam.trajectory)
        ate_j, _ = evaluate.ate_rmse(_centres(jt), gt[[f.frame_idx for f in jt], :3, 3],
                                     align_scale=True)
        assert abs(ate - ate_j) < 0.01
    else:
        assert ate < 0.04


def test_exception_mid_run_resets_async_init(mono_frames):
    """An exception from the frame iterator mid-run, raised once an init
    confirmation is in flight, leaves the Slam in its serial mode: no
    async confirmation, none pending, synchronising timers."""
    slam = Slam(_config(SlamConfig, False), device="cpu")
    seen = []

    def failing():
        # The confirmation of the pair (0, 45) is dispatched with the 60th
        # frame: one more frame follows it.
        frames = mono_frames[1]
        for fr in frames + [(frames[-1][0] + MONO_STRIDE, *frames[-1][1:])]:
            if slam._pending_init_verify is not None:
                raise KeyError("frame source failed")
            yield fr

    with pytest.raises(KeyError, match="frame source failed"):
        run_pipelined(slam, failing(), DEPTH, h2d_block=1,
                      on_frame=lambda s, i: seen.append(s._async_init_verify))
    assert seen and all(seen) and not slam.initialized
    assert not slam._async_init_verify and slam._pending_init_verify is None
    assert slam.timers.sync


def test_init_confirmation_is_read_at_age_four():
    """_check_init_verify reads a pending confirmation on its fifth tick (or
    when forced), never earlier, whatever the state of the copy."""
    slam = Slam(_config(SlamConfig, False), device="cpu")
    read = []

    class Rows:
        def result(self):
            read.append(True)
            return np.zeros((1, 4), np.float32)  # fails the match gate

    for force in (False, True):
        read.clear()
        slam._pending_init_verify = dict(age=0, rows=Rows(), frame_idx=3, feats=None, step=None,
                                         anchor_feats=None, anchor_idx=0, reverified=True)
        before = slam.stats["init_reverify_rejects"]
        ticks = 0
        while not read:
            assert slam._check_init_verify(force=force) is False
            ticks += 1
        assert ticks == (1 if force else 5)
        assert slam._pending_init_verify is None
        assert slam.stats["init_reverify_rejects"] == before + 1


def test_host_rows_stack_and_copy_on_the_cpu():
    """HostRows stacks the rows of several steps into one host array; on
    the CPU it is a plain copy (no event), detached from its sources."""
    rows = [torch.arange(13, dtype=torch.float32) + 100 * k for k in range(4)]
    copy = HostRows(rows)
    rows[0].zero_()
    got = copy.result()
    assert copy.event is None and got.shape == (4, 13) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.stack([np.arange(13) + 100 * k for k in range(4)]))
