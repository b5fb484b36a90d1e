"""The batched multi-sequence run (config #3) on the CPU: the batched
front-end and the batch-wide plain versions of kernels B1 and B3 against
their single-image counterparts and the JAX package's vmapped front-end,
and `multi.run_batched` against the JAX package's `run_batched` and against
the port's own `run_sequence`, on distinct WindowViews of the half-size
synthetic scene (320x240, halved intrinsics, K=256, M=512).

Stated tolerances: the front-end against JAX has the bars of
tests/test_torch_frontend.py (uv and valid equal, score rtol 1e-5, >= 99.5%
of descriptor bits); poses against JAX those of tests/test_torch_slam.py
(R, t within 1e-4 until the first BA applies, 1e-3 after); the port's
batched path against its single path: bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slam import HALF_INTR, POSE_ATOL, POSE_ATOL_BA, _configs
from torch_parity import RAGGED_SIZES, checkerboard, desc_bits, edge_keypoints, n, smooth_noise, t, uniform_noise

from visual_slam_tpu import multi as jmulti
from visual_slam_tpu.models import frontend as jfrontend
from visual_slam_tpu.utils.dataset import WindowView as JWindowView

from visual_slam_tpu_torch import convert, multi
from visual_slam_tpu_torch.models import frontend
from visual_slam_tpu_torch.ops.kernels import detect_kernel, patch_kernel
from visual_slam_tpu_torch.pipeline import run_sequence
from visual_slam_tpu_torch.utils.dataset import WindowView
from visual_slam_tpu_torch.utils.scene import FrameSequence, SyntheticRGBDScene

PEAK_RTOL = 1e-5
MIN_DESC_BIT_AGREEMENT = 0.995
N_FRAMES = 30


def _stack(h=240, w=320):
    return np.stack([smooth_noise(h, w, sigma=3.0, seed=7), checkerboard(h, w, 20),
                     uniform_noise(h, w, seed=9)])


def _same_features(fb, singles):
    for b, f in enumerate(singles):
        for name in f._fields:
            assert torch.equal(getattr(fb, name)[b], getattr(f, name)), (b, name)


@pytest.mark.parametrize("h,w", [(240, 320), *RAGGED_SIZES[2:4]])
def test_batched_plain_kernels_equal_single(h, w):
    """The plain versions of B1 (peaks, blur, B2 mode) and B3 on a (B,H,W)
    stack equal B single-image calls bit for bit, at ragged sizes too."""
    imgs = t(np.stack([uniform_noise(h, w, seed=s) for s in range(3)]))
    peaks, blur = detect_kernel.corner_peaks_and_blur(imgs, border=0 if h < 60 else 16)
    b2 = detect_kernel.corner_peaks(imgs)
    K = 64
    uv = t(np.stack([edge_keypoints(h, w, K, seed=s) for s in range(3)]))
    patches = patch_kernel.extract_patches(imgs, uv)
    assert patches.shape == (3, K, 32, 32)
    for b in range(3):
        p1, b1 = detect_kernel.corner_peaks_and_blur(imgs[b], border=0 if h < 60 else 16)
        assert torch.equal(peaks[b], p1) and torch.equal(blur[b], b1)
        assert torch.equal(b2[b], detect_kernel.corner_peaks(imgs[b]))
        assert torch.equal(patches[b], patch_kernel.extract_patches(imgs[b], uv[b]))


def test_extract_batch_matches_jax():
    """extract_batch at B=2, 240x320, K=256 against the JAX package's
    vmapped Pallas front-end (interpret mode): uv and valid equal, score to
    PEAK_RTOL, >= 99.5% of descriptor bits equal, per image."""
    imgs = _stack()[:2]
    fj = jfrontend.extract_batch(jnp.asarray(imgs), 256)
    ft = frontend.extract_batch(t(imgs), 256)
    assert ft.uv.shape == (2, 256, 2) and ft.desc.shape == (2, 256, 8)
    np.testing.assert_array_equal(n(ft.uv), np.asarray(fj.uv))
    np.testing.assert_array_equal(n(ft.valid), np.asarray(fj.valid))
    np.testing.assert_allclose(n(ft.score), np.asarray(fj.score), rtol=PEAK_RTOL, atol=0)
    for b in range(2):
        valid = np.asarray(fj.valid[b])
        assert valid.sum() > 50
        agree = desc_bits(convert.to_jax_desc(ft.desc[b]))[valid] == desc_bits(np.asarray(fj.desc[b]))[valid]
        assert agree.mean() >= MIN_DESC_BIT_AGREEMENT, (b, agree.mean())


def test_extract_batch_equals_single_extract():
    """extract_batch on a float32 gray stack and on a uint8 RGB stack gives
    each image's extract features bit for bit."""
    imgs = _stack()
    _same_features(frontend.extract_batch(t(imgs), 256), [frontend.extract(t(a), 256) for a in imgs])
    rgb = np.random.default_rng(4).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    _same_features(frontend.extract_batch(t(rgb), 128), [frontend.extract(t(a), 128) for a in rgb])


class _Record:
    """Mixin: the BA-apply count after each frame a Slam consumes."""

    def _try_initialize(self, frame_idx, feats, depth):
        super()._try_initialize(frame_idx, feats, depth)
        self.ba_after.append(self.stats["ba_runs"])

    def _track(self, frame_idx, feats, depth):
        super()._track(frame_idx, feats, depth)
        self.ba_after.append(self.stats["ba_runs"])


def _recording(cls):
    class Recording(_Record, cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.ba_after = []

    return Recording


@pytest.fixture(scope="module")
def rgbd_base():
    scene = SyntheticRGBDScene(60, 240, 320, intrinsics=HALF_INTR)
    return FrameSequence(list(scene.frames()), scene.ground_truth())


def _rgbd_views(base, cls):
    return [cls(base, 0, length=N_FRAMES), cls(base, 20, length=N_FRAMES, reverse=True)]


@pytest.fixture(scope="module")
def rgbd_runs(rgbd_base):
    """The port's run_batched, the JAX package's (its front-end sharded
    over 2 of the suite's 8 virtual CPU devices) and the port's
    run_sequence of each view, RGB-D."""
    jcfg, tcfg = _configs(True)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jmulti, "Slam", _recording(jmulti.Slam))
        mp.setattr(multi, "Slam", _recording(multi.Slam))
        jslams = jmulti.run_batched(_rgbd_views(rgbd_base, JWindowView), jcfg)
        tslams = multi.run_batched(_rgbd_views(rgbd_base, WindowView), tcfg, device="cpu")
    finally:
        mp.undo()
    for s in jslams:
        s.close()
    singles = [run_sequence(v, tcfg, device="cpu") for v in _rgbd_views(rgbd_base, WindowView)]
    return jslams, tslams, singles


def _kf_frames(slam):
    return [f.frame_idx for f in slam.trajectory if f.is_keyframe]


def _apply_frames(slam):
    b = slam.ba_after
    return [i for i in range(len(b)) if b[i] > (b[i - 1] if i else 0)]


def test_run_batched_rgbd_matches_jax(rgbd_runs):
    """Per sequence: init, keyframe and BA-apply frames equal the JAX
    run_batched's, R and t within POSE_ATOL until the first BA applies and
    POSE_ATOL_BA after; the two sequences really differ."""
    jslams, tslams, _ = rgbd_runs
    for js, ts in zip(jslams, tslams):
        assert ts.stats["init_frame"] == js.stats["init_frame"] == 0
        assert _kf_frames(ts) == _kf_frames(js) and len(_kf_frames(ts)) >= 2
        assert _apply_frames(ts) == _apply_frames(js) and ts.stats["ba_runs"] >= 1
        first_apply = _apply_frames(ts)[0]
        assert [f.frame_idx for f in ts.trajectory] == [f.frame_idx for f in js.trajectory]
        for ft, fj in zip(ts.trajectory, js.trajectory):
            atol = POSE_ATOL if ft.frame_idx < first_apply else POSE_ATOL_BA
            np.testing.assert_allclose(ft.R_cw, fj.R_cw, atol=atol)
            np.testing.assert_allclose(ft.t_cw, fj.t_cw, atol=atol)
        assert ts.stats["frontend_devices"] == 1 and js.stats["frontend_devices"] == 2
    _, c0 = tslams[0].positions()
    _, c1 = tslams[1].positions()
    assert np.abs(c0 - c1).max() > 1e-3


def _same_run(batched, single):
    """Bit for bit: the trajectory, the stats (but frontend_devices) and
    the map's landmarks."""
    assert len(batched.trajectory) == len(single.trajectory)
    for a, b in zip(batched.trajectory, single.trajectory):
        assert (a.frame_idx, a.is_keyframe, a.n_tracked, a.ref_kf) == (
            b.frame_idx, b.is_keyframe, b.n_tracked, b.ref_kf)
        assert np.array_equal(a.R_cw, b.R_cw) and np.array_equal(a.t_cw, b.t_cw)
    stats = {k: v for k, v in batched.stats.items() if k != "frontend_devices"}
    assert stats == single.stats
    assert np.array_equal(batched.map.pt_xyz, single.map.pt_xyz)


def test_run_batched_rgbd_equals_run_sequence(rgbd_runs):
    """Each sequence of the port's run_batched equals its own run_sequence
    bit for bit."""
    _, tslams, singles = rgbd_runs
    for b, s in zip(tslams, singles):
        _same_run(b, s)


def test_run_batched_mono_equals_run_sequence():
    """Monocular, two windows of every 3rd frame of the half-size scene: each
    sequence of run_batched inits where its run_sequence does and equals it
    bit for bit."""
    scene = SyntheticRGBDScene(178, 240, 320, intrinsics=HALF_INTR)
    base = FrameSequence([(j, scene.render(i)[0], None) for j, i in enumerate(range(0, 150, 3))])
    views = [WindowView(base, 0, length=N_FRAMES), WindowView(base, 20, length=N_FRAMES)]
    _, tcfg = _configs(False)
    slams = multi.run_batched(views, tcfg, device="cpu")
    for view, slam in zip(views, slams):
        assert slam.initialized
        _same_run(slam, run_sequence(view, tcfg, device="cpu"))
