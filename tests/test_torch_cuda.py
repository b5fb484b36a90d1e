"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA card and skips without one; this
file imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from torch_parity import checkerboard, desc_bits, edge_keypoints, smooth_noise

from visual_slam_tpu_torch import convert
from visual_slam_tpu_torch.config import SlamConfig
from visual_slam_tpu_torch.models import frontend
from visual_slam_tpu_torch.models import ba, ba_large
from visual_slam_tpu_torch.ops.kernels import detect_kernel, patch_kernel, seg_kernel
from visual_slam_tpu_torch.pipeline import run_sequence
from visual_slam_tpu_torch.utils import synthetic
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

pytestmark = pytest.mark.cuda

PEAK_RTOL = 1e-5  # kernel and plain run the same float ops: expect bit-equality
BLUR_ATOL = 1e-6
MIN_DESC_BIT_AGREEMENT = 0.995  # card vs CPU: matmul sums in another order
POSE_ATOL = 1e-4
# B4 adds with float atomics: the JAX package's bar between its reduce
# kernel and its XLA version (tests/test_pallas_kernels.py:46-48).
REDUCE_RTOL, REDUCE_ATOL = 1e-5, 1e-4
# BA on the card vs on the CPU: f32 camera sums associate differently and LM
# accept/reject rounds amplify it (the JAX package's sharded-identity bars,
# tests/test_ba_large.py:41-46).
BA_COST_RTOL, BA_T_ATOL, BA_X_ATOL = 1e-2, 1e-3, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["noise", "checker"])
def test_detect_blur_matches_plain(cuda, name):
    """B1 and its B2 mode vs the plain version, both on the card."""
    img_np = smooth_noise(480, 640) if name == "noise" else checkerboard()
    img = torch.from_numpy(img_np).to(cuda)
    n0, n2 = detect_kernel.launches, detect_kernel.launches_no_blur
    pk, bk = detect_kernel.corner_peaks_and_blur(img)
    p2 = detect_kernel.corner_peaks(img)
    pp, bp = detect_kernel.corner_peaks_and_blur_torch(img)
    torch.cuda.synchronize()
    assert (detect_kernel.launches, detect_kernel.launches_no_blur) == (n0 + 1, n2 + 1)
    fin = torch.isfinite(pp)
    assert torch.equal(torch.isfinite(pk), fin) and torch.equal(p2, pk)
    torch.testing.assert_close(pk[fin], pp[fin], rtol=PEAK_RTOL, atol=0)
    torch.testing.assert_close(bk, bp, rtol=0, atol=BLUR_ATOL)


def test_patch_matches_plain(cuda):
    """B3 is bit-exact, including keypoints that clamp at every edge."""
    img = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (480, 640)).astype(np.float32)).to(cuda)
    uv = torch.from_numpy(edge_keypoints(480, 640, 1024)).to(cuda)
    n0 = patch_kernel.launches
    got = patch_kernel.extract_patches(img, uv)
    want = patch_kernel.extract_patches_torch(img, uv)
    assert patch_kernel.launches == n0 + 1
    assert torch.equal(got, want)


def test_wrappers_raise_instead_of_falling_back(cuda):
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    with pytest.raises(ValueError):
        detect_kernel.corner_peaks_and_blur(torch.zeros((64, 64), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        detect_kernel.corner_peaks_and_blur(torch.zeros((64, 64), device=cuda), nms_radius=2)
    with pytest.raises(ValueError):
        patch_kernel.extract_patches(torch.zeros((64, 64), device=cuda), torch.zeros((4, 2)))


def test_frontend_card_matches_cpu(cuda):
    img = torch.from_numpy(smooth_noise(480, 640, seed=4))
    fg = frontend.extract(img.to(cuda), 1024)
    fc = frontend.extract(img, 1024)
    assert torch.equal(fg.uv.cpu(), fc.uv) and torch.equal(fg.valid.cpu(), fc.valid)
    torch.testing.assert_close(fg.score.cpu(), fc.score, rtol=PEAK_RTOL, atol=0)
    v = fc.valid.numpy()
    agree = desc_bits(convert.to_jax_desc(fg.desc))[v] == desc_bits(convert.to_jax_desc(fc.desc))[v]
    assert agree.mean() >= MIN_DESC_BIT_AGREEMENT


def test_slice_card_matches_cpu(cuda):
    """8 frames of the RGB-D slice on the card and on the CPU agree."""
    intr = np.array([240.6, 240.0, 159.75, 119.75], np.float32)
    scene = SyntheticRGBDScene(8, 240, 320, intrinsics=intr)
    runs = []
    for device in (cuda, "cpu"):
        cfg = SlamConfig(use_depth=True, intrinsics=intr)
        cfg.frontend.max_features = 256
        cfg.map.track_capacity = 512
        runs.append(run_sequence(scene, cfg, device=device))
    for fg, fc in zip(runs[0].trajectory, runs[1].trajectory):
        np.testing.assert_allclose(fg.R_cw, fc.R_cw, atol=POSE_ATOL)
        np.testing.assert_allclose(fg.t_cw, fc.t_cw, atol=POSE_ATOL)
        assert abs(fg.n_tracked - fc.n_tracked) <= 2
    assert runs[0].stats == runs[1].stats


@pytest.mark.parametrize("C,N,K,case", [
    (27, 1 << 22, 5000, "config5"),  # the build's reduce at BASELINE.json config #5
    (12, 1 << 22, 5000, "config5"),  # the projection's expand there
    (5, 100003, 257, "ragged"),  # N a multiple of no block; ids >= K and < 0
    (27, 1 << 20, 5000, "hot"),  # 90% of the slots on 3 cameras
    (3, 50000, 100000, "wide"),  # K too wide for shared memory
])
def test_seg_kernels_match_plain(cuda, C, N, K, case):
    rng = np.random.default_rng(C + K)
    cam = rng.integers(0, K, N).astype(np.int32)
    data = rng.normal(size=(C, N)).astype(np.float32)
    if case == "ragged":
        cam[::7], cam[::11] = K + 3, -1
    if case == "hot":
        hot = rng.uniform(size=N) < 0.9
        cam[hot] = np.array([7, 1234, K - 1], np.int32)[rng.integers(0, 3, int(hot.sum()))]
        data = (rng.integers(-1024, 1024, (C, N)) / 256).astype(np.float32)  # exact sums
    d, c = torch.from_numpy(data).to(cuda), torch.from_numpy(cam).to(cuda)
    x = torch.from_numpy(rng.normal(size=(C, K)).astype(np.float32)).to(cuda)
    n_red, n_exp = seg_kernel.reduce_launches, seg_kernel.expand_launches
    red = seg_kernel.cam_reduce(d, c, K)
    exp = seg_kernel.cam_expand(x, c)
    assert (seg_kernel.reduce_launches, seg_kernel.expand_launches) == (n_red + 1, n_exp + 1)
    torch.testing.assert_close(red, seg_kernel.cam_reduce_torch(d, c, K),
                               rtol=REDUCE_RTOL, atol=REDUCE_ATOL)
    if case == "hot":
        assert torch.equal(red, seg_kernel.cam_reduce_torch(d, c, K))
    assert torch.equal(exp, seg_kernel.cam_expand_torch(x, c))


def test_seg_wrappers_raise_instead_of_falling_back(cuda):
    cam = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        seg_kernel.cam_reduce(torch.zeros((3, 10), dtype=torch.float64, device=cuda), cam, 4)
    with pytest.raises(ValueError):
        seg_kernel.cam_reduce(torch.zeros((3, 10), device=cuda), cam.long(), 4)
    with pytest.raises(ValueError):
        seg_kernel.cam_reduce(torch.zeros((10, 3), device=cuda).T, cam, 4)
    with pytest.raises(ValueError):
        seg_kernel.cam_expand(torch.zeros((3, 4), device=cuda), cam.cpu())


def test_ba_large_card_matches_cpu(cuda):
    prob, gt = synthetic.build_loop_map(64, 2048, 4)
    n_red, n_exp = seg_kernel.reduce_launches, seg_kernel.expand_launches
    og, cg = ba_large.optimize(ba.BAProblem(*(f.to(cuda) for f in prob)), n_iters=5, cg_iters=8,
                               init_lambda=1e-2)
    oc, cc = ba_large.optimize(prob, n_iters=5, cg_iters=8, init_lambda=1e-2)
    assert seg_kernel.reduce_launches - n_red == 5 * (8 + 2)
    assert seg_kernel.expand_launches - n_exp == 1 + 5 * (8 + 3)
    assert abs(float(cg) - float(cc)) < BA_COST_RTOL * float(cc)
    np.testing.assert_allclose(og.t.cpu().numpy(), oc.t.numpy(), atol=BA_T_ATOL)
    np.testing.assert_allclose(og.X.cpu().numpy(), oc.X.numpy(), atol=BA_X_ATOL)


@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_online_ba_card_matches_cpu(cuda, solver):
    runs = []
    for device in (cuda, "cpu"):
        prob, _ = synthetic.arc_problem(6, 300, 0.3, 0.03, 0.05, seed=0, device=device)
        runs.append(ba.optimize(prob, n_iters=6, cg_iters=10, solver=solver))
    (og, cg), (oc, cc) = runs
    assert abs(float(cg) - float(cc)) < BA_COST_RTOL * float(cc)
    # Monocular scale is a gauge freedom here: compare scale-aligned.
    s = np.linalg.norm(og.t[1].cpu().numpy()) / np.linalg.norm(oc.t[1].numpy())
    np.testing.assert_allclose(og.t.cpu().numpy() / s, oc.t.numpy(), atol=BA_T_ATOL)
