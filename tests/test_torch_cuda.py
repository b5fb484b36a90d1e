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
from visual_slam_tpu_torch.ops.kernels import detect_kernel, patch_kernel
from visual_slam_tpu_torch.pipeline import run_sequence
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

pytestmark = pytest.mark.cuda

PEAK_RTOL = 1e-5  # kernel and plain run the same float ops: expect bit-equality
BLUR_ATOL = 1e-6
MIN_DESC_BIT_AGREEMENT = 0.995  # card vs CPU: matmul sums in another order
POSE_ATOL = 1e-4


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
