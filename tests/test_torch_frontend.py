"""Parity of the port's front-end (kernels B1/B2/B3 in their plain PyTorch
versions, top-K, descriptors) with the JAX package on the CPU. The CUDA
kernels themselves are tested in test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import (RAGGED_SIZES, check_or_recompute, checkerboard, desc_bits, edge_keypoints,
                          n, smooth_noise, t, uniform_noise)

from visual_slam_tpu.models import frontend as jfrontend
from visual_slam_tpu.ops import descriptor as jdesc, descriptor_mxu as jmxu
from visual_slam_tpu.ops.pallas import detect_kernel as jdetect, patch_kernel as jpatch

from visual_slam_tpu_torch import convert
from visual_slam_tpu_torch.models import frontend
from visual_slam_tpu_torch.ops import descriptor, descriptor_mxu
from visual_slam_tpu_torch.ops.kernels import detect_kernel, patch_kernel

# Stated tolerances (JAX's CPU backend contracts a*b+c into FMAs, the port
# does not, so float results may differ in the last bit):
PEAK_RTOL = 1e-5  # NMS'd response at the (exactly equal) peak positions
BLUR_ATOL = 1e-6  # blurred image, values in [0,1]
MIN_DESC_BIT_AGREEMENT = 0.995  # bf16 sampling matmul sums in another order


def _images():
    rng = np.random.default_rng(1)
    small = smooth_noise(128, 256, sigma=2.0, seed=1)
    small[40:80, 60:100] = 1.0  # planted corners, as test_pallas_kernels.py
    return {
        "noise_128x256": small,
        "noise_480x640": smooth_noise(480, 640, sigma=3.0, seed=0),
        "checker_480x640": checkerboard(),
        "raw_480x640": rng.uniform(0, 1, (480, 640)).astype(np.float32),
        **{f"raw_{h}x{w}": uniform_noise(h, w, seed=h + w) for h, w in RAGGED_SIZES},
        "raw_45x70_border0": uniform_noise(45, 70, seed=115),
    }


IMAGES = _images()
BORDER = {"raw_45x70_border0": 0}  # the rest: the default 16 px frame


def test_constant_tables_bit_equal():
    """PATTERN, _D, _WX and _WY are rebuilt by the port bit for bit, and the
    converter carries the JAX tables over unchanged."""
    np.testing.assert_array_equal(descriptor.PATTERN, np.asarray(jdesc.PATTERN))
    np.testing.assert_array_equal(descriptor_mxu.difference_matrices(), jmxu._D)
    np.testing.assert_array_equal(descriptor_mxu._WX, jmxu._WX)
    np.testing.assert_array_equal(descriptor_mxu._WY, jmxu._WY)
    ours = descriptor_mxu.tables("cpu")
    theirs = convert.from_jax_tables(jdesc.PATTERN, jmxu._D, jmxu._WX, jmxu._WY, "cpu")
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_detect_blur_plain_matches_pallas(name):
    """B1 plain vs corner_peaks_and_blur_pallas (interpret): the peak
    positions exactly, the response to PEAK_RTOL, the blur to BLUR_ATOL; at
    ragged sizes, with border 0, and on an image no larger than the border
    frame (no finite peak)."""
    img, border = IMAGES[name], BORDER.get(name, 16)

    def check(port, jx):
        (pt, bt), (pj, bj) = port, jx
        np.testing.assert_array_equal(np.isfinite(pt), np.isfinite(pj))
        fin = np.isfinite(pj)
        if min(img.shape) <= 2 * border:
            assert not fin.any()
        else:
            assert fin.sum() > 10
        np.testing.assert_allclose(pt[fin], pj[fin], rtol=PEAK_RTOL, atol=0)
        np.testing.assert_allclose(bt, bj, rtol=0, atol=BLUR_ATOL)

    check_or_recompute(
        check,
        lambda: tuple(n(a) for a in detect_kernel.corner_peaks_and_blur(t(img), border=border)),
        lambda: tuple(np.asarray(a) for a in jdetect.corner_peaks_and_blur_pallas(
            jnp.asarray(img), border=border, interpret=True)))


def test_detect_b2_mode_plain_matches_pallas():
    """B2 (peaks only) plain vs corner_peaks_pallas, and equal to B1's peaks."""
    img = IMAGES["noise_128x256"]
    pj = np.asarray(jdetect.corner_peaks_pallas(jnp.asarray(img), interpret=True))
    pt = n(detect_kernel.corner_peaks(t(img)))
    np.testing.assert_array_equal(np.isfinite(pt), np.isfinite(pj))
    fin = np.isfinite(pj)
    np.testing.assert_allclose(pt[fin], pj[fin], rtol=PEAK_RTOL, atol=0)
    assert torch.equal(t(pt), detect_kernel.corner_peaks_and_blur(t(img))[0])


@pytest.mark.parametrize("H,W,K", [(128, 256, 64), (480, 640, 1024)])
def test_patches_plain_bit_exact(H, W, K):
    """B3 plain vs cut_patches(*extract_windows(interpret)): bit-exact patches,
    including keypoints that clamp at every edge; frac as extract_patches."""
    img = np.random.default_rng(2).uniform(0, 1, (H, W)).astype(np.float32)
    uv = edge_keypoints(H, W, K)
    want = np.asarray(jpatch.cut_patches(*jpatch.extract_windows(
        jnp.asarray(img), jnp.asarray(uv), interpret=True)))
    _, want_frac = jpatch.extract_patches(jnp.asarray(img), jnp.asarray(uv), interpret=True)
    got = patch_kernel.extract_patches(t(img), t(uv))
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(patch_kernel.patch_frac(t(uv), H, W)), np.asarray(want_frac))


def test_topk_tie_order():
    """Equal peak values come out in ascending flat index, as jax.lax.top_k."""
    peaks = np.full((40, 50), -np.inf, np.float32)
    for (y, x) in [(30, 7), (5, 40), (5, 9), (20, 20), (12, 3)]:
        peaks[y, x] = 2.0
    peaks[7, 7] = 3.0
    uv_j, top_j, valid_j = jfrontend._topk_select(jnp.asarray(peaks), 12)
    uv_t, top_t, valid_t = frontend._topk_select(t(peaks), 12)
    np.testing.assert_array_equal(n(uv_t), np.asarray(uv_j))
    np.testing.assert_array_equal(n(top_t), np.asarray(top_j))
    np.testing.assert_array_equal(n(valid_t), np.asarray(valid_j))


@pytest.mark.parametrize("name", ["checker_480x640", "noise_480x640"])
def test_extract_matches_jax(name):
    """The whole front-end vs frontend.extract_pallas at 480x640, K=1024:
    uv and valid equal, score to PEAK_RTOL (it is B1's response), >= 99.5%
    of descriptor bits equal."""
    img = IMAGES[name]
    fj = jfrontend.extract_pallas(jnp.asarray(img), max_features=1024)
    ft = frontend.extract(t(img), max_features=1024)
    np.testing.assert_array_equal(n(ft.uv), np.asarray(fj.uv))
    np.testing.assert_array_equal(n(ft.valid), np.asarray(fj.valid))
    np.testing.assert_allclose(n(ft.score), np.asarray(fj.score), rtol=PEAK_RTOL, atol=0)
    valid = np.asarray(fj.valid)
    assert valid.sum() > 50
    agree = desc_bits(convert.to_jax_desc(ft.desc))[valid] == desc_bits(np.asarray(fj.desc))[valid]
    assert agree.mean() >= MIN_DESC_BIT_AGREEMENT, agree.mean()


def test_descriptor_words_round_trip():
    """int32 words carry the uint32 bits: pack/unpack and the converter agree
    with the JAX unpack, high bit included."""
    rng = np.random.default_rng(3)
    d = rng.integers(0, 2**32, size=(16, 8), dtype=np.uint32)
    d[0, 0] = 0xFFFFFFFF
    d[1, 0] = 0x80000000
    dt = convert.from_jax_desc(d, "cpu")
    assert dt.dtype == torch.int32
    np.testing.assert_array_equal(convert.to_jax_desc(dt), d)
    pm1 = np.asarray(jdesc.unpack_pm1(jnp.asarray(d), dtype=jnp.float32))
    np.testing.assert_array_equal(n(descriptor.unpack_pm1(dt)), pm1)
    np.testing.assert_array_equal(n(descriptor.pack_bits(descriptor.unpack_pm1(dt) > 0)), n(dt))


def test_cpu_wrappers_use_plain_versions():
    """On a CPU tensor the wrappers run the plain versions and count no launch."""
    before = (detect_kernel.launches, detect_kernel.launches_no_blur, patch_kernel.launches)
    img = t(IMAGES["noise_128x256"])
    frontend.extract(img, max_features=64)
    detect_kernel.corner_peaks(img)
    assert (detect_kernel.launches, detect_kernel.launches_no_blur,
            patch_kernel.launches) == before
