"""Kernel B1: fused corner peaks + Gaussian blur (B2: peaks only).

Replaces visual_slam_tpu/ops/pallas/detect_kernel.py:_detect_blur_kernel
(called through corner_peaks_and_blur_pallas) and, as the blur-off mode of
the same CUDA kernel, _detect_kernel (corner_peaks_pallas). The CUDA source
is csrc/detect_blur.cu; its header says what bounds it on the H100 and how
the tiling answers that.

`corner_peaks_and_blur_torch` is the plain PyTorch version. It does the
float operations of the JAX kernel in the same order, which is also the
CUDA kernel's order, so on the card the two agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0  # B1 launches (blur on)
launches_no_blur = 0  # B2-mode launches (blur off)

NMS_RADIUS = 3  # the CUDA kernel's compile-time NMS radius
BLUR_RADIUS = 4  # ... and blur radius


def blur_weights(radius: int = BLUR_RADIUS, sigma: float = 2.0) -> np.ndarray:
    """(radius+1,) float32: centre weight first, then distance 1..radius.

    The float32 values of the normalised float64 Gaussian, as the JAX
    kernel bakes them in."""
    x = np.arange(-radius, radius + 1)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)[radius:]


def _shift(x: torch.Tensor, dy: int, dx: int, fill: float = 0.0) -> torch.Tensor:
    """out[y, x] = x[y - dy, x - dx], `fill` where that falls off the image."""
    H, W = x.shape
    out = torch.full_like(x, fill)
    out[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = (
        x[max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
    )
    return out


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum via separable zero-padded shifts."""
    h = _shift(x, 0, -1) + x + _shift(x, 0, 1)
    return _shift(h, -1, 0) + h + _shift(h, 1, 0)


def corner_peaks_torch(img: torch.Tensor, nms_radius: int = 3, border: int = 16):
    """(H,W) float32 -> (H,W) NMS'd min-eigenvalue response (-inf off-peak)."""
    H, W = img.shape
    tl, t, tr = _shift(img, 1, 1), _shift(img, 1, 0), _shift(img, 1, -1)
    bl, b, br = _shift(img, -1, 1), _shift(img, -1, 0), _shift(img, -1, -1)
    l, r = _shift(img, 0, 1), _shift(img, 0, -1)
    ix = (tr + 2 * r + br - tl - 2 * l - bl) * 0.125
    iy = (bl + 2 * b + br - tl - 2 * t - tr) * 0.125
    ixx = _box3(ix * ix) * (1.0 / 9.0)
    iyy = _box3(iy * iy) * (1.0 / 9.0)
    ixy = _box3(ix * iy) * (1.0 / 9.0)
    tr_h = 0.5 * (ixx + iyy)
    d = 0.5 * (ixx - iyy)
    det_part = torch.sqrt(torch.clamp_min(d * d + ixy * ixy, 0.0))
    resp = tr_h - det_part
    neg_inf = float("-inf")
    inside = torch.zeros_like(resp, dtype=torch.bool)
    inside[border:H - border, border:W - border] = True
    resp = torch.where(inside, resp, neg_inf)
    m = resp
    for d in range(1, nms_radius + 1):
        m = torch.maximum(m, torch.maximum(_shift(resp, 0, -d, neg_inf), _shift(resp, 0, d, neg_inf)))
    mm = m
    for d in range(1, nms_radius + 1):
        mm = torch.maximum(mm, torch.maximum(_shift(m, -d, 0, neg_inf), _shift(m, d, 0, neg_inf)))
    return torch.where(resp >= mm, resp, neg_inf)


def gaussian_blur_torch(img: torch.Tensor, radius: int = BLUR_RADIUS, sigma: float = 2.0):
    """Separable zero-padded Gaussian: horizontal pass, then vertical."""
    g = [float(w) for w in blur_weights(radius, sigma)]
    h = img * g[0]
    for d in range(1, radius + 1):
        h = h + (_shift(img, 0, -d) + _shift(img, 0, d)) * g[d]
    v = h * g[0]
    for d in range(1, radius + 1):
        v = v + (_shift(h, -d, 0) + _shift(h, d, 0)) * g[d]
    return v


def corner_peaks_and_blur_torch(img, nms_radius=3, border=16, blur_radius=BLUR_RADIUS, blur_sigma=2.0):
    """Plain version of B1: (H,W) float32 -> (peaks, blurred)."""
    return (
        corner_peaks_torch(img, nms_radius, border),
        gaussian_blur_torch(img, blur_radius, blur_sigma),
    )


def _launch(img: torch.Tensor, nms_radius: int, border: int, with_blur: bool,
            blur_radius: int, blur_sigma: float):
    if img.device.type != "cuda":
        raise ValueError(f"detect kernel: tensor on {img.device}, not CUDA")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("detect kernel takes a contiguous (H,W) float32 image")
    if nms_radius != NMS_RADIUS or blur_radius != BLUR_RADIUS:
        raise ValueError(
            f"detect kernel is compiled for nms_radius={NMS_RADIUS}, "
            f"blur_radius={BLUR_RADIUS}"
        )
    H, W = img.shape
    lib = build.library()
    peaks = torch.empty_like(img)
    blur = torch.empty_like(img) if with_blur else None
    g = [float(w) for w in blur_weights(blur_radius, blur_sigma)]
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = lib.vslam_detect_blur(
        img.data_ptr(), peaks.data_ptr(), blur.data_ptr() if with_blur else None,
        H, W, border, *g, stream, img.device.index,
    )
    build.check(err, "vslam_detect_blur")
    return peaks, blur


def corner_peaks_and_blur(img: torch.Tensor, nms_radius: int = 3, border: int = 16,
                          blur_radius: int = BLUR_RADIUS, blur_sigma: float = 2.0):
    """(H,W) float32 image -> (NMS'd corner peaks, Gaussian-blurred image).

    CPU tensor: the plain version. CUDA tensor: kernel B1, one launch."""
    global launches
    if img.device.type == "cpu":
        return corner_peaks_and_blur_torch(img, nms_radius, border, blur_radius, blur_sigma)
    peaks, blur = _launch(img, nms_radius, border, True, blur_radius, blur_sigma)
    launches += 1
    return peaks, blur


def corner_peaks(img: torch.Tensor, nms_radius: int = 3, border: int = 16):
    """(H,W) float32 -> (H,W) NMS'd corner response. CUDA: B1 with the blur
    switched off (B2 mode)."""
    global launches_no_blur
    if img.device.type == "cpu":
        return corner_peaks_torch(img, nms_radius, border)
    peaks, _ = _launch(img, nms_radius, border, False, BLUR_RADIUS, 2.0)
    launches_no_blur += 1
    return peaks
