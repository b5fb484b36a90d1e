"""Feature front-end: detect + orient + describe (port of
visual_slam_tpu/models/frontend.py:21-106, :116, :171-189, :201-210).

The per-frame equivalent of the reference's `Frame.process_frame` ->
`FeatureExtractor.compute_features` (src/v2/frame.py:85-91, :10-14):
Shi-Tomasi corners promoted to oriented keypoints with ORB-style binary
descriptors, at a fixed feature budget with a validity mask. This is the
JAX package's Pallas path (_extract_pallas_fused): kernel B1 for the
response, NMS and blur, exact top-K, kernel B3 for the patches, and the
sampling-matrix descriptor. `extract_batch` runs a (B,H,W) stack through
the same stages with one B1 launch and one B3 launch for the whole stack
(the JAX package's vmapped front-end; multi.run_batched's, config #3).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import descriptor_mxu
from ..ops.kernels import detect_kernel, patch_kernel


class Features(NamedTuple):
    """Fixed-shape per-frame features.

    uv: (K,2) float32 pixel coords; desc: (K,8) int32 packed 256-bit
    descriptors (the JAX package's uint32 bits); score: (K,) corner
    response; valid: (K,) bool.
    """

    uv: torch.Tensor
    desc: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor


def _topk_select(peaks: torch.Tensor, max_features: int, quality_level: float = 0.01):
    """NMS'd peak map (H,W), or a (B,H,W) stack of them -> top-K corner
    coordinates of each map, EXACT top-k.

    Ties keep jax.lax.top_k's order, ascending flat index: NMS keeps plateau
    ties and most of the map is -inf, and torch.topk promises no order among
    equals. A stable descending sort along the last dimension gives (value
    desc, index asc) in each map. The weakest-corner choice alone moved
    200-frame ATE from 0.0147 to 0.0187 in the JAX package (commit 1db4dbd)."""
    W = peaks.shape[-1]
    top, idx = torch.sort(peaks.flatten(-2), dim=-1, descending=True, stable=True)
    top, idx = top[..., :max_features], idx[..., :max_features]
    y = (idx // W).to(torch.float32)
    x = (idx % W).to(torch.float32)
    uv = torch.stack([x, y], dim=-1)
    valid = (top > quality_level * top[..., :1]) & torch.isfinite(top)
    return uv, top, valid


def extract(img: torch.Tensor, max_features: int = 1024, quality_level: float = 0.01,
            nms_radius: int = 3) -> Features:
    """Full front-end for one image: grayscale (H,W) float32 in [0,1], or
    RGB (H,W,3) / gray (H,W) uint8. quality_level/nms_radius mirror
    goodFeaturesToTrack's qualityLevel/minDistance (frame.py:11)."""
    gray = to_gray(img).contiguous()
    peaks, blurred = detect_kernel.corner_peaks_and_blur(gray, nms_radius=nms_radius)
    uv, score, valid = _topk_select(peaks, max_features, quality_level)
    patches = patch_kernel.extract_patches(blurred, uv)
    desc, _ = descriptor_mxu.describe_from_patches(patches)
    return Features(uv=uv, desc=desc, score=score, valid=valid)


def extract_batch(imgs, max_features: int = 1024, quality_level: float = 0.01,
                  nms_radius: int = 3, device="cuda") -> Features:
    """The front-end over a (B,H,W) gray stack (float32 in [0,1], or uint8),
    or a (B,H,W,3) uint8 RGB stack: Features with a leading B, each image's
    the same as `extract` gives it. A tensor runs where it lies; anything
    else (a NumPy stack) is moved to `device` first. On the card: one B1
    launch, one top-K sort and one B3 launch for the whole stack.

    The descriptor runs once per image, in `extract`'s shapes: on an H100 its
    float32 product over all B*K patches at once rounded a sum otherwise and
    flipped a bit against `extract`, and equal features are what hold each
    sequence of multi.run_batched to its own single run."""
    if not isinstance(imgs, torch.Tensor):
        imgs = torch.as_tensor(np.asarray(imgs), device=device)
    gray = to_gray(imgs, batched=True).contiguous()
    if gray.dim() != 3:
        raise ValueError(f"extract_batch takes a (B,H,W) or (B,H,W,3) stack, not {tuple(imgs.shape)}")
    peaks, blurred = detect_kernel.corner_peaks_and_blur(gray, nms_radius=nms_radius)
    uv, score, valid = _topk_select(peaks, max_features, quality_level)
    patches = patch_kernel.extract_patches(blurred, uv)
    desc = torch.stack([descriptor_mxu.describe_from_patches(p)[0] for p in patches])
    return Features(uv=uv, desc=desc, score=score, valid=valid)


def to_gray(rgb: torch.Tensor, batched: bool = False) -> torch.Tensor:
    """(H,W,3) RGB or (H,W) gray, uint8/float -> (H,W) float32 in [0,1];
    with `batched`, a leading batch dimension: (B,H,W,3) or (B,H,W)."""
    img = rgb.to(torch.float32)
    if rgb.dtype == torch.uint8:
        img = img / 255.0
    if rgb.dim() == 2 + batched:
        return img
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
