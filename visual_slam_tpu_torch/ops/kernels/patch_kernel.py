"""Kernel B3: per-keypoint 32x32 patch gather.

Replaces visual_slam_tpu/ops/pallas/patch_kernel.py:_patch_kernel, which
the JAX package composes with the one-hot matmul cut (`extract_windows`
then `cut_patches`, together `extract_patches`). The TPU's aligned 40x160
window and the one-hot cut exist only for Mosaic's 8/128 alignment rule;
the CUDA kernel (csrc/patch.cu) copies the exact patch instead.

Both take one image or a stack: (H,W) + (K,2) -> (K,32,32), or (B,H,W) +
(B,K,2) -> (B,K,32,32), the stack in one launch (the JAX package vmaps its
pallas_call in the batched front-end).

`extract_patches_torch` is the plain PyTorch version; the copy is exact, so
the kernel agrees with it bit for bit.
"""
from __future__ import annotations

import torch

from . import build

PATCH = 32  # patch side; the keypoint pattern fits a 31x31 window + bilinear +1

launches = 0


def patch_corners(uv: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(...,2) keypoints -> (...,2) float patch corners [cx, cy]:
    floor(uv) - 15, clamped to [0, W-32] x [0, H-32]."""
    corner = torch.floor(uv) - (PATCH // 2 - 1)
    return torch.stack(
        [corner[..., 0].clamp(0, W - PATCH), corner[..., 1].clamp(0, H - PATCH)], dim=-1
    )


def patch_frac(uv: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(K,2) offset of each keypoint from its patch corner (the second
    output of the JAX package's extract_patches; the front-end does not
    use it, so the kernel's wrapper does not compute it)."""
    return uv - patch_corners(uv, H, W)


def extract_patches_torch(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Plain version: (H,W) image + (K,2) keypoints -> (K,32,32) patches, or
    (B,H,W) + (B,K,2) -> (B,K,32,32)."""
    H, W = img.shape[-2:]
    c = patch_corners(uv, H, W).to(torch.int64)
    ar = torch.arange(PATCH, device=img.device)
    rows = (c[..., 1, None] + ar)[..., :, None]  # (...,K,32,1)
    cols = (c[..., 0, None] + ar)[..., None, :]  # (...,K,1,32)
    if img.dim() == 2:
        return img[rows, cols]
    b = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[b, rows, cols]


def extract_patches(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(H,W) float32 image + (K,2) float32 keypoints -> (K,32,32) patches,
    or a (B,H,W) stack + (B,K,2) keypoints -> (B,K,32,32).
    CPU tensor: the plain version. CUDA tensor: kernel B3, one launch for
    the whole stack."""
    global launches
    if img.device.type == "cpu" and uv.device.type == "cpu":
        return extract_patches_torch(img, uv)
    if img.device.type != "cuda" or uv.device != img.device:
        raise ValueError(f"patch kernel: tensors on {img.device} / {uv.device}")
    if img.dtype != torch.float32 or img.dim() not in (2, 3) or not img.is_contiguous():
        raise ValueError("patch kernel takes a contiguous (H,W) or (B,H,W) float32 image")
    if (uv.dtype != torch.float32 or uv.dim() != img.dim() or uv.shape[-1] != 2
            or uv.shape[:-2] != img.shape[:-2] or not uv.is_contiguous()):
        raise ValueError("patch kernel takes contiguous float32 keypoints, (K,2) for an (H,W) "
                         "image and (B,K,2) for a (B,H,W) stack")
    B = img.shape[0] if img.dim() == 3 else 1
    H, W = img.shape[-2:]
    if H < PATCH or W < PATCH:
        raise ValueError(f"image {H}x{W} is smaller than a {PATCH}x{PATCH} patch")
    K = uv.shape[-2]
    out = torch.empty((*uv.shape[:-1], PATCH, PATCH), dtype=torch.float32, device=img.device)
    lib = build.library()
    err = lib.vslam_patch(
        img.data_ptr(), uv.data_ptr(), out.data_ptr(), B, H, W, K,
        torch.cuda.current_stream(img.device).cuda_stream, img.device.index,
    )
    build.check(err, "vslam_patch")
    launches += 1
    return out
