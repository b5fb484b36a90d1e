"""Oriented rBRIEF descriptors from 32x32 patches via per-rotation sampling
matrices (port of visual_slam_tpu/ops/descriptor_mxu.py:49-158).

  1. kernel B3 (ops/kernels/patch_kernel.py) gathers a 32x32 patch of the
     blurred image per keypoint,
  2. the intensity-centroid orientation is a dot product with two fixed
     moment-weight vectors,
  3. the orientation is blended between two of N_BINS rotations; bin b has
     a difference matrix D_b (1024 x 256) whose column s holds the bilinear
     weights of BRIEF sample s+256 minus those of sample s, so
     bits = (patch_flat @ D_b > 0),
  4. bits pack into (K, 8) int32 words (ops/descriptor.pack_bits).

The sampling matmul runs over all bins, as the JAX package's einsum does,
with bf16-rounded inputs and float32 accumulation; the bin blend is float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import descriptor as desc_ref
from .kernels import patch_kernel

N_BINS = 32
N_BITS = desc_ref.N_BITS
PATCH = patch_kernel.PATCH
_CENTER = PATCH // 2 - 1  # keypoint sits at (15,15) for integer corners


def _build_sampling_matrices() -> np.ndarray:
    """(N_BINS, PATCH*PATCH, 512) float32 bilinear sampling matrices."""
    pat = desc_ref.PATTERN  # (256,2,2) offsets
    # Endpoints flattened as [256 first, 256 second].
    px = np.concatenate([pat[:, 0, 0], pat[:, 1, 0]])  # (512,)
    py = np.concatenate([pat[:, 0, 1], pat[:, 1, 1]])
    S = np.zeros((N_BINS, PATCH * PATCH, 512), np.float32)
    for b in range(N_BINS):
        th = 2 * np.pi * b / N_BINS
        c, s = np.cos(th), np.sin(th)
        xs = _CENTER + c * px - s * py
        ys = _CENTER + s * px + c * py
        x0 = np.clip(np.floor(xs), 0, PATCH - 2).astype(np.int64)
        y0 = np.clip(np.floor(ys), 0, PATCH - 2).astype(np.int64)
        fx = xs - x0
        fy = ys - y0
        cols = np.arange(512)
        S[b, y0 * PATCH + x0, cols] += (1 - fx) * (1 - fy)
        S[b, y0 * PATCH + x0 + 1, cols] += fx * (1 - fy)
        S[b, (y0 + 1) * PATCH + x0, cols] += (1 - fx) * fy
        S[b, (y0 + 1) * PATCH + x0 + 1, cols] += fx * fy
    return S


@functools.cache
def difference_matrices() -> np.ndarray:
    """(N_BINS, 1024, 256) float32: D_b = S_b[:, 256:] - S_b[:, :256].

    Built on first use (32 MB), not at import."""
    S = _build_sampling_matrices()
    return np.ascontiguousarray(S[:, :, N_BITS:] - S[:, :, :N_BITS])


def _orientation_weights():
    """Intensity-centroid moment weights over the patch (ORB orientation)."""
    r = PATCH // 2 - 2  # stay inside the patch
    ys, xs = np.mgrid[0:PATCH, 0:PATCH]
    dx = (xs - _CENTER).astype(np.float32)
    dy = (ys - _CENTER).astype(np.float32)
    circle = ((dx**2 + dy**2) <= r * r).astype(np.float32)
    return (dx * circle).reshape(-1), (dy * circle).reshape(-1)


_WX, _WY = _orientation_weights()  # (1024,) float32 each


@functools.cache
def _device_tables(device: torch.device):
    """The constant tables on `device`: bf16-rounded D (kept as float32),
    and the moment weights."""
    D = torch.from_numpy(difference_matrices()).to(device)
    return (
        D.to(torch.bfloat16).to(torch.float32),
        torch.from_numpy(_WX).to(device),
        torch.from_numpy(_WY).to(device),
    )


def tables(device) -> dict[str, torch.Tensor]:
    """PATTERN, _D, _WX and _WY as float32 tensors on `device` (the tables
    that the port shares with the JAX package; see convert.from_jax_tables)."""
    return dict(
        pattern=torch.from_numpy(desc_ref.PATTERN).to(device),
        D=torch.from_numpy(difference_matrices()).to(device),
        wx=torch.from_numpy(_WX).to(device),
        wy=torch.from_numpy(_WY).to(device),
    )


def orientation_from_patches(flat: torch.Tensor) -> torch.Tensor:
    """(K, 1024) -> (K,) intensity-centroid orientation (radians)."""
    _, wx, wy = _device_tables(flat.device)
    return torch.atan2(flat @ wy, flat @ wx)


def describe_from_patches(patches: torch.Tensor):
    """(K,32,32) patches -> ((K,8) int32 descriptors, (K,) orientations)."""
    K = patches.shape[0]
    flat = patches.reshape(K, PATCH * PATCH)
    theta = orientation_from_patches(flat)
    return _sample_and_pack(flat, theta), theta


def _sample_and_pack(flat: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(K, 1024) patches + (K,) orientations -> (K, 8) packed descriptors.

    Soft bin assignment: blend the two adjacent rotation bins linearly, so
    the sampled values stay continuous in theta (hard quantisation flips
    whole patterns when a noisy orientation crosses a bin boundary).

    bf16 inputs / f32 accumulation, as in the JAX package: intensities are
    in [0,1] and the bilinear weights in [-1,1]; the blended difference only
    feeds a sign test, so the ~0.4% input rounding can flip a bit only where
    the two BRIEF samples are already within image noise of each other.
    Rounding both operands to bf16 and multiplying in float32 (TF32 off)
    gives exact products — the bf16 MXU form — with f32 sums.
    """
    K = flat.shape[0]
    D_bf, _, _ = _device_tables(flat.device)
    two_pi = 2 * np.pi
    # jnp.mod semantics: fmod, then shift negative remainders by the divisor.
    r = torch.fmod(theta, two_pi)
    r = torch.where((r != 0) & (r < 0), r + two_pi, r)
    bin_f = r / two_pi * N_BINS
    fl = torch.floor(bin_f)
    b0 = fl.to(torch.int64) % N_BINS
    b1 = (b0 + 1) % N_BINS
    alpha = bin_f - fl
    flat_bf = flat.to(torch.bfloat16).to(torch.float32)
    outs = torch.matmul(flat_bf, D_bf)  # (B,K,256): all bins in one product
    ar = torch.arange(K, device=flat.device)
    # The one-hot blend over B: only bins b0 and b1 carry weight.
    diff = outs[b0, ar] * (1 - alpha)[:, None] + outs[b1, ar] * alpha[:, None]
    return desc_ref.pack_bits(diff > 0)
