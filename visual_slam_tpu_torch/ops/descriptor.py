"""256-bit rotated-BRIEF descriptor constants and bit packing (port of
visual_slam_tpu/ops/descriptor.py:20-41 and :150).

Packed descriptors are (K, 8) int32 tensors that carry the same bit
pattern as the JAX package's (K, 8) uint32 words: torch's uint32 lacks the
bitwise ops this code needs. Bit `s` of word `w` is BRIEF bit `32*w + s`.
Unpacking uses `(w >> s) & 1`, which is right for negative words too
(the arithmetic shift only fills bits that the mask drops).
"""
from __future__ import annotations

import numpy as np
import torch

N_BITS = 256
N_WORDS = N_BITS // 32
PATCH_RADIUS = 13  # sample offsets stay inside a 31x31 patch after rotation


def _make_pattern() -> np.ndarray:
    """Deterministic BRIEF test pattern: (N_BITS, 2, 2) float32 offsets.

    Gaussian-distributed around the center (sigma = patch/5), the classic
    BRIEF-32 recipe; the fixed seed is the JAX package's, so the pattern is
    bit-identical to it.
    """
    rng = np.random.default_rng(20240616)
    sigma = PATCH_RADIUS / 2.0
    pts = rng.normal(scale=sigma, size=(N_BITS, 2, 2))
    return np.clip(pts, -PATCH_RADIUS, PATCH_RADIUS).astype(np.float32)


PATTERN = _make_pattern()  # (256, 2, 2) — (pair, endpoint, xy)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32 packed words (bit s of word w = bit 32w+s)."""
    K = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(K, N_WORDS, 32).to(torch.int64) << shifts).sum(-1)
    # Values are in [0, 2^32); fold to the int32 with the same bits.
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_pm1(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(K, 8) int32 -> (K, 256) ±1 values, the matmul form for matching."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], N_BITS).to(dtype) * 2 - 1
