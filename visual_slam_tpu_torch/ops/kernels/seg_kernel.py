"""Kernels B4 and B5: camera-segment reduce and expand for bundle adjustment.

Replace visual_slam_tpu/ops/pallas/seg_kernel.py:_cam_reduce_kernel (via
`cam_reduce`) and _cam_expand_kernel (via `cam_expand`). The TPU kernels
multiply by an implicit two-level one-hot matrix because XLA's scatter and
gather were row-rate-limited there; the CUDA kernels (csrc/seg.cu) gather
and add with native loads and float atomics instead. The header of the
source says what bounds them on the H100 and why the reduce takes
block-private shared-memory sums.

    cam_reduce: (C,N) per-slot rows, (N,) camera ids, K -> (C,K) sums
    cam_expand: (C,K) per-camera rows, (N,) camera ids  -> (C,N) copies

A camera id outside [0,K) contributes nothing to the reduce and receives 0
from the expand (the Pallas kernels' padding rule). `cam_expand_torch` and
`cam_reduce_torch` are the plain PyTorch versions. The expand copies, so
the kernel is bit-equal to its plain version. The reduce adds with float
atomics in an order that changes from run to run; it agrees with its plain
version to rtol 1e-5 / atol 1e-4, the JAX package's own bar between its
kernel and its XLA version.
"""
from __future__ import annotations

import torch

from . import build

reduce_launches = 0  # B4 launches
expand_launches = 0  # B5 launches

_MAX_K = 1 << 28  # keeps K * sizeof(float) inside the C side's int


def _slot_index(cam: torch.Tensor, K: int) -> torch.Tensor:
    """Camera ids with every out-of-range id sent to the extra column K."""
    return torch.where((cam >= 0) & (cam < K), cam, K).to(torch.int64)


def cam_reduce_torch(data: torch.Tensor, cam: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version of B4: (C,N) float32, (N,) ids -> (C,K) per-camera sums."""
    out = torch.zeros((data.shape[0], K + 1), dtype=data.dtype, device=data.device)
    out.index_add_(1, _slot_index(cam, K), data)
    return out[:, :K]


def cam_expand_torch(x: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Plain version of B5: (C,K) float32, (N,) ids -> (C,N) per-slot copies."""
    C, K = x.shape
    padded = torch.cat([x, torch.zeros((C, 1), dtype=x.dtype, device=x.device)], dim=1)
    return padded.index_select(1, _slot_index(cam, K))


def _check(rows: torch.Tensor, cam: torch.Tensor, K: int, name: str) -> None:
    if rows.device.type != "cuda" or cam.device != rows.device:
        raise ValueError(f"{name}: tensors on {rows.device} / {cam.device}")
    if rows.dtype != torch.float32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"{name} takes a contiguous 2-D float32 table")
    if cam.dtype != torch.int32 or cam.dim() != 1 or not cam.is_contiguous():
        raise ValueError(f"{name} takes contiguous (N,) int32 camera ids")
    if not 1 <= K <= _MAX_K:
        raise ValueError(f"{name}: K = {K} cameras is outside [1, {_MAX_K}]")


def cam_reduce(data: torch.Tensor, cam: torch.Tensor, K: int) -> torch.Tensor:
    """(C,N) float32, (N,) int32, K -> (C,K) float32 per-camera sums.
    CPU tensor: the plain version. CUDA tensor: kernel B4, one launch."""
    global reduce_launches
    if data.device.type == "cpu":
        return cam_reduce_torch(data, cam, K)
    _check(data, cam, K, "cam_reduce")
    C, N = data.shape
    if cam.shape[0] != N:
        raise ValueError(f"cam_reduce: {cam.shape[0]} camera ids for {N} slots")
    out = torch.zeros((C, K), dtype=torch.float32, device=data.device)
    err = build.library().vslam_cam_reduce(
        data.data_ptr(), cam.data_ptr(), out.data_ptr(), C, N, K,
        torch.cuda.current_stream(data.device).cuda_stream, data.device.index,
    )
    build.check(err, "vslam_cam_reduce")
    reduce_launches += 1
    return out


def cam_expand(x: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """(C,K) float32, (N,) int32 -> (C,N) float32 per-slot copies.
    CPU tensor: the plain version. CUDA tensor: kernel B5, one launch."""
    global expand_launches
    if x.device.type == "cpu":
        return cam_expand_torch(x, cam)
    C, K = x.shape
    _check(x, cam, K, "cam_expand")
    N = cam.shape[0]
    out = torch.empty((C, N), dtype=torch.float32, device=x.device)
    err = build.library().vslam_cam_expand(
        x.data_ptr(), cam.data_ptr(), out.data_ptr(), C, N, K,
        torch.cuda.current_stream(x.device).cuda_stream, x.device.index,
    )
    build.check(err, "vslam_cam_expand")
    expand_launches += 1
    return out
