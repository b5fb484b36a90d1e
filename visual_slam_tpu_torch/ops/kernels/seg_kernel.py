"""Kernels B4 and B5: camera-segment reduce and expand for bundle adjustment.

Replace visual_slam_tpu/ops/pallas/seg_kernel.py:_cam_reduce_kernel (via
`cam_reduce`) and _cam_expand_kernel (via `cam_expand`). The TPU kernels
multiply by an implicit two-level one-hot matrix because XLA's scatter and
gather were row-rate-limited there; the CUDA kernels (csrc/seg.cu) gather
with native loads, and the reduce takes a deterministic segmented sum over
a reduce plan. The header of the source says what bounds them on the H100.

    cam_reduce: (C,N) per-slot rows, (N,) camera ids, K -> (C,K) sums
    cam_expand: (C,K) per-camera rows, (N,) camera ids  -> (C,N) copies

A camera id outside [0,K) contributes nothing to the reduce and receives 0
from the expand (the Pallas kernels' padding rule). `cam_expand_torch` and
`cam_reduce_torch` are the plain PyTorch versions. The expand copies, so
the kernel is bit-equal to its plain version. The reduce adds in an order
fixed by its plan (`reduce_plan`), the same on every call and every run
(tests/torch_parity.py's `cam_reduce_walk` repeats its additions in
PyTorch). Against its plain version (`index_add_`, another order) it
agrees to rtol 1e-5 / atol 1e-4, the JAX package's own bar between its
kernel and its XLA version, where a camera has few slots, and exactly
where every partial sum is exact in float32. Where thousands of slots
share a camera, `index_add_`'s own float32 sums drift past that bar; B4's
tree of partial sums stays closer to the float64 sums there.

The plan is integer bookkeeping on the camera ids, built with PyTorch ops on
the ids' device and without a host read. A BA problem's ids stay fixed over
its LM and CG iterations, so `ba.optimize` and `ba_large.optimize` build one
plan per call and pass it to every `cam_reduce`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import build

reduce_launches = 0  # B4 calls (each is two kernel launches, counted once)
expand_launches = 0  # B5 launches

_MAX_K = 1 << 28  # keeps K * sizeof(float) inside the C side's int
WARP_RUN = 32  # B4 sums a longer run of one camera in a tile with a warp
TILE_GROUPS = 4  # B4's second pass splits the tiles into this many shares, in order
MIN_TILE, MAX_TILE = 1024, 16384  # MAX_TILE: an int16 offset; 3 rows fill shared memory

EXPAND_THREADS, EXPAND_MIN_THREADS = 1024, 128  # B5's block sizes, long and short N


class ReducePlan(NamedTuple):
    """How kernel B4 walks the slots of one camera index `cam` (N,) with K
    cameras. Slots are cut into tiles of `tile` contiguous slots. "Sorted
    order" lists the in-range slots tile by tile, each tile's stably sorted
    by camera; a camera's slots inside one tile are a run, and runs are
    numbered in sorted order. `max_runs` bounds the number of runs from the
    shapes alone, so building a plan never reads the device."""

    K: int
    N: int
    tile: int
    order: torch.Tensor  # (N rounded up to a multiple of 8,) int16: slot - tile * T at each sorted position
    run_start: torch.Tensor  # (max_runs+1,) int32: first sorted position; unused runs start at the end
    tile_ptr: torch.Tensor  # (n_tiles+1,) int32: tile t owns runs [tile_ptr[t], tile_ptr[t+1])
    # (n_tiles, ceil(K/32), 2) int32 (mask, base): bit l of mask marks a run
    # of camera 32 w + l in tile t; base is tile t's first run with camera >= 32 w
    words: torch.Tensor

    @property
    def max_runs(self) -> int:
        return self.run_start.shape[0] - 1

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self[3:])


def default_tile(N: int) -> int:
    """Tiles of up to MAX_TILE slots, at least about 128 of them where N allows."""
    tile = MIN_TILE
    while tile < MAX_TILE and tile * 128 < N:
        tile *= 2
    return tile


def max_runs(N: int, K: int, tile: int) -> int:
    """Most runs a plan can hold: one per (tile, camera), never more than N."""
    return max(1, min(N, -(-N // tile) * min(K, tile)))


def reduce_plan(cam: torch.Tensor, K: int, tile: int | None = None) -> ReducePlan:
    """The reduce plan of camera ids `cam` (N,) int32 over K cameras, on
    cam's device: a stable sort, a cumulative sum and binary searches, each
    of a shape fixed by (N, K, tile)."""
    if cam.dtype != torch.int32 or cam.dim() != 1:
        raise ValueError("reduce_plan takes (N,) int32 camera ids")
    N = cam.shape[0]
    T = default_tile(N) if tile is None else tile
    if T < 16 or T > MAX_TILE or T & (T - 1):
        raise ValueError(f"reduce_plan: tile {T} is not a power of two in [16, {MAX_TILE}]")
    if not 1 <= K <= _MAX_K or N >= 1 << 31:
        raise ValueError(f"reduce_plan: K = {K}, N = {N} out of range")
    dev, i32 = cam.device, torch.int32
    n_tiles = -(-N // T)
    R = max_runs(N, K, T)
    W = -(-K // 32)
    if N == 0:
        z = lambda *n: torch.zeros(n, dtype=i32, device=dev)  # noqa: E731
        return ReducePlan(K, N, T, torch.zeros(0, dtype=torch.int16, device=dev), z(R + 1), z(1),
                          z(0, W, 2))
    kt = torch.int64 if n_tiles * K >= (1 << 31) - 1 else i32
    slot = torch.arange(N, dtype=torch.int64, device=dev)
    sentinel = n_tiles * K  # out-of-range ids sort after every tile
    valid = (cam >= 0) & (cam < K)
    key = torch.where(valid, (slot // T).to(kt) * K + cam.to(kt), sentinel)
    skey, perm = torch.sort(key, stable=True)  # ties keep slot order
    order = torch.zeros(-(-N // 8) * 8, dtype=torch.int16, device=dev)  # 16-byte copies
    order[:N] = perm % T
    is_start = skey < sentinel
    is_start[1:] &= skey[1:] != skey[:-1]
    count = torch.cumsum(is_start, 0)  # runs started at or before each position
    n_runs, n_valid = count[-1], (skey < sentinel).sum()
    run_start = torch.minimum(
        torch.searchsorted(count, torch.arange(1, R + 2, device=dev)), n_valid)
    real = torch.arange(R, device=dev) < n_runs
    rkey = torch.where(real, skey[run_start[:R].clamp(max=N - 1)], sentinel).to(torch.int64)
    tile_ptr = torch.searchsorted(rkey, torch.arange(n_tiles + 1, device=dev) * K)
    base = torch.searchsorted(rkey, (torch.arange(n_tiles, device=dev)[:, None] * K
                                     + torch.arange(W, device=dev) * 32).reshape(-1))
    rcam = rkey % K
    word = torch.where(real, (rkey // K) * W + rcam // 32, n_tiles * W)  # unused runs: a spare word
    mask = torch.zeros(n_tiles * W + 1, dtype=torch.int64, device=dev)
    mask.index_add_(0, word, torch.where(real, torch.ones_like(rcam) << (rcam % 32), 0))
    mask = mask[:-1]
    mask = torch.where(mask >= 1 << 31, mask - (1 << 32), mask)  # the same 32 bits as int32
    words = torch.stack([mask, base], dim=1).reshape(n_tiles, W, 2)
    return ReducePlan(K, N, T, order, run_start.to(i32), tile_ptr.to(i32), words.to(i32))


class ExpandGeometry(NamedTuple):
    """How kernel B5 covers a (C,K) -> (C,N) expand (csrc/seg.cu). Thread t
    of block (b, y) takes channels [y * ck, y * ck + ck) of the 4-slot
    groups q = b * threads + t + i * grid_x * threads, i = 0, 1, ..., below
    expand_groups(N, vec4). Group q's slots: 4q..4q+3 with 16-byte accesses,
    else 128 w + l + 32 j (j < 4) for q = 32 w + l, so a warp's 4-byte
    accesses are coalesced."""

    ck: int  # channels a chunk
    chunks: int  # grid y, ceil(C / ck)
    grid_x: int  # blocks a chunk, each walking the groups with a grid stride
    threads: int
    vec4: bool  # 16-byte ids and stores; else 4-byte ones, coalesced across a warp
    evict_first: bool  # streaming stores: the output is larger than L2


def expand_groups(N: int, vec4: bool) -> int:
    """B5's 4-slot groups: N / 4 with 16-byte accesses, else 32 a 128 slots."""
    return N // 4 if vec4 else -(-N // 128) * 32


@functools.lru_cache(maxsize=256)
def expand_geometry(C: int, N: int, sms: int, l2_bytes: int, vec4: bool = True) -> ExpandGeometry:
    """B5's launch for C channels and N slots on a card with `sms` SMs and
    `l2_bytes` of L2; `vec4`: the ids are 16-byte aligned. One block of
    EXPAND_THREADS an SM walks the groups, all channels at once; where N is
    too short for a block an SM, smaller blocks, then chunks of fewer
    channels, down to one. Cached: a BA problem's shapes are fixed over its
    calls."""
    vec4 = vec4 and N % 4 == 0
    groups = expand_groups(N, vec4)
    threads, ck, chunks = EXPAND_THREADS, C, 1
    while -(-groups // threads) * chunks < sms and threads > EXPAND_MIN_THREADS:
        threads //= 2
    while -(-groups // threads) * chunks < sms and ck > 1:
        chunks = -(-C // (ck - 1))
        ck = -(-C // chunks)
    resident = EXPAND_THREADS // threads  # 64 registers a thread: 1024 threads an SM
    grid_x = max(1, min(resident * sms // chunks, -(-groups // threads)))
    return ExpandGeometry(ck, chunks, grid_x, threads, vec4, 4 * C * N > l2_bytes)


@functools.cache
def _card(index: int) -> tuple[int, int]:
    """(SMs, L2 bytes) of CUDA card `index`."""
    prop = torch.cuda.get_device_properties(index)
    return prop.multi_processor_count, prop.L2_cache_size


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


def cam_reduce(data: torch.Tensor, cam: torch.Tensor, K: int,
               plan: ReducePlan | None = None) -> torch.Tensor:
    """(C,N) float32, (N,) int32, K -> (C,K) float32 per-camera sums.
    CPU tensor: the plain version (`plan` is not read). CUDA tensor: kernel
    B4 over `plan`, built here from (cam, K) when not given; one call, two
    launches."""
    global reduce_launches
    if data.device.type == "cpu":
        return cam_reduce_torch(data, cam, K)
    _check(data, cam, K, "cam_reduce")
    C, N = data.shape
    if cam.shape[0] != N:
        raise ValueError(f"cam_reduce: {cam.shape[0]} camera ids for {N} slots")
    if plan is None:
        plan = reduce_plan(cam, K)
    if plan.K != K or plan.N != N or plan.order.device != data.device:
        raise ValueError(f"cam_reduce: a plan for K={plan.K}, N={plan.N} on "
                         f"{plan.order.device}, given K={K}, N={N} on {data.device}")
    partial = torch.empty((C, plan.max_runs), dtype=torch.float32, device=data.device)
    out = torch.empty((C, K), dtype=torch.float32, device=data.device)
    err = build.library().vslam_cam_reduce(
        data.data_ptr(), plan.order.data_ptr(), plan.run_start.data_ptr(),
        plan.tile_ptr.data_ptr(), plan.words.data_ptr(), partial.data_ptr(), out.data_ptr(),
        C, N, K, plan.tile, plan.max_runs,
        torch.cuda.current_stream(data.device).cuda_stream, data.device.index,
    )
    build.check(err, "vslam_cam_reduce")
    reduce_launches += 1
    return out


def _launch_expand(lib, x: torch.Tensor, cam: torch.Tensor, g: ExpandGeometry) -> torch.Tensor:
    """One launch of B5 from `lib` (a build of csrc/seg.cu) over geometry
    `g`, on tensors `_check` has passed; raises on a CUDA error. Counts
    nothing: `cam_expand` does."""
    C, K = x.shape
    N = cam.shape[0]
    out = torch.empty((C, N), dtype=torch.float32, device=x.device)
    err = lib.vslam_cam_expand(
        x.data_ptr(), cam.data_ptr(), out.data_ptr(), C, N, K, g.ck, g.grid_x, g.threads,
        g.vec4, g.evict_first, torch.cuda.current_stream(x.device).cuda_stream, x.device.index,
    )
    build.check(err, "vslam_cam_expand")
    return out


def cam_expand(x: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """(C,K) float32, (N,) int32 -> (C,N) float32 per-slot copies.
    CPU tensor: the plain version. CUDA tensor: kernel B5, one launch."""
    global expand_launches
    if x.device.type == "cpu":
        return cam_expand_torch(x, cam)
    C, K = x.shape
    _check(x, cam, K, "cam_expand")
    g = expand_geometry(C, cam.shape[0], *_card(x.device.index), cam.data_ptr() % 16 == 0)
    out = _launch_expand(build.library(), x, cam, g)
    expand_launches += 1
    return out
