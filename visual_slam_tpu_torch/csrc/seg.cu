// Camera-segment reduce (B4) and expand (B5) for bundle adjustment.
//
// Replace the Pallas TPU kernels of visual_slam_tpu/ops/pallas/seg_kernel.py:
//   cam_reduce_tile_kernel + cam_reduce_camera_kernel <- _cam_reduce_kernel
//       (via cam_reduce): out[c,k] = sum over slots n with cam[n] == k of data[c,n]
//   cam_expand_kernel  <- _cam_expand_kernel (via cam_expand)
//       out[c,n] = x[c, cam[n]]
// A slot whose camera is outside [0,K) contributes nothing to the reduce and
// receives 0 from the expand, as the Pallas kernels' padding rule gives.
//
// The TPU kernels multiply by a two-level one-hot matrix on the MXU because
// XLA's scatter/gather ran at a few rows per cycle there. Hopper has native
// gathers, so neither kernel here uses tensor cores or a one-hot matrix.
//
// What bounds them on the H100: device-memory bytes. At BASELINE.json
// config #5 (K = 5000 cameras, N = 4,194,304 slots) the expand writes C*N*4
// bytes (201 MB at C = 12, ~60 us at 3.35 TB/s) and the reduce reads C*N*4
// bytes plus the (N,) camera ids (453 MB + 17 MB at C = 27, ~140 us).
//
// B5: bound by device-memory bytes, the C*N*4 it writes and the N*4 ids it
// reads; at config #5 it moves them at ~2.3 TB/s, near what a mix of
// reads and writes reaches on an H100 (a write-only fill_ of the output
// ~3.2 TB/s). What the design does about it: a thread takes 4 slots, with
// one 16-byte load of their ids (the next 4 loaded before the current ones
// are used) and one 16-byte store a channel; where N % 4 != 0 or the ids
// are unaligned, 4-byte ones, each coalesced across the warp. The stores
// are evict-first where the output is larger than L2, so the ids and the
// table stay there. The values are gathered from the channel-major (C,K)
// table through L1/L2, which holds it (240 KB at config #5): a table staged
// camera-major in shared memory was measured within 5% of this gather
// either way (PERF.md) and was dropped. One persistent 1024-thread block an
// SM walks the slots; where N is short the blocks shrink to 128 threads,
// then the channels are cut into chunks (blockIdx.y), until every SM has a
// block. ops/kernels/seg_kernel.expand_geometry picks the chunks, the grid
// and the vector path from the shapes. Every output is a copy, so the
// result is bit-equal to the plain version.
//
// B4: a deterministic segmented sum over a per-problem reduce plan, with no
// atomics. The camera ids of a BA problem do not change across its LM and CG
// iterations, so the plan is built once per problem from (cam, K) in
// ops/kernels/seg_kernel.py (`reduce_plan`): the slots are cut into tiles of
// T contiguous slots; inside a tile the in-range slots are sorted stably by
// camera and stored as int16 offsets into the tile; a camera's slots inside
// a tile form one run, and runs are numbered tile by tile. Two launches make
// one call:
//   1. cam_reduce_tile_kernel, one block per (tile, chunk of channels):
//      keeps the tile's offsets and run bounds in shared memory and walks
//      the chunk's channels one by one, copying the next channel's row of
//      the tile into a double buffer with 16-byte cp.async (coalesced along
//      n, each byte of data read once) while it sums the current one. A run
//      of at most 32 slots is summed by one thread, a longer one (a hot
//      camera) by a warp whose lane l takes slots l, l+32, ... and whose
//      lane sums meet in a fixed shuffle tree. One partial per (run,
//      channel), written in run order, so neighbouring threads store to
//      neighbouring addresses.
//   2. cam_reduce_camera_kernel, one block per (32 cameras, channel): the
//      plan holds, for each tile and 32 cameras, a bit mask of the cameras
//      with a run there and the index of the first such run, so lane l
//      finds its camera's run with one popcount. Each of the block's 4
//      warps adds its quarter of the tiles in order, from 0; the 4 sums are
//      then added in warp order and written to out[c,k] (0 for a camera
//      with no slot). No barrier inside the loop, no atomics.
// Every output is summed in an order fixed by the plan, so the same input
// gives the same bits on every call and every run (`cam_reduce_walk` in
// tests/torch_parity.py repeats the same additions in PyTorch). A hot camera
// (the padding slots of make_problem all carry camera 0) costs one warp per
// tile instead of a chain of serialised atomics. At config #5 (T = 16384)
// about 0.3 N runs remain: the partials add ~0.6 of one read of the rows in
// write plus read traffic. They are written in run order, not at each
// camera's own place: scattered 4-byte stores there took more than half of
// the first pass's time on an H100.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int EXPAND_THREADS = 1024;  // B5: the most threads a block
constexpr int TILE_THREADS = 1024;    // B4 pass 1
constexpr int TILE_GROUPS = 4;        // B4 pass 2: warps of a block, one share of the tiles each
constexpr int TILE_BATCH = 8;         // B4 pass 2: tiles whose loads are in flight together
constexpr int WARP_RUN = 32;          // B4 pass 1: longer runs are summed by a warp
constexpr int SMEM_MAX = 227 * 1024;  // the most dynamic shared memory a block may use

__device__ __forceinline__ bool in_range(int k, int K) {
  return static_cast<unsigned>(k) < static_cast<unsigned>(K);
}

// Slot j (0..3) of thread group q. vec4: 4q + j, so a thread's 4 slots take
// one 16-byte id load and one 16-byte store a channel. Scalar: 128 w + l +
// 32 j for q = 32 w + l, so each of a warp's 4-byte loads and stores covers
// 32 consecutive slots.
__device__ __forceinline__ long long slot_of(long long q, int j, bool vec4) {
  return vec4 ? 4 * q + j : (q / 32) * 128 + q % 32 + 32 * j;
}

// Group q's values into row p, cut at N; evict-first where the output does
// not fit in L2.
__device__ __forceinline__ void store_slots(float* p, long long q, long long N, float4 v,
                                            bool vec4, bool evict_first) {
  if (vec4) {
    if (evict_first) {
      __stcs(reinterpret_cast<float4*>(p) + q, v);
    } else {
      reinterpret_cast<float4*>(p)[q] = v;
    }
    return;
  }
  const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long n = slot_of(q, j, false);
    if (n < N) {
      if (evict_first) {
        __stcs(p + n, s[j]);
      } else {
        p[n] = s[j];
      }
    }
  }
}

// The camera ids of group q's slots (K past N, which the caller never stores).
__device__ __forceinline__ int4 load_ids(const int* __restrict__ cam, long long q, long long N,
                                         int K, bool vec4) {
  if (vec4) return __ldg(reinterpret_cast<const int4*>(cam) + q);
  int k[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long n = slot_of(q, j, false);
    k[j] = n < N ? __ldg(cam + n) : K;
  }
  return make_int4(k[0], k[1], k[2], k[3]);
}

// Block (b, y): channels [y ck, y ck + nc) of every group q = b * blockDim.x +
// threadIdx.x + i * gridDim.x * blockDim.x below `groups` (N / 4 with vec4,
// else 32 per 128 slots), gathered from x through L1/L2; 0 for an id
// outside [0,K).
__global__ void __launch_bounds__(EXPAND_THREADS)
cam_expand_kernel(const float* __restrict__ x, const int* __restrict__ cam,
                  float* __restrict__ out, int C, long long N, int K, int ck, bool vec4,
                  bool evict_first) {
  const int c0 = blockIdx.y * ck, nc = min(ck, C - c0);
  const long long groups = vec4 ? N / 4 : (N + 127) / 128 * 32;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int4 ids = q < groups ? load_ids(cam, q, N, K, vec4) : make_int4(K, K, K, K);
  for (; q < groups; q += stride) {
    const int4 next = q + stride < groups ? load_ids(cam, q + stride, N, K, vec4) : ids;
    int k[4] = {ids.x, ids.y, ids.z, ids.w};
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = in_range(k[j], K);
      k[j] = ok[j] ? k[j] : 0;  // always a valid address; the value is masked below
    }
    float* row = out + static_cast<size_t>(c0) * N;
    for (int c = 0; c < nc; ++c) {
      const float* xc = x + static_cast<size_t>(c0 + c) * K;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __ldg(xc + k[j]);
      store_slots(row + static_cast<size_t>(c) * N, q, N,
                  make_float4(ok[0] ? v[0] : 0.f, ok[1] ? v[1] : 0.f, ok[2] ? v[2] : 0.f,
                              ok[3] ? v[3] : 0.f),
                  vec4, evict_first);
    }
    ids = next;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Copy row c of the tile (len floats from data + c * N + base) into dst:
// 16-byte cp.async where every row start is 16-byte aligned, else one float
// per thread.
__device__ __forceinline__ void stage_row(float* dst, const float* __restrict__ data, int c,
                                          long long N, long long base, int len, bool vec4) {
  const float* src = data + static_cast<size_t>(c) * N + base;
  if (vec4) {
    for (int v = threadIdx.x; v < len / 4; v += blockDim.x) cp_async16(dst + 4 * v, src + 4 * v);
  } else {
    for (int v = threadIdx.x; v < len; v += blockDim.x) dst[v] = src[v];
  }
}

// Block b: tile b / chunks, channels [c0, c0 + nc) with c0 = (b % chunks) * ck,
// one after another: the next channel's row is copied into the other half
// of a double buffer while the current one is summed. Shared memory: 2 rows
// of T floats, the tile's offsets (T + 8 int16, copied from the 16-byte
// boundary below its first sorted position; `order` is padded to a multiple
// of 8 entries) and its run bounds (up to T + 1 uint16, relative to that
// boundary).
__global__ void __launch_bounds__(TILE_THREADS)
cam_reduce_tile_kernel(const float* __restrict__ data, const int16_t* __restrict__ order,
                       const int* __restrict__ run_start, const int* __restrict__ tile_ptr,
                       float* __restrict__ partial, int C, long long N, int T, int ck,
                       int chunks, long long max_runs, bool vec4) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);
  uint16_t* offs = reinterpret_cast<uint16_t*>(rows + 2 * static_cast<size_t>(T));
  uint16_t* bounds = offs + T + 8;
  const int tile = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * ck;
  const int nc = min(ck, C - c0);
  const long long base = static_cast<long long>(tile) * T;
  const int len = static_cast<int>(min(static_cast<long long>(T), N - base));
  const int r0 = tile_ptr[tile], nr = tile_ptr[tile + 1] - r0;
  const int jb = run_start[r0] & ~7, je = (run_start[r0 + nr] + 7) & ~7;
  for (int i = threadIdx.x; i < (je - jb) / 8; i += blockDim.x)
    cp_async16(offs + 8 * i, order + jb + 8 * i);
  stage_row(rows, data, c0, N, base, len, vec4);
  cp_async_commit();
  for (int i = threadIdx.x; i <= nr; i += blockDim.x) bounds[i] = run_start[r0 + i] - jb;
  const int lane = threadIdx.x % 32;

  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      stage_row(rows + ((c + 1) & 1) * static_cast<size_t>(T), data, c0 + c + 1, N, base, len,
                vec4);
      cp_async_commit();
      cp_async_wait<1>();  // channel c (and the offsets) landed; c + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* row = rows + (c & 1) * static_cast<size_t>(T);
    float* dst = partial + static_cast<size_t>(c0 + c) * max_runs + r0;

    // Runs of at most WARP_RUN slots: one thread each, the slots in order
    // from 0.
    for (int i = threadIdx.x; i < nr; i += blockDim.x) {
      const int a = bounds[i], b = bounds[i + 1];
      if (b - a > WARP_RUN) continue;
      float s = 0.f;
      for (int j = a; j < b; ++j) s += row[offs[j]];
      dst[i] = s;
    }
    // Longer runs: one warp each. Lane l sums slots l, l+32, ... in order;
    // the 32 lane sums meet in a fixed shuffle tree.
    for (int w = (threadIdx.x / 32) * 32; w < nr; w += blockDim.x) {
      const int i = w + lane;
      const int n = i < nr ? bounds[i + 1] - bounds[i] : 0;
      unsigned long_runs = __ballot_sync(0xffffffffu, n > WARP_RUN);
      while (long_runs) {
        const int ii = w + __ffs(long_runs) - 1;
        long_runs &= long_runs - 1;
        float s = 0.f;
        for (int j = bounds[ii] + lane; j < bounds[ii + 1]; j += 32) s += row[offs[j]];
        for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
        if (lane == 0) dst[ii] = s;
      }
    }
    __syncthreads();  // this half of the buffer is refilled two channels on
  }
}

// Block (w, c): cameras [32 w, 32 w + 32), channel c. words[t * W + w] is
// (mask, base): bit l of mask says camera 32 w + l has a run in tile t, and
// base is the index of the first run of tile t with camera >= 32 w, so that
// camera's run is base + (the set bits of mask below l). Warp q takes tiles
// [q * share, (q + 1) * share).
__global__ void __launch_bounds__(TILE_GROUPS * 32)
cam_reduce_camera_kernel(const float* __restrict__ partial, const int2* __restrict__ words,
                         float* __restrict__ out, int K, int tiles, int W, long long max_runs) {
  __shared__ float part[TILE_GROUPS][32];
  const int w = blockIdx.x, c = blockIdx.y, q = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int share = (tiles + TILE_GROUPS - 1) / TILE_GROUPS;
  const int t_end = min(tiles, (q + 1) * share);
  const float* src = partial + static_cast<size_t>(c) * max_runs;
  const unsigned below = (1u << lane) - 1u;
  float s = 0.f;
  for (int t0 = q * share; t0 < t_end; t0 += TILE_BATCH) {
    int2 e[TILE_BATCH];
#pragma unroll
    for (int u = 0; u < TILE_BATCH; ++u)
      e[u] = t0 + u < t_end ? words[static_cast<size_t>(t0 + u) * W + w] : make_int2(0, 0);
    float v[TILE_BATCH];
#pragma unroll
    for (int u = 0; u < TILE_BATCH; ++u) {
      const unsigned m = static_cast<unsigned>(e[u].x);
      v[u] = (m >> lane) & 1u ? src[e[u].y + __popc(m & below)] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < TILE_BATCH; ++u) s += v[u];  // + 0 where the camera has no run
  }
  part[q][lane] = s;
  __syncthreads();
  if (q == 0) {
    float o = part[0][lane];
#pragma unroll
    for (int g = 1; g < TILE_GROUPS; ++g) o += part[g][lane];
    const int k = 32 * w + lane;
    if (k < K) out[static_cast<size_t>(c) * K + k] = o;
  }
}

}  // namespace

// x (C,K) float32, cam (N,) int32, out (C,N) float32, all contiguous on
// `device`; launch on `stream`. The geometry comes from
// seg_kernel.expand_geometry: ck channels a chunk (one chunk per
// blockIdx.y), grid_x blocks of `threads` per chunk, vec4 (16-byte ids and
// stores) and evict_first (streaming stores). Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a geometry the kernel does not take.
extern "C" int vslam_cam_expand(const float* x, const int* cam, float* out, int C, long long N,
                                int K, int ck, int grid_x, int threads, int vec4,
                                int evict_first, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const int chunks = ck > 0 ? (C + ck - 1) / ck : 0;
  if (ck <= 0 || chunks > 65535 || grid_x <= 0 || threads <= 0 || threads > EXPAND_THREADS ||
      threads % 32 ||
      (vec4 && (N % 4 || reinterpret_cast<uintptr_t>(cam) % 16 ||
                reinterpret_cast<uintptr_t>(out) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cam_expand_kernel<<<dim3(grid_x, chunks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, cam, out, C, N, K, ck, vec4, evict_first);
  return static_cast<int>(cudaGetLastError());
}

// data (C,N) float32; the plan of seg_kernel.reduce_plan for (cam, K) with
// tile T: order (N rounded up to a multiple of 8,) int16, run_start
// (max_runs+1,), tile_ptr (ceil(N/T)+1,) int32, words (ceil(N/T),
// ceil(K/32)) int32 pairs; partial (C, max_runs) float32 scratch; out (C,K)
// float32, every entry written. All contiguous on `device`; both launches
// on `stream`. Returns cudaGetLastError().
extern "C" int vslam_cam_reduce(const float* data, const int16_t* order, const int* run_start,
                                const int* tile_ptr, const int* words, float* partial,
                                float* out, int C, long long N, int K, int T,
                                long long max_runs, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (N + T - 1) / T;
  if (tiles > 0) {
    // Channel chunks only as many as it takes to give the card about two
    // blocks per SM: a block walks its tile's runs once per channel, and
    // copies overlap sums only within a block.
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long want_chunks = (2LL * sms + tiles - 1) / tiles;
    if (want_chunks > C) want_chunks = C;
    const int ck = static_cast<int>((C + want_chunks - 1) / want_chunks);
    const int chunks = (C + ck - 1) / ck;
    const size_t smem = 2 * static_cast<size_t>(T) * 4 + (2 * static_cast<size_t>(T) + 9) * 2;
    if (smem > SMEM_MAX || tiles * chunks >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    const bool vec4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
    err = cudaFuncSetAttribute(cam_reduce_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cam_reduce_tile_kernel<<<static_cast<unsigned>(tiles * chunks), TILE_THREADS, smem, s>>>(
        data, order, run_start, tile_ptr, partial, C, N, T, ck, chunks, max_runs, vec4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int W = (K + 31) / 32;
  if (C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cam_reduce_camera_kernel<<<dim3(W, C), TILE_GROUPS * 32, 0, s>>>(
      partial, reinterpret_cast<const int2*>(words), out, K, static_cast<int>(tiles), W,
      max_runs);
  return static_cast<int>(cudaGetLastError());
}
