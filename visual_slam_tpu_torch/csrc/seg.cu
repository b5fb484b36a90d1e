// Camera-segment reduce (B4) and expand (B5) for bundle adjustment.
//
// Replace the Pallas TPU kernels of visual_slam_tpu/ops/pallas/seg_kernel.py:
//   cam_reduce_kernel  <- _cam_reduce_kernel (via cam_reduce)
//       out[c,k] = sum over slots n with cam[n] == k of data[c,n]
//   cam_expand_kernel  <- _cam_expand_kernel (via cam_expand)
//       out[c,n] = x[c, cam[n]]
// A slot whose camera is outside [0,K) contributes nothing to the reduce and
// receives 0 from the expand, as the Pallas kernels' padding rule gives.
//
// The TPU kernels multiply by a two-level one-hot matrix on the MXU because
// XLA's scatter/gather ran at a few rows per cycle there. Hopper has native
// gathers and float atomics, so neither kernel here uses tensor cores or a
// one-hot matrix.
//
// What bounds them on the H100: device-memory bytes. At BASELINE.json
// config #5 (K = 5000 cameras, N = 4,194,304 slots) the expand writes C*N*4
// bytes (201 MB at C = 12, ~60 us at 3.35 TB/s) and the reduce reads C*N*4
// bytes plus the (N,) camera ids once per channel chunk (453 MB + 117 MB at
// C = 27, ~170 us).
//
// B5: one thread per slot reads cam[n] once and writes its C outputs; each
// row's writes are coalesced along n. The (C,K) table (<= 540 KB) stays in
// L2. Every output is a copy, so the result is bit-equal to the plain
// version.
//
// B4, design (a) of the two considered: block-private partial sums in shared
// memory. Each block owns a chunk of channels (as many K-float rows as fit in
// SMEM_BUDGET bytes: 4 rows = 80 KB at K = 5000, so two blocks share an SM)
// and a grid-stride share of the slots; it adds each slot into shared memory
// with shared-memory atomics, then flushes every non-zero (channel, camera)
// partial with one global atomicAdd. Reads of data and cam stay coalesced.
// The alternative, sorting the slots by camera once per problem and taking a
// deterministic segmented sum, gathers 4-byte values from 32-byte sectors
// (8x the read traffic) because a camera's slots are scattered over N by the
// landmark-major layout. Float atomics make the order of the additions, and
// so the last bits of each sum, change from run to run: the reduce is held to
// rtol 1e-5 / atol 1e-4 against its plain version, not bit-equality. Where
// not even one K-float row fits in shared memory, every slot adds straight
// into device memory (cam_reduce_global_kernel).
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 512;
constexpr int SMEM_BUDGET = 96 * 1024;  // bytes of partial sums per block
constexpr int BLOCKS_PER_SM = 2;

__device__ __forceinline__ bool in_range(int k, int K) {
  return static_cast<unsigned>(k) < static_cast<unsigned>(K);
}

__global__ void __launch_bounds__(THREADS)
cam_expand_kernel(const float* __restrict__ x, const int* __restrict__ cam,
                  float* __restrict__ out, int C, long long N, int K) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const int k = cam[n];
    const bool ok = in_range(k, K);
    const int kk = ok ? k : 0;  // always a valid address; the value is masked
    for (int c = 0; c < C; ++c) {
      const float v = x[static_cast<size_t>(c) * K + kk];
      out[static_cast<size_t>(c) * N + n] = ok ? v : 0.f;
    }
  }
}

// blockIdx.y picks channels [c0, c0 + ck); blockIdx.x a share of the slots.
__global__ void __launch_bounds__(THREADS)
cam_reduce_smem_kernel(const float* __restrict__ data, const int* __restrict__ cam,
                       float* __restrict__ out, int C, long long N, int K, int ck) {
  extern __shared__ float acc[];  // (nc, K) partial sums
  const int c0 = blockIdx.y * ck;
  const int nc = min(ck, C - c0);
  const int cells = nc * K;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  const float* src = data + static_cast<size_t>(c0) * N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const int k = cam[n];
    if (!in_range(k, K)) continue;
    for (int c = 0; c < nc; ++c)
      atomicAdd(&acc[c * K + k], src[static_cast<size_t>(c) * N + n]);
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(c0) * K;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(&dst[i], v);  // adding 0 would change nothing
  }
}

__global__ void __launch_bounds__(THREADS)
cam_reduce_global_kernel(const float* __restrict__ data, const int* __restrict__ cam,
                         float* __restrict__ out, int C, long long N, int K) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const int k = cam[n];
    if (!in_range(k, K)) continue;
    for (int c = 0; c < C; ++c)
      atomicAdd(&out[static_cast<size_t>(c) * K + k], data[static_cast<size_t>(c) * N + n]);
  }
}

int blocks_for(long long N) {
  const long long b = (N + THREADS - 1) / THREADS;
  return static_cast<int>(b < (1LL << 30) ? b : (1LL << 30));
}

}  // namespace

// x (C,K) float32, cam (N,) int32, out (C,N) float32, all contiguous on
// `device`; launch on `stream`. Returns cudaGetLastError().
extern "C" int vslam_cam_expand(const float* x, const int* cam, float* out, int C,
                                long long N, int K, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N > 0 && C > 0)
    cam_expand_kernel<<<blocks_for(N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, cam, out, C, N, K);
  return static_cast<int>(cudaGetLastError());
}

// data (C,N) float32, cam (N,) int32, out (C,K) float32 and ZEROED by the
// caller, all contiguous on `device`; launch on `stream`. Returns
// cudaGetLastError().
extern "C" int vslam_cam_reduce(const float* data, const int* cam, float* out, int C,
                                long long N, int K, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ck_max = SMEM_BUDGET / (K * static_cast<int>(sizeof(float)));
  if (ck_max == 0) {
    cam_reduce_global_kernel<<<blocks_for(N), THREADS, 0, s>>>(data, cam, out, C, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  // Even chunks: C = 27 at ck_max = 4 gives 7 chunks of at most 4 rows.
  const int chunks = (C + ck_max - 1) / ck_max;
  const int ck = (C + chunks - 1) / chunks;
  const int smem = ck * K * static_cast<int>(sizeof(float));
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // About two resident blocks per SM in all; fewer where N is short, so that
  // each block's flush (ck*K atomics) stays small against its slots.
  int slices = (BLOCKS_PER_SM * sms + chunks - 1) / chunks;
  const long long by_work = N / (4LL * K) + 1;
  if (by_work < slices) slices = static_cast<int>(by_work);
  if (blocks_for(N) < slices) slices = blocks_for(N);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cam_reduce_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cam_reduce_smem_kernel<<<dim3(slices, chunks), THREADS, smem, s>>>(data, cam, out, C, N,
                                                                    K, ck);
  return static_cast<int>(cudaGetLastError());
}
