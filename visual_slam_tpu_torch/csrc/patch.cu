// Per-keypoint 32x32 patch gather from the blurred image.
//
// Replaces the Pallas TPU kernel visual_slam_tpu/ops/pallas/patch_kernel.py
// (_patch_kernel via extract_windows, then the one-hot matmul cut of
// cut_patches). The TPU kernel copied an aligned 40x160 window only because
// Mosaic needs 8/128-aligned dynamic starts, and cut the exact patch out with
// one-hot matmuls; Hopper loads from any address, so this kernel copies the
// exact patch: rows of the image starting at floor(uv) - 15, clamped to
// [0, W-32] x [0, H-32].
//
// The JAX package vmaps the pallas_call over a (B, H, W) stack in its
// batched front-end; here one launch covers the stack: B*K blocks, block i
// copying keypoint i % K of image i / K (the (B, K, 2) keypoints and the
// (B, K, 32, 32) patches are flat in the same order). One image is B = 1.
//
// What bounds it: launch latency. K=1024 patches are 4 MB written and at
// most as much read (~2.5 us of device-memory time at 3.35 TB/s). One block
// of 32x8 threads per keypoint; each warp copies whole 32-float rows, so
// reads are two 64 B-aligned segments per row and writes are one aligned
// 128 B line per row. The copy is exact, so the result is bit-equal to the
// plain PyTorch version (ops/kernels/patch_kernel.py: extract_patches_torch).
#include <cuda_runtime.h>

namespace {

constexpr int PATCH = 32;
constexpr int HALF = PATCH / 2;
constexpr int ROWS = 8;  // warps per block

__global__ void __launch_bounds__(PATCH * ROWS)
patch_kernel(const float* __restrict__ img, const float* __restrict__ uv,
             float* __restrict__ out, int H, int W, int K) {
  const int k = blockIdx.x;  // keypoint k % K of image k / K
  img += static_cast<size_t>(k / K) * H * W;
  // Same float ops as the JAX wrapper: clip(floor(uv) - 15, 0, W-32), then
  // truncate to int.
  const float cxf = fminf(fmaxf(floorf(uv[2 * k]) - (HALF - 1), 0.f),
                          static_cast<float>(W - PATCH));
  const float cyf = fminf(fmaxf(floorf(uv[2 * k + 1]) - (HALF - 1), 0.f),
                          static_cast<float>(H - PATCH));
  const float* src = img + static_cast<int>(cyf) * W + static_cast<int>(cxf);
  float* dst = out + static_cast<size_t>(k) * PATCH * PATCH;
  for (int r = threadIdx.y; r < PATCH; r += ROWS)
    dst[r * PATCH + threadIdx.x] = src[r * W + threadIdx.x];
}

}  // namespace

// Launch on `stream` (a cudaStream_t) of `device`; img is (B,H,W) float32,
// uv (B,K,2) float32, out (B,K,32,32) float32. Returns cudaGetLastError().
extern "C" int vslam_patch(const float* img, const float* uv, float* out,
                           int B, int H, int W, int K, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && K > 0)
    patch_kernel<<<B * K, dim3(PATCH, ROWS), 0, static_cast<cudaStream_t>(stream)>>>(
        img, uv, out, H, W, K);
  return static_cast<int>(cudaGetLastError());
}
