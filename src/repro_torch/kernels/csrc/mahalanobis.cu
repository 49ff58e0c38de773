// Batched squared Mahalanobis distance for Hopper (sm_90a), plain C
// interface.
//
// Replaces repro/kernels/mahalanobis.py: mahalanobis_pallas /
// _mahalanobis_kernel,  d²_k = diff_kᵀ Λ_k diff_k  (paper eq. 22).
//
// Bound by device memory: one read of Λ (K·D²·4 bytes), 2 flops per
// element.  The TPU kernel accumulated row tiles into a (1, 1) output block
// across its sequential grid; Hopper's blocks run in no order, so here one
// block owns one component and reduces inside itself: each warp walks its
// rows (coalesced loads along the row, diff_k in shared memory), folds
// diff_r·(Λ_r·diff) into a per-warp sum, and thread 0 adds the eight warp
// sums in a fixed order.  No float atomics: repeated runs are bit-equal.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                     // 8 warps
constexpr int kWarps = kThreads / kWarp;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void mahalanobis_kernel(const float* __restrict__ diff,
                                   const float* __restrict__ lam,
                                   float* __restrict__ out, int D) {
  extern __shared__ float sdiff[];
  __shared__ float partial[kWarps];
  const int k = blockIdx.x;
  const float* dv = diff + (size_t)k * D;
  for (int j = threadIdx.x; j < D; j += blockDim.x) sdiff[j] = dv[j];
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float sum = 0.f;                                // meaningful in lane 0
  for (int r = warp; r < D; r += kWarps) {
    const float* row = lam + ((size_t)k * D + r) * D;
    float acc = 0.f;
#pragma unroll 4
    for (int j = lane; j < D; j += kWarp) acc += row[j] * sdiff[j];
    acc = warp_sum(acc);
    sum += sdiff[r] * acc;
  }
  if (lane == 0) partial[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += partial[w];
    out[k] = total;
  }
}

}  // namespace

extern "C" {

// out_k = diff_kᵀ Λ_k diff_k.  diff (K,D), lam (K,D,D), out (K,).
int figmn_mahalanobis(const float* diff, const float* lam, float* out, int K,
                      int D, void* stream) {
  mahalanobis_kernel<<<K, kThreads, (size_t)D * sizeof(float),
                       (cudaStream_t)stream>>>(diff, lam, out, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
