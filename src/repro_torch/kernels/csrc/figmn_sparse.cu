// Top-C shortlist kernels for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/figmn_sparse.py:
//   gathered_matvec <- gathered_matvec_pallas / _gathered_matvec_kernel
//                      y_c = Λ[idx_c]·diff_c for the C shortlisted rows
//   scatter_apply   <- scatter_apply_pallas / _scatter_apply_kernel
//                      Λ[idx_c] ← Λ[idx_c]·a_c − (b_c·y_c,i)·y_c,j in place
//
// Both are bound by device memory: gathered_matvec reads C·D² floats of Λ
// once (2 flops each), scatter_apply reads and writes them once.  The TPU
// kernels prefetch the index vector as scalars so the BlockSpec can DMA
// Λ[idx_c]; here each block reads its own index from device memory, so
// there is no host round-trip and the gathered rows are never copied out.
// The read path calls gathered_matvec over flattened (point, slot) pairs,
// so C can be B·C there: pairs run on grid.x (no 65535 limit).
//
// Each launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                     // 8 warps
constexpr int kRows = 32;                         // rows of Λ per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per (pair c, tile of 32 rows).  diff_c sits in shared memory;
// each warp walks its rows of Λ[idx_c] with the lanes striding along the
// row (coalesced), accumulates in fp32 and reduces with shuffles — the
// summation order of matvec2.  An index outside [0, K) writes NaN.
__global__ void gathered_matvec_kernel(const float* __restrict__ lam,
                                       const float* __restrict__ diff,
                                       const int* __restrict__ idx,
                                       float* __restrict__ y, int D, int K) {
  extern __shared__ float sdiff[];
  const int c = blockIdx.x;
  const int k = idx[c];
  const float* dv = diff + (size_t)c * D;
  for (int j = threadIdx.x; j < D; j += blockDim.x) sdiff[j] = dv[j];
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row_end = min((int)(blockIdx.y + 1) * kRows, D);
  const bool valid = k >= 0 && k < K;
  for (int r = blockIdx.y * kRows + warp; r < row_end; r += kThreads / kWarp) {
    float acc = 0.f;
    if (valid) {
      const float* row = lam + ((size_t)k * D + r) * D;
#pragma unroll 4
      for (int j = lane; j < D; j += kWarp) acc += row[j] * sdiff[j];
      acc = warp_sum(acc);
    }
    if (lane == 0) y[(size_t)c * D + r] = valid ? acc : nanf("");
  }
}

// A flat grid-stride pass over the C·D² elements of the shortlisted rows.
// Shortlist indices are unique, so every element of Λ is read and written
// by one thread at most: the update runs in place, race-free, and the K−C
// other rows are never touched (the TPU kernel aliased its output to Λ for
// the same effect).  Association as the Pallas body: (Λ·a) − (b·y_i)·y_j.
__global__ void scatter_apply_kernel(float* lam, const float* __restrict__ y,
                                     const float* __restrict__ coefs,
                                     const int* __restrict__ idx, int C,
                                     int D, int K) {
  const size_t dd = (size_t)D * D;
  const size_t total = (size_t)C * dd;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(e / dd);
    const size_t rem = e - (size_t)c * dd;
    const int i = (int)(rem / D), j = (int)(rem - (size_t)i * D);
    const int k = idx[c];
    if (k < 0 || k >= K) continue;
    const float a = coefs[2 * c], b = coefs[2 * c + 1];
    const float* yc = y + (size_t)c * D;
    float* p = lam + (size_t)k * dd + rem;
    *p = *p * a - (b * yc[i]) * yc[j];
  }
}

}  // namespace

extern "C" {

// y = Λ[idx]·diff.  lam (K,D,D), diff and y (C,D), idx (C,) int32.
int figmn_gathered_matvec(const float* lam, const float* diff, const int* idx,
                          float* y, int C, int D, int K, void* stream) {
  dim3 grid(C, (D + kRows - 1) / kRows);
  gathered_matvec_kernel<<<grid, kThreads, (size_t)D * sizeof(float),
                           (cudaStream_t)stream>>>(lam, diff, idx, y, D, K);
  return (int)cudaGetLastError();
}

// Λ[idx_c] ← Λ[idx_c]·coefs[c,0] − (coefs[c,1]·y_c,i)·y_c,j in place.
// lam (K,D,D), y (C,D), coefs (C,2), idx (C,) int32, unique.
int figmn_scatter_apply(float* lam, const float* y, const float* coefs,
                        const int* idx, int C, int D, int K, void* stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t total = (size_t)C * D * D;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (size_t)sms * 8 ? want : (size_t)sms * 8);
  scatter_apply_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      lam, y, coefs, idx, C, D, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
