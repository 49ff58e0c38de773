// FIGMN precision update kernels for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/figmn_update.py:
//   matvec2      <- matvec2_pallas / _matvec2_kernel   (y, z) = (Λa, Λb)
//   rank2_apply  <- rank2_apply_pallas / _rank2_apply_kernel
//                   Λ' = Λ·inv1mw − c1·yyᵀ + c2·yb ybᵀ
//
// Both are bound by device memory: matvec2 reads Λ (K·D²·4 bytes) once and
// does 2 flops per element; rank2_apply reads and writes Λ once
// (2·K·D²·4 bytes) with a handful of flops per element.  The design keeps
// every access to Λ coalesced along a row and never pads D: the TPU
// wrappers pad D to 128 lanes (repro/kernels/ops.py), which at D = 794
// would copy the whole Λ twice per point; here the ragged edge is masked
// by the loop bound instead.
//
// Each launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kWarp = 32;
constexpr int kMatvecThreads = 256;               // 8 warps
constexpr int kMatvecRows = 32;                   // rows of Λ per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per (row tile, component).  Each warp walks its rows of Λ_k;
// the lanes stride along the row (coalesced loads), accumulate in fp32 and
// reduce with shuffles.  TWO selects the second vector.
template <bool TWO>
__global__ void matvec2_kernel(const float* __restrict__ lam,
                               const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ y, float* __restrict__ z,
                               int D) {
  const int k = blockIdx.y;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const float* av = a + (size_t)k * D;
  const float* bv = TWO ? b + (size_t)k * D : nullptr;
  const int row_end = min((int)(blockIdx.x + 1) * kMatvecRows, D);
  for (int r = blockIdx.x * kMatvecRows + warp; r < row_end;
       r += kMatvecThreads / kWarp) {
    const float* row = lam + ((size_t)k * D + r) * D;
    float acc = 0.f, acc2 = 0.f;
#pragma unroll 4
    for (int j = lane; j < D; j += kWarp) {
      const float l = row[j];
      acc += l * av[j];
      if (TWO) acc2 += l * bv[j];
    }
    acc = warp_sum(acc);
    if (TWO) acc2 = warp_sum(acc2);
    if (lane == 0) {
      y[(size_t)k * D + r] = acc;
      if (TWO) z[(size_t)k * D + r] = acc2;
    }
  }
}

// One block per (row i, component k); threads stride along the row.
// Every element is read and written by the same thread, so out may alias
// lam: the update is done in place, saving a K·D² allocation per point
// (the TPU path donated the buffer instead).  The association follows the
// TPU kernel: ((Λ·inv1mw) − (c1·y_i)·y_j) + (c2·yb_i)·yb_j.
template <bool TWO>
__global__ void rank2_apply_kernel(const float* lam, const float* __restrict__ y,
                                   const float* __restrict__ yb,
                                   const float* __restrict__ inv1mw,
                                   const float* __restrict__ c1,
                                   const float* __restrict__ c2, float* out,
                                   int D) {
  const int i = blockIdx.x, k = blockIdx.y;
  const float* yk = y + (size_t)k * D;
  const float s = inv1mw[k];
  const float cy = c1[k] * yk[i];
  float cyb = 0.f;
  const float* ybk = nullptr;
  if (TWO) {
    ybk = yb + (size_t)k * D;
    cyb = c2[k] * ybk[i];
  }
  const size_t base = ((size_t)k * D + i) * D;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    float v = lam[base + j] * s - cy * yk[j];
    if (TWO) v = v + cyb * ybk[j];
    out[base + j] = v;
  }
}

}  // namespace

extern "C" {

const char* figmn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int figmn_device_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// y = Λa (and z = Λb when b is not null).  lam (K,D,D), a, b, y, z (K,D).
int figmn_matvec2(const float* lam, const float* a, const float* b, float* y,
                  float* z, int K, int D, void* stream) {
  dim3 grid((D + kMatvecRows - 1) / kMatvecRows, K);
  cudaStream_t s = (cudaStream_t)stream;
  if (b != nullptr)
    matvec2_kernel<true><<<grid, kMatvecThreads, 0, s>>>(lam, a, b, y, z, D);
  else
    matvec2_kernel<false><<<grid, kMatvecThreads, 0, s>>>(lam, a, nullptr, y,
                                                          nullptr, D);
  return (int)cudaGetLastError();
}

// out = lam·inv1mw − c1·yyᵀ (+ c2·yb ybᵀ when yb is not null).  out may
// be lam.
int figmn_rank2_apply(const float* lam, const float* y, const float* yb,
                      const float* inv1mw, const float* c1, const float* c2,
                      float* out, int K, int D, void* stream) {
  dim3 grid(D, K);
  const int threads = std::min(256, ((D + kWarp - 1) / kWarp) * kWarp);
  cudaStream_t s = (cudaStream_t)stream;
  if (yb != nullptr)
    rank2_apply_kernel<true><<<grid, threads, 0, s>>>(lam, y, yb, inv1mw, c1,
                                                      c2, out, D);
  else
    rank2_apply_kernel<false><<<grid, threads, 0, s>>>(lam, y, nullptr, inv1mw,
                                                       c1, nullptr, out, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
