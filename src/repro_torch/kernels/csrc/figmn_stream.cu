// Resident streaming FIGMN fit for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/figmn_stream.py: figmn_stream_pallas /
// _stream_kernel.  A whole chunk runs in ONE launch: (Λ, μ, logdet, sp,
// active) are loaded into dynamic shared memory once, every point of the
// chunk goes through the gate, the kernel's own masked posterior and the
// exact-mode fused rank-one update with the state held on chip, and the
// state is written back once.  Device memory sees only the x_t rows.
//
// What bounds it: with the state on chip it is bound by operations
// (≈ 6·K·D² flops per point, 2·K·D² of them in the matvec), but as a single
// block (one SM of 132) it runs far below the card's rate; the per-point
// loop is sequential in the data by construction (that IS the IGMN).  A
// cluster or multi-block design is later work.  The working set must fit
// the per-block opt-in shared memory (227 KB on H100): the wrapper checks
// it against the value queried from the device before launching.
//
// Order of operations follows the TPU kernel so the plain PyTorch version
// (repro_torch/kernels/ref.py::figmn_stream_ref) is a faithful oracle:
//   logp  = -0.5·((D·log2π + logdet) + d²)
//   logw  = active ? logp + log(max(sp, 1e-30)) : -1e30
//   post  = active ? exp(logw − max logw) : 0, / max(Σ, 1e-30); 0 if !accept
//   w     = post / max(sp + post, 1e-30);  β = w / (1 + w·d²)
//   Λ'    = (Λ − (β·y_j)·y_i) / (1 − w);  logdet += D·log(1−w) + log1p(w·d²)
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 512;                 // 16 warps
constexpr int kWarps = kThreads / kWarp;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
figmn_stream_kernel(const float* __restrict__ xs, int n,
                    const float* __restrict__ mu0,
                    const float* __restrict__ lam0,
                    const float* __restrict__ logdet0,
                    const float* __restrict__ sp0,
                    const int* __restrict__ active0, float thresh,
                    float log_norm, float fdim, float* __restrict__ mu_out,
                    float* __restrict__ lam_out,
                    float* __restrict__ logdet_out,
                    float* __restrict__ sp_out, int* __restrict__ nacc_out,
                    int K, int D) {
  extern __shared__ float smem[];
  const int KD = K * D;
  float* lam = smem;                          // K·D·D
  float* mu = lam + (size_t)KD * D;           // K·D
  float* diff = mu + KD;                      // K·D
  float* y = diff + KD;                       // K·D
  float* logdet = y + KD;                     // K
  float* sp = logdet + K;                     // K
  float* act = sp + K;                        // K (1.0 active, 0.0 free)
  float* d2 = act + K;                        // K
  float* w = d2 + K;                          // K (also logw scratch)
  float* beta = w + K;                        // K
  float* omw = beta + K;                      // K (1 − w)
  float* x = omw + K;                         // D

  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;

  for (size_t e = tid; e < (size_t)KD * D; e += kThreads) lam[e] = lam0[e];
  for (int e = tid; e < KD; e += kThreads) mu[e] = mu0[e];
  for (int k = tid; k < K; k += kThreads) {
    logdet[k] = logdet0[k];
    sp[k] = sp0[k];
    act[k] = active0[k] != 0 ? 1.f : 0.f;
  }
  int accepted = 0;                           // thread 0's counter
  __syncthreads();

  for (int t = 0; t < n; ++t) {
    for (int d = tid; d < D; d += kThreads) x[d] = xs[(size_t)t * D + d];
    __syncthreads();
    for (int e = tid; e < KD; e += kThreads) diff[e] = x[e % D] - mu[e];
    __syncthreads();

    // y = Λ·diff: one warp per row of the (K·D, D) stack of precisions.
    for (int r = warp; r < KD; r += kWarps) {
      const float* row = lam + (size_t)r * D;
      const float* dk = diff + (r / D) * D;
      float acc = 0.f;
      for (int j = lane; j < D; j += kWarp) acc += row[j] * dk[j];
      acc = warp_sum(acc);
      if (lane == 0) y[r] = acc;
    }
    __syncthreads();

    // d²_k = diff_k · y_k: one warp per component.
    for (int k = warp; k < K; k += kWarps) {
      float acc = 0.f;
      for (int i = lane; i < D; i += kWarp) acc += diff[k * D + i] * y[k * D + i];
      acc = warp_sum(acc);
      if (lane == 0) d2[k] = acc;
    }
    __syncthreads();

    // Gate + masked posterior + per-slot coefficients: warp 0, lanes over K.
    if (warp == 0) {
      int any = 0;
      float m = -__int_as_float(0x7f800000);   // -inf
      for (int k = lane; k < K; k += kWarp) {
        const bool a = act[k] != 0.f;
        any |= (a && d2[k] < thresh);
        const float logp = -0.5f * ((log_norm + logdet[k]) + d2[k]);
        const float lw = a ? logp + logf(fmaxf(sp[k], 1e-30f)) : -1e30f;
        w[k] = lw;
        m = fmaxf(m, lw);
      }
      const bool accept = __any_sync(0xffffffffu, any) != 0;
      m = warp_max(m);
      float s = 0.f;
      for (int k = lane; k < K; k += kWarp) {
        const float p = act[k] != 0.f ? expf(w[k] - m) : 0.f;
        w[k] = p;
        s += p;
      }
      s = fmaxf(warp_sum(s), 1e-30f);
      for (int k = lane; k < K; k += kWarp) {
        const float post = accept ? w[k] / s : 0.f;
        const float sp_new = sp[k] + post;
        const float wk = post / fmaxf(sp_new, 1e-30f);
        const float om = 1.f - wk;
        w[k] = wk;
        omw[k] = om;
        beta[k] = wk / (1.f + wk * d2[k]);
        logdet[k] = logdet[k] + (fdim * logf(om) + log1pf(wk * d2[k]));
        sp[k] = sp_new;
      }
      if (lane == 0 && accept) ++accepted;
    }
    __syncthreads();

    for (int e = tid; e < KD; e += kThreads) mu[e] = mu[e] + w[e / D] * diff[e];
    for (int r = warp; r < KD; r += kWarps) {
      const int k = r / D;
      float* row = lam + (size_t)r * D;
      const float* yk = y + k * D;
      const float yi = y[r], bk = beta[k], om = omw[k];
      for (int j = lane; j < D; j += kWarp) row[j] = (row[j] - (bk * yk[j]) * yi) / om;
    }
    __syncthreads();
  }

  for (size_t e = tid; e < (size_t)KD * D; e += kThreads) lam_out[e] = lam[e];
  for (int e = tid; e < KD; e += kThreads) mu_out[e] = mu[e];
  for (int k = tid; k < K; k += kThreads) {
    logdet_out[k] = logdet[k];
    sp_out[k] = sp[k];
  }
  if (tid == 0) nacc_out[0] = accepted;
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for a (K, D) pool, in bytes.
long long figmn_stream_smem_bytes(int K, int D) {
  return 4LL * ((long long)K * D * D + 3LL * K * D + 7LL * K + D);
}

int figmn_stream(const float* xs, int n, const float* mu0, const float* lam0,
                 const float* logdet0, const float* sp0, const int* active0,
                 float thresh, float log_norm, float fdim, float* mu,
                 float* lam, float* logdet, float* sp, int* nacc, int K, int D,
                 void* stream) {
  const long long bytes = figmn_stream_smem_bytes(K, D);
  cudaError_t err = cudaFuncSetAttribute(
      figmn_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  figmn_stream_kernel<<<1, kThreads, (size_t)bytes, (cudaStream_t)stream>>>(
      xs, n, mu0, lam0, logdet0, sp0, active0, thresh, log_norm, fdim, mu, lam,
      logdet, sp, nacc, K, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
