// Resident streaming FIGMN fit over a grid of blocks, for Hopper (sm_90a),
// plain C interface.
//
// Replaces repro/kernels/figmn_stream.py: figmn_stream_pallas /
// _stream_kernel for pools whose working set does not fit one block's
// shared memory (figmn_stream.cu holds those that do).  On the TPU the
// whole (K, D, D) stack sat in one core's VMEM, up to the reference's
// 12 MiB budget; here it is spread over G co-resident blocks:
//
//   rows over blocks: the (K·D, D) stack of Λ rows is cut into G contiguous
//     ranges of R rows (the last may be shorter), each held in its block's
//     dynamic shared memory for the whole chunk.  A component may straddle
//     two or more blocks.  Each block also keeps its own copy of μ for the
//     components its rows touch.
//   one grid barrier per point: each block computes y = Λ·diff for its
//     rows and the partial d² of each component it touches, and writes both
//     to global scratch double-buffered on the point's parity (t % 2).
//     After the barrier every block, redundantly and in the same order,
//     sums each component's partials in block order, evaluates the gate,
//     the masked posterior, w, β, 1 − w, logdet and sp for all K, and
//     updates its rows of Λ and its copy of μ from the full y_k (read back
//     from L2).  A block that writes parity t % 2 again (point t + 2) has
//     passed barrier t + 1, which every block reaches only after its reads
//     of point t, so one barrier per point suffices.
//   determinism: every block must reach bit-equal accept, w and β, or the
//     blocks would update Λ with different coefficients.  No sum uses
//     atomics; every reduction has one fixed order; every block runs the
//     same code on the same values (logdet and sp are replicated per
//     block).  Two launches on the same inputs are bit-equal.
//   co-residency: the barrier spins, so the grid must be co-resident.  The
//     kernel is launched only with cudaLaunchCooperativeKernel, which
//     refuses a grid larger than the card can hold
//     (cudaErrorCooperativeLaunchTooLarge); the wrapper plans G from the
//     occupancy query below and raises on any refusal.
//
// What bounds it: per point ≈ 6·K·D² flops spread over G SMs, plus one grid
// barrier (a few µs: G atomics on one L2 line and a spin) that no amount of
// parallelism hides; the per-point loop is sequential in the data by
// construction.  Tensor cores, TMA and a cluster/DSMEM variant for ≤ 16
// blocks are later work.
//
// Order of operations per point follows the TPU kernel, as figmn_stream.cu
// does (see there); only the summation order of y, d² and the posterior's
// normaliser differs from the plain version (ref.py::figmn_stream_ref).
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

// Generation barrier over the whole grid, valid only under a cooperative
// launch.  bar[0] counts arrivals, bar[1] is the generation.  The last
// block to arrive resets the count and bumps the generation; the others
// spin on the generation they read before arriving.  Thread 0 fences
// before arriving and after leaving, so the block's writes before the
// barrier are visible to every block after it (the pattern of
// cooperative_groups' grid sync).
__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
figmn_stream_grid_kernel(const float* __restrict__ xs, int n,
                         const float* __restrict__ mu0,
                         const float* __restrict__ lam0,
                         const float* __restrict__ logdet0,
                         const float* __restrict__ sp0,
                         const int* __restrict__ active0, float thresh,
                         float log_norm, float fdim, float* __restrict__ mu_out,
                         float* __restrict__ lam_out,
                         float* __restrict__ logdet_out,
                         float* __restrict__ sp_out, int* __restrict__ nacc_out,
                         float* ybuf, float* d2part, float* kvec,
                         unsigned int* bar, int K, int D, int R, int NC) {
  extern __shared__ float smem[];
  const int G = gridDim.x, b = blockIdx.x;
  const int KD = K * D;
  const int r0 = b * R;
  const int rows = min(R, KD - r0);
  const int k_lo = r0 / D;
  const int k_hi = (r0 + rows - 1) / D;
  const int nc = k_hi - k_lo + 1;             // ≤ NC

  float* lam = smem;                          // rows·D (R·D reserved)
  float* mu = lam + (size_t)R * D;            // NC·D, components k_lo..k_hi
  float* diff = mu + NC * D;                  // NC·D
  float* yk = diff + NC * D;                  // NC·D, full y of those
  float* yown = yk + NC * D;                  // R, y of this block's rows
  float* x = yown + R;                        // D
  float* wl = x + D;                          // NC: w of k_lo..k_hi
  float* bl = wl + NC;                        // NC: β
  float* ol = bl + NC;                        // NC: 1 − w
  float* red = ol + NC;                       // kWarps
  // this block's private copy of the per-component vectors, in global
  // memory (K may be too large for shared memory); thread tid owns the
  // entries k ≡ tid (mod kThreads) for the whole launch
  float* logdet = kvec + (size_t)b * 4 * K;
  float* sp = logdet + K;
  float* d2 = sp + K;
  float* lw = d2 + K;                         // log-weight, then p

  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;

  for (size_t e = tid; e < (size_t)rows * D; e += kThreads)
    lam[e] = lam0[(size_t)r0 * D + e];
  for (int e = tid; e < nc * D; e += kThreads) mu[e] = mu0[k_lo * D + e];
  for (int k = tid; k < K; k += kThreads) {
    logdet[k] = logdet0[k];
    sp[k] = sp0[k];
  }
  int accepted = 0;                           // block 0, thread 0
  __syncthreads();

  for (int t = 0; t < n; ++t) {
    float* yb = ybuf + (size_t)(t & 1) * KD;
    float* pb = d2part + (size_t)(t & 1) * G * NC;
    for (int d = tid; d < D; d += kThreads) x[d] = xs[(size_t)t * D + d];
    __syncthreads();
    for (int e = tid; e < nc * D; e += kThreads) diff[e] = x[e % D] - mu[e];
    __syncthreads();

    // y = Λ·diff for this block's rows: one warp per row.
    for (int rl = warp; rl < rows; rl += kWarps) {
      const int r = r0 + rl;
      const float* row = lam + (size_t)rl * D;
      const float* dk = diff + (r / D - k_lo) * D;
      float acc = 0.f;
      for (int j = lane; j < D; j += kWarp) acc += row[j] * dk[j];
      acc = warp_sum(acc);
      if (lane == 0) {
        yown[rl] = acc;
        yb[r] = acc;
      }
    }
    __syncthreads();

    // This block's part of d²_k = diff_k · y_k: one warp per component.
    for (int c = warp; c < nc; c += kWarps) {
      const int k = k_lo + c;
      const int a = max(r0, k * D), z = min(r0 + rows, (k + 1) * D);
      float acc = 0.f;
      for (int r = a + lane; r < z; r += kWarp)
        acc += diff[c * D + (r - k * D)] * yown[r - r0];
      acc = warp_sum(acc);
      if (lane == 0) pb[(size_t)b * NC + c] = acc;
    }

    grid_barrier(bar, (unsigned int)G);

    // The full y of the components this block updates (L2, not L1: other
    // blocks wrote it).
    for (int e = tid; e < nc * D; e += kThreads)
      yk[e] = __ldcg(yb + (size_t)k_lo * D + e);

    // Gate and masked posterior over all K, the same in every block.
    int any = 0;
    float m = -__int_as_float(0x7f800000);     // -inf
    for (int k = tid; k < K; k += kThreads) {
      float s = 0.f;                          // partials in block order
      for (int bb = (k * D) / R; bb <= ((k + 1) * D - 1) / R; ++bb)
        s += __ldcg(pb + (size_t)bb * NC + (k - (bb * R) / D));
      d2[k] = s;
      const bool act = active0[k] != 0;
      any |= (act && s < thresh);
      const float logp = -0.5f * ((log_norm + logdet[k]) + s);
      const float l = act ? logp + logf(fmaxf(sp[k], 1e-30f)) : -1e30f;
      lw[k] = l;
      m = fmaxf(m, l);
    }
    const bool accept = __syncthreads_or(any) != 0;
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    m = red[0];
    for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
    __syncthreads();                          // red is reused below
    float s = 0.f;
    for (int k = tid; k < K; k += kThreads) {
      const float p = active0[k] != 0 ? expf(lw[k] - m) : 0.f;
      lw[k] = p;
      s += p;
    }
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    s = red[0];
    for (int i = 1; i < kWarps; ++i) s += red[i];
    s = fmaxf(s, 1e-30f);
    for (int k = tid; k < K; k += kThreads) {
      const float post = accept ? lw[k] / s : 0.f;
      const float sp_new = sp[k] + post;
      const float wk = post / fmaxf(sp_new, 1e-30f);
      const float om = 1.f - wk;
      logdet[k] = logdet[k] + (fdim * logf(om) + log1pf(wk * d2[k]));
      sp[k] = sp_new;
      if (k >= k_lo && k <= k_hi) {
        wl[k - k_lo] = wk;
        ol[k - k_lo] = om;
        bl[k - k_lo] = wk / (1.f + wk * d2[k]);
      }
    }
    if (b == 0 && tid == 0 && accept) ++accepted;
    __syncthreads();

    for (int e = tid; e < nc * D; e += kThreads) mu[e] = mu[e] + wl[e / D] * diff[e];
    for (int rl = warp; rl < rows; rl += kWarps) {
      const int c = (r0 + rl) / D - k_lo;
      float* row = lam + (size_t)rl * D;
      const float* ykc = yk + c * D;
      const float yi = yown[rl], bk = bl[c], om = ol[c];
      for (int j = lane; j < D; j += kWarp) row[j] = (row[j] - (bk * ykc[j]) * yi) / om;
    }
    __syncthreads();
  }

  // Each block writes its own rows of Λ and μ; block 0 the per-component
  // vectors (every block holds the same values) and the accept count.
  for (size_t e = tid; e < (size_t)rows * D; e += kThreads)
    lam_out[(size_t)r0 * D + e] = lam[e];
  for (int e = tid; e < rows; e += kThreads) mu_out[r0 + e] = mu[r0 - k_lo * D + e];
  if (b == 0) {
    for (int k = tid; k < K; k += kThreads) {
      logdet_out[k] = logdet[k];
      sp_out[k] = sp[k];
    }
    if (tid == 0) nacc_out[0] = accepted;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block holding R rows whose span touches at
// most NC components, in bytes (the layout above).
long long figmn_stream_grid_smem_bytes(int R, int NC, int D) {
  return 4LL * ((long long)R * D + 3LL * NC * D + R + D + 3LL * NC + kWarps);
}

int figmn_device_sm_count(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  return v;
}

int figmn_device_coop_launch(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrCooperativeLaunch, device) !=
      cudaSuccess)
    return -1;
  return v;
}

// Blocks of the grid kernel that can be resident on one SM of `device`
// at `bytes` of dynamic shared memory; negative on error.
int figmn_stream_grid_blocks_per_sm(int device, long long bytes) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(figmn_stream_grid_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, figmn_stream_grid_kernel, kThreads, (size_t)bytes);
  if (prev != device) cudaSetDevice(prev);
  return err == cudaSuccess ? n : -(int)err;
}

int figmn_stream_grid(const float* xs, int n, const float* mu0,
                      const float* lam0, const float* logdet0,
                      const float* sp0, const int* active0, float thresh,
                      float log_norm, float fdim, float* mu, float* lam,
                      float* logdet, float* sp, int* nacc, float* ybuf,
                      float* d2part, float* kvec, unsigned int* bar, int K,
                      int D, int G, int R, int NC, void* stream) {
  const long long bytes = figmn_stream_grid_smem_bytes(R, NC, D);
  cudaError_t err = cudaFuncSetAttribute(
      figmn_stream_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&xs,     &n,   &mu0,  &lam0,   &logdet0, &sp0,  &active0,
                  &thresh, &log_norm, &fdim, &mu, &lam,  &logdet, &sp,
                  &nacc,   &ybuf, &d2part, &kvec, &bar,   &K,    &D,
                  &R,      &NC};
  err = cudaLaunchCooperativeKernel((const void*)figmn_stream_grid_kernel,
                                    dim3(G), dim3(kThreads), args,
                                    (size_t)bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
