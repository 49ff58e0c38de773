// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/flash_attention.py: _flash_fwd_flat /
// _flash_kernel — online-softmax attention with a causal mask, a sliding
// window given at run time, and keys at k_pos < 0 hidden; it writes out
// and the row log-sum-exp lse.
//
// Bound: at the full config (head_dim 80, T = S = 8192, window 4096) by
// operations, 4·d per visible (query, key) pair, far above the bytes of
// q, k, v and out.  This first kernel does them on the float32 pipes with
// no multiply-add contraction (-fmad=false, as every kernel here), so
// it is far from the tensor-core bound; wgmma/TMA are later work.
//
// Design.  One block of 8 warps owns 64 query rows of one (batch, head);
// each warp owns 8 rows.  A loop over 64-key tiles takes the place of the
// TPU kernel's sequential kv grid axis, carrying m, l and acc in
// registers.  q, k and v are staged in shared memory as float32 with an
// odd row stride (no bank conflicts); a tile whose (query, key) pairs are
// all hidden for the block's 64 rows is skipped (that is where the causal
// and window masks save work) — skipping it changes nothing, since a
// hidden logit's p is 0 once a row has seen any key and is rescaled to 0
// (alpha = exp(-1e30 - m) = 0) when it first does.  A row that sees no key
// at all is recomputed at the end as the plain version defines it (p = 1
// on every key: the mean of v).  GQA is read in place: query head h reads
// KV head h / (H / KV).  The ragged d, T and S edges are masked in the
// kernel: no padded copies.
//
// Rounding follows the reference: the dot in float32, then the scale;
// hidden logits -1e30; p summed unrounded into l and rounded to v's type
// before the PV product; acc rescaled by alpha then accumulated in float32
// (the reference adds the tile's whole dot to the rescaled acc: the same
// terms, another order); out = acc / max(l, 1e-30) rounded to q's type,
// lse = m + log(max(l, 1e-30)).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile (two per lane)
constexpr int kRows = kBQ / kWarps;     // query rows per warp
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int win) {
  const int dpos = qp - kp;
  return kp >= 0 && (!causal || dpos >= 0) && (win <= 0 || dpos < win);
}

// Shared memory: q, k, v tiles (float32, row stride ds = d | 1), the
// warps' rounded p rows, and the tile's positions.
__host__ __device__ inline size_t smem_bytes(int d) {
  const int ds = d | 1;
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * ds + kBQ * kBK)
         + sizeof(int) * (kBQ + kBK);
}

// NC = ceil(d / 32): the accumulator columns each lane owns (c = lane + 32i).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, T* __restrict__ out,
                 float* __restrict__ lse, int Tq, int S, int H, int KVH,
                 int d, int win, int causal, float scale) {
  extern __shared__ float smem[];
  const int ds = d | 1;
  float* qs = smem;
  float* ks = qs + kBQ * ds;
  float* vs = ks + kBK * ds;
  float* ps = vs + kBK * ds;
  int* qp = reinterpret_cast<int*>(ps + kBQ * kBK);
  int* kp = qp + kBQ;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);
  const int t0 = blockIdx.x * kBQ;
  const size_t qstride = (size_t)H * d, kstride = (size_t)KVH * d;
  const T* qb = q + (size_t)b * Tq * qstride + (size_t)h * d;
  const T* kb = k + (size_t)b * S * kstride + (size_t)hk * d;
  const T* vb = v + (size_t)b * S * kstride + (size_t)hk * d;

  for (int r = warp; r < kBQ; r += kWarps) {
    const int t = t0 + r;
    for (int c = lane; c < d; c += kWarp)
      qs[r * ds + c] = t < Tq ? to_f32(qb[(size_t)t * qstride + c]) : 0.f;
  }
  if (threadIdx.x < kBQ) {
    const int t = t0 + threadIdx.x;
    qp[threadIdx.x] = t < Tq ? qpos[(size_t)b * Tq + t] : 0;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }
  const int row0 = warp * kRows;

  for (int j0 = 0; j0 < S; j0 += kBK) {
    __syncthreads();                       // the last tile's reads are done
    if (threadIdx.x < kBK) {
      const int s = j0 + threadIdx.x;
      kp[threadIdx.x] = s < S ? kpos[(size_t)b * S + s] : -1;
    }
    __syncthreads();
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (t0 + row0 + r >= Tq) continue;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = lane + kWarp * cc;
        any |= (j0 + col < S) && visible(qp[row0 + r], kp[col], causal, win);
      }
    }
    if (!__syncthreads_or(any)) continue;  // no visible pair in this tile

    for (int r = warp; r < kBK; r += kWarps) {
      const int s = j0 + r;
      for (int c = lane; c < d; c += kWarp) {
        const bool in = s < S;
        ks[r * ds + c] = in ? to_f32(kb[(size_t)s * kstride + c]) : 0.f;
        vs[r * ds + c] = in ? to_f32(vb[(size_t)s * kstride + c]) : 0.f;
      }
    }
    __syncthreads();

    float x[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) x[r][0] = x[r][1] = 0.f;
    const float* k0 = ks + lane * ds;
    const float* k1 = ks + (lane + kWarp) * ds;
    for (int c = 0; c < d; ++c) {
      const float a0 = k0[c], a1 = k1[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qs[(row0 + r) * ds + c];
        x[r][0] += qv * a0;
        x[r][1] += qv * a1;
      }
    }

    float alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpr = qp[row0 + r];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = lane + kWarp * cc;
        if (j0 + col >= S)
          x[r][cc] = -INFINITY;              // no such key: p = 0
        else if (!visible(qpr, kp[col], causal, win))
          x[r][cc] = kNeg;
        else
          x[r][cc] = x[r][cc] * scale;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x[r][0], x[r][1])));
      alpha[r] = expf(m[r] - m_new);
      const float p0 = expf(x[r][0] - m_new), p1 = expf(x[r][1] - m_new);
      l[r] = l[r] * alpha[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      ps[(row0 + r) * kBK + lane] = to_f32(from_f32<T>(p0));
      ps[(row0 + r) * kBK + lane + kWarp] = to_f32(from_f32<T>(p1));
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] = acc[r][i] * alpha[r];
    const int nk = min(kBK, S - j0);
    for (int j = 0; j < nk; ++j) {
      float vv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + kWarp * i;
        vv[i] = c < d ? vs[j * ds + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = ps[(row0 + r) * kBK + j];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] += pj * vv[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + row0 + r;
    if (t >= Tq) continue;
    if (m[r] == kNeg) {
      // no visible key: p = exp(-1e30 - (-1e30)) = 1 on all S keys
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = lane + kWarp * i;
          if (c < d) acc[r][i] += to_f32(vb[(size_t)s * kstride + c]);
        }
      l[r] = (float)S;
    }
    const float lc = fmaxf(l[r], 1e-30f);
    T* ob = out + ((size_t)b * Tq + t) * qstride + (size_t)h * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + kWarp * i;
      if (c < d) ob[c] = from_f32<T>(acc[r][i] / lc);
    }
    if (lane == 0) lse[((size_t)b * H + h) * Tq + t] = m[r] + logf(lc);
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, float* lse, int B, int Tq, int S,
           int H, int KVH, int d, int win, int causal, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, NC>;
  const size_t smem = smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(out), lse, Tq,
      S, H, KVH, d, win, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* qpos,
             const int* kpos, void* out, float* lse, int B, int Tq, int S,
             int H, int KVH, int d, int win, int causal, float scale,
             cudaStream_t st) {
#define FLASH_CASE(nc)                                                       \
  case nc:                                                                   \
    return launch<T, nc>(q, k, v, qpos, kpos, out, lse, B, Tq, S, H, KVH, d, \
                         win, causal, scale, st);
  switch ((d + kWarp - 1) / kWarp) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

// Shared memory one block takes for head dim d (the wrapper checks it
// against the device's opt-in limit).
long long figmn_flash_fwd_smem_bytes(int d) { return (long long)smem_bytes(d); }

// q (B,T,H,d), k/v (B,S,KVH,d) of one type (bf16 = 1 or f32 = 0),
// qpos (B,T), kpos (B,S) int32; out (B,T,H,d), lse (B,H,T) float32.
// 1 <= d <= 256, H % KVH == 0, T >= 1.
int figmn_flash_fwd(const void* q, const void* k, const void* v,
                    const int* qpos, const int* kpos, void* out, float* lse,
                    int B, int T, int S, int H, int KVH, int d, int win,
                    int causal, float scale, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16
             ? dispatch<__nv_bfloat16>(q, k, v, qpos, kpos, out, lse, B, T, S,
                                       H, KVH, d, win, causal, scale, st)
             : dispatch<float>(q, k, v, qpos, kpos, out, lse, B, T, S, H, KVH,
                               d, win, causal, scale, st);
}

}  // extern "C"
