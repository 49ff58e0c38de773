// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dq and (dk, dv).
//
// Replaces repro/kernels/flash_attention.py: _flash_bwd_flat, whose two
// pallas_calls run _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel.  Both
// recompute p = exp(scale·qkᵀ − lse) in float32 under the forward's mask
// (keys at k_pos < 0 hidden, causal, a run-time window, ≤ 0: full), with
// p = 0 where a key is hidden, dp = dO·vᵀ and ds = p ∘ (dp − δ), where
// δ = rowsum(dO ∘ O) is formed outside the kernels (as the reference
// forms it).  p is not rounded here: the forward rounds it before PV,
// the backward does not.  A row that sees no key gets p = 0 everywhere:
// dq = 0, and it adds nothing to dk or dv.
//
// Bound: at the full config (head_dim 80, T = S = 8192, window 4096) by
// operations, 6·d per visible (query, key) pair for dq (q·k, dO·v, ds·k)
// and 8·d for dk and dv (q·k, dO·v, p·dO, ds·q).  As the forward, these
// first kernels do them on the float32 pipes with no multiply-add
// contraction (-fmad=false), far from the tensor-core bound; wgmma, TMA
// and bf16 mma are later work.
//
// flash_bwd_dq: one block of 8 warps owns 64 query rows of one (batch,
// query head); each warp owns 8 rows.  A loop over 64-key tiles takes the
// place of the TPU kernel's sequential kv grid axis, with dq in float32
// registers (each lane owns the columns lane + 32i).  Each lane computes
// the logits and dp of two keys of the tile for its warp's 8 rows, writes
// ds to shared memory, and the warp then accumulates ds·k.
//
// flash_bwd_dkv: one block owns 64 keys of one (batch, KV head); each warp
// owns 8 keys.  It loops over the g query heads of the group (h = hk·g …
// hk·g + g − 1) and, for each, over the 64-row query tiles, with dk and dv
// in float32 registers across all of them: one fixed order and no atomics,
// so the GQA sum is deterministic (two launches are bit-equal), and it
// rounds once at the end.  The reference expands k and v to the query
// heads and lets autodiff sum the group; here KV head h / (H / KV) is read
// in place.
//
// In both: tiles are staged in shared memory as float32 with an odd row
// stride (no bank conflicts); a tile whose (query, key) pairs are all
// hidden is skipped (that is where the causal mask and the window save
// work); the ragged d, T and S edges are masked in the kernel (no padded
// copies).  The scale multiplies the summed dot at the end (the reference
// multiplies each tile's dot: the same terms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kB = 64;                  // query rows or keys per tile
constexpr int kRows = kB / kWarps;      // rows (dq) or keys (dkv) per warp

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

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int win) {
  const int dpos = qp - kp;
  return kp >= 0 && (!causal || dpos >= 0) && (win <= 0 || dpos < win);
}

// Shared memory: four float32 tiles of 64 rows (row stride ds = d | 1),
// NT tiles of 64 × 64 (ds for dq; p and ds for dkv), the tile's lse and
// δ, and the query and key positions.
__host__ __device__ inline size_t smem_bytes(int d, int nt) {
  const int ds = d | 1;
  return sizeof(float) * ((size_t)4 * kB * ds + (size_t)nt * kB * kB + 2 * kB)
         + sizeof(int) * 2 * kB;
}

// NC = ceil(d / 32): the accumulator columns each lane owns (c = lane + 32i).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tq, int S, int H, int KVH, int d, int win, int causal,
                    float scale) {
  extern __shared__ float smem[];
  const int ds = d | 1;
  float* qs = smem;
  float* dos = qs + kB * ds;
  float* ks = dos + kB * ds;
  float* vs = ks + kB * ds;
  float* dss = vs + kB * ds;
  float* lse_s = dss + kB * kB;
  float* del_s = lse_s + kB;
  int* qp = reinterpret_cast<int*>(del_s + kB);
  int* kp = qp + kB;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);
  const int t0 = blockIdx.x * kB;
  const size_t qstride = (size_t)H * d, kstride = (size_t)KVH * d;
  const T* qb = q + (size_t)b * Tq * qstride + (size_t)h * d;
  const T* dob = dout + (size_t)b * Tq * qstride + (size_t)h * d;
  const T* kb = k + (size_t)b * S * kstride + (size_t)hk * d;
  const T* vb = v + (size_t)b * S * kstride + (size_t)hk * d;

  for (int r = warp; r < kB; r += kWarps) {
    const int t = t0 + r;
    for (int c = lane; c < d; c += kWarp) {
      const bool in = t < Tq;
      qs[r * ds + c] = in ? to_f32(qb[(size_t)t * qstride + c]) : 0.f;
      dos[r * ds + c] = in ? to_f32(dob[(size_t)t * qstride + c]) : 0.f;
    }
  }
  if (threadIdx.x < kB) {
    const int t = t0 + threadIdx.x;
    const bool in = t < Tq;
    const size_t row = ((size_t)b * H + h) * Tq + t;
    qp[threadIdx.x] = in ? qpos[(size_t)b * Tq + t] : 0;
    lse_s[threadIdx.x] = in ? lse[row] : 0.f;
    del_s[threadIdx.x] = in ? delta[row] : 0.f;
  }

  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  const int row0 = warp * kRows;

  for (int j0 = 0; j0 < S; j0 += kB) {
    __syncthreads();                       // the last tile's reads are done
    if (threadIdx.x < kB) {
      const int s = j0 + threadIdx.x;
      kp[threadIdx.x] = s < S ? kpos[(size_t)b * S + s] : -1;
    }
    __syncthreads();
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (t0 + row0 + r >= Tq) continue;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        any |= visible(qp[row0 + r], kp[lane + kWarp * cc], causal, win);
    }
    if (!__syncthreads_or(any)) continue;  // no visible pair in this tile

    for (int r = warp; r < kB; r += kWarps) {
      const int s = j0 + r;
      for (int c = lane; c < d; c += kWarp) {
        const bool in = s < S;
        ks[r * ds + c] = in ? to_f32(kb[(size_t)s * kstride + c]) : 0.f;
        vs[r * ds + c] = in ? to_f32(vb[(size_t)s * kstride + c]) : 0.f;
      }
    }
    __syncthreads();

    // logits and dp of keys lane and lane + 32 for the warp's rows
    float x[kRows][2], y[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      x[r][0] = x[r][1] = y[r][0] = y[r][1] = 0.f;
    const float* k0 = ks + lane * ds;
    const float* k1 = ks + (lane + kWarp) * ds;
    const float* v0 = vs + lane * ds;
    const float* v1 = vs + (lane + kWarp) * ds;
    for (int c = 0; c < d; ++c) {
      const float a0 = k0[c], a1 = k1[c], b0 = v0[c], b1 = v1[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qs[(row0 + r) * ds + c];
        const float dv = dos[(row0 + r) * ds + c];
        x[r][0] += qv * a0;
        x[r][1] += qv * a1;
        y[r][0] += dv * b0;
        y[r][1] += dv * b1;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const bool row_in = t0 + row < Tq;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = lane + kWarp * cc;
        float dsv = 0.f;
        if (row_in && visible(qp[row], kp[col], causal, win)) {
          const float p = expf(x[r][cc] * scale - lse_s[row]);
          dsv = p * (y[r][cc] - del_s[row]);
        }
        dss[row * kB + col] = dsv;
      }
    }
    __syncwarp();

    const int nk = min(kB, S - j0);
    for (int j = 0; j < nk; ++j) {
      float kv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + kWarp * i;
        kv[i] = c < d ? ks[j * ds + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = dss[(row0 + r) * kB + j];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] += dsj * kv[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + row0 + r;
    if (t >= Tq) continue;
    T* o = dq + ((size_t)b * Tq + t) * qstride + (size_t)h * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + kWarp * i;
      if (c < d) o[c] = from_f32<T>(acc[r][i] * scale);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ kpos, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int S, int H, int KVH, int d,
                     int win, int causal, float scale) {
  extern __shared__ float smem[];
  const int ds = d | 1;
  float* ks = smem;
  float* vs = ks + kB * ds;
  float* qs = vs + kB * ds;
  float* dos = qs + kB * ds;
  float* ps = dos + kB * ds;               // p, [key][row]
  float* dss = ps + kB * kB;               // ds, [key][row]
  float* lse_s = dss + kB * kB;
  float* del_s = lse_s + kB;
  int* qp = reinterpret_cast<int*>(del_s + kB);
  int* kp = qp + kB;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int bk = blockIdx.y, b = bk / KVH, hk = bk % KVH;
  const int g = H / KVH;
  const int s0 = blockIdx.x * kB;
  const size_t qstride = (size_t)H * d, kstride = (size_t)KVH * d;
  const T* kb = k + (size_t)b * S * kstride + (size_t)hk * d;
  const T* vb = v + (size_t)b * S * kstride + (size_t)hk * d;

  for (int r = warp; r < kB; r += kWarps) {
    const int s = s0 + r;
    for (int c = lane; c < d; c += kWarp) {
      const bool in = s < S;
      ks[r * ds + c] = in ? to_f32(kb[(size_t)s * kstride + c]) : 0.f;
      vs[r * ds + c] = in ? to_f32(vb[(size_t)s * kstride + c]) : 0.f;
    }
  }
  if (threadIdx.x < kB) {
    const int s = s0 + threadIdx.x;
    kp[threadIdx.x] = s < S ? kpos[(size_t)b * S + s] : -1;
  }

  float ak[kRows][NC], av[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) ak[r][i] = av[r][i] = 0.f;
  const int key0 = warp * kRows;

  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const T* qb = q + (size_t)b * Tq * qstride + (size_t)h * d;
    const T* dob = dout + (size_t)b * Tq * qstride + (size_t)h * d;
    for (int i0 = 0; i0 < Tq; i0 += kB) {
      __syncthreads();                     // the last tile's reads are done
      if (threadIdx.x < kB) {
        const int t = i0 + threadIdx.x;
        const bool in = t < Tq;
        const size_t row = ((size_t)b * H + h) * Tq + t;
        qp[threadIdx.x] = in ? qpos[(size_t)b * Tq + t] : 0;
        lse_s[threadIdx.x] = in ? lse[row] : 0.f;
        del_s[threadIdx.x] = in ? delta[row] : 0.f;
      }
      __syncthreads();
      bool any = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int row = lane + kWarp * cc;
          any |= i0 + row < Tq &&
                 visible(qp[row], kp[key0 + r], causal, win);
        }
      if (!__syncthreads_or(any)) continue;  // no visible pair in this tile

      for (int r = warp; r < kB; r += kWarps) {
        const int t = i0 + r;
        for (int c = lane; c < d; c += kWarp) {
          const bool in = t < Tq;
          qs[r * ds + c] = in ? to_f32(qb[(size_t)t * qstride + c]) : 0.f;
          dos[r * ds + c] = in ? to_f32(dob[(size_t)t * qstride + c]) : 0.f;
        }
      }
      __syncthreads();

      // logits and dp of rows lane and lane + 32 for the warp's keys
      float x[kRows][2], y[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        x[r][0] = x[r][1] = y[r][0] = y[r][1] = 0.f;
      const float* q0 = qs + lane * ds;
      const float* q1 = qs + (lane + kWarp) * ds;
      const float* d0 = dos + lane * ds;
      const float* d1 = dos + (lane + kWarp) * ds;
      for (int c = 0; c < d; ++c) {
        const float a0 = q0[c], a1 = q1[c], b0 = d0[c], b1 = d1[c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float kv = ks[(key0 + r) * ds + c];
          const float vv = vs[(key0 + r) * ds + c];
          x[r][0] += a0 * kv;
          x[r][1] += a1 * kv;
          y[r][0] += b0 * vv;
          y[r][1] += b1 * vv;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = key0 + r;
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int row = lane + kWarp * cc;
          float p = 0.f, dsv = 0.f;
          if (i0 + row < Tq && visible(qp[row], kp[key], causal, win)) {
            p = expf(x[r][cc] * scale - lse_s[row]);
            dsv = p * (y[r][cc] - del_s[row]);
          }
          ps[key * kB + row] = p;
          dss[key * kB + row] = dsv;
        }
      }
      __syncwarp();

      const int nq = min(kB, Tq - i0);
      for (int i = 0; i < nq; ++i) {
        float qv[NC], dov[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = lane + kWarp * n;
          qv[n] = c < d ? qs[i * ds + c] : 0.f;
          dov[n] = c < d ? dos[i * ds + c] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pr = ps[(key0 + r) * kB + i];
          const float dr = dss[(key0 + r) * kB + i];
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            av[r][n] += pr * dov[n];
            ak[r][n] += dr * qv[n];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = s0 + key0 + r;
    if (s >= S) continue;
    const size_t off = ((size_t)b * S + s) * kstride + (size_t)hk * d;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = lane + kWarp * n;
      if (c < d) {
        dk[off + c] = from_f32<T>(ak[r][n] * scale);
        dv[off + c] = from_f32<T>(av[r][n]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const int *qpos, *kpos;
  const void* dout;
  const float *lse, *delta;
  void *o1, *o2;                           // dq; or dk, dv
  int B, Tq, S, H, KVH, d, win, causal;
  float scale;
};

template <typename T, int NC>
int launch_dq(const Args& a, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, NC>;
  const size_t smem = smem_bytes(a.d, 1);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Tq + kB - 1) / kB, a.B * a.H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.qpos, a.kpos,
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.o1),
      a.Tq, a.S, a.H, a.KVH, a.d, a.win, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_dkv(const Args& a, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, NC>;
  const size_t smem = smem_bytes(a.d, 2);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.S + kB - 1) / kB, a.B * a.KVH);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.qpos, a.kpos,
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.o1),
      static_cast<T*>(a.o2), a.Tq, a.S, a.H, a.KVH, a.d, a.win, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T, bool DQ>
int dispatch(const Args& a, cudaStream_t st) {
#define BWD_CASE(nc) \
  case nc:           \
    return DQ ? launch_dq<T, nc>(a, st) : launch_dkv<T, nc>(a, st);
  switch ((a.d + kWarp - 1) / kWarp) {
    BWD_CASE(1) BWD_CASE(2) BWD_CASE(3) BWD_CASE(4)
    BWD_CASE(5) BWD_CASE(6) BWD_CASE(7) BWD_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

template <bool DQ>
int run(const Args& a, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16, DQ>(a, st)
                 : dispatch<float, DQ>(a, st);
}

}  // namespace

extern "C" {

// Shared memory one block of each kernel takes for head dim d (the wrapper
// checks it against the device's opt-in limit).
long long figmn_flash_bwd_dq_smem_bytes(int d) {
  return (long long)smem_bytes(d, 1);
}
long long figmn_flash_bwd_dkv_smem_bytes(int d) {
  return (long long)smem_bytes(d, 2);
}

// q, dout (B,T,H,d), k/v (B,S,KVH,d) of one type (bf16 = 1 or f32 = 0),
// qpos (B,T), kpos (B,S) int32, lse and delta (B,H,T) float32; dq
// (B,T,H,d) in that type.  1 <= d <= 256, H % KVH == 0, T >= 1.
int figmn_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, const void* dout,
                       const float* lse, const float* delta, void* dq, int B,
                       int T, int S, int H, int KVH, int d, int win,
                       int causal, float scale, int is_bf16, void* stream) {
  const Args a{q, k, v, qpos, kpos, dout, lse, delta, dq, nullptr,
               B, T, S, H, KVH, d, win, causal, scale};
  return run<true>(a, is_bf16, stream);
}

// The same operands; dk, dv (B,S,KVH,d) in k's and v's type.
int figmn_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const int* qpos, const int* kpos, const void* dout,
                        const float* lse, const float* delta, void* dk,
                        void* dv, int B, int T, int S, int H, int KVH, int d,
                        int win, int causal, float scale, int is_bf16,
                        void* stream) {
  const Args a{q, k, v, qpos, kpos, dout, lse, delta, dk, dv,
               B, T, S, H, KVH, d, win, causal, scale};
  return run<false>(a, is_bf16, stream);
}

}  // extern "C"
