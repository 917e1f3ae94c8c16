// K4's backward — the gradient of o = softmax(q k^T / sqrt(hd)) v with
// respect to q, k and v, for every form the forward takes: causal or not,
// q_offset, a local-attention window, grouped-query attention (query head h
// reads kv head h / G), ragged S and T with S != T, float32 and bf16 at
// head widths 8-256, q/k/v read through their strides.
//
// The TPU kernel it stands beside,
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention, has
// no backward: the reference trains through XLA's chunked attend.  The
// port's training path runs K4's forward on the card, so its gradient is a
// kernel too (kernels/flash_attention/ops.py::FlashAttentionFn).
//
// FlashAttention-2's backward (Dao, 2023), in float32 on the CUDA cores:
//
// * a pre-pass (flash_bwd_stats_kernel), one CTA per (batch, head, 64
//   queries; 32 at hd 256), recomputes each query row's log-sum-exp over
//   the keys it sees (log2 units, the forward's online max and sum without
//   P.V) and delta = rowsum(dO * O).  The forward kernels are left as they
//   are: they save no statistics.
// * the main kernel (flash_bwd_kernel), one CTA per (batch, kv head, key
//   tile of 64 keys; 32 at hd 256), keeps the tile's K and V in shared
//   memory and its dK and dV in registers, and loops over the G query heads
//   of its kv head and over the query tiles that see its keys (tiles above
//   the causal diagonal and below the window are never visited).  Per query
//   tile it recomputes S = Q K^T and dP = dO V^T, P = exp2(S - lse) and
//   dS = P * (dP - delta), adds P^T dO to dV and dS^T Q to dK, and adds
//   dS K into a float32 dQ buffer with atomicAdd (the wrapper casts it).
//   dK and dV are summed over the G query heads in registers: no atomics.
//
// The gradient is the plain version's (autograd through attention_ref,
// probabilities in float32): P is recomputed in float32 from the saved q
// and k.  delta reads the forward's O, which the tensor-core route computed
// with P rounded to bf16 and stored in bf16; that rounding is the one
// difference from the plain version's gradient.
//
// Bound on the H100: operations.  At llama3.2-3b's training shape (S = T =
// 4096, 24 heads, hd 128, causal) the backward does 10 hd FLOPs per visible
// pair (S, dP, dV, dK, dQ), about 258 GFLOP, 0.26 ms at the bf16 tensor
// cores' 989 TFLOP/s; the pre-pass adds 2 hd per pair.  This first version
// runs in float32 on the CUDA cores (67 TFLOP/s peak); the tensor cores are
// later work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>

#include "helios_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {   // element strides of the batch, sequence and head axes
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool sees(int qpos, int t, int causal,
                                     int window) {
  return (!causal || t <= qpos) && (window <= 0 || qpos - t < window);
}

// ---------------------------------------------------------------------------
// Pre-pass: lse (log2 units) and delta per (batch, head, query).
// 128 threads; 8 neighbouring lanes per query row (shuffle reductions),
// kRows rows per thread; key tiles of 32.
// ---------------------------------------------------------------------------
namespace stats {

constexpr int kThreads = 128;
constexpr int kColGroups = 8;
constexpr int kRowGroups = kThreads / kColGroups;   // 16
constexpr int kBK = 32;
constexpr int kKeys = kBK / kColGroups;             // 4

template <int HD>
__host__ __device__ constexpr int block_q() {
  return HD > 128 ? 32 : 64;
}

template <int HD>
constexpr int smem_bytes() {
  return 4 * (block_q<HD>() + kBK) * (HD + 1);
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// grid (B * H, ceil(S / kBQ)); o and dO contiguous (B, S, H, HD); lse and
// delta (B, H, S) float32.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ lse, float* __restrict__ delta,
                           int S, int Tk, int H, int G, Strides st,
                           float scale_log2, int causal, int q_offset,
                           int window) {
  constexpr int kBQ = block_q<HD>();
  constexpr int kRows = kBQ / kRowGroups;
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* sQ = smem;              // [kBQ][LD], scaled by scale * log2(e)
  float* sK = sQ + kBQ * LD;     // [kBK][LD]

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups, cg = tid % kColGroups;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + (h / G) * st.kh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    const int s = q0 + r;
    sQ[r * LD + d] =
        s < S ? to_f32(qp[static_cast<int64_t>(s) * st.qs + d]) * scale_log2
              : 0.f;
  }

  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int kv_end = causal ? min(Tk, q_offset + min(q0 + kBQ, S)) : Tk;
  const int lo = window > 0 ? q_offset + q0 - window + 1 : 0;
  for (int k0 = lo > 0 ? lo / kBK * kBK : 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e - r * HD;
      const int t = k0 + r;
      sK[r * LD + d] =
          t < Tk ? to_f32(kp[static_cast<int64_t>(t) * st.ks + d]) : 0.f;
    }
    __syncthreads();
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[kRows], kb[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = sQ[(rg * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kb[j] = sK[(cg + kColGroups * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q_offset + q0 + rg * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int t = k0 + cg + kColGroups * j;
        if (t >= Tk || !sees(qpos, t, causal, window)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sum += exp2f(s[i][j] - m_use);
      l[i] = l[i] * exp2f(m[i] - m_use) + row_sum(sum);
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + rg * kRows + i;
    float dsum = 0.f;
    if (s < S) {
      const int64_t off = ((static_cast<int64_t>(b) * S + s) * H + h) * HD;
      for (int d = cg; d < HD; d += kColGroups)
        dsum = fmaf(to_f32(dout[off + d]), to_f32(o[off + d]), dsum);
    }
    dsum = row_sum(dsum);
    if (s < S && cg == 0) {
      const int64_t r = (static_cast<int64_t>(b) * H + h) * S + s;
      lse[r] = l[i] > 0.f ? m[i] + log2f(l[i]) : -INFINITY;
      delta[r] = dsum;
    }
  }
}

}  // namespace stats

// ---------------------------------------------------------------------------
// Main kernel: one CTA per (batch, kv head, key tile).
// 256 threads.  The score phase maps 16 x 16 threads over the (query, key)
// tile; the dK/dV and dQ phases map kTD neighbouring lanes over the head
// dimension (conflict-free shared-memory reads, coalesced atomics) and the
// rest over key (or query) rows, whose P and dS reads are warp broadcasts.
// Shared rows are padded to HD + 1 floats.
// ---------------------------------------------------------------------------
namespace bwd {

constexpr int kThreads = 256;

template <int HD>
__host__ __device__ constexpr int block_k() {
  return HD > 128 ? 32 : 64;
}
template <int HD>
__host__ __device__ constexpr int block_q() {
  return HD > 128 ? 32 : 64;
}
template <int HD>
__host__ __device__ constexpr int lanes_d() {   // threads across hd
  return HD % 32 == 0 ? 32 : (HD % 16 == 0 ? 16 : 8);
}

template <int HD>
constexpr int smem_bytes() {
  return 4 * (2 * block_k<HD>() * (HD + 1) + 2 * block_q<HD>() * (HD + 1) +
              2 * block_q<HD>() * (block_k<HD>() + 1) + 2 * block_q<HD>());
}

// grid (B * K, ceil(Tk / kBK)); dout contiguous (B, S, H, HD); lse, delta
// (B, H, S); dq_acc float32 (B, S, H, HD), zeroed; dk, dv (B, Tk, K, HD).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Tk, int H, int Kh,
                     Strides st, float scale, float scale_log2, int causal,
                     int q_offset, int window) {
  constexpr int kBK = block_k<HD>();
  constexpr int kBQ = block_q<HD>();
  constexpr int LD = HD + 1;
  constexpr int LP = kBK + 1;
  constexpr int kSR = kBQ / 16, kSK = kBK / 16;   // score phase, per thread
  constexpr int kTD = lanes_d<HD>();
  constexpr int kDims = HD / kTD;
  constexpr int kGroups = kThreads / kTD;
  constexpr int kKeyRows = kBK / kGroups;         // dK/dV rows per thread
  constexpr int kQRows = kBQ / kGroups;           // dQ rows per thread
  static_assert(kKeyRows >= 1 && kQRows >= 1, "tile too small");
  extern __shared__ float smem[];
  float* sK = smem;                 // [kBK][LD]
  float* sV = sK + kBK * LD;        // [kBK][LD]
  float* sQ = sV + kBK * LD;        // [kBQ][LD]
  float* sdO = sQ + kBQ * LD;       // [kBQ][LD]
  float* sP = sdO + kBQ * LD;       // [kBQ][LP]
  float* sdS = sP + kBQ * LP;       // [kBQ][LP]
  float* sL = sdS + kBQ * LP;       // [kBQ]
  float* sD = sL + kBQ;             // [kBQ]

  const int tid = threadIdx.x;
  const int sr = tid / 16, sc = tid % 16;         // score phase
  const int gr = tid / kTD, gd = tid % kTD;       // dK/dV and dQ phases
  const int G = H / Kh;
  const int b = blockIdx.x / Kh, kh = blockIdx.x % Kh;
  const int n0 = blockIdx.y * kBK;
  const T* kp = k + b * st.kb + kh * st.kh;
  const T* vp = v + b * st.vb + kh * st.vh;

  for (int e = tid; e < kBK * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    const int t = n0 + r;
    const bool in = t < Tk;
    sK[r * LD + d] = in ? to_f32(kp[static_cast<int64_t>(t) * st.ks + d]) : 0.f;
    sV[r * LD + d] = in ? to_f32(vp[static_cast<int64_t>(t) * st.vs + d]) : 0.f;
  }

  float dk_acc[kKeyRows][kDims], dv_acc[kKeyRows][kDims];
#pragma unroll
  for (int i = 0; i < kKeyRows; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // the queries that see a key of this tile: from the diagonal (causal) to
  // the window's far edge
  const int s_lo = causal ? max(0, n0 - q_offset) : 0;
  const int s_hi =
      window > 0 ? min(S, n0 + kBK - 1 + window - q_offset) : S;
  const int q_first = s_lo / kBQ * kBQ;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qp = q + b * st.qb + h * st.qh;
    const float* lse_h = lse + (static_cast<int64_t>(b) * H + h) * S;
    const float* delta_h = delta + (static_cast<int64_t>(b) * H + h) * S;
    for (int q0 = q_first; q0 < s_hi; q0 += kBQ) {
      __syncthreads();   // the previous tile's sQ, sdO, sP, sdS are read
      for (int e = tid; e < kBQ * HD; e += kThreads) {
        const int r = e / HD, d = e - r * HD;
        const int s = q0 + r;
        const bool in = s < S;
        sQ[r * LD + d] =
            in ? to_f32(qp[static_cast<int64_t>(s) * st.qs + d]) : 0.f;
        sdO[r * LD + d] =
            in ? to_f32(dout[((static_cast<int64_t>(b) * S + s) * H + h) *
                                 HD + d])
               : 0.f;
      }
      for (int r = tid; r < kBQ; r += kThreads) {
        const int s = q0 + r;
        sL[r] = s < S ? lse_h[s] : -INFINITY;
        sD[r] = s < S ? delta_h[s] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T for the thread's kSR x kSK entries
      float s_[kSR][kSK], dp[kSR][kSK];
#pragma unroll
      for (int i = 0; i < kSR; ++i)
#pragma unroll
        for (int j = 0; j < kSK; ++j) s_[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qa[kSR], oa[kSR], kb[kSK], vb[kSK];
#pragma unroll
        for (int i = 0; i < kSR; ++i) {
          qa[i] = sQ[(sr * kSR + i) * LD + d];
          oa[i] = sdO[(sr * kSR + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < kSK; ++j) {
          kb[j] = sK[(sc + 16 * j) * LD + d];
          vb[j] = sV[(sc + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < kSR; ++i)
#pragma unroll
          for (int j = 0; j < kSK; ++j) {
            s_[i][j] = fmaf(qa[i], kb[j], s_[i][j]);
            dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kSR; ++i) {
        const int r = sr * kSR + i;
        const int qpos = q_offset + q0 + r;
        const bool row_in = q0 + r < S;
#pragma unroll
        for (int j = 0; j < kSK; ++j) {
          const int c = sc + 16 * j;
          const int t = n0 + c;
          const bool vis = row_in && t < Tk && sees(qpos, t, causal, window);
          const float p = vis ? exp2f(s_[i][j] * scale_log2 - sL[r]) : 0.f;
          sP[r * LP + c] = p;
          sdS[r * LP + c] = p * (dp[i][j] - sD[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's queries
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pa[kKeyRows], sa[kKeyRows], ob[kDims], qb[kDims];
#pragma unroll
        for (int i = 0; i < kKeyRows; ++i) {
          pa[i] = sP[r * LP + gr * kKeyRows + i];
          sa[i] = sdS[r * LP + gr * kKeyRows + i];
        }
#pragma unroll
        for (int c = 0; c < kDims; ++c) {
          ob[c] = sdO[r * LD + gd + kTD * c];
          qb[c] = sQ[r * LD + gd + kTD * c];
        }
#pragma unroll
        for (int i = 0; i < kKeyRows; ++i)
#pragma unroll
          for (int c = 0; c < kDims; ++c) {
            dv_acc[i][c] = fmaf(pa[i], ob[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(sa[i], qb[c], dk_acc[i][c]);
          }
      }

      // dQ += dS K, added into the float32 buffer
      float dq[kQRows][kDims];
#pragma unroll
      for (int i = 0; i < kQRows; ++i)
#pragma unroll
        for (int c = 0; c < kDims; ++c) dq[i][c] = 0.f;
#pragma unroll 2
      for (int t = 0; t < kBK; ++t) {
        float sa[kQRows], kb[kDims];
#pragma unroll
        for (int i = 0; i < kQRows; ++i)
          sa[i] = sdS[(gr * kQRows + i) * LP + t];
#pragma unroll
        for (int c = 0; c < kDims; ++c) kb[c] = sK[t * LD + gd + kTD * c];
#pragma unroll
        for (int i = 0; i < kQRows; ++i)
#pragma unroll
          for (int c = 0; c < kDims; ++c) dq[i][c] = fmaf(sa[i], kb[c], dq[i][c]);
      }
#pragma unroll
      for (int i = 0; i < kQRows; ++i) {
        const int s = q0 + gr * kQRows + i;
        if (s >= S) continue;
        float* out = dq_acc + ((static_cast<int64_t>(b) * S + s) * H + h) * HD;
#pragma unroll
        for (int c = 0; c < kDims; ++c)
          atomicAdd(out + gd + kTD * c, dq[i][c] * scale);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kKeyRows; ++i) {
    const int t = n0 + gr * kKeyRows + i;
    if (t >= Tk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * Tk + t) * Kh + kh) * HD;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      store(dk + off + gd + kTD * c, dk_acc[i][c] * scale);
      store(dv + off + gd + kTD * c, dv_acc[i][c]);
    }
  }
}

}  // namespace bwd

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, float* lse, float* delta, float* dq_acc,
           void* dk, void* dv, int B, int S, int Tk, int H, int K,
           const Strides& st, int causal, int q_offset, int window,
           float scale, cudaStream_t stream) {
  constexpr int s_bytes = stats::smem_bytes<HD>();
  constexpr int m_bytes = bwd::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      stats::flash_bwd_stats_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, s_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd::flash_bwd_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               m_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bq = stats::block_q<HD>();
  const dim3 g1(B * H, (S + bq - 1) / bq);
  stats::flash_bwd_stats_kernel<T, HD><<<g1, stats::kThreads, s_bytes,
                                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, S,
      Tk, H, H / K, st, scale * kLog2e, causal, q_offset, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bk = bwd::block_k<HD>();
  const dim3 g2(B * K, (Tk + bk - 1) / bk);
  bwd::flash_bwd_kernel<T, HD><<<g2, bwd::kThreads, m_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, H, K, st,
      scale, scale * kLog2e, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* o, const void* dout, float* lse, float* delta,
                float* dq_acc, void* dk, void* dv, int B, int S, int Tk,
                int H, int K, const Strides& st, int causal, int q_offset,
                int window, float scale, cudaStream_t s) {
#define HELIOS_FAB_CASE(D)                                                   \
  case D:                                                                    \
    return launch<T, D>(q, k, v, o, dout, lse, delta, dq_acc, dk, dv, B, S,  \
                        Tk, H, K, st, causal, q_offset, window, scale, s);
  switch (hd) {
    HELIOS_FAB_CASE(8)
    HELIOS_FAB_CASE(16)
    HELIOS_FAB_CASE(32)
    HELIOS_FAB_CASE(64)
    HELIOS_FAB_CASE(80)
    HELIOS_FAB_CASE(96)
    HELIOS_FAB_CASE(112)
    HELIOS_FAB_CASE(128)
    HELIOS_FAB_CASE(256)
    default:
      break;
  }
#undef HELIOS_FAB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, K, hd) with the given element strides of
// their batch, sequence and head axes (hd contiguous); o and dout (B, S, H,
// hd) contiguous, the forward's output and its gradient; all of one dtype
// (float32 when is_bf16 == 0, else bfloat16).  Scratch: lse and delta (B,
// H, S) float32; dq_acc (B, S, H, hd) float32, zeroed by the caller, gets
// dq.  dk and dv (B, T, K, hd) contiguous, the inputs' dtype, every entry
// written (the caller zeroes them itself when B, S or T is 0: nothing is
// launched then).  hd is 8, 16, 32, 64, 80, 96, 112, 128 or 256; H % K == 0;
// window > 0: a query at position p sees only keys t > p - window.  Two
// launches (the statistics, then the gradients); returns the first
// cudaGetLastError() that is not cudaSuccess (cudaErrorInvalidValue for an
// unsupported hd).
extern "C" int helios_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* lse, void* delta, void* dq_acc, void* dk,
    void* dv, int is_bf16, int B, int S, int T, int H, int K, int hd,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int causal,
    int q_offset, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || T <= 0) return 0;
  if (K <= 0 || H % K) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* dq = static_cast<float*>(dq_acc);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, l, dl, dq, dk, dv,
                                      B, S, T, H, K, st, causal, q_offset,
                                      window, scale, s);
  return dispatch_hd<float>(hd, q, k, v, o, dout, l, dl, dq, dk, dv, B, S, T,
                            H, K, st, causal, q_offset, window, scale, s);
}
