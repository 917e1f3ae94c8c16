// K4 — flash attention forward: o = softmax(q k^T / sqrt(hd)) v per query
// head, causal or not, with an online softmax and float32 accumulation, for
// grouped-query attention (query head h reads kv head h / G).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (_flash_kernel), which walks a (BH, S/bq, T/bk) grid in order, keeps the
// running max, sum and output block in VMEM scratch across the sequential
// kv axis, asserts S % bq == 0 and T % bk == 0, and takes kv already
// repeated to H heads (ops.py::mha does the jnp.repeat).
//
// What changes on Hopper: the blocks of a grid run in parallel in no order,
// so one CTA owns a tile of 64 queries of one (batch, head) and loops over
// the key tiles itself, carrying the running max, sum and accumulator in
// registers.  GQA maps the query head to its kv head instead of copying kv.
// Ragged S and T are masked in the kernel (no padding in Python).  q, k, v
// are read through their strides in the model's (B, S, H, hd) layout, so
// the wrapper copies nothing; only hd must be contiguous.
//
// Bound on the H100: operations.  The causal prefill does 4 * hd FLOPs per
// unmasked (query, key) pair — about 26 GFLOP per llama3.2-3b layer at
// batch 4 x 1024 tokens — over 67 MB of q/k/v/o, so the bf16 tensor cores
// (989 TFLOP/s) set the floor.  This first version is simple and right: it
// runs on the CUDA cores in float32 (scores, exponentials and P.V, as the
// reference does), from shared-memory tiles converted to float32 on load;
// each thread owns 4 query rows x 4 keys of a score tile and 4 rows x hd/8
// output columns, and a row's 8 threads are neighbouring lanes of one warp,
// so row max and sum are three shuffles and P stays warp-private in shared
// memory.  Heaviest (latest) causal query tiles are scheduled first.
// wgmma, TMA and bf16 tensor-core products are the later redesign.
#include <cuda_bf16.h>
#include <math.h>

#include "helios_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kColGroups = 8;                       // threads per query row
constexpr int kRowGroups = kThreads / kColGroups;   // 16
constexpr int kBQ = 64;                             // queries per CTA
constexpr int kBK = 32;                             // keys per tile
constexpr int kRows = kBQ / kRowGroups;             // 4 rows per thread
constexpr int kKeys = kBK / kColGroups;             // 4 keys per thread
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

template <int HD>
constexpr int smem_bytes() {   // padded rows: conflict-free column reads
  return 4 * (kBQ * (HD + 1) + 2 * kBK * (HD + 1) + kBQ * (kBK + 1));
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

// grid (B * H, ceil(S / kBQ)); block kThreads; dynamic smem smem_bytes<HD>.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S,
                     int Tk, int H, int G, Strides st, float scale_log2,
                     int causal, int q_offset) {
  constexpr int LD = HD + 1;
  constexpr int LP = kBK + 1;
  constexpr int kDims = HD / kColGroups;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                 // [kBQ][LD], pre-scaled by scale*log2(e)
  float* sK = sQ + kBQ * LD;        // [kBK][LD]
  float* sV = sK + kBK * LD;        // [kBK][LD]
  float* sP = sV + kBK * LD;        // [kBQ][LP], probabilities of the tile

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups, cg = tid % kColGroups;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + (h / G) * st.kh;
  const T* vp = v + b * st.vb + (h / G) * st.vh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    const int s = q0 + r;
    sQ[r * LD + d] =
        s < S ? to_f32(qp[static_cast<int64_t>(s) * st.qs + d]) * scale_log2
              : 0.f;
  }

  float acc[kRows][kDims];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;
  }

  // keys any query of the tile can see
  const int kv_end =
      causal ? min(Tk, q_offset + min(q0 + kBQ, S)) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile's sK, sV are no longer read
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e - r * HD;
      const int t = k0 + r;
      const bool in = t < Tk;
      sK[r * LD + d] = in ? to_f32(kp[static_cast<int64_t>(t) * st.ks + d])
                          : 0.f;
      sV[r * LD + d] = in ? to_f32(vp[static_cast<int64_t>(t) * st.vs + d])
                          : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
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
        if (t >= Tk || (causal && t > qpos)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // a row that has seen no key yet keeps a zero sum and accumulator
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        sP[(rg * kRows + i) * LP + cg + kColGroups * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();   // a row's probabilities are read by the lanes that wrote

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = sP[(rg * kRows + i) * LP + t];
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const float vv = sV[t * LD + cg + kColGroups * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + rg * kRows + i;
    if (s >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* out = o + ((static_cast<int64_t>(b) * S + s) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < kDims; ++c)
      store(out + cg + kColGroups * c, acc[i][c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int H, int K, const Strides& st, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, H / K, st,
      scale * kLog2e, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int S, int Tk, int H, int K, const Strides& st,
                int causal, int q_offset, float scale, cudaStream_t s) {
#define HELIOS_FA_CASE(D)                                                   \
  case D:                                                                   \
    return launch<T, D>(q, k, v, o, B, S, Tk, H, K, st, causal, q_offset, \
                        scale, s);
  switch (hd) {
    HELIOS_FA_CASE(8)
    HELIOS_FA_CASE(16)
    HELIOS_FA_CASE(32)
    HELIOS_FA_CASE(64)
    HELIOS_FA_CASE(80)
    HELIOS_FA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HELIOS_FA_CASE
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, K, hd), with the given element strides of
// their batch, sequence and head axes (hd contiguous); o (B, S, H, hd)
// contiguous, same dtype (float32 when is_bf16 == 0, else bfloat16).
// hd is 8, 16, 32, 64, 80 or 128 (the model widths, and the reduced
// configs' 8); H % K == 0.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported hd).
extern "C" int helios_flash_attention(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int S, int T, int H, int K, int hd, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int causal, int q_offset, float scale,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (T <= 0 || K <= 0 || H % K) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, T, H, K, st,
                                      causal, q_offset, scale, s);
  return dispatch_hd<float>(hd, q, k, v, o, B, S, T, H, K, st, causal,
                            q_offset, scale, s);
}
