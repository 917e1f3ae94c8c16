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
// so one CTA owns a tile of queries of one (batch, head) and loops over the
// key tiles itself, carrying the running max, sum and accumulator in
// registers.  GQA maps the query head to its kv head instead of copying kv.
// Ragged S and T are masked in the kernel (no padding in Python).  q, k, v
// are read through their strides in the model's (B, S, H, hd) layout, so
// the wrapper copies nothing; only hd must be contiguous.  Heaviest
// (latest) causal query tiles are scheduled first.
//
// Local attention (window > 0; recurrentgemma-2b's 2048, which the Pallas
// kernel does not take: the reference computes it in XLA's chunked attend
// with the mask q - k < window).  A query at position p sees keys
// p - window < t (and t <= p when causal).  A CTA starts at the key tile
// that holds the first key its first query sees, so tiles wholly below the
// band are never loaded; tiles that cross either edge are masked per
// element.  At S 4096 and window 2048 a quarter of the causal pairs lie
// below the band.
//
// Bound on the H100: operations.  The causal prefill does 4 * hd FLOPs per
// unmasked (query, key) pair — about 26 GFLOP per llama3.2-3b layer at
// batch 4 x 1024 tokens — over 67 MB of q/k/v/o, so the bf16 tensor cores
// (989 TFLOP/s) set the floor.  Two routes, chosen by the wrapper
// (kernels/flash_attention/ops.py::pick_route):
//
// * tensor cores (helios_flash_attention_tc): bf16 at head widths 64, 80,
//   96, 112, 128 and 256, every bf16 prefill of the served configs.  wgmma
//   fed by TMA; see the comment above namespace tc below.
// * CUDA cores (helios_flash_attention): float32 at every width, and bf16
//   at widths 8-32 (the reduced configs).  Scores, exponentials and P.V in
//   float32 from shared-memory tiles converted to float32 on load; each
//   thread owns kRows query rows x 4 keys of a score tile and kRows rows x
//   hd/8 output columns, and a row's 8 threads are neighbouring lanes of
//   one warp, so row max and sum are three shuffles and P stays
//   warp-private in shared memory.  A CTA holds 64 query rows (4 per
//   thread), and 32 at hd 256 (2 per thread): its float32 accumulator is
//   then 2 x 32 registers a thread, where 64 rows would take 128, and its
//   shared memory 103 KB, two CTAs to an SM.
//
// Under autograd both routes also write each query's log-sum-exp (log2
// units, from the online softmax's running max and sum) for the backward
// (flash_attention_bwd.cu), so it need not recompute it; serving passes a
// null pointer and writes nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>

#include "helios_common.cuh"
#include "helios_wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kColGroups = 8;                       // threads per query row
constexpr int kRowGroups = kThreads / kColGroups;   // 16
constexpr int kBK = 32;                             // keys per tile
constexpr int kKeys = kBK / kColGroups;             // 4 keys per thread
constexpr float kLog2e = 1.4426950408889634f;

// queries per CTA: 64, and 32 at hd 256 to keep the accumulator in
// registers
template <int HD>
__host__ __device__ constexpr int block_q() {
  return HD > 128 ? 32 : 64;
}

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
  return 4 * (block_q<HD>() * (HD + 1) + 2 * kBK * (HD + 1) +
              block_q<HD>() * (kBK + 1));
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
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S,
                     int Tk, int H, int G, Strides st, float scale_log2,
                     int causal, int q_offset, int window) {
  constexpr int kBQ = block_q<HD>();
  constexpr int kRows = kBQ / kRowGroups;  // query rows per thread
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
  for (int k0 = first_key(q_offset + q0, window, kBK); k0 < kv_end;
       k0 += kBK) {
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
        if (t >= Tk || (causal && t > qpos) ||
            (window > 0 && qpos - t >= window))
          s[i][j] = -INFINITY;
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
    if (lse != nullptr && cg == 0)   // m is in scaled log2 units here
      lse[(static_cast<int64_t>(b) * H + h) * S + s] =
          l[i] > 0.f ? m[i] + log2f(l[i]) : HELIOS_NO_KEY_LSE;
    T* out = o + ((static_cast<int64_t>(b) * S + s) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < kDims; ++c)
      store(out + cg + kColGroups * c, acc[i][c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Tk, int H, int K, const Strides& st, int causal,
           int q_offset, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  constexpr int bq = block_q<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + bq - 1) / bq);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Tk, H, H / K, st,
      scale * kLog2e, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

// float32 at every width; bf16 only at 8-32 (bf16 heads of 64-256 take the
// tensor-core route, so no CUDA-core instance is built for them)
template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Tk, int H, int K,
                const Strides& st, int causal, int q_offset, int window,
                float scale, cudaStream_t s) {
#define HELIOS_FA_CASE(D)                                                     \
  case D:                                                                     \
    if constexpr (sizeof(T) == 4 || D <= 32)                                  \
      return launch<T, D>(q, k, v, o, lse, B, S, Tk, H, K, st, causal,        \
                          q_offset, window, scale, s);                        \
    break;
  switch (hd) {
    HELIOS_FA_CASE(8)
    HELIOS_FA_CASE(16)
    HELIOS_FA_CASE(32)
    HELIOS_FA_CASE(64)
    HELIOS_FA_CASE(80)
    HELIOS_FA_CASE(96)
    HELIOS_FA_CASE(112)
    HELIOS_FA_CASE(128)
    HELIOS_FA_CASE(256)
    default:
      break;
  }
#undef HELIOS_FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// Tensor-core route: bf16, head widths 64, 80, 96, 112, 128 and 256, on
// sm_90a.
//
// One CTA of three warpgroups owns 128 query rows of one (batch, head).
// Warpgroup 0 is the producer: one thread issues TMA loads — the query tile
// once, then key and value tiles of kBK keys into a ring of kStages
// shared-memory stages, each stage completing on its own mbarrier — and
// its registers are handed to the consumers with setmaxnreg.  Warpgroups 1
// and 2 each own 64 query rows (wgmma's M).  Per key tile a consumer
// computes S = Q K^T with wgmma (bf16 in, float32 out, both operands in
// shared memory), masks only the tiles that cross the causal diagonal or
// the end of the keys, runs the online softmax in registers on a log2-scaled
// score (a row's four values per 8 columns sit in one lane quad: two
// shuffles), rounds P to bf16 in registers — the reference model rounds P to
// v's dtype before P.V — and accumulates O += P V with P as wgmma's register
// operand and V read MN-major from shared memory through the descriptor's
// transpose bit, so V is never transposed.  The normaliser l sums the
// unrounded float32 P.  A tile past a warpgroup's last visible key, or
// wholly below its window, is skipped (its stage is still released); the
// producer starts at the first tile the CTA's first query sees.
//
// Tiles are stored as the TMA writes them with 128-byte swizzle: a block of
// 64 head columns (128 bytes) per row, 8-row atoms of 1024 bytes; a width
// of 128 is two such blocks, 256 four, and 80, 96 and 112 are padded to 128
// by the TMA's out-of-bounds zero fill (the padding columns add zeros to S
// and are not stored).  The same zero fill covers query rows past S and
// keys past T; padded keys are masked to -inf as well.
//
// At hd 256 (recurrentgemma-2b: 10 query heads on one kv head, a window of
// 2048) a key tile is 64 keys, not 128: Q (64 KB) and two stages of K and V
// (2 x 64 KB) then fit the 227 KB a CTA may hold, where 128-key tiles would
// take 320 KB.  A consumer thread holds O in 128 float32 registers, S in 32
// and P in 16; P.V is one m64n256k16 wgmma per 16 keys.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;           // query rows per CTA, 64 per consumer
constexpr int kStages = 2;         // K/V tiles in flight
constexpr int kThreads = 384;      // producer + 2 consumer warpgroups
constexpr int kRow = 128;          // bytes of one swizzled row: 64 bf16
constexpr int kAtom = 8 * kRow;    // one 8-row swizzle atom
constexpr int kProducerRegs = 24;  // setmaxnreg: 24 * 128 + 240 * 256
constexpr int kConsumerRegs = 240; //   <= 65,536 registers of the SM

// keys per tile at a head width padded to HDP: 128, and 64 at 256, where
// two stages of 128-key K and V tiles would not fit beside Q
__host__ __device__ constexpr int key_tile(int hdp) {
  return hdp > 128 ? 64 : 128;
}

// Shared-memory layout for a head width padded to HDP (64, 128 or 256), in
// bytes from a 1024-aligned base: Q, kStages K tiles, kStages V tiles, then
// the mbarriers (Q full; per stage K full, V full and empty).
template <int HDP>
struct Layout {
  static constexpr int kBK = key_tile(HDP);            // keys per tile
  static constexpr int kCols = HDP / 64;               // 64-column blocks
  static constexpr int kQBytes = kCols * kBQ * kRow;
  static constexpr int kKVBytes = kCols * kBK * kRow;  // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

// grid (B * H, ceil(S / kBQ)); block kThreads; dynamic smem
// Layout<HDP>::kBytes.  The tensor maps view q, k, v as (hd, rows, heads,
// batch), innermost first, in boxes of 64 columns x kBQ (q) or kBK (k, v)
// rows.  wgmma m64nN's accumulator: register i of a thread (warp w of its
// warpgroup, lane) holds row 16 w + lane / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's 64-row tile.  Its
// 16-column slice kk, as pairs (8 kk + 2 x, 8 kk + 2 x + 1) for x = 0..3,
// is exactly the register A operand of an m64nNk16 step, so P feeds P.V
// from registers with no shuffle.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int S, int Tk, int H,
                        int G, int hd, float scale_log2, int causal,
                        int q_offset, int window) {
  using L = Layout<HDP>;
  constexpr int kBK = L::kBK;
  static_assert(L::kBytes <= 232448, "over the 227 KB a CTA may hold");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  const auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  const auto empty = [&](int s) {
    return q_full + 8 * (1 + 2 * kStages + s);
  };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  // key tiles [j0, j_end) hold the keys any query of the tile can see
  const int kv_end = causal ? min(Tk, q_offset + min(q0 + kBQ, S)) : Tk;
  const int j_end = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int j0 = first_key(q_offset + q0, window, kBK) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast from lane 0 so the compiler can prove it
  // uniform: wgmma under a condition it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {             // ---- producer warpgroup -----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int kvh = h / G;
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kCols; ++c)
        tma_load(sQ + c * kBQ * kRow, &qmap, q_full, 64 * c, q0, h, b);
      for (int j = j0; j < j_end; ++j) {
        const int s = (j - j0) % kStages;
        mbar_wait(empty(s), (((j - j0) / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), L::kKVBytes);
        for (int c = 0; c < L::kCols; ++c)
          tma_load(sK + s * L::kKVBytes + c * kBK * kRow, &kmap, k_full(s),
                   64 * c, j * kBK, kvh, b);
        mbar_expect_tx(v_full(s), L::kKVBytes);
        for (int c = 0; c < L::kCols; ++c)
          tma_load(sV + s * L::kKVBytes + c * kBK * kRow, &vmap, v_full(s),
                   64 * c, j * kBK, kvh, b);
      }
    }
  } else {                   // ---- consumer warpgroups ----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = wg - 1;
    const int lane = threadIdx.x % 32;
    const int r0 = q0 + 64 * w;   // the warpgroup's first query row
    const int row = r0 + 16 * (threadIdx.x % 128 / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);
    // keys any query of this warpgroup can see
    const int my_end = r0 >= S ? 0
                       : causal ? min(Tk, q_offset + min(r0 + 64, S))
                                : Tk;
    const uint32_t sQw = sQ + 64 * w * kRow;

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int j = j0; j < j_end; ++j) {
      const int s = (j - j0) % kStages, k0 = j * kBK;
      const uint32_t parity = ((j - j0) / kStages) & 1;
      const uint32_t tK = sK + s * L::kKVBytes, tV = sV + s * L::kKVBytes;
      mbar_wait(k_full(s), parity);
      // the tile holds a key that some row of the warpgroup sees
      if (k0 < my_end &&
          (window <= 0 || k0 + kBK > q_offset + r0 - window + 1)) {
        // S = Q K^T in HDP / 16 steps of 16 head columns: a step moves 32
        // bytes along a 128-byte swizzled row, then on to the next block
        // of 64 columns.  The first step overwrites sc.
        float sc[kBK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t c = kk / 4, x = (kk % 4) * 32;
          wgmma_ss<kBK>(sc, smem_desc(sQw + c * kBQ * kRow + x, 16, kAtom),
                        smem_desc(tK + c * kBK * kRow + x, 16, kAtom), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(sc);

        // mask keys past T, causally past each row's position, and
        // below its window; only tiles that cross one of those edges need it
        if (k0 + kBK > Tk || (causal && k0 + kBK - 1 > q_offset + r0) ||
            (window > 0 && q_offset + r0 + 63 - k0 >= window)) {
#pragma unroll
          for (int i = 0; i < kBK / 2; ++i) {
            const int key = k0 + 8 * (i / 4) + col0 + i % 2;
            const int pos = q_offset + row + 8 * ((i / 2) % 2);
            if (key >= Tk || (causal && key > pos) ||
                (window > 0 && pos - key >= window))
              sc[i] = -INFINITY;
          }
        }

        // online softmax on the thread's two rows, in log2 units
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i)
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
        float alpha[2], shift[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mx[r]));
          // a row that has seen no key yet keeps a zero sum and accumulator
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          alpha[r] = fast_exp2((m[r] - m_use) * scale_log2);
          shift[r] = m_use * scale_log2;
          m[r] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int r = (i / 2) % 2;
          sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -shift[r]));
          sum[r] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
        for (int i = 0; i < HDP / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
        uint32_t p[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            p[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

        // O += P V in kBK / 16 steps of 16 keys (16 rows of each 64-column
        // block of V); V is MN-major: 8-key groups kAtom apart, 64-column
        // blocks a whole block of kBK rows apart
        mbar_wait(v_full(s), parity);
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_pv<HDP>(acc, p[kk],
                        smem_desc(tV + kk * 16 * kRow, kBK * kRow, kAtom));
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        pin(p);
      } else {
        mbar_wait(v_full(s), parity);
      }
      mbar_arrive(empty(s));
    }

    // epilogue: O / l (0 for a row that saw no key), bf16 pairs straight to
    // the (B, S, H, hd) output; the padding columns of hd 80-112 are dropped
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]);
      const int sq = row + 8 * r;
      if (sq >= S) continue;
      const float inv = lr > 0.f ? 1.f / lr : 0.f;
      if (lse != nullptr && lane % 4 == 0)
        lse[(static_cast<int64_t>(b) * H + h) * S + sq] =
            lr > 0.f ? m[r] * scale_log2 + log2f(lr) : HELIOS_NO_KEY_LSE;
      __nv_bfloat16* out = o + ((static_cast<int64_t>(b) * S + sq) * H + h) *
                                   hd;
#pragma unroll
      for (int c = 0; c < HDP / 8; ++c) {
        const int col = 8 * c + col0;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(acc[4 * c + 2 * r] * inv,
                                    acc[4 * c + 2 * r + 1] * inv);
      }
    }
  }
}

template <int HDP>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, void* o, float* lse, int B, int S, int Tk,
           int H, int K, int hd, int causal, int q_offset, int window,
           float scale, cudaStream_t stream) {
  constexpr int bytes = Layout<HDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<HDP><<<grid, kThreads, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, S, Tk, H, H / K, hd,
      scale * 1.4426950408889634f, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// The CUDA-core route: q (B, S, H, hd), k and v (B, T, K, hd), with the
// given element strides of their batch, sequence and head axes (hd
// contiguous); o (B, S, H, hd) contiguous, same dtype (float32 when
// is_bf16 == 0, else bfloat16); lse (B, H, S) float32 or null: each
// query's log-sum-exp of its scaled scores in log2 units, the statistic the
// backward reads (HELIOS_NO_KEY_LSE for a query that sees no key); null
// writes none.  hd is 8, 16, 32, 64, 80, 96, 112, 128 or
// 256 for float32 (the model widths, and the reduced configs' 8) and 8, 16
// or 32 for bfloat16; H % K == 0.  window > 0: a query at position p
// sees only keys t > p - window.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported hd).
extern "C" int helios_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int is_bf16, int B, int S, int T, int H, int K, int hd, int64_t q_sb,
    int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int causal, int q_offset, int window,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (T <= 0 || K <= 0 || H % K) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, l, B, S, T, H, K, st,
                                      causal, q_offset, window, scale, s);
  return dispatch_hd<float>(hd, q, k, v, o, l, B, S, T, H, K, st, causal,
                            q_offset, window, scale, s);
}

// The tensor-core route: q (B, S, H, hd), k and v (B, T, K, hd), bf16, with
// the given element strides of their batch, sequence and head axes (hd
// contiguous; base pointers and strides 16-byte multiples, as TMA reads
// them); o (B, S, H, hd) contiguous bf16; lse as above.  hd is 64, 80, 96,
// 112, 128 or 256; H % K == 0; window as above.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported shape), or minus the CUresult when a tensor map cannot be
// built (-1000 when the driver has no cuTensorMapEncodeTiled).
extern "C" int helios_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int S, int T, int H, int K, int hd, int64_t q_sb, int64_t q_ss,
    int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int causal, int q_offset, int window, float scale,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (T <= 0 || K <= 0 || H % K ||
      (hd != 64 && hd != 80 && hd != 96 && hd != 112 && hd != 128 &&
       hd != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!encode_tiled()) return -1000;
  const int hdp = hd == 64 ? 64 : hd <= 128 ? 128 : 256;   // padded width
  const int bk = tc::key_tile(hdp);
  CUtensorMap qm, km, vm;
  CUresult r = make_map(&qm, q, B, S, H, hd, q_sb, q_ss, q_sh, tc::kBQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&km, k, B, T, K, hd, k_sb, k_ss, k_sh, bk);
  if (r == CUDA_SUCCESS)
    r = make_map(&vm, v, B, T, K, hd, v_sb, v_ss, v_sh, bk);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hdp == 64)
    return tc::launch<64>(qm, km, vm, o, l, B, S, T, H, K, hd, causal,
                          q_offset, window, scale, s);
  if (hdp == 128)
    return tc::launch<128>(qm, km, vm, o, l, B, S, T, H, K, hd, causal,
                           q_offset, window, scale, s);
  return tc::launch<256>(qm, km, vm, o, l, B, S, T, H, K, hd, causal,
                         q_offset, window, scale, s);
}
