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
// Both routes read each query's log-sum-exp (lse, log2 units) as the
// forward saved it under autograd (flash_attention.cu), so P = exp2(s *
// scale * log2(e) - lse) is recomputed without a pass over the keys.  A
// pre-pass (flash_bwd_delta_kernel, a warp per query row) computes only
// delta = rowsum(dO * O), reading the forward's output: bound by the bytes
// of O and dO.  Then, on the backward's own route
// (kernels/flash_attention/ops.py::bwd_route_of):
//
// * tensor cores (helios_flash_attention_bwd_tc): bf16 at head widths 64,
//   80, 96, 112 and 128, FlashAttention-3's backward for Hopper (Shah et
//   al., 2024) split into two kernels so that nothing is added by atomics
//   and the result is the same from run to run; see namespace tcb below.
// * CUDA cores (helios_flash_attention_bwd): float32 at every width, bf16
//   at 8-32 and 256 (whose forward runs on the tensor cores and saves the
//   log-sum-exp read here).  FlashAttention-2's backward (Dao, 2023) in
//   float32: one CTA per (batch, kv head, key tile of 64 keys; 32 at hd
//   256) keeps the tile's K and V in shared memory and its dK and dV in
//   registers, loops over the G query heads of its kv head and over the
//   query tiles that see its keys (tiles above the causal diagonal and
//   below the window are never visited), and adds dS K into a float32 dQ
//   buffer with atomicAdd (the wrapper casts it).
//
// The gradient is the plain version's (autograd through attention_ref,
// probabilities in float32), but for roundings: delta reads the forward's
// O, stored in its dtype (and on the tensor cores computed with P rounded
// to bf16), and the tensor-core route rounds dS to bf16 before its
// products and feeds P to dV as a bf16 pair hi + lo; sums stay float32.
//
// Bound on the H100: operations.  At llama3.2-3b's training shape (S = T =
// 4096, 24 heads, hd 128, causal) the gradient needs 10 hd FLOPs per
// visible pair (S, dP, dV, dK, dQ), about 258 GFLOP, 0.26 ms at the bf16
// tensor cores' 989 TFLOP/s.  The split tensor-core design recomputes S and
// dP in its dQ kernel and adds P's low half into dV: 16 hd per pair (10 in
// the dK/dV kernel, 6 in the dQ kernel), 412 GFLOP, 0.417 ms.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>

#include "helios_common.cuh"
#include "helios_wgmma.cuh"

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
// Pre-pass: delta = rowsum(dO * O) per (batch, head, query), a warp per row.
// ---------------------------------------------------------------------------
namespace pre {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;   // rows per CTA

// grid ceil(B * S * H / kRows); o and dout contiguous (B, S, H, hd); delta
// (B, H, ld) float32, ld >= S.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, int64_t rows, int S,
                           int H, int hd, int ld) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / 32;
  if (r >= rows) return;   // uniform over the warp
  const int lane = threadIdx.x % 32;
  const T* op = o + r * hd;
  const T* dp = dout + r * hd;
  float sum = 0.f;
  for (int d = lane; d < hd; d += 32)
    sum = fmaf(to_f32(dp[d]), to_f32(op[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int64_t bs = r / H;   // b * S + s
    const int64_t b = bs / S;
    delta[(b * H + r % H) * ld + bs % S] = sum;
  }
}

template <typename T>
int launch(const void* o, const void* dout, float* delta, int B, int S,
           int H, int hd, int ld, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * S * H;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows));
  flash_bwd_delta_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, S,
      H, hd, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pre

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

// ---------------------------------------------------------------------------
// Tensor-core route: bf16, head widths 64, 80, 96, 112 and 128, on sm_90a.
//
// Two kernels, each laid out as the forward's CTA (flash_attention.cu,
// namespace tc): three warpgroups, the first a producer whose one thread
// issues TMA loads into a ring of kStages shared-memory stages (each
// completing on its own mbarrier, released by the consumers on another),
// its registers handed to the two consumer warpgroups with setmaxnreg.
// Each consumer owns 64 rows of the CTA's resident block (wgmma's M) and
// streams tiles of kTile rows.  Products are bf16 wgmma with float32 sums,
// in the two forms the forward uses: both operands in shared memory
// (K-major), or A in registers and B read MN-major from shared memory
// through the descriptor's transpose bit, so no tile is ever transposed.
//
// * flash_bwd_dkdv_kernel: one CTA per (batch, kv head, kBlk keys), its K
//   and V resident; it streams, for each of the G query heads of its kv
//   head, the Q and dO tiles (kTile queries) that see its keys, with their
//   lse and delta (a TMA box of one row each).  Per tile a consumer computes
//   S^T = K Q^T and dP^T = V dO^T (shared x shared), P^T = exp2(S^T scale
//   log2(e) - lse) and dS^T = P^T (dP^T - delta) in registers, and adds
//   dV += P^T dO and dK += dS^T Q (registers x shared).  dS^T is rounded
//   to bf16; P^T goes in as a bf16 pair hi + lo, two products: dV's
//   entries cancel (a rounded P alone left entries of dV off by several
//   times 2^-8 of the mean |dV|, the limit they are held to), dK's and
//   dQ's limits carry delta's rounding already.  dK and dV stay in
//   float32 registers over every tile and head, and are written once.
// * flash_bwd_dq_kernel: one CTA per (batch, query head, kBlk queries), its
//   Q and dO resident, lse and delta in registers; it streams the K and V
//   tiles (kTile keys) its queries see, computes S = Q K^T and dP = dO V^T,
//   P and dS as above, and adds dQ += dS K; dQ is written once.
//
// Tiles past the causal diagonal or below the window are never loaded; a
// tile that one consumer's rows do not see is skipped by that consumer (its
// stage still released).  Ragged S and T, and the padding columns of hd
// 80-112, rest on the TMA's zero fill; tiles that cross a diagonal, a
// window edge, or the end of the queries or keys are masked per element
// (P = dS = 0), and padding columns and rows are not stored.
// ---------------------------------------------------------------------------
namespace tcb {

constexpr int kThreads = 384;      // producer + 2 consumer warpgroups
constexpr int kBlk = 128;          // resident rows per CTA, 64 per consumer
constexpr int kTile = 64;          // rows per streamed tile
constexpr int kStages = 2;         // streamed tiles in flight
constexpr int kRow = 128;          // bytes of one swizzled row: 64 bf16
constexpr int kAtom = 8 * kRow;    // one 8-row swizzle atom
constexpr int kProducerRegs = 24;  // setmaxnreg: 24 * 128 + 240 * 256
constexpr int kConsumerRegs = 240; //   <= 65,536 registers of the SM

// Shared-memory layout of both kernels for a head width padded to HDP (64
// or 128), in bytes from a 1024-aligned base: two resident blocks of kBlk
// rows (K, V for dK/dV; Q, dO for dQ), kStages tiles of each streamed
// tensor (Q and dO; K and V), then kStages (lse, delta) boxes (dK/dV only)
// and the mbarriers (resident full; per stage full and empty).
template <int HDP>
struct Layout {
  static constexpr int kCols = HDP / 64;                 // 64-column blocks
  static constexpr int kResBytes = kCols * kBlk * kRow;  // one resident block
  static constexpr int kTileBytes = kCols * kTile * kRow;
  static constexpr int kStatBytes = 2 * kTile * 4;       // lse, delta boxes
  static constexpr int kRes0 = 0;
  static constexpr int kRes1 = kResBytes;
  static constexpr int kStr0 = 2 * kResBytes;
  static constexpr int kStr1 = kStr0 + kStages * kTileBytes;
  static constexpr int kStats = kStr1 + kStages * kTileBytes;
  static constexpr int kBar = kStats + kStages * kStatBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// grid (B * Kh, ceil(Tk / kBlk)): the CTA of key block n0 = blockIdx.y *
// kBlk (the heaviest, first keys under a causal mask, start first); block
// kThreads; dynamic smem Layout<HDP>::kBytes.  The bf16 maps view q, dO (in
// boxes of kTile rows) and k, v (kBlk rows) as (hd, rows, heads, batch);
// lse and delta, (B, H, ld) float32, as (ld, B * H) in boxes of kTile x 1.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap lsemap,
                          const __grid_constant__ CUtensorMap deltamap,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int S, int Tk,
                          int H, int Kh, int hd, float scale,
                          float scale_log2, int causal, int q_offset,
                          int window) {
  using L = Layout<HDP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base + L::kRes0, sV = base + L::kRes1;
  const uint32_t sQ = base + L::kStr0, sdO = base + L::kStr1;
  const uint32_t sStats = base + L::kStats;
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kStats);
  const uint32_t kv_full = base + L::kBar;
  const auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return kv_full + 8 * (1 + kStages + s); };

  const int G = H / Kh;
  const int b = blockIdx.x / Kh, kvh = blockIdx.x % Kh;
  const int n0 = blockIdx.y * kBlk;
  // query tiles [t0, t0 + n_tiles) hold every query that sees a key of the
  // block: from the causal diagonal to the window's far edge
  const int s_lo = causal ? max(0, n0 - q_offset) : 0;
  const int s_hi =
      window > 0 ? min(S, n0 + kBlk - 1 + window - q_offset) : S;
  const int t0 = s_lo / kTile;
  const int n_tiles = max(0, (max(s_hi, 0) + kTile - 1) / kTile - t0);
  const int n_iter = G * n_tiles;   // (head, tile) pairs, head-major

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
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
      mbar_expect_tx(kv_full, 2 * L::kResBytes);
      for (int c = 0; c < L::kCols; ++c) {
        tma_load(sK + c * kBlk * kRow, &kmap, kv_full, 64 * c, n0, kvh, b);
        tma_load(sV + c * kBlk * kRow, &vmap, kv_full, 64 * c, n0, kvh, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        const int h = kvh * G + it / n_tiles;
        const int q0 = (t0 + it % n_tiles) * kTile;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTileBytes + L::kStatBytes);
        for (int c = 0; c < L::kCols; ++c) {
          tma_load(sQ + s * L::kTileBytes + c * kTile * kRow, &qmap, full(s),
                   64 * c, q0, h, b);
          tma_load(sdO + s * L::kTileBytes + c * kTile * kRow, &domap,
                   full(s), 64 * c, q0, h, b);
        }
        tma_load_2d(sStats + s * L::kStatBytes, &lsemap, full(s), q0,
                    b * H + h);
        tma_load_2d(sStats + s * L::kStatBytes + kTile * 4, &deltamap,
                    full(s), q0, b * H + h);
      }
    }
  } else {                   // ---- consumer warpgroups ----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = wg - 1;
    const int lane = threadIdx.x % 32;
    const int k0w = n0 + 64 * w;   // the warpgroup's first key
    const int key = k0w + 16 * (threadIdx.x % 128 / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t sKw = sK + 64 * w * kRow, sVw = sV + 64 * w * kRow;

    float dk_acc[HDP / 2], dv_acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      const int q0 = (t0 + it % n_tiles) * kTile;
      const int p0 = q_offset + q0;                      // first position
      const int p1 = q_offset + min(q0 + kTile, S) - 1;  // last position
      const uint32_t tQ = sQ + s * L::kTileBytes;
      const uint32_t tdO = sdO + s * L::kTileBytes;
      const float* sl = stats + s * (L::kStatBytes / 4);  // lse, then delta
      mbar_wait(full(s), (it / kStages) & 1);
      // some key of the warpgroup is seen by some query of the tile
      if (k0w < Tk && (!causal || k0w <= p1) &&
          (window <= 0 || p0 - (k0w + 63) < window)) {
        // S^T = K Q^T and dP^T = V dO^T in HDP / 16 steps of 16 head
        // columns each; the first step overwrites
        float st[kTile / 2], dpt[kTile / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t c = kk / 4, x = (kk % 4) * 32;
          wgmma_ss_n64(st, smem_desc(sKw + c * kBlk * kRow + x, 16, kAtom),
                       smem_desc(tQ + c * kTile * kRow + x, 16, kAtom), kk);
        }
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t c = kk / 4, x = (kk % 4) * 32;
          wgmma_ss_n64(dpt, smem_desc(sVw + c * kBlk * kRow + x, 16, kAtom),
                       smem_desc(tdO + c * kTile * kRow + x, 16, kAtom), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(st);
        pin(dpt);

        // the tile crosses the causal diagonal, the window's edge, or the
        // end of the keys or queries: mask per element
        const bool edge = k0w + 64 > Tk || q0 + kTile > S ||
                          (causal && k0w + 63 > p0) ||
                          (window > 0 && p0 + kTile - 1 - k0w >= window);
        // P^T as a bf16 pair (hi, lo) and dS^T rounded, packed as wgmma's
        // A operand
        uint32_t p[kTile / 16][4], plo[kTile / 16][4], ds[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            float pv[2], dsv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 8 * kk + 2 * x + e;
              const int qc = 8 * (i / 4) + col0 + e;   // query in the tile
              pv[e] = fast_exp2(fmaf(st[i], scale_log2, -sl[qc]));
              dsv[e] = pv[e] * (dpt[i] - sl[kTile + qc]);
              if (edge) {
                const int t = key + 8 * (x % 2), pos = p0 + qc;
                if (q0 + qc >= S || t >= Tk || (causal && t > pos) ||
                    (window > 0 && pos - t >= window))
                  pv[e] = dsv[e] = 0.f;
              }
            }
            pack_bf16_split(pv[0], pv[1], p[kk][x], plo[kk][x]);
            ds[kk][x] = pack_bf16(dsv[0], dsv[1]);
          }
        }

        // dV += P^T dO and dK += dS^T Q in kTile / 16 steps of 16 queries;
        // dO and Q are read MN-major: 8-query groups kAtom apart, 64-column
        // blocks a whole tile of kTile rows apart
        pin(dv_acc);
        pin(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_pv<HDP>(dv_acc, p[kk],
                        smem_desc(tdO + kk * 16 * kRow, kTile * kRow, kAtom));
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_pv<HDP>(dv_acc, plo[kk],
                        smem_desc(tdO + kk * 16 * kRow, kTile * kRow, kAtom));
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_pv<HDP>(dk_acc, ds[kk],
                        smem_desc(tQ + kk * 16 * kRow, kTile * kRow, kAtom));
        wgmma_commit();
        wgmma_wait_all();
        pin(dv_acc);
        pin(dk_acc);
        pin(p);
        pin(plo);
        pin(ds);
      }
      mbar_arrive(empty(s));
    }

    // epilogue: bf16 pairs straight to the (B, Tk, Kh, hd) outputs; keys
    // past Tk and the padding columns of hd 80-112 are dropped
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = key + 8 * r;
      if (t >= Tk) continue;
      const int64_t off = ((static_cast<int64_t>(b) * Tk + t) * Kh + kvh) * hd;
#pragma unroll
      for (int c = 0; c < HDP / 8; ++c) {
        const int col = 8 * c + col0;
        if (col < hd) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
              __floats2bfloat162_rn(dk_acc[4 * c + 2 * r] * scale,
                                    dk_acc[4 * c + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
              __floats2bfloat162_rn(dv_acc[4 * c + 2 * r],
                                    dv_acc[4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

// grid (B * H, ceil(S / kBlk)): the CTA of query block q0 (the latest, the
// heaviest under a causal mask, start first); block kThreads; dynamic smem
// Layout<HDP>::kBytes.  The maps view q, dO (boxes of kBlk rows) and k, v
// (kTile rows) as (hd, rows, heads, batch); lse, delta (B, H, ld) float32.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int S, int Tk, int H,
                        int G, int hd, int ld, float scale, float scale_log2,
                        int causal, int q_offset, int window) {
  using L = Layout<HDP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kRes0, sdO = base + L::kRes1;
  const uint32_t sK = base + L::kStr0, sV = base + L::kStr1;
  const uint32_t q_full = base + L::kBar;
  const auto full = [&](int s) { return q_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlk;
  // key tiles [j0, j_end) hold the keys any query of the block can see
  const int kv_end = causal ? min(Tk, q_offset + min(q0 + kBlk, S)) : Tk;
  const int j_end = kv_end > 0 ? (kv_end + kTile - 1) / kTile : 0;
  const int j0 = first_key(q_offset + q0, window, kTile) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {             // ---- producer warpgroup -----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int kvh = h / G;
      mbar_expect_tx(q_full, 2 * L::kResBytes);
      for (int c = 0; c < L::kCols; ++c) {
        tma_load(sQ + c * kBlk * kRow, &qmap, q_full, 64 * c, q0, h, b);
        tma_load(sdO + c * kBlk * kRow, &domap, q_full, 64 * c, q0, h, b);
      }
      for (int j = j0; j < j_end; ++j) {
        const int s = (j - j0) % kStages;
        mbar_wait(empty(s), (((j - j0) / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTileBytes);
        for (int c = 0; c < L::kCols; ++c) {
          tma_load(sK + s * L::kTileBytes + c * kTile * kRow, &kmap, full(s),
                   64 * c, j * kTile, kvh, b);
          tma_load(sV + s * L::kTileBytes + c * kTile * kRow, &vmap, full(s),
                   64 * c, j * kTile, kvh, b);
        }
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
    const uint32_t sQw = sQ + 64 * w * kRow, sdOw = sdO + 64 * w * kRow;
    // the thread's two rows' lse and delta; a row past S gets P = 0
    float lr[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sq = row + 8 * r;
      const int64_t at = (static_cast<int64_t>(b) * H + h) * ld + sq;
      lr[r] = sq < S ? lse[at] : HELIOS_NO_KEY_LSE;
      dr[r] = sq < S ? delta[at] : 0.f;
    }

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int j = j0; j < j_end; ++j) {
      const int s = (j - j0) % kStages, k0 = j * kTile;
      const uint32_t tK = sK + s * L::kTileBytes, tV = sV + s * L::kTileBytes;
      mbar_wait(full(s), ((j - j0) / kStages) & 1);
      // the tile holds a key that some row of the warpgroup sees
      if (k0 < my_end &&
          (window <= 0 || k0 + kTile > q_offset + r0 - window + 1)) {
        float sc[kTile / 2], dp[kTile / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t c = kk / 4, x = (kk % 4) * 32;
          wgmma_ss_n64(sc, smem_desc(sQw + c * kBlk * kRow + x, 16, kAtom),
                       smem_desc(tK + c * kTile * kRow + x, 16, kAtom), kk);
        }
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t c = kk / 4, x = (kk % 4) * 32;
          wgmma_ss_n64(dp, smem_desc(sdOw + c * kBlk * kRow + x, 16, kAtom),
                       smem_desc(tV + c * kTile * kRow + x, 16, kAtom), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(sc);
        pin(dp);

        const bool edge = k0 + kTile > Tk ||
                          (causal && k0 + kTile - 1 > q_offset + r0) ||
                          (window > 0 && q_offset + r0 + 63 - k0 >= window);
        uint32_t ds[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            float dsv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 8 * kk + 2 * x + e, r = x % 2;
              const float pv = fast_exp2(fmaf(sc[i], scale_log2, -lr[r]));
              dsv[e] = pv * (dp[i] - dr[r]);
              if (edge) {
                const int t = k0 + 8 * (i / 4) + col0 + e;
                const int pos = q_offset + row + 8 * r;
                if (t >= Tk || (causal && t > pos) ||
                    (window > 0 && pos - t >= window))
                  dsv[e] = 0.f;
              }
            }
            ds[kk][x] = pack_bf16(dsv[0], dsv[1]);
          }
        }

        // dQ += dS K in kTile / 16 steps of 16 keys; K read MN-major
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_pv<HDP>(acc, ds[kk],
                        smem_desc(tK + kk * 16 * kRow, kTile * kRow, kAtom));
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        pin(ds);
      }
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sq = row + 8 * r;
      if (sq >= S) continue;
      __nv_bfloat16* out =
          dq + ((static_cast<int64_t>(b) * S + sq) * H + h) * hd;
#pragma unroll
      for (int c = 0; c < HDP / 8; ++c) {
        const int col = 8 * c + col0;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(acc[4 * c + 2 * r] * scale,
                                    acc[4 * c + 2 * r + 1] * scale);
      }
    }
  }
}

// The tensor maps of one backward call: q and dO in boxes of kTile rows
// (dK/dV) and of kBlk rows (dQ), k and v the other way round.
struct Maps {
  CUtensorMap q_tile, do_tile, k_blk, v_blk, q_blk, do_blk, k_tile, v_tile,
      lse, delta;
};

template <int HDP>
int launch(const Maps& m, const float* lse, const float* delta, void* dq,
           void* dk, void* dv, int B, int S, int Tk, int H, int K, int hd,
           int ld, int causal, int q_offset, int window, float scale,
           cudaStream_t stream) {
  constexpr int bytes = Layout<HDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  flash_bwd_dkdv_kernel<HDP>
      <<<dim3(B * K, (Tk + kBlk - 1) / kBlk), kThreads, bytes, stream>>>(
          m.q_tile, m.k_blk, m.v_blk, m.do_tile, m.lse, m.delta,
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          S, Tk, H, K, hd, scale, scale_log2, causal, q_offset, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<HDP>
      <<<dim3(B * H, (S + kBlk - 1) / kBlk), kThreads, bytes, stream>>>(
          m.q_blk, m.k_tile, m.v_tile, m.do_blk, lse, delta,
          static_cast<__nv_bfloat16*>(dq), S, Tk, H, H / K, hd, ld, scale,
          scale_log2, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tcb

// The CUDA-core route: the delta pre-pass, then the main kernel.
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, float* dq_acc,
           void* dk, void* dv, int B, int S, int Tk, int H, int K,
           const Strides& st, int causal, int q_offset, int window,
           float scale, cudaStream_t stream) {
  constexpr int bytes = bwd::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd::flash_bwd_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = pre::launch<T>(o, dout, delta, B, S, H, HD, S, stream);
  if (rc) return rc;
  constexpr int bk = bwd::block_k<HD>();
  const dim3 grid(B * K, (Tk + bk - 1) / bk);
  bwd::flash_bwd_kernel<T, HD><<<grid, bwd::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, H, K, st,
      scale, scale * kLog2e, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* o, const void* dout, const float* lse,
                float* delta, float* dq_acc, void* dk, void* dv, int B, int S,
                int Tk, int H, int K, const Strides& st, int causal,
                int q_offset, int window, float scale, cudaStream_t s) {
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

// The CUDA-core route.  q (B, S, H, hd), k and v (B, T, K, hd) with the
// given element strides of their batch, sequence and head axes (hd
// contiguous); o and dout (B, S, H, hd) contiguous, the forward's output
// and its gradient; all of one dtype (float32 when is_bf16 == 0, else
// bfloat16).  lse (B, H, S) float32, as the forward saved it.  Scratch:
// delta (B, H, S) float32; dq_acc (B, S, H, hd) float32, zeroed by the
// caller, gets dq.  dk and dv (B, T, K, hd) contiguous, the inputs' dtype,
// every entry written (the caller zeroes them itself when B, S or T is 0:
// nothing is launched then).  hd is 8, 16, 32, 64, 80, 96, 112, 128 or
// 256; H % K == 0; window > 0: a query at position p sees only keys t > p -
// window.  Two launches (delta, then the gradients); returns the first
// cudaGetLastError() that is not cudaSuccess (cudaErrorInvalidValue for an
// unsupported hd).
extern "C" int helios_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq_acc, void* dk,
    void* dv, int is_bf16, int B, int S, int T, int H, int K, int hd,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int causal,
    int q_offset, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || T <= 0) return 0;
  if (K <= 0 || H % K) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* dq = static_cast<float*>(dq_acc);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, l, dl, dq, dk, dv,
                                      B, S, T, H, K, st, causal, q_offset,
                                      window, scale, s);
  return dispatch_hd<float>(hd, q, k, v, o, dout, l, dl, dq, dk, dv, B, S, T,
                            H, K, st, causal, q_offset, window, scale, s);
}

// The tensor-core route: bf16 at hd 64, 80, 96, 112 or 128; q, k, v with
// the given element strides (hd contiguous; base pointers and strides
// 16-byte multiples, as TMA reads them); o, dout as above; lse and delta
// (scratch) (B, H, ld) float32, ld >= S a multiple of 4, 16-byte aligned,
// only the first S of each row read as values; dq (B, S, H, hd), dk and
// dv (B, T, K, hd) contiguous bf16, every entry written.  Three launches
// (delta, dK/dV, dQ), no atomics.  Returns as the CUDA-core route, or minus
// the CUresult when a tensor map cannot be built (-1000 when the driver
// has no cuTensorMapEncodeTiled).
extern "C" int helios_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int T, int H, int K, int hd, int ld,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int causal,
    int q_offset, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || T <= 0) return 0;
  if (K <= 0 || H % K || ld < S || ld % 4 ||
      (hd != 64 && hd != 80 && hd != 96 && hd != 112 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!encode_tiled()) return -1000;
  // dout is contiguous (B, S, H, hd)
  const int64_t d_sb = static_cast<int64_t>(S) * H * hd, d_ss =
      static_cast<int64_t>(H) * hd, d_sh = hd;
  const int64_t rows = static_cast<int64_t>(B) * H;
  constexpr int kTile = tcb::kTile, kBlk = tcb::kBlk;
  tcb::Maps m;
  CUresult r = make_map(&m.q_tile, q, B, S, H, hd, q_sb, q_ss, q_sh, kTile);
  if (r == CUDA_SUCCESS)
    r = make_map(&m.q_blk, q, B, S, H, hd, q_sb, q_ss, q_sh, kBlk);
  if (r == CUDA_SUCCESS)
    r = make_map(&m.do_tile, dout, B, S, H, hd, d_sb, d_ss, d_sh, kTile);
  if (r == CUDA_SUCCESS)
    r = make_map(&m.do_blk, dout, B, S, H, hd, d_sb, d_ss, d_sh, kBlk);
  if (r == CUDA_SUCCESS)
    r = make_map(&m.k_blk, k, B, T, K, hd, k_sb, k_ss, k_sh, kBlk);
  if (r == CUDA_SUCCESS)
    r = make_map(&m.k_tile, k, B, T, K, hd, k_sb, k_ss, k_sh, kTile);
  if (r == CUDA_SUCCESS)
    r = make_map(&m.v_blk, v, B, T, K, hd, v_sb, v_ss, v_sh, kBlk);
  if (r == CUDA_SUCCESS)
    r = make_map(&m.v_tile, v, B, T, K, hd, v_sb, v_ss, v_sh, kTile);
  if (r == CUDA_SUCCESS) r = make_rows_map(&m.lse, lse, rows, ld, kTile);
  if (r == CUDA_SUCCESS) r = make_rows_map(&m.delta, delta, rows, ld, kTile);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = pre::launch<__nv_bfloat16>(o, dout,
                                            static_cast<float*>(delta), B, S,
                                            H, hd, ld, s);
  if (rc) return rc;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (hd == 64)
    return tcb::launch<64>(m, l, dl, dq, dk, dv, B, S, T, H, K, hd, ld,
                           causal, q_offset, window, scale, s);
  return tcb::launch<128>(m, l, dl, dq, dk, dv, B, S, T, H, K, hd, ld,
                          causal, q_offset, window, scale, s);
}
