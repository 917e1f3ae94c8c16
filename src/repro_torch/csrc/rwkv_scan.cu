// K5 — WKV6 scan: RWKV-6's data-dependent-decay recurrence over a sequence,
// per (batch, head), with an N x N float32 state [key x value]:
//
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- exp(logw_t[i]) * S[i][j] + k_t[i] * v_t[j]
//
// from a given initial state, writing y and the final state and, for the
// backward (csrc/rwkv_scan_bwd.cu), the state before every TB-th token.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_scan/rwkv_scan.py::
// wkv_pallas (_wkv_kernel), which runs a (BH, T/chunk) grid in order,
// carries the state in VMEM scratch across the sequential chunk axis, and
// factors each 16-token chunk into MXU products with exp(+-cumsum(logw)).
// That factorisation is not copied: exp(-cumsum(logw)) over a chunk
// overflows float32 once the model's decays reach their clip (logw down to
// -20), and TF32 tensor cores would not hold the result to 1e-4.  This
// kernel is the exact recurrence in float32 on the CUDA cores, any T, no
// padding; the state in and out is the model's decode cache.
//
// Bound on the H100: bytes, with the float32 pipes close behind.  Each
// token reads r, k, v, logw and writes y, 20 bytes per channel (344 MB per
// rwkv6-7b layer at batch 4 x 1024 tokens: 0.103 ms at 3.35 TB/s), and a
// state element takes a multiply and two FMAs per token (1.07 G element-
// steps per layer).  One CTA of N threads per (batch, head) with a barrier
// per token, as the first port did, left the card idle (0.7 us a token,
// 14% of the bound).  What this design does about it:
//
// * One CTA per (batch, head); each thread holds an IC x JT tile of the
//   state in registers: IC rows (as IC/4 float4 chunks, interleaved over
//   the TPC = N/IC threads of a column group so a warp's shared-memory
//   reads are distinct 16-byte words) of JT columns.  A column's partial y
//   is summed over its TPC neighbouring lanes with __shfl_xor_sync.
// * Tokens are staged TB at a time by TMA: thread 0 issues four tensor-map
//   boxes (r, k, logw, v of one head's TB tokens) into a ring of NS slots,
//   each completing on its own mbarrier (whose wait traps after a bounded
//   spin), so no thread spends instructions or load slots on staging.
// * G tokens per state update.  Two steps of the recurrence regroup
//   exactly: S_{t+1} = (w_t+1 w_t) S_t-1 + (w_t+1 k_t) v_t^T +
//   k_t+1 v_t+1^T, and y_t+1 reads S_t-1 through r_t+1 w_t plus
//   (r_t+1 . k_t) v_t.  Every factor is a product of decays <= 1, never a
//   quotient, so nothing overflows anywhere in the clip range.  A state
//   element then costs (1 + 2G) / G operations a token instead of 3.
// * The block's per-token vectors are prepared once for all columns, by
//   all warps, the block before it is used: exp(logw), the decay products
//   above, and the per-token scalars b_t = sum_i r_t u k_t (the bonus term
//   sum_i r_i u_i k_i v_j becomes b_t v_j) and r_t+g . (decayed k_t+s).
//   One barrier per block.
#include <math.h>

#include "helios_common.cuh"

namespace {

// N: head size; IC x JT: the state tile a thread holds; G: tokens per state
// update; TB: tokens per staged block; NS: blocks in the ring.
template <int N, int IC, int JT, int G, int TB, int NS>
struct Cfg {
  static_assert(IC % 4 == 0 && N % IC == 0 && N % JT == 0, "tile shape");
  static_assert(NS >= 3 && TB % G == 0, "ring shape");
  static_assert(TB == 16, "the backward reads a checkpoint every 16 tokens");
  static constexpr int kTPC = N / IC;             // threads per column group
  static constexpr int kCompute = kTPC * N / JT;  // threads holding state
  static constexpr int kThreads = (kCompute + 31) / 32 * 32;
  static constexpr int kChunks = IC / 4;          // float4 rows per thread
  static constexpr int kDots = G + G * (G - 1) / 2;   // b_g and c_gs a group
  // one ring slot, in floats: r, k, w, v [TB][N], then G + 1 coefficients
  // a token; each part 128-byte aligned as the TMA writes it
  static constexpr int kK = TB * N, kW = 2 * TB * N, kV = 3 * TB * N;
  static constexpr int kCoef = 4 * TB * N;
  static constexpr int kBuf = kCoef + (TB * (G + 1) + 31) / 32 * 32;
  static constexpr int kLoadBytes = 4 * N * TB * 4;          // per block
  static constexpr int kSmem = (NS * kBuf + N) * 4 + 128;    // ring, u, align
  static constexpr unsigned kMask =
      kCompute >= 32 ? 0xffffffffu : (1u << kCompute) - 1;
};

template <int JT>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[JT]) {
  if constexpr (JT == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  } else if constexpr (JT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  } else {
#pragma unroll
    for (int c = 0; c < JT; ++c) x[c] = p[c];
  }
}

template <int JT>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[JT]) {
  if constexpr (JT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (JT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int c = 0; c < JT; ++c) p[c] = x[c];
  }
}

// The four (B, T, H, N) inputs as 4-D tensor maps (N, H, T, B); boxes of
// one head's TB tokens.  Tokens past T read as zeros.
struct Maps {
  CUtensorMap r, k, w, v;
};

// Prepare group grp of a landed block in place.  With w = exp(logw):
// b_g = sum_i r_g u_i k_g and, for s < g, c_gs = sum_i r_g k_s
// prod_{s<x<g} w_x go to the coefficients; r_g <- r_g prod_{x<g} w_x,
// k_s <- k_s prod_{s<x<G} w_x, and the group's first w row <- prod_x w_x.
// Rows past T are zeros: exp(0) = 1 keeps the decay products, and zero k
// and v add nothing.  One warp; lane i owns channels i, i + 32, ...
template <int N, int G, int kDots>
__device__ __forceinline__ void prep_group(float* buf, const float* su,
                                           int t0, int lane, int kK, int kW,
                                           float* coef) {
  float dot[kDots];
#pragma unroll
  for (int d = 0; d < kDots; ++d) dot[d] = 0.f;
#pragma unroll
  for (int j = 0; j < (N + 31) / 32; ++j) {
    const int i = lane + 32 * j;
    if (i >= N) break;
    float rr[G], kk[G], ww[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      rr[g] = buf[(t0 + g) * N + i];
      kk[g] = buf[kK + (t0 + g) * N + i];
      ww[g] = expf(buf[kW + (t0 + g) * N + i]);
      dot[g] = fmaf(rr[g] * su[i], kk[g], dot[g]);
    }
#pragma unroll
    for (int s0 = 0; s0 < G; ++s0) {
      float z = kk[s0];
#pragma unroll
      for (int g = s0 + 1; g < G; ++g) {
        float& c = dot[G + g * (g - 1) / 2 + s0];
        c = fmaf(rr[g], z, c);
        z *= ww[g];
      }
    }
    float p = 1.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      buf[(t0 + g) * N + i] = rr[g] * p;
      p *= ww[g];
    }
    buf[kW + t0 * N + i] = p;
    float q = 1.f;
#pragma unroll
    for (int s0 = G - 1; s0 >= 0; --s0) {
      buf[kK + (t0 + s0) * N + i] = kk[s0] * q;
      q *= ww[s0];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int d = 0; d < kDots; ++d) dot[d] += __shfl_xor_sync(~0u, dot[d], o);
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      coef[g * (G + 1) + G] = dot[g];
#pragma unroll
      for (int s0 = 0; s0 < g; ++s0)
        coef[g * (G + 1) + s0] = dot[G + g * (g - 1) / 2 + s0];
    }
  }
}

// grid B * H, one CTA per (batch, head); block Cfg::kThreads; dynamic
// shared memory Cfg::kSmem.
template <int N, int IC, int JT, int G, int TB, int NS>
__global__ void __launch_bounds__(Cfg<N, IC, JT, G, TB, NS>::kThreads)
    wkv6_kernel(const __grid_constant__ Maps maps, const float* __restrict__ u,
                const float* __restrict__ s_in, float* __restrict__ y,
                float* __restrict__ s_out, float* __restrict__ ckpt, int T,
                int H) {
  using C = Cfg<N, IC, JT, G, TB, NS>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t landed[NS];   // a ring slot's block has landed
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t{127});
  float* su = smem + NS * C::kBuf;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t tok = static_cast<int64_t>(H) * N;       // one token's step
  const int64_t base = (static_cast<int64_t>(b) * T * H + h) * N;  // (b,0,h)
  const int n_blocks = (T + TB - 1) / TB;

  // thread 0 stages block n into its slot: four TMA boxes on one barrier
  const auto load = [&](int n) {
    if (tid != 0 || n >= n_blocks) return;
    // the slot was last written and read by threads (generic proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    float* buf = smem + (n % NS) * C::kBuf;
    const uint32_t bar = smem_addr(&landed[n % NS]);
    mbar_expect_tx(bar, C::kLoadBytes);
    tma_load(smem_addr(buf), &maps.r, bar, 0, h, n * TB, b);
    tma_load(smem_addr(buf + C::kK), &maps.k, bar, 0, h, n * TB, b);
    tma_load(smem_addr(buf + C::kW), &maps.w, bar, 0, h, n * TB, b);
    tma_load(smem_addr(buf + C::kV), &maps.v, bar, 0, h, n * TB, b);
  };
  // every warp prepares its share of block n's groups, once it has landed
  const auto prep = [&](int n) {
    mbar_wait(smem_addr(&landed[n % NS]), (n / NS) & 1);
    float* buf = smem + (n % NS) * C::kBuf;
    for (int grp = warp; grp < TB / G; grp += C::kThreads / 32)
      prep_group<N, G, C::kDots>(buf, su, grp * G, lane, C::kK, C::kW,
                                 buf + C::kCoef + grp * G * (G + 1));
  };

  for (int i = tid; i < N; i += C::kThreads) su[i] = u[h * N + i];
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(smem_addr(&landed[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int n = 0; n < NS - 1; ++n) load(n);

  const bool computes = tid < C::kCompute;   // false: a warp's spare lanes
  const int rg = tid % C::kTPC, cg = tid / C::kTPC;
  const int jt = cg * JT;                      // the thread's first column
  const int64_t state_off = static_cast<int64_t>(bh) * N * N;
  // s[4 q + e][c] = S[4 (q * TPC + rg) + e][jt + c]
  float s[IC][JT];
  if (computes) {
#pragma unroll
    for (int q = 0; q < C::kChunks; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        load_cols<JT>(
            s_in + state_off + (4 * (q * C::kTPC + rg) + e) * N + jt,
            s[4 * q + e]);
  }
  if (n_blocks > 0) prep(0);

  for (int n = 0; n < n_blocks; ++n) {
    // block n is prepared and every thread is done with block n - 1,
    // whose slot block n + NS - 1 now takes
    __syncthreads();
    load(n + NS - 1);
    if (n + 1 < n_blocks) prep(n + 1);
    if (!computes) continue;
    if (ckpt != nullptr) {   // the state before token n * TB
      float* at = ckpt + (static_cast<int64_t>(bh) * n_blocks + n) * N * N;
#pragma unroll
      for (int q = 0; q < C::kChunks; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store_cols<JT>(at + (4 * (q * C::kTPC + rg) + e) * N + jt,
                         s[4 * q + e]);
    }
    const float* buf = smem + (n % NS) * C::kBuf;
    const int t0 = n * TB, nb = min(TB, T - t0);
    // G tokens a step: y_g from the state before the group, then
    // S <- D S + sum_s k'_s v_s^T with the prepared rows
#pragma unroll 2
    for (int tg = 0; tg < nb; tg += G) {
      float vv[G][JT], yy[G][JT];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        load_cols<JT>(buf + C::kV + (tg + g) * N + jt, vv[g]);
#pragma unroll
        for (int c = 0; c < JT; ++c) yy[g][c] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < C::kChunks; ++q) {
        const int at = 4 * (q * C::kTPC + rg);
        const float4 d4 =
            *reinterpret_cast<const float4*>(buf + C::kW + tg * N + at);
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
        float rr[G][4], kk[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 r4 =
              *reinterpret_cast<const float4*>(buf + (tg + g) * N + at);
          const float4 k4 = *reinterpret_cast<const float4*>(
              buf + C::kK + (tg + g) * N + at);
          rr[g][0] = r4.x, rr[g][1] = r4.y, rr[g][2] = r4.z, rr[g][3] = r4.w;
          kk[g][0] = k4.x, kk[g][1] = k4.y, kk[g][2] = k4.z, kk[g][3] = k4.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < JT; ++c) {
            float st = s[4 * q + e][c];
#pragma unroll
            for (int g = 0; g < G; ++g) yy[g][c] = fmaf(rr[g][e], st, yy[g][c]);
            st *= dd[e];
#pragma unroll
            for (int g = 0; g < G; ++g) st = fmaf(kk[g][e], vv[g][c], st);
            s[4 * q + e][c] = st;
          }
      }
#pragma unroll
      for (int m = 1; m < C::kTPC; m <<= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int c = 0; c < JT; ++c)
            yy[g][c] += __shfl_xor_sync(C::kMask, yy[g][c], m);
      // y_g += b_g v_g + sum_{s<g} c_gs v_s
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* coef = buf + C::kCoef + (tg + g) * (G + 1);
#pragma unroll
        for (int c = 0; c < JT; ++c) {
          yy[g][c] = fmaf(coef[G], vv[g][c], yy[g][c]);
#pragma unroll
          for (int s0 = 0; s0 < g; ++s0)
            yy[g][c] = fmaf(coef[s0], vv[s0][c], yy[g][c]);
        }
        float* out = y + base + (t0 + tg + g) * tok + jt;
        if (rg == 0 && tg + g < nb) store_cols<JT>(out, yy[g]);
      }
    }
  }
  if (computes) {
#pragma unroll
    for (int q = 0; q < C::kChunks; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_cols<JT>(
            s_out + state_off + (4 * (q * C::kTPC + rg) + e) * N + jt,
            s[4 * q + e]);
  }
}

// A (B, T, H, N) float32 tensor as the 4-D map (N, H, T, B) with boxes of
// (N, 1, TB, 1).
CUresult make_map(CUtensorMap* map, const void* p, int B, int T, int H, int N,
                  int TB) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(N) * 4;
  const cuuint64_t strides[3] = {row, row * H, row * H * T};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(N), 1,
                             static_cast<cuuint32_t>(TB), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int N, int IC, int JT, int G, int TB, int NS>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s_in, float* y, float* s_out,
           float* ckpt, int B, int T, int H, cudaStream_t stream) {
  using C = Cfg<N, IC, JT, G, TB, NS>;
  Maps maps{};
  if (T > 0) {   // with no tokens the maps are never read
    if (!encode_tiled()) return -1000;
    CUresult rc = make_map(&maps.r, r, B, T, H, N, TB);
    if (rc == CUDA_SUCCESS) rc = make_map(&maps.k, k, B, T, H, N, TB);
    if (rc == CUDA_SUCCESS) rc = make_map(&maps.w, w, B, T, H, N, TB);
    if (rc == CUDA_SUCCESS) rc = make_map(&maps.v, v, B, T, H, N, TB);
    if (rc != CUDA_SUCCESS) return -static_cast<int>(rc);
  }
  const auto kernel = wkv6_kernel<N, IC, JT, G, TB, NS>;
  static const bool configured = [&] {   // a refusal fails the launch
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         C::kSmem);
    // the whole carveout as shared memory, so several rings share one SM
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return true;
  }();
  (void)configured;
  kernel<<<B * H, C::kThreads, C::kSmem, stream>>>(maps, u, s_in, y, s_out,
                                                   ckpt, T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, logw and y (B, T, H, N), u (H, N), s_in and s_out (B, H, N, N),
// all float32, contiguous and 16-byte aligned; N is 8, 16, 32 or 64.  ckpt:
// null, or (B, H, ceil(T / 16), N, N) for the state before tokens 0, 16,
// 32, ... (the staging block is 16 tokens at every N).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another N), or minus the CUresult when a tensor map cannot be built (-1000
// when the driver has no cuTensorMapEncodeTiled).
extern "C" int helios_wkv6(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, const void* s_in,
                           void* y, void* s_out, void* ckpt, int B, int T,
                           int H, int N, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  float* ck = static_cast<float*>(ckpt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {   //   N  IC JT  G  TB  NS: threads = (N / IC) * (N / JT)
    case 8:
      return launch<8, 4, 1, 1, 16, 4>(f(r), f(k), f(v), f(logw), f(u),
                                       f(s_in), yo, so, ck, B, T, H, s);
    case 16:
      return launch<16, 4, 2, 2, 16, 4>(f(r), f(k), f(v), f(logw), f(u),
                                        f(s_in), yo, so, ck, B, T, H, s);
    case 32:
      return launch<32, 8, 2, 4, 16, 4>(f(r), f(k), f(v), f(logw), f(u),
                                        f(s_in), yo, so, ck, B, T, H, s);
    case 64:
      return launch<64, 16, 4, 2, 16, 4>(f(r), f(k), f(v), f(logw), f(u),
                                         f(s_in), yo, so, ck, B, T, H, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
