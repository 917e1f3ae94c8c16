// K5's backward: the gradient of the WKV6 scan (csrc/rwkv_scan.cu) with
// respect to r, k, v, logw, u and the initial state, per (batch, head), in
// float32 on the CUDA cores.  With S_{t-1} the state before token t,
// w_t = exp(logw_t) and G_t the cotangent of S_t (G_{T-1} = the final
// state's cotangent), for t = T-1 down to 0:
//
//   dr_t[i]    = sum_j (S_{t-1}[i][j] + u_i k_t[i] v_t[j]) dy_t[j]
//   dk_t[i]    = sum_j (G_t[i][j] + u_i r_t[i] dy_t[j]) v_t[j]
//   dv_t[j]    = sum_i (G_t[i][j] + u_i r_t[i] dy_t[j]) k_t[i]
//   dlogw_t[i] = w_t[i] sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]     += r_t[i] k_t[i] sum_j v_t[j] dy_t[j]   (over t and batch)
//   G_{t-1}    = diag(w_t) G_t + r_t dy_t^T
//
// and the initial state's gradient is G_{-1}.
//
// Replaces no TPU kernel: src/repro/kernels/rwkv_scan/rwkv_scan.py::
// wkv_pallas has no backward; the reference trains by differentiating
// models/rwkv6.py::wkv_chunked through XLA.  Every factor here is a decay
// product at most 1: S_{t-1} is recomputed forward from a checkpoint, never
// recovered from S_t by dividing by w_t (2e-9 at the clip, logw -20), and
// dlogw is the direct sum above, not a difference of two suffix sums, which
// cancels in float32 over long sequences at logw near 0.
//
// Bound on the H100: the float32 pipes, with the bytes close behind.  Each
// state element costs 14 FLOPs a token (the recompute and G's update, 3
// each; four products summed, 2 each); each token reads r, k, v, logw, dy
// and writes dr, dk, dv, dlogw, 36 bytes a channel.  The forward saves the
// state S0 at the start of every kC-token chunk.  Only two things are
// serial: G carried backwards across chunk boundaries, and the recurrence
// inside a chunk.  So the backward is four launches:
//
// * wkv6_bwd_decay_kernel writes w = exp(logw) once, over whole chunks (1
//   past T: no decay), for the two kernels below, whose paths then call no
//   expf.
// * wkv6_bwd_carry_kernel walks a head's chunks from last to first and
//   carries G across their boundaries only: G before a chunk =
//   diag(A) G_end + sum_tau diag(P_tau) r_tau dy_tau^T, with P_s the
//   product of w over the chunk's tokens before s and A over all of them:
//   a rank-kC update of the N x N cotangent a chunk, float32 on the CUDA
//   cores.  Columns of G evolve on their own: a CTA holds JA of them, a
//   thread a 2 x 4 tile, and r, w and dy land by TMA in a ring of kNS
//   chunks; the next chunk's P r and A are formed while this one updates.
//   It stores G at the end of every chunk (gend, the size of the
//   checkpoints) and G before chunk 0 (dstate0).
// * wkv6_bwd_chunk_kernel runs every chunk at once: one thread-block
//   cluster per (batch, head, kPer chunks), one CTA (rank) per JC value
//   columns and as many rows, each chunk from its own checkpoint S0 and
//   G_end.  Within a chunk, with Q_s the product of w over the tokens
//   after s and D(x, y) over those strictly between x and y (every factor
//   a product of decays, at most 1, never a quotient):
//
//     S_{s-1} = P_s S0 + sum_{x<s} D(x,s) k_x v_x^T
//     G_s     = Q_s G_end + sum_{t>s} D(s,t) r_t dy_t^T
//
//   so with X1_s = S0 dy_s, X2_s = G_end v_s, X3 = rowsum(G_end * S0),
//   VD[x][t] = v_x . dy_t and M[s][t] = sum_i D(s,t) r_t k_s (M[s][s] =
//   b_s = sum_i u_i r_s k_s), each row i:
//
//     dr_s    = P_s X1_s + sum_{x<s} D(x,s) k_x VD[x][s] + u k_s VD[s][s]
//     dk_s    = Q_s X2_s + sum_{t>s} D(s,t) r_t VD[s][t] + u r_s VD[s][s]
//     dlogw_s = A X3 + sum_{x<s} Q_x k_x X2_x + sum_{t>s} P_t r_t X1_t
//               + sum_{x<s<t} D(x,t) k_x r_t VD[x][t]
//     dv_s    = (K Q)_s^T G_end + sum_{t>=s} M[s][t] dy_t
//
//   (w_s dlogw's sum over j, folded into the decays).  Each rank forms,
//   over its JC columns, the partial products X1, X2 and VD (4 x 4
//   register tiles from column-major copies of S0's and G_end's columns)
//   and X3, over its JC rows the partial M, and its columns' (K Q)^T
//   G_end; the chunk's r, k, w (all rows) and v, dy (its columns) land by
//   TMA.  After a cluster barrier rank c adds its rows' X1, X2, X3, and all
//   of VD and M, over ranks 0, 1, ... in order through distributed shared
//   memory, then forms its rows' dr, dk and dlogw (thread (row, x) holds
//   token x's terms of every token, added over x by a transposing
//   butterfly of shuffles) and its columns' dv, and stores them straight
//   to device memory; du's partials, a cluster's chunks added in order, go
//   to a small scratch.  4 CTAs of 256 threads an SM at N 64: the phases
//   between barriers are short, and the other CTAs hide them.
// * wkv6_bwd_du_kernel adds du's partials in (batch, group) order.
//
// No atomics anywhere: two runs give the same bits.
#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "helios_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 16;    // tokens a chunk (the forward's checkpoints)
constexpr int kPS = kC + 4;   // a row's stride in the by-token arrays
constexpr int kNS = 4;    // the carry's ring of staged chunks
constexpr int kVS = kC + 1;   // VD's row stride (a warp reads a column)
constexpr int kPer = 4;       // chunks a chunk-kernel cluster walks

// N: head size; JC: value columns (and rows) a chunk-kernel CTA, 4 columns
// a thread; JA: columns a carry CTA, a 2 x 4 tile a thread.
template <int N, int JC>
struct Cfg {
  static constexpr int kQ = JC / 4;            // threads a state row
  static constexpr int kThreads = N * kQ;
  static constexpr int kCluster = N / JC;      // the chunk kernel's ranks
  static constexpr int kLanes = kThreads < 32 ? kThreads : 32;
  static constexpr unsigned kMask =
      kLanes == 32 ? 0xffffffffu : (1u << kLanes) - 1;
  static constexpr int kBox = kC * N;          // floats of one staged input
  // 4 CTAs an SM at N 64 (64 registers at 256 threads): the phases
  // between barriers are short, and more CTAs hide them; 128 registers
  // at the smaller head sizes
  static constexpr int kMinBlocks =
      kThreads >= 256 ? 4 : 512 / kThreads < 16 ? 512 / kThreads : 16;
  static_assert((kQ == 2 || kQ == 4) && N % JC == 0 && kThreads % JC == 0,
                "tile shape");
  // the chunk kernel's shared memory, in floats: the staged chunk (r, k, w
  // [kC][N]; this rank's columns of v, dy [kC][JC]), P and Q by
  // [token][row], the checkpoint's and G_end's columns [JC][kNT]
  // (column-major, rows padded; its rows' dr, dk, dlogw [3][kC][JC] on
  // their way out, once those are read, where they fit), this rank's
  // partials (X1, X2 [row][kPS], X3, VD, M, (K Q)^T G_end), then the sums
  // over the ranks for its rows (X1, X2 [JC][kPS], X3, VD [kC][kVS], M),
  // u, and its rows' du over the chunks it walks
  static constexpr int kVj = 3 * kBox, kDyj = kVj + kC * JC;
  static constexpr int kP = kDyj + kC * JC, kQd = kP + kBox;
  static constexpr int kNT = N + 4;
  static constexpr int kS0t = kQd + kBox, kGt = kS0t + JC * kNT;
  static constexpr bool kOutInTiles = 3 * kC * JC <= 2 * JC * kNT;
  static constexpr int kX1p = kGt + JC * kNT, kX2p = kX1p + N * kPS;
  static constexpr int kX3p = kX2p + N * kPS, kVDp = kX3p + N;
  static constexpr int kMp = kVDp + kC * kC, kDvq = kMp + kC * kC;
  static constexpr int kX1 = kDvq + kC * JC, kX2 = kX1 + JC * kPS;
  static constexpr int kX3 = kX2 + JC * kPS, kVD = kX3 + JC;
  static constexpr int kM = kVD + kC * kVS;
  static constexpr int kOut = kOutInTiles ? kS0t : kM + kC * kC;
  static constexpr int kU = kM + kC * kC + (kOutInTiles ? 0 : 3 * kC * JC);
  static constexpr int kDu = kU + N;                  // du over the group
  static constexpr int kBar = kDu + JC + (kDu + JC) % 2;   // an mbarrier
  static constexpr int kSmemChunk = (kBar + 2) * 4;
  // the carry: JA columns, a 2 x 4 tile a thread; kNS chunks of (r, w,
  // dy), then P_tau r_tau by [row][kPS] and A by row, for two chunks
  static constexpr int kJA = N >= 16 ? 16 : N;
  static constexpr int kCarryGroups = N / kJA;
  static constexpr int kCarryThreads = (N / 2) * (kJA / 4);
  static constexpr int kA = kNS * 3 * kBox, kDc = kA + 2 * N * kPS;
  static constexpr int kBarCarry = kDc + 2 * N;      // kNS mbarriers
  static constexpr int kSmemCarry = (kBarCarry + 2 * kNS) * 4;
};

// The (B, T, H, N) inputs as 4-D tensor maps (N, H, T, B); boxes of one
// head's kC tokens, all N channels (vj, dyj: JC of them).  Tokens past T
// read as zeros; w spans whole chunks (1 past T).
struct Maps {
  CUtensorMap r, k, w, dy, vj, dyj;
};

struct Args {
  const float *u, *ckpt;
  const float* ds;        // the final state's cotangent, or null (zeros)
  float* gend;            // (B, H, n_chunks, N, N): G after each chunk
  float *dr, *dk, *dv, *dw, *ds0;   // or null: not needed
  float* du_p;            // (B, n_groups, H, N), or null
  int B, T, H;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void to4(float4 a, float (&x)[4]) {
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The kernels' dynamic shared memory: declared shared, so every access
// through it stays a 32-bit shared-space load or store.  TMA writes need
// 128-byte alignment; the kernels have no static shared memory, so the
// window starts there (checked at launch: a misaligned base traps).
extern __shared__ __align__(128) float smem[];

__device__ __forceinline__ void check_aligned() {
  if (threadIdx.x == 0 && (smem_addr(smem) & 127)) __trap();
}

// x[0 .. V) over the W lanes whose lowest lane bits differ (W a power of 2):
// each lane ends with the sums of V / W of the indices, x[0 .. V / W) =
// indices bits * V / W + 0, 1, ... (bits = those lane bits, highest
// first), in V - V / W shuffles instead of V log2 W.  a + b == b + a, so
// both sides of every exchange hold the same bits.  One step a template
// level, so every index is a constant and x stays in registers.
template <int V, int W, int M = W / 2>
__device__ __forceinline__ void transpose_sum(float (&x)[V], int bits,
                                              unsigned mask) {
  if constexpr (M >= 1) {
    constexpr int kH = V * M / W;
    const bool up = (bits & M) != 0;
#pragma unroll
    for (int e = 0; e < kH; ++e) {
      const float send = up ? x[e] : x[e + kH];
      const float keep = up ? x[e + kH] : x[e];
      x[e] = keep + __shfl_xor_sync(mask, send, M);
    }
    transpose_sum<V, W, M / 2>(x, bits, mask);
  }
}

// grid kCarryGroups * B * H: CTA (bh, group) at bh * kCarryGroups + group;
// block kCarryThreads; dynamic shared memory kSmemCarry.
template <int N, int JC>
__global__ void __launch_bounds__(Cfg<N, JC>::kCarryThreads)
    wkv6_bwd_carry_kernel(const __grid_constant__ Maps m, const Args a) {
  using C = Cfg<N, JC>;
  constexpr int kT = C::kCarryThreads, kQA = C::kJA / 4;
  float* ring = smem;
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + C::kBarCarry);
  check_aligned();
  const int tid = threadIdx.x, rb = tid / kQA, q = tid % kQA;
  const int grp = blockIdx.x % C::kCarryGroups;
  const int bh = blockIdx.x / C::kCarryGroups;
  const int H = a.H, T = a.T, b = bh / H, h = bh % H;
  const int col = grp * C::kJA + 4 * q;      // the thread's first column
  const int n_chunks = (T + kC - 1) / kC;
  // rows 2 rb, 2 rb + 1, columns col ..
  const int64_t tile = (static_cast<int64_t>(bh) * N + 2 * rb) * N + col;

  // thread 0 stages the j-th chunk from the end into slot j % kNS
  const auto load = [&](int j) {
    if (tid != 0 || j >= n_chunks) return;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    float* slot = ring + (j % kNS) * 3 * C::kBox;
    const uint32_t bar = smem_addr(&landed[j % kNS]);
    const int t0 = (n_chunks - 1 - j) * kC;
    mbar_expect_tx(bar, 3 * C::kBox * 4);
    tma_load(smem_addr(slot), &m.r, bar, 0, h, t0, b);
    tma_load(smem_addr(slot + C::kBox), &m.w, bar, 0, h, t0, b);
    tma_load(smem_addr(slot + 2 * C::kBox), &m.dy, bar, 0, h, t0, b);
  };
  // once the j-th chunk from the end has landed: P_tau r_tau and A for
  // every row into buffer j % 2, a thread a row at a time
  const auto prep = [&](int j) {
    mbar_wait(smem_addr(&landed[j % kNS]), (j / kNS) & 1);
    const float* sr = ring + (j % kNS) * 3 * C::kBox;
    const float* sw = sr + C::kBox;
    float *sa = ring + C::kA + (j % 2) * N * kPS, *sdc = ring + C::kDc;
    for (int i = tid; i < N; i += kT) {
      float run = 1.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        sa[i * kPS + t] = sr[t * N + i] * run;
        run *= sw[t * N + i];
      }
      sdc[(j % 2) * N + i] = run;
    }
  };
  if (tid == 0) {
    for (int x = 0; x < kNS; ++x) mbar_init(smem_addr(&landed[x]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int j = 0; j < kNS; ++j) load(j);

  float g[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    g[e][0] = g[e][1] = g[e][2] = g[e][3] = 0.f;
    if (a.ds) to4(ld4(a.ds + tile + e * N), g[e]);
  }
  if (n_chunks > 0) prep(0);
  __syncthreads();
  for (int j = 0; j < n_chunks; ++j) {
    const int c = n_chunks - 1 - j;
    if (a.gend) {   // G after chunk c
      float* out = a.gend + (static_cast<int64_t>(bh) * n_chunks + c) * N * N +
                   (2 * rb) * N + col;
#pragma unroll
      for (int e = 0; e < 2; ++e) st4(out + e * N, g[e]);
    }
    if (j + 1 < n_chunks) prep(j + 1);   // the next chunk, meanwhile
    // G <- diag(A) G + sum_tau (P_tau r_tau) dy_tau^T
    const float* sdy = ring + (j % kNS) * 3 * C::kBox + 2 * C::kBox;
    const float* sa = ring + C::kA + (j % 2) * N * kPS;
    const float* sdc = ring + C::kDc + (j % 2) * N;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dc = sdc[2 * rb + e];
#pragma unroll
      for (int f = 0; f < 4; ++f) g[e][f] *= dc;
    }
#pragma unroll
    for (int t4 = 0; t4 < kC / 4; ++t4) {
      float av[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        to4(lds4(sa + (2 * rb + e) * kPS + 4 * t4), av[e]);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float d[4];
        to4(lds4(sdy + (4 * t4 + x) * N + col), d);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) g[e][f] = fmaf(av[e][x], d[f], g[e][f]);
      }
    }
    __syncthreads();   // the slot and this chunk's P r and A are free
    load(j + kNS);
  }
  if (a.ds0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) st4(a.ds0 + tile + e * N, g[e]);
  }
}

// grid kCluster * n_groups * B * H in clusters of kCluster, n_groups =
// ceil(n_chunks / kPer): cluster (bh, group p) at bh * n_groups + p walks
// chunks p kPer .. (at most kPer), rank = the CTA's JC columns and rows;
// block kThreads; dynamic shared memory kSmemChunk.
template <int N, int JC>
__global__ void __launch_bounds__(Cfg<N, JC>::kThreads,
                                  Cfg<N, JC>::kMinBlocks)
    wkv6_bwd_chunk_kernel(const __grid_constant__ Maps m, const Args a) {
  using C = Cfg<N, JC>;
  constexpr int kQ = C::kQ, kT = C::kThreads;
  float* sm = smem;
  uint64_t& landed = *reinterpret_cast<uint64_t*>(smem + C::kBar);
  check_aligned();
  float *sr = sm, *sk = sm + C::kBox, *sw = sm + 2 * C::kBox;
  float *sv = sm + C::kVj, *sdy = sm + C::kDyj;
  float *sP = sm + C::kP, *sQ = sm + C::kQd;
  float *sS0t = sm + C::kS0t, *sGt = sm + C::kGt, *su = sm + C::kU;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, i = tid / kQ, q = tid % kQ;
  const int H = a.H, T = a.T;
  const int n_chunks = (T + kC - 1) / kC;
  const int n_groups = (n_chunks + kPer - 1) / kPer;
  const int cl = blockIdx.x / C::kCluster;
  const int p = cl % n_groups, bh = cl / n_groups, b = bh / H, h = bh % H;
  const int c_lo = p * kPer, n_mine = min(kPer, n_chunks - c_lo);
  const int c0 = rank * JC, col = c0 + 4 * q;
  const int64_t tok = static_cast<int64_t>(H) * N;                 // a token
  const int64_t base = (static_cast<int64_t>(b) * T * H + h) * N;  // (b,0,h)

  // thread 0 stages chunk j of the group (the buffer is free)
  const auto load = [&](int j) {
    if (tid != 0 || j >= n_mine) return;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t bar = smem_addr(&landed);
    const int t0 = (c_lo + j) * kC;
    mbar_expect_tx(bar, (3 * C::kBox + 2 * kC * JC) * 4);
    tma_load(smem_addr(sr), &m.r, bar, 0, h, t0, b);
    tma_load(smem_addr(sk), &m.k, bar, 0, h, t0, b);
    tma_load(smem_addr(sw), &m.w, bar, 0, h, t0, b);
    tma_load(smem_addr(sv), &m.vj, bar, c0, h, t0, b);
    tma_load(smem_addr(sdy), &m.dyj, bar, c0, h, t0, b);
  };
  if (tid == 0) {
    mbar_init(smem_addr(&landed), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load(0);
  for (int x = tid; x < N; x += kT) su[x] = a.u[h * N + x];
  __syncthreads();   // the barrier is initialised, u in place
  // the thread's 4 columns of row i of a chunk's checkpoint and G_end
  const auto tile = [&](int j) {
    return ((static_cast<int64_t>(bh) * n_chunks + c_lo + j) * N + i) * N +
           col;
  };
  float* sdu = sm + C::kDu;        // row c0 + tid's du, over the group
  if (tid < JC) sdu[tid] = 0.f;
  for (int j = 0; j < n_mine; ++j) {
    const int c = c_lo + j, t0 = c * kC;
    float s0[4], ge[4];
    to4(ld4(a.ckpt + tile(j)), s0);
    to4(ld4(a.gend + tile(j)), ge);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sS0t[(4 * q + e) * C::kNT + i] = s0[e];
      sGt[(4 * q + e) * C::kNT + i] = ge[e];
    }
    mbar_wait(smem_addr(&landed), j & 1);
    __syncthreads();
    // P_s, Q_s and k_s Q_s, a thread a row at a time
    for (int r = tid; r < N; r += kT) {
      float run = 1.f;
#pragma unroll
      for (int s = 0; s < kC; ++s) {
        sP[s * N + r] = run;
        run *= sw[s * N + r];
      }
      run = 1.f;
#pragma unroll
      for (int s = kC - 1; s >= 0; --s) {
        sQ[s * N + r] = run;
        run *= sw[s * N + r];
      }
    }
    // the other ranks have read chunk j - 1's partials
    if (j > 0)
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

    // this rank's partials over its columns, a thread a 4 x 4 tile of
    // one of them: X1_s = S0 dy_s and X2_s = G_end v_s (4 rows x 4
    // tokens), and VD[x][t] = v_x . dy_t (4 x 4 tokens)
    for (int it = tid; it < 2 * N + 16; it += kT) {
      const bool vd = it >= 2 * N;
      const int two = it / N, rb = vd ? (it - 2 * N) / 4 : (it % N) / 4;
      const int sb = it % 4;
      float acc[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
      const float* vec = (two == 1 ? sv : sdy) + 4 * sb * JC;
#pragma unroll 2
      for (int cc = 0; cc < JC; ++cc) {
        float m4[4];
        if (vd) {
#pragma unroll
          for (int e = 0; e < 4; ++e) m4[e] = sv[(4 * rb + e) * JC + cc];
        } else {
          to4(lds4((two ? sGt : sS0t) + 4 * rb + cc * C::kNT), m4);
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float x = vec[f * JC + cc];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e][f] = fmaf(m4[e], x, acc[e][f]);
        }
      }
      if (vd) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st4(sm + C::kVDp + (4 * rb + e) * kC + 4 * sb, acc[e]);
      } else {
        float* out = sm + (two ? C::kX2p : C::kX1p) + 4 * rb * kPS + 4 * sb;
#pragma unroll
        for (int e = 0; e < 4; ++e) st4(out + e * kPS, acc[e]);
      }
    }
    // X3 = rowsum(G_end * S0): the thread's 4 columns, then the row's kQ
    // lanes
    {
      float x3 = ge[0] * s0[0];
#pragma unroll
      for (int e = 1; e < 4; ++e) x3 = fmaf(ge[e], s0[e], x3);
#pragma unroll
      for (int o = kQ / 2; o >= 1; o >>= 1)
        x3 += __shfl_xor_sync(C::kMask, x3, o);
      if (q == 0) sm[C::kX3p + i] = x3;
    }
    __syncthreads();                         // P and Q are in place
    // M[s][t] over this rank's rows: thread (s, row), lanes over the rows,
    // summed over them by the butterfly (lane ii keeps t = ii kC / JC ..)
    for (int o = tid; o < kC * JC; o += kT) {
      const int s = o / JC, ii = o % JC, r = c0 + ii;
      const float ks = sk[s * N + r];
      float y[kC], d = 1.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        if (t < s) {
          y[t] = 0.f;
        } else if (t == s) {
          y[t] = su[r] * sr[s * N + r] * ks;
        } else {
          y[t] = d * sr[t * N + r] * ks;
          d *= sw[t * N + r];
        }
      }
      transpose_sum<kC, JC>(y, ii, C::kMask);
#pragma unroll
      for (int l = 0; l < kC / JC; ++l)
        sm[C::kMp + s * kC + ii * (kC / JC) + l] = y[l];
    }
    // dv's first part, (K Q)_s^T G_end over all rows for this rank's
    // columns: rows in blocks of 16 (4 at a time), the blocks in order
    for (int o = tid; o < kC * JC; o += kT) {
      const int s = o / JC, jj = o % JC;
      float acc = 0.f;
#pragma unroll 1
      for (int r0 = 0; r0 < N; r0 += 16) {
        float blk = 0.f;
#pragma unroll
        for (int r = r0; r < r0 + 16 && r < N; r += 4) {
          float kk[4], qq[4], gg[4];
          to4(lds4(sk + s * N + r), kk);
          to4(lds4(sQ + s * N + r), qq);
          to4(lds4(sGt + jj * C::kNT + r), gg);
#pragma unroll
          for (int e = 0; e < 4; ++e) blk = fmaf(kk[e] * qq[e], gg[e], blk);
        }
        acc += blk;
      }
      sm[C::kDvq + o] = acc;
    }

    // the ranks' partials meet: rank c adds its rows' X1, X2, X3 and all
    // of VD and M over ranks 0, 1, ... in order
    cluster.sync();
    constexpr int kRowItems = 2 * JC * (kC / 4);        // X1, X2 float4s
    constexpr int kSqItems = 2 * kC * kC / 4;           // VD, M float4s
    for (int x = tid; x < kRowItems + kSqItems + JC; x += kT) {
      int from, to;
      bool vec = true;
      if (x < kRowItems) {
        const int arr = x / (JC * kC / 4), rem = x % (JC * kC / 4);
        const int ii = rem / (kC / 4), s4 = rem % (kC / 4);
        from = (arr ? C::kX2p : C::kX1p) + (c0 + ii) * kPS + 4 * s4;
        to = (arr ? C::kX2 : C::kX1) + ii * kPS + 4 * s4;
      } else if (x < kRowItems + kSqItems) {
        const int y = x - kRowItems, arr = y / (kC * kC / 4);
        const int e = 4 * (y % (kC * kC / 4));
        from = (arr ? C::kMp : C::kVDp) + e;
        to = arr ? C::kM + e : C::kVD + (e / kC) * kVS + e % kC;
        vec = arr != 0;
      } else {
        const int ii = x - kRowItems - kSqItems;
        from = C::kX3p + c0 + ii, to = C::kX3 + ii, vec = false;
      }
      const bool wide = vec || x < kRowItems + kSqItems;   // 4 floats in
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int rk = 0; rk < C::kCluster; ++rk) {
        const float* remote = cluster.map_shared_rank(sm + from, rk);
        float y[4];
        to4(wide ? lds4(remote) : make_float4(*remote, 0.f, 0.f, 0.f), y);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += y[e];
      }
      if (vec) {
        st4(sm + to, acc);
      } else if (wide) {   // VD's rows padded to kVS
#pragma unroll
        for (int e = 0; e < 4; ++e) sm[to + e] = acc[e];
      } else {
        sm[to] = acc[0];
      }
    }
    // this rank's reads of the others are done (waited for before the
    // next chunk's partials are written, and at the end)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();

    const float* X1 = sm + C::kX1;
    const float* X2 = sm + C::kX2;
    const float* VD = sm + C::kVD;
    float* out = sm + C::kOut;                 // [dr, dk, dlogw][s][ii]
    // dr, dk, dlogw of this rank's rows: thread (row, x), the 16 lanes of a
    // row over x, its terms of every token summed over them by the
    // butterfly (lane x keeps token x): with D = D(x, t) over t > x,
    //   dr_t    gets D k_x VD[x][t]          (t > x), P_x X1_x + u k_x VD[x][x]
    //   dlogw_s gets Q_x k_x X2_x + k_x sum_{t>s} D r_t VD[x][t]   (s > x),
    //           A X3 (s = x), P_x r_x X1_x (s < x)
    // and dk_x = Q_x X2_x + u r_x VD[x][x] + sum_{t>x} D r_t VD[x][t] alone.
    for (int it = tid; it < JC * kC; it += kT) {
      const int ii = it / kC, x = it % kC, r = c0 + ii;
      const float kx = sk[x * N + r], rx = sr[x * N + r], ur = su[r];
      const float px = sP[x * N + r], qx = sQ[x * N + r];
      const float x1 = X1[ii * kPS + x], x2 = X2[ii * kPS + x];
      const float vdxx = VD[x * kVS + x];
      float vr[kC], vw[kC], tt[kC], d = 1.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float vd = VD[x * kVS + t];
        if (t > x) {
          vr[t] = d * kx * vd;
          tt[t] = d * sr[t * N + r] * vd;
          d *= sw[t * N + r];
        } else {
          vr[t] = t == x ? fmaf(px, x1, ur * kx * vdxx) : 0.f;
          tt[t] = 0.f;
        }
      }
      transpose_sum<kC, kC>(vr, x, C::kMask);
      out[(0 * kC + x) * JC + ii] = vr[0];
      float dk = fmaf(qx, x2, ur * rx * vdxx);
#pragma unroll
      for (int t = 0; t < kC; ++t) dk += tt[t];
      const float a3 = sP[(kC - 1) * N + r] * sw[(kC - 1) * N + r] *
                       sm[C::kX3 + ii];
      float om = 0.f;                          // sum_{t>s} tt[t]
#pragma unroll
      for (int s = kC - 1; s >= 0; --s) {
        vw[s] = s > x ? fmaf(kx, om, qx * kx * x2)
                      : s == x ? a3 : px * rx * x1;
        om += tt[s];
      }
      transpose_sum<kC, kC>(vw, x, C::kMask);
      out[(1 * kC + x) * JC + ii] = dk;
      out[(2 * kC + x) * JC + ii] = vw[0];
    }
    __syncthreads();
    // ... stored a token's JC rows at a time
    for (int o = tid; o < 3 * kC * (JC / 4); o += kT) {
      const int part = o / (kC * (JC / 4)), rem = o % (kC * (JC / 4));
      const int s = rem / (JC / 4), j4 = rem % (JC / 4);
      float* g = part == 0 ? a.dr : part == 1 ? a.dk : a.dw;
      if (!g || t0 + s >= T) continue;
      float y[4];
      to4(lds4(out + (part * kC + s) * JC + 4 * j4), y);
      st4(g + base + (t0 + s) * tok + c0 + 4 * j4, y);
    }
    // dv of this rank's columns: + sum_{t>=s} M[s][t] dy_t
    if (a.dv) {
      for (int o = tid; o < kC * JC; o += kT) {
        const int s = o / JC, jj = o % JC;
        if (t0 + s >= T) continue;
        float acc = sm[C::kDvq + o];
        for (int t = s; t < kC; ++t)
          acc = fmaf(sm[C::kM + s * kC + t], sdy[t * JC + jj], acc);
        a.dv[base + (t0 + s) * tok + c0 + jj] = acc;
      }
    }
    // du's partial of this chunk for this rank's rows (tokens past T add
    // 0), added over the group's chunks in order
    if (a.du_p && tid < JC) {
      const int r = c0 + tid;
      float d = 0.f;
      for (int s = 0; s < kC; ++s)
        d = fmaf(sr[s * N + r] * sk[s * N + r], VD[s * kVS + s], d);
      sdu[tid] += d;
    }
    __syncthreads();   // the staged chunk and the tiles are free
    load(j + 1);
  }
  if (a.du_p && tid < JC)
    a.du_p[((static_cast<int64_t>(b) * n_groups + p) * H + h) * N + c0 +
           tid] = sdu[tid];
  // no rank leaves while another reads its partials
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// w = exp(logw) (B, T_pad, H, N), T_pad the tokens of whole chunks, 1
// past T (no decay): every decay the other kernels take, once.  hn4:
// float4s a token.
__global__ void wkv6_bwd_decay_kernel(float4* w, const float4* logw, int T,
                                      int T_pad, int hn4, int64_t n4) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < n4; e += step) {
    const int64_t tok = e / hn4;                 // b * T_pad + t
    const int t = static_cast<int>(tok % T_pad);
    const int64_t b = tok / T_pad;
    float4 y = make_float4(1.f, 1.f, 1.f, 1.f);
    if (t < T) {
      const float4 x = __ldg(logw + (b * T + t) * hn4 + e % hn4);
      y = make_float4(expf(x.x), expf(x.y), expf(x.z), expf(x.w));
    }
    w[e] = y;
  }
}

// du (H, N): the (B, n_groups, H, N) partials added in (batch, group) order.
__global__ void wkv6_bwd_du_kernel(float* du, const float* du_p, int n,
                                   int HN) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= HN) return;
  float acc = 0.f;
  for (int e = 0; e < n; ++e) acc += du_p[static_cast<int64_t>(e) * HN + x];
  du[x] = acc;
}

// A (B, T, H, N) float32 tensor as the 4-D map (N, H, T, B) with boxes of
// (width, 1, kC, 1).
CUresult make_map(CUtensorMap* map, const void* p, int B, int T, int H,
                  int N, int width) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(N) * 4;
  const cuuint64_t strides[3] = {row, row * H, row * H * T};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(width), 1, kC, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename K>
void allow_smem(K kernel, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
}

template <int N, int JC>
int launch_bwd(const Maps& maps, const Args& a, float* du, const float* logw,
               float* w, cudaStream_t stream) {
  using C = Cfg<N, JC>;
  const auto carry = wkv6_bwd_carry_kernel<N, JC>;
  const auto chunk = wkv6_bwd_chunk_kernel<N, JC>;
  static const bool configured = [&] {   // a refusal fails the launch
    allow_smem(carry, C::kSmemCarry);
    allow_smem(chunk, C::kSmemChunk);
    return true;
  }();
  (void)configured;
  const int n_chunks = (a.T + kC - 1) / kC;
  const int bh = a.B * a.H;
  const bool rows = a.dr || a.dk || a.dv || a.dw || a.du_p;
  if (n_chunks > 0 && (a.ds0 || rows)) {
    const int64_t n4 = static_cast<int64_t>(bh) * n_chunks * kC * N / 4;
    const int blocks = static_cast<int>(std::min<int64_t>((n4 + 255) / 256,
                                                          4096));
    wkv6_bwd_decay_kernel<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<float4*>(w), reinterpret_cast<const float4*>(logw),
        a.T, n_chunks * kC, a.H * N / 4, n4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.ds0 || (rows && n_chunks > 0)) {
    carry<<<C::kCarryGroups * bh, C::kCarryThreads, C::kSmemCarry,
            stream>>>(maps, a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rows && n_chunks > 0) {
    cudaLaunchConfig_t cfg = {};
    const int n_groups = (n_chunks + kPer - 1) / kPer;
    cfg.gridDim = dim3(static_cast<unsigned>(C::kCluster * n_groups * bh));
    cfg.blockDim = dim3(C::kThreads);
    cfg.dynamicSmemBytes = C::kSmemChunk;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C::kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, chunk, maps, a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (du) {
    const int hn = a.H * N;
    wkv6_bwd_du_kernel<<<(hn + 255) / 256, 256, 0, stream>>>(
        du, a.du_p, a.B * ((n_chunks + kPer - 1) / kPer), hn);
  }
  return static_cast<int>(cudaGetLastError());
}

// For each kernel of head size N: {threads, dynamic shared memory bytes,
// resident CTAs an SM}, carry then chunk, then the chunk kernel's cluster
// size and how many such clusters the card holds at once.
template <int N, int JC>
int occupancy(int* out) {
  using C = Cfg<N, JC>;
  const auto carry = wkv6_bwd_carry_kernel<N, JC>;
  const auto chunk = wkv6_bwd_chunk_kernel<N, JC>;
  allow_smem(carry, C::kSmemCarry);
  allow_smem(chunk, C::kSmemChunk);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], carry, C::kCarryThreads, C::kSmemCarry);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[5], chunk, C::kThreads, C::kSmemChunk);
  out[0] = C::kCarryThreads, out[3] = C::kThreads;
  out[1] = C::kSmemCarry, out[4] = C::kSmemChunk, out[6] = C::kCluster;
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C::kCluster * 1024);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmemChunk;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(&out[7], chunk, &cfg));
}

}  // namespace

// r, k, v, logw, dy, dr, dk, dv, dlogw (B, T, H, N); u, du (H, N); ckpt
// (B, H, ceil(T / 16), N, N), the forward's state before tokens 0, 16, ...;
// ds, ds0 (B, H, N, N); all float32, contiguous, 16-byte aligned.  ds null:
// a zero cotangent; dr, dk, dv, dlogw, du or ds0 null: not computed.  gend:
// (B, H, ceil(T / 16), N, N) scratch when any of dr, dk, dv, dlogw, du is
// computed; du_part: (B, n_groups, H, N) scratch when du is computed,
// n_groups = ceil(ceil(T / 16) / per_cta); w: (B, 16 ceil(T / 16), H, N)
// scratch for exp(logw).  cluster and per_cta must be the
// compiled cluster size of head size N (1, 1, 2, 4 for N = 8, 16, 32, 64)
// and chunks a cluster (kPer).  Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for another N, cluster or per_cta), or
// minus the CUresult when a tensor map cannot be built (-1000 when the
// driver has no cuTensorMapEncodeTiled).
extern "C" int helios_wkv6_bwd(const void* r, const void* k, const void* v,
                               const void* logw, const void* u,
                               const void* ckpt, const void* dy,
                               const void* ds, void* dr, void* dk, void* dv,
                               void* dlogw, void* du, void* ds0, void* gend,
                               void* du_part, void* w, int B, int T, int H,
                               int N,
                               int cluster, int per_cta, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (per_cta != kPer) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  Maps maps{};
  if (T > 0) {   // with no tokens the maps are never read
    if (!encode_tiled()) return -1000;
    // the tensor maps need the device's context current on this thread
    // (autograd calls the backward from a thread of its own)
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaSetDevice(dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int jc = N == 8 ? 8 : 16;   // the dispatch's JC below
    const void* srcs[6] = {r, k, w, dy, v, dy};
    CUtensorMap* dsts[6] = {&maps.r,  &maps.k,  &maps.w,
                            &maps.dy, &maps.vj, &maps.dyj};
    const int t_pad = (T + kC - 1) / kC * kC;   // w: whole chunks
    for (int x = 0; x < 6; ++x) {
      const CUresult rc = make_map(dsts[x], srcs[x], B, x == 2 ? t_pad : T,
                                   H, N, x < 4 ? N : jc);
      if (rc != CUDA_SUCCESS) return -static_cast<int>(rc);
    }
  }
  Args a{f(u), f(ckpt), f(ds), o(gend), o(dr), o(dk), o(dv), o(dlogw),
         o(ds0), du ? o(du_part) : nullptr, B, T, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N * 8 + cluster) {   //   N  JC: threads N * JC / 4
    case 8 * 8 + 1:
      return launch_bwd<8, 8>(maps, a, o(du), f(logw), o(w), s);
    case 16 * 8 + 1:
      return launch_bwd<16, 16>(maps, a, o(du), f(logw), o(w), s);
    case 32 * 8 + 2:
      return launch_bwd<32, 16>(maps, a, o(du), f(logw), o(w), s);
    case 64 * 8 + 4:
      return launch_bwd<64, 16>(maps, a, o(du), f(logw), o(w), s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[8]: the kernels' launch shapes and residency at head size N
// (``occupancy``).  Returns a cudaError_t (cudaErrorInvalidValue for
// another N).
extern "C" int helios_wkv6_bwd_occupancy(int N, int* out) {
  switch (N) {
    case 8: return occupancy<8, 8>(out);
    case 16: return occupancy<16, 16>(out);
    case 32: return occupancy<32, 16>(out);
    case 64: return occupancy<64, 16>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
