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
// and writes dr, dk, dv, dlogw, 36 bytes a channel.  The design:
//
// * The forward saves the state at the start of every kCkpt-token chunk
//   (its staging block).  One CTA per (batch, head, group of JC value
//   columns): column j of S and of G evolves on its own, so the groups
//   need no communication, and at B = 1 a head's four groups give 256 CTAs
//   instead of 64.  Thread (i, sub) holds row i's JT columns of the group.
// * Chunks from last to first.  The chunk's r, k, exp(logw) (all rows) and
//   v, dy (the group's columns) are staged in shared memory.  Sweep 1
//   recomputes S_{t-1} for the chunk from its checkpoint into a thread-
//   private shared-memory slot per token; sweep 2 walks the chunk backwards
//   with G in registers, forms the row sums (dr, dk, dlogw, du: in-thread
//   over JT columns, then across the TPR threads of a row by shuffles) and
//   overwrites each slot with G_t.  A third pass forms dv, a sum over the
//   rows, from those G_t slots, float4 columns a thread.
// * dr, dk and dlogw of each group are partial sums over its columns; a
//   second kernel adds the groups' partials in group order, and a third
//   adds du's per-(group, batch) partials in (batch, group) order.  No
//   atomics: two runs give the same bits.
#include <math.h>

#include <algorithm>

#include "helios_common.cuh"

namespace {

constexpr int kCkpt = 16;   // tokens between checkpoints (the forward's TB)

// N: head size; JC: value columns a CTA; TPR: threads a state row.
template <int N, int JC, int TPR>
struct BwdCfg {
  static constexpr int kJT = JC / TPR;         // columns a thread holds
  static constexpr int kQ = kJT / 4;           // float4s a thread holds
  static constexpr int kThreads = N * TPR;
  static constexpr int kGroups = N / JC;
  static_assert(kJT % 4 == 0 && N % JC == 0, "tile shape");
  // the state slots: float4 (token s, q, thread), kThreads + 2 apart per
  // (s, q), so dv's pass reads its float4s from distinct banks
  static constexpr int kStride = kThreads + 2;
  static constexpr int kSlots = kCkpt * kQ * kStride * 4;     // floats
  // then the staged chunk, in floats: r, k, w [kCkpt][N]; v, dy
  // [kCkpt][JC]; u [N]; b [kCkpt] (b_s = sum_i u_i r_s[i] k_s[i])
  static constexpr int kR = kSlots, kK = kR + kCkpt * N, kW = kK + kCkpt * N;
  static constexpr int kV = kW + kCkpt * N, kDy = kV + kCkpt * JC;
  static constexpr int kU = kDy + kCkpt * JC, kB = kU + N;
  static constexpr int kSmem = (kB + kCkpt) * 4;
  static constexpr unsigned kMask =
      kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1;
};

struct BwdArgs {
  const float *r, *k, *v, *logw, *u, *ckpt, *dy;
  const float* ds;          // the final state's cotangent, or null (zeros)
  float *dv, *ds0;          // or null: not needed
  // the groups' partials of dr, dk, dlogw, each (groups, B, T, H, N) (the
  // outputs themselves with one group), and du's (groups, B, H, N); null
  // where not needed
  float *dr_p, *dk_p, *dw_p, *du_p;
  int B, T, H;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}

// grid B * H * groups, CTA (bh, group) at bh * groups + group; block
// kThreads; dynamic shared memory kSmem.
template <int N, int JC, int TPR>
__global__ void __launch_bounds__(BwdCfg<N, JC, TPR>::kThreads)
    wkv6_bwd_kernel(const BwdArgs a) {
  using C = BwdCfg<N, JC, TPR>;
  constexpr int kJT = C::kJT, kQ = C::kQ, kStride = C::kStride;
  extern __shared__ __align__(16) float sm[];
  float4* slots = reinterpret_cast<float4*>(sm);
  float *sr = sm + C::kR, *sk = sm + C::kK, *sw = sm + C::kW;
  float *sv = sm + C::kV, *sdy = sm + C::kDy, *su = sm + C::kU;
  float* sb = sm + C::kB;
  const int tid = threadIdx.x;
  const int grp = blockIdx.x % C::kGroups, bh = blockIdx.x / C::kGroups;
  const int H = a.H, T = a.T, b = bh / H, h = bh % H;
  const int i = tid / TPR, sub = tid % TPR;
  const int c0 = grp * JC;                 // the CTA's first column
  const int col = c0 + sub * kJT;          // the thread's first column
  const int n_chunks = (T + kCkpt - 1) / kCkpt;
  const int64_t tok = static_cast<int64_t>(H) * N;                 // a token
  const int64_t base = (static_cast<int64_t>(b) * T * H + h) * N;  // (b,0,h)
  const int64_t part = static_cast<int64_t>(grp) * a.B * T * H * N;
  const int64_t row = (static_cast<int64_t>(bh) * N + i) * N + col;

  for (int x = tid; x < N; x += C::kThreads) su[x] = a.u[h * N + x];
  const float ui = a.u[h * N + i];
  float g[kJT];                            // G, row i, columns col..
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const float4 d = a.ds ? ld4(a.ds + row + 4 * q) : make_float4(0, 0, 0, 0);
    g[4 * q] = d.x, g[4 * q + 1] = d.y, g[4 * q + 2] = d.z, g[4 * q + 3] = d.w;
  }
  float du = 0.f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kCkpt, n = min(kCkpt, T - t0);
    __syncthreads();   // the previous chunk's readers are done
    for (int x = tid; x < n * (N / 4); x += C::kThreads) {
      const int s = x / (N / 4), q = x % (N / 4);
      const int64_t off = base + (t0 + s) * tok + 4 * q;
      const float4 lw = ld4(a.logw + off);
      st4(sr + s * N + 4 * q, ld4(a.r + off));
      st4(sk + s * N + 4 * q, ld4(a.k + off));
      st4(sw + s * N + 4 * q,
          make_float4(expf(lw.x), expf(lw.y), expf(lw.z), expf(lw.w)));
    }
    for (int x = tid; x < n * (JC / 4); x += C::kThreads) {
      const int s = x / (JC / 4), q = x % (JC / 4);
      const int64_t off = base + (t0 + s) * tok + c0 + 4 * q;
      st4(sv + s * JC + 4 * q, ld4(a.v + off));
      st4(sdy + s * JC + 4 * q, ld4(a.dy + off));
    }
    __syncthreads();
    if (a.dv) {   // b_s for dv's pass; rows rotated by s across the banks
      for (int s = tid; s < n; s += C::kThreads) {
        float acc = 0.f;
        for (int x = 0; x < N; ++x) {
          const int ii = (x + s) % N;
          acc = fmaf(su[ii] * sr[s * N + ii], sk[s * N + ii], acc);
        }
        sb[s] = acc;
      }
    }

    // sweep 1: S_{t-1} for every token of the chunk, from its checkpoint
    {
      float st[kJT];
      const float* ck = a.ckpt +
          ((static_cast<int64_t>(bh) * n_chunks + c) * N + i) * N + col;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 x = ld4(ck + 4 * q);
        st[4 * q] = x.x, st[4 * q + 1] = x.y, st[4 * q + 2] = x.z;
        st[4 * q + 3] = x.w;
      }
      for (int s = 0; s < n; ++s) {
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          slots[(s * kQ + q) * kStride + tid] = make_float4(
              st[4 * q], st[4 * q + 1], st[4 * q + 2], st[4 * q + 3]);
        const float w = sw[s * N + i], kk = sk[s * N + i];
        const float* vr = sv + s * JC + sub * kJT;
#pragma unroll
        for (int x = 0; x < kJT; ++x) st[x] = fmaf(w, st[x], kk * vr[x]);
      }
    }

    // sweep 2: backwards through the chunk with G_t
    for (int s = n - 1; s >= 0; --s) {
      float sp[kJT];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float4& slot = slots[(s * kQ + q) * kStride + tid];
        const float4 x = slot;
        sp[4 * q] = x.x, sp[4 * q + 1] = x.y, sp[4 * q + 2] = x.z;
        sp[4 * q + 3] = x.w;
        if (a.dv)
          slot = make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2],
                             g[4 * q + 3]);
      }
      const float rr = sr[s * N + i], kk = sk[s * N + i], w = sw[s * N + i];
      const float* vr = sv + s * JC + sub * kJT;
      const float* dyr = sdy + s * JC + sub * kJT;
      float vdy = 0.f, dr = 0.f, dk = 0.f, gs = 0.f;
#pragma unroll
      for (int x = 0; x < kJT; ++x) {
        vdy = fmaf(vr[x], dyr[x], vdy);
        dr = fmaf(sp[x], dyr[x], dr);
        dk = fmaf(g[x], vr[x], dk);
        gs = fmaf(g[x], sp[x], gs);
      }
      dr = fmaf(ui * kk, vdy, dr);
      dk = fmaf(ui * rr, vdy, dk);
      du = fmaf(rr * kk, vdy, du);
      float dw = w * gs;
#pragma unroll
      for (int m = 1; m < TPR; m <<= 1) {
        dr += __shfl_xor_sync(C::kMask, dr, m);
        dk += __shfl_xor_sync(C::kMask, dk, m);
        dw += __shfl_xor_sync(C::kMask, dw, m);
      }
      if (sub == 0) {
        const int64_t o = part + base + (t0 + s) * tok + i;
        if (a.dr_p) a.dr_p[o] = dr;
        if (a.dk_p) a.dk_p[o] = dk;
        if (a.dw_p) a.dw_p[o] = dw;
      }
#pragma unroll
      for (int x = 0; x < kJT; ++x) g[x] = fmaf(w, g[x], rr * dyr[x]);
    }

    // dv_t = G_t^T k_t + b_t dy_t, four columns a thread
    if (a.dv) {
      __syncthreads();
      for (int x = tid; x < n * (JC / 4); x += C::kThreads) {
        const int s = x / (JC / 4), jq = x % (JC / 4);
        const float4* gs = slots + (s * kQ + jq % kQ) * kStride + jq / kQ;
        const float* ks = sk + s * N;
        float4 acc = make_float4(0, 0, 0, 0);
        for (int ii = 0; ii < N; ++ii) {
          const float4 gg = gs[ii * TPR];
          const float kv = ks[ii];
          acc.x = fmaf(gg.x, kv, acc.x), acc.y = fmaf(gg.y, kv, acc.y);
          acc.z = fmaf(gg.z, kv, acc.z), acc.w = fmaf(gg.w, kv, acc.w);
        }
        const float bs = sb[s];
        const float* d = sdy + s * JC + 4 * jq;
        acc.x = fmaf(bs, d[0], acc.x), acc.y = fmaf(bs, d[1], acc.y);
        acc.z = fmaf(bs, d[2], acc.z), acc.w = fmaf(bs, d[3], acc.w);
        st4(a.dv + base + (t0 + s) * tok + c0 + 4 * jq, acc);
      }
    }
  }

  if (a.ds0) {
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      st4(a.ds0 + row + 4 * q, make_float4(g[4 * q], g[4 * q + 1],
                                           g[4 * q + 2], g[4 * q + 3]));
  }
  if (a.du_p) {
#pragma unroll
    for (int m = 1; m < TPR; m <<= 1) du += __shfl_xor_sync(C::kMask, du, m);
    if (sub == 0)
      a.du_p[(static_cast<int64_t>(grp) * a.B * H + bh) * N + i] = du;
  }
}

// dr, dk, dlogw: the groups' partials added in group order, float4 a
// thread (a null output is skipped).  m4: float4s of one group's partials.
__global__ void wkv6_bwd_sum_kernel(float* dr, float* dk, float* dw,
                                    const float* part, int64_t m4,
                                    int groups) {
  float* outs[3] = {dr, dk, dw};
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < m4; e += step) {
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      if (!outs[o]) continue;
      const float4* p = reinterpret_cast<const float4*>(part) +
                        static_cast<int64_t>(o) * groups * m4 + e;
      float4 acc = p[0];
      for (int gi = 1; gi < groups; ++gi) {
        const float4 x = p[gi * m4];
        acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
      }
      reinterpret_cast<float4*>(outs[o])[e] = acc;
    }
  }
}

// du (H, N): the (groups, B, H, N) partials added in (batch, group) order.
__global__ void wkv6_bwd_du_kernel(float* du, const float* du_p, int B,
                                   int HN, int groups) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= HN) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int gi = 0; gi < groups; ++gi)
      acc += du_p[(static_cast<int64_t>(gi) * B + b) * HN + x];
  du[x] = acc;
}

template <int N, int JC, int TPR>
int launch_bwd(BwdArgs a, float* dr, float* dk, float* dw, float* du,
               float* part, cudaStream_t stream) {
  using C = BwdCfg<N, JC, TPR>;
  const auto kernel = wkv6_bwd_kernel<N, JC, TPR>;
  static const bool configured = [&] {   // a refusal fails the launch
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         C::kSmem);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return true;
  }();
  (void)configured;
  const int64_t m = static_cast<int64_t>(a.B) * a.T * a.H * N;
  if (C::kGroups == 1) {   // one group: the partials are the sums
    a.dr_p = dr, a.dk_p = dk, a.dw_p = dw;
  } else {
    a.dr_p = dr ? part : nullptr;
    a.dk_p = dk ? part + C::kGroups * m : nullptr;
    a.dw_p = dw ? part + 2 * C::kGroups * m : nullptr;
  }
  kernel<<<a.B * a.H * C::kGroups, C::kThreads, C::kSmem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C::kGroups > 1 && m > 0 && (dr || dk || dw)) {
    const int64_t m4 = m / 4;
    const int blocks =
        static_cast<int>(std::min<int64_t>((m4 + 255) / 256, 4096));
    wkv6_bwd_sum_kernel<<<blocks, 256, 0, stream>>>(dr, dk, dw, part, m4,
                                                    C::kGroups);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (du) {
    const int hn = a.H * N;
    wkv6_bwd_du_kernel<<<(hn + 255) / 256, 256, 0, stream>>>(
        du, a.du_p, a.B, hn, C::kGroups);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, logw, dy, dr, dk, dv, dlogw (B, T, H, N); u, du (H, N); ckpt
// (B, H, ceil(T / 16), N, N), the forward's state before tokens 0, 16, ...;
// ds, ds0 (B, H, N, N); all float32, contiguous, 16-byte aligned.  ds null:
// a zero cotangent; dr, dk, dv, dlogw, du or ds0 null: not computed.  part:
// (3, groups, B, T, H, N) scratch when groups > 1 (else unused); du_part:
// (groups, B, H, N) scratch when du is computed.  groups must be the
// compiled column groups of head size N (1, 1, 2, 4 for N = 8, 16, 32, 64).
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// another N or groups).
extern "C" int helios_wkv6_bwd(const void* r, const void* k, const void* v,
                               const void* logw, const void* u,
                               const void* ckpt, const void* dy,
                               const void* ds, void* dr, void* dk, void* dv,
                               void* dlogw, void* du, void* ds0, void* part,
                               void* du_part, int B, int T, int H, int N,
                               int groups, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  BwdArgs a{f(r), f(k), f(v), f(logw), f(u), f(ckpt), f(dy), f(ds),
            o(dv), o(ds0), nullptr, nullptr, nullptr, o(du_part), B, T, H};
  if (!du) a.du_p = nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N * 8 + groups) {   //   N  JC TPR: threads N * TPR
    case 8 * 8 + 1:
      return launch_bwd<8, 8, 2>(a, o(dr), o(dk), o(dlogw), o(du), o(part),
                                 s);
    case 16 * 8 + 1:
      return launch_bwd<16, 16, 2>(a, o(dr), o(dk), o(dlogw), o(du),
                                   o(part), s);
    case 32 * 8 + 2:
      return launch_bwd<32, 16, 2>(a, o(dr), o(dk), o(dlogw), o(du),
                                   o(part), s);
    case 64 * 8 + 4:
      return launch_bwd<64, 16, 2>(a, o(dr), o(dk), o(dlogw), o(du),
                                   o(part), s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
