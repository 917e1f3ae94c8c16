// K5 — WKV6 scan: RWKV-6's data-dependent-decay recurrence over a sequence,
// per (batch, head), with an N x N float32 state [key x value]:
//
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- exp(logw_t[i]) * S[i][j] + k_t[i] * v_t[j]
//
// from a given initial state, writing y and the final state.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_scan/rwkv_scan.py::
// wkv_pallas (_wkv_kernel), which runs a (BH, T/chunk) grid in order,
// carries the state in VMEM scratch across the sequential chunk axis, and
// factors each 16-token chunk into MXU products with exp(+-cumsum(logw)).
//
// What changes on Hopper, and why the chunk factorisation is not copied:
// exp(-cumsum(logw)) over a chunk overflows float32 once the model's decays
// reach their clip (logw down to -20: exp(16 * 20) is inf), where the
// sequential recurrence stays finite; and the TPU kernel starts from a zero
// state and needs T padded to a whole chunk, which would decay the state it
// returns.  This kernel is the exact recurrence, one token per step: one CTA
// per (batch, head) with N threads, thread j owning column j of the state
// in N registers.  Each step, thread j loads r, k, exp(logw) of channel j
// into shared memory (double-buffered, so one barrier per step) and v_j
// into a register, then does 2N fused multiply-adds; the next token's
// loads are issued before the barrier so their latency overlaps this
// step's arithmetic.  Any T, no padding; the state in and out is the
// model's decode cache.
//
// Bound on the H100: bytes.  Each token reads r, k, v, logw and writes y,
// 20 bytes per channel, against 4N FLOPs per channel; at N = 64 that is
// 12.8 FLOP per byte, far below the card's float32 ridge, so the floor is
// the 5 x B x T x H x N x 4 bytes over 3.35 TB/s.  The serial token loop is
// what this version leaves on the table (latency per step, 256 CTAs of 64
// threads at rwkv6-7b's batch 4); a chunked form with relative decays is
// the later redesign.
#include <math.h>

#include "helios_common.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(N)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ s_in,
                float* __restrict__ y, float* __restrict__ s_out, int T,
                int H) {
  __shared__ float sr[2][N], sk[2][N], sw[2][N], su[N];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const int64_t state_off = static_cast<int64_t>(bh) * N * N;

  float s[N];   // s[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = s_in[state_off + i * N + j];
  su[j] = u[h * N + j];

  const int64_t step = static_cast<int64_t>(H) * N;
  int64_t at = (static_cast<int64_t>(b) * T * H + h) * N + j;   // (b, 0, h, j)
  float nr = 0.f, nk = 0.f, nv = 0.f, nw = 0.f;
  if (T > 0) {
    nr = r[at];
    nk = k[at];
    nv = v[at];
    nw = logw[at];
  }
  for (int t = 0; t < T; ++t, at += step) {
    const int buf = t & 1;
    sr[buf][j] = nr;
    sk[buf][j] = nk;
    sw[buf][j] = expf(nw);
    const float vj = nv;
    if (t + 1 < T) {
      nr = r[at + step];
      nk = k[at + step];
      nv = v[at + step];
      nw = logw[at + step];
    }
    // after this barrier every thread has finished step t - 1, so the
    // other buffer (read there) is free for step t + 1's writes
    __syncthreads();
    float yj = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float a = sk[buf][i] * vj;
      yj = fmaf(sr[buf][i], fmaf(su[i], a, s[i]), yj);
      s[i] = fmaf(s[i], sw[buf][i], a);
    }
    y[at] = yj;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s_out[state_off + i * N + j] = s[i];
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s_in, float* y, float* s_out, int B,
           int T, int H, cudaStream_t stream) {
  wkv6_kernel<N><<<B * H, N, 0, stream>>>(r, k, v, w, u, s_in, y, s_out, T,
                                          H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, logw and y (B, T, H, N), u (H, N), s_in and s_out (B, H, N, N),
// all float32 and contiguous; N is 8, 16, 32 or 64.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another N).
extern "C" int helios_wkv6(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, const void* s_in,
                           void* y, void* s_out, int B, int T, int H, int N,
                           void* stream) {
  if (B <= 0 || H <= 0) return 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8:
      return launch<8>(f(r), f(k), f(v), f(logw), f(u), f(s_in), yo, so, B, T,
                       H, s);
    case 16:
      return launch<16>(f(r), f(k), f(v), f(logw), f(u), f(s_in), yo, so, B,
                        T, H, s);
    case 32:
      return launch<32>(f(r), f(k), f(v), f(logw), f(u), f(s_in), yo, so, B,
                        T, H, s);
    case 64:
      return launch<64>(f(r), f(k), f(v), f(logw), f(u), f(s_in), yo, so, B,
                        T, H, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
