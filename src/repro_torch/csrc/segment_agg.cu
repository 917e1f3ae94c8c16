// K3 — segment sum: out[s] = sum over edges e with seg[e] == s of msgs[e],
// in f32, with ids outside [0, n_segments) dropped.
//
// Replaces the TPU kernel
// src/repro/kernels/segment_agg/segment_agg.py::segment_sum_pallas
// (_segment_kernel), which turns each block of edges into a one-hot
// (block_e x n_segments) matrix and lets the MXU do the scatter, summing
// into one output block across sequential grid steps.
//
// Why that does not carry over: Hopper's blocks run in parallel with no
// order, and the sampler's segment ids are not sorted (second-hop dst_pos
// come in runs of `fanout` out of order, padded edges point at 0, and
// GCN's source degrees sum over fully unsorted src_pos), so the one-hot
// tile would be O(E * n_segments) work for O(E * D) of useful sums.
//
// Bound on the H100: bytes.  The sum does one add per message element; it
// must read E * D messages and write n_segments * D sums, so its floor is
// that traffic over 3.35 TB/s.  The output is zeroed by the caller and the
// kernel adds into it with reductions resolved in L2 (RED), so the order of
// the adds changes from run to run: the result matches a sequential sum to
// a tolerance, not bit for bit.  Design (run-accumulating reductions):
//
// * Rows routes (any D > 4).  A warp takes a contiguous chunk of edges and
//   one pass of columns; each lane owns column units of the pass.  While
//   consecutive edges carry the same id the warp sums their rows in
//   registers, and it flushes one reduction per run and unit, so the
//   sampler's runs of `fanout` equal ids cost one RED per run instead of
//   one per edge.  The ids of up to 32 edges come in one coalesced load and
//   are broadcast by shuffle; the rows of kUnroll edges (16 / Q: 16 units
//   per lane) are loaded before any is added, without waiting for the ids,
//   so a warp's first rows and its ids are in flight together.
//   - vec: rows of whole aligned 16-byte units (f32 x 4, bf16 x 8): one
//     16-byte load per unit and `red.global.add.v4.f32` (sm_90's vector
//     atomicAdd on float4) per 4 sums.
//   - scalar: any other width: one element per unit, scalar RED.
// * Edges route (D <= 4: counts, degrees).  Lanes span edges, not
//   columns: 32 consecutive edges per warp step, an inclusive segmented
//   scan over their runs of equal ids by shuffles, and one RED per run and
//   column from the run's last lane.
//
// A flush whose sums are all zero is skipped (exact: the output starts at
// +0), so the sampler's padded edges, which all point at segment 0 with
// zero messages, pile no reductions onto one row.  An id outside
// [0, n_segments) ends a run and is not added.
#include <cuda_bf16.h>

#include "helios_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A column unit: VEC consecutive elements of T moved by one load.
template <typename T, int VEC>
struct Unit {  // VEC == 1: one element
  using V = T;
  static __device__ __forceinline__ void add(const V& v, float* acc) {
    acc[0] += to_f32(v);
  }
};
template <>
struct Unit<float, 4> {
  using V = float4;
  static __device__ __forceinline__ void add(const V& v, float* acc) {
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
};
template <>
struct Unit<__nv_bfloat16, 8> {
  using V = uint4;
  static __device__ __forceinline__ void add(const V& v, float* acc) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a bf16 is the top half of an f32
      acc[2 * k] += __uint_as_float(w[k] << 16);
      acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

// Adds VEC sums into out[0..VEC): one vector RED per 4 (out 16-byte
// aligned), else scalar REDs.
template <int VEC>
__device__ __forceinline__ void red_add(float* out, const float* acc) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      atomicAdd(reinterpret_cast<float4*>(out + k),
                make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) atomicAdd(out + k, acc[k]);
  }
}

template <typename I>
__device__ __forceinline__ long long valid_id(const I* seg, int64_t e,
                                              int64_t n_segments) {
  const long long s = static_cast<long long>(seg[e]);
  return s >= 0 && s < n_segments ? s : -1;
}

// Rows routes: work item = (chunk of `chunk` edges, pass of 32 * Q units).
template <typename T, int VEC, int Q, typename I>
__global__ void __launch_bounds__(kThreads)
    segment_rows_kernel(const T* __restrict__ msgs, const I* __restrict__ seg,
                        float* __restrict__ out, int64_t E, int64_t D,
                        int64_t n_segments, int64_t chunk, int64_t passes) {
  using U = Unit<T, VEC>;
  using V = typename U::V;
  // rows a warp loads before it adds any: 16 column units per lane in
  // flight whatever the width, so 8 KB per warp on the vec route
  constexpr int kUnroll = 16 / Q;
  const int lane = threadIdx.x & 31;
  const int64_t units = D / VEC;
  const V* rows = reinterpret_cast<const V*>(msgs);
  const int64_t items = (E + chunk - 1) / chunk * passes;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t w = warp; w < items; w += n_warps) {
    const int64_t e0 = w / passes * chunk;
    const int64_t e1 = E - e0 < chunk ? E : e0 + chunk;
    const int64_t u0 = w % passes * (32 * Q) + lane;
    float acc[Q][VEC];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[q][k] = 0.f;
    long long cur = -1;
    // a lane whose sums are all zero adds nothing (exact: the output
    // starts at +0), so padded edges with zero messages cost no RED
    const auto flush = [&]() {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        bool any = false;
#pragma unroll
        for (int k = 0; k < VEC; ++k) any |= acc[q][k] != 0.f;
        const int64_t u = u0 + 32 * q;
        if (cur >= 0 && any && u < units)
          red_add<VEC>(out + cur * D + u * VEC, acc[q]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[q][k] = 0.f;
      }
    };
    for (int64_t b = e0; b < e1; b += 32) {
      const int nb = e1 - b < 32 ? static_cast<int>(e1 - b) : 32;
      const long long mine = lane < nb ? valid_id(seg, b + lane, n_segments)
                                       : -1;
      for (int k0 = 0; k0 < nb; k0 += kUnroll) {
        // the rows' loads do not wait for the ids: both are in flight
        V buf[kUnroll][Q];
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) {
          const V* src = rows + (b + k0 + r) * units;
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int64_t u = u0 + 32 * q;
            if (k0 + r < nb && u < units) buf[r][q] = src[u];
          }
        }
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) {
          const long long id = __shfl_sync(kFull, mine, (k0 + r) & 31);
          if (k0 + r >= nb) break;
          if (id != cur) {
            flush();
            cur = id;
          }
          if (cur >= 0) {
#pragma unroll
            for (int q = 0; q < Q; ++q)
              if (u0 + 32 * q < units) U::add(buf[r][q], acc[q]);
          }
        }
      }
    }
    flush();
  }
}

// Edges route (D <= 4): lane k of a warp step takes edge b + k.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    segment_edges_kernel(const T* __restrict__ msgs, const I* __restrict__ seg,
                         float* __restrict__ out, int64_t E, int D,
                         int64_t n_segments) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t b = warp * 32; b < E; b += n_warps * 32) {
    const int64_t e = b + lane;
    const long long id = e < E ? valid_id(seg, e, n_segments) : -1;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (id >= 0) {
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (d < D) v[d] = to_f32(msgs[e * D + d]);
    }
    // run heads, and each lane's run start: the last head at or below it
    const long long prev = __shfl_up_sync(kFull, id, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != id);
    const int start = 31 - __clz(heads & ((2u << lane) - 1u));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float t = __shfl_up_sync(kFull, v[d], off);
        if (lane - off >= start) v[d] += t;
      }
    }
    const long long next = __shfl_down_sync(kFull, id, 1);
    if (id >= 0 && (lane == 31 || next != id)) {
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (d < D && v[d] != 0.f) atomicAdd(out + id * D + d, v[d]);
    }
  }
}

int64_t grid_for(int64_t warps) {
  int64_t blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  return blocks < 1 ? 1 : blocks > 132 * 16 ? 132 * 16 : blocks;
}

template <typename T, int VEC, typename I>
void launch_rows(const void* msgs, const void* seg, float* out, int64_t E,
                 int64_t D, int64_t n_segments, int q, int64_t chunk,
                 cudaStream_t s) {
  const int64_t per_pass = 32 * static_cast<int64_t>(q);
  const int64_t passes = (D / VEC + per_pass - 1) / per_pass;
  const int64_t blocks = grid_for((E + chunk - 1) / chunk * passes);
  const T* m = static_cast<const T*>(msgs);
  const I* g = static_cast<const I*>(seg);
#define HELIOS_ROWS(QQ)                                                 \
  segment_rows_kernel<T, VEC, QQ, I><<<blocks, kThreads, 0, s>>>(       \
      m, g, out, E, D, n_segments, chunk, passes)
  // the vec route takes q up to 4, the scalar route up to 8
  if (q == 1) {
    HELIOS_ROWS(1);
  } else if (q == 2) {
    HELIOS_ROWS(2);
  } else if (q == 4 || VEC > 1) {
    HELIOS_ROWS(4);
  } else {
    HELIOS_ROWS(8);
  }
#undef HELIOS_ROWS
}

template <typename T, typename I>
void launch(const void* msgs, const void* seg, float* out, int64_t E,
            int64_t D, int64_t n_segments, int route, int q, int64_t chunk,
            cudaStream_t s) {
  if (route == 0) {
    segment_edges_kernel<T, I><<<grid_for((E + 31) / 32), kThreads, 0, s>>>(
        static_cast<const T*>(msgs), static_cast<const I*>(seg), out, E,
        static_cast<int>(D), n_segments);
  } else if (route == 1) {
    constexpr int kVec = 16 / sizeof(T);
    launch_rows<T, kVec, I>(msgs, seg, out, E, D, n_segments, q, chunk, s);
  } else {
    launch_rows<T, 1, I>(msgs, seg, out, E, D, n_segments, q, chunk, s);
  }
}

}  // namespace

// msgs (E, D) row-major, f32 (msgs_is_bf16 == 0) or bf16; seg (E,) int32 or
// int64; out (n_segments, D) f32, zeroed by the caller.  route: 0 edges
// (D <= 4), 1 vec (row bytes and msgs a multiple of 16 bytes), 2 scalar;
// q: column units per lane and pass (1, 2, 4 or 8) and chunk: edges per
// warp work item, both of the rows routes (the edges route takes 32 edges
// per warp step).  Returns cudaGetLastError() after
// the launch.
extern "C" int helios_segment_sum(const void* msgs, int msgs_is_bf16,
                                  const void* seg, int seg_is_64, void* out,
                                  int64_t E, int64_t D, int64_t n_segments,
                                  int route, int q, int64_t chunk,
                                  void* stream) {
  if (E <= 0 || D <= 0 || n_segments <= 0) return 0;
  if (route < 0 || route > 2 || (route == 0 && D > 4) ||
      (route > 0 && chunk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (msgs_is_bf16) {
    if (seg_is_64)
      launch<__nv_bfloat16, int64_t>(msgs, seg, o, E, D, n_segments, route, q,
                                     chunk, s);
    else
      launch<__nv_bfloat16, int32_t>(msgs, seg, o, E, D, n_segments, route, q,
                                     chunk, s);
  } else {
    if (seg_is_64)
      launch<float, int64_t>(msgs, seg, o, E, D, n_segments, route, q, chunk,
                             s);
    else
      launch<float, int32_t>(msgs, seg, o, E, D, n_segments, route, q, chunk,
                             s);
  }
  return static_cast<int>(cudaGetLastError());
}
