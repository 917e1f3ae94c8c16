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
// that traffic over 3.35 TB/s.  Design for that bound: one warp per edge,
// grid-stride; the warp reads its edge's row once, lanes on neighbouring
// columns (coalesced), and adds it into the zeroed output with f32
// atomicAdd, which compiles to fire-and-forget RED operations resolved in
// L2.  The order of the adds changes from run to run, so the result
// matches a sequential sum to a tolerance, not bit for bit.
#include <cuda_bf16.h>

#include "helios_common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, typename I>
__global__ void segment_sum_kernel(const T* __restrict__ msgs,
                                   const I* __restrict__ seg,
                                   float* __restrict__ out, int64_t E,
                                   int64_t D, int64_t n_segments) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t e = warp; e < E; e += n_warps) {
    const int64_t s = static_cast<int64_t>(seg[e]);
    if (s < 0 || s >= n_segments) continue;
    const T* src = msgs + e * D;
    float* dst = out + s * D;
#pragma unroll 4
    for (int64_t d = lane; d < D; d += 32) atomicAdd(dst + d, to_f32(src[d]));
  }
}

template <typename T>
void launch(const void* msgs, const void* seg, int seg_is_64, float* out,
            int64_t E, int64_t D, int64_t n_segments, cudaStream_t s) {
  const int threads = 256;
  const int64_t warps_per_block = threads / 32;
  int64_t blocks = (E + warps_per_block - 1) / warps_per_block;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (seg_is_64)
    segment_sum_kernel<T, int64_t><<<blocks, threads, 0, s>>>(
        static_cast<const T*>(msgs), static_cast<const int64_t*>(seg), out, E,
        D, n_segments);
  else
    segment_sum_kernel<T, int32_t><<<blocks, threads, 0, s>>>(
        static_cast<const T*>(msgs), static_cast<const int32_t*>(seg), out, E,
        D, n_segments);
}

}  // namespace

// msgs (E, D) row-major, f32 (msgs_is_bf16 == 0) or bf16; seg (E,) int32 or
// int64; out (n_segments, D) f32, zeroed by the caller.  Returns
// cudaGetLastError() after the launch.
extern "C" int helios_segment_sum(const void* msgs, int msgs_is_bf16,
                                  const void* seg, int seg_is_64, void* out,
                                  int64_t E, int64_t D, int64_t n_segments,
                                  void* stream) {
  if (E <= 0 || D <= 0 || n_segments <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (msgs_is_bf16)
    launch<__nv_bfloat16>(msgs, seg, seg_is_64, o, E, D, n_segments, s);
  else
    launch<float>(msgs, seg, seg_is_64, o, E, D, n_segments, s);
  return static_cast<int>(cudaGetLastError());
}
