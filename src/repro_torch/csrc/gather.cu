// K2 — row gather: out[i] = table[idx[i]].
//
// Replaces the TPU kernel src/repro/kernels/gather/gather.py::gather_rows
// (_gather_kernel and _gather_kernel_blocked), where scalar-prefetched
// indices drive one row DMA HBM->VMEM per row, a few kept in flight per
// grid step.
//
// Bound on the H100: bytes.  The gather does no arithmetic; it reads B rows
// and writes B rows (2 * B * row_bytes, plus the index), so its floor is
// that traffic over the 3.35 TB/s of device memory.  Design for that bound:
// one warp per output row, grid-stride over rows so every SM keeps many
// rows in flight (the Hopper counterpart of the TPU's rows_per_step DMAs);
// each lane moves the widest aligned unit that divides the row width and
// the base pointers (16 bytes for f32 rows of 1024), so a warp issues
// 512-byte coalesced requests.  The copy moves bits, not values, so it is
// exact in every dtype.  An index outside [0, n_rows) yields a zero row
// instead of a wild read.
#include "helios_common.cuh"

namespace {

template <typename V, typename I>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const I* __restrict__ idx,
                                   V* __restrict__ out, int64_t B,
                                   int64_t n_rows, int64_t row_vecs) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = warp; i < B; i += n_warps) {
    const int64_t r = static_cast<int64_t>(idx[i]);
    V* dst = out + i * row_vecs;
    if (r < 0 || r >= n_rows) {
      for (int64_t j = lane; j < row_vecs; j += 32) dst[j] = V{};
      continue;
    }
    const V* src = table + r * row_vecs;
#pragma unroll 4
    for (int64_t j = lane; j < row_vecs; j += 32) dst[j] = src[j];
  }
}

}  // namespace

// table (n_rows, row_bytes) and out (B, row_bytes) row-major; idx (B,) of
// int32 (idx_is_64 == 0) or int64.  Returns cudaGetLastError() after the
// launch.
extern "C" int helios_gather_rows(const void* table, const void* idx,
                                  int idx_is_64, void* out, int64_t B,
                                  int64_t n_rows, int64_t row_bytes,
                                  void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  const int64_t warps_per_block = threads / 32;
  int64_t blocks = (B + warps_per_block - 1) / warps_per_block;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const int w = helios_vec_bytes(row_bytes, table, out, nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  helios_dispatch_vec(w, [&](auto tag) {
    using V = decltype(tag);
    const int64_t row_vecs = row_bytes / static_cast<int64_t>(sizeof(V));
    if (idx_is_64)
      gather_rows_kernel<V, int64_t><<<blocks, threads, 0, s>>>(
          static_cast<const V*>(table), static_cast<const int64_t*>(idx),
          static_cast<V*>(out), B, n_rows, row_vecs);
    else
      gather_rows_kernel<V, int32_t><<<blocks, threads, 0, s>>>(
          static_cast<const V*>(table), static_cast<const int32_t*>(idx),
          static_cast<V*>(out), B, n_rows, row_vecs);
  });
  return static_cast<int>(cudaGetLastError());
}
