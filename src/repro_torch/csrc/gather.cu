// K2 — row gather: out[i] = table[idx[i]].
//
// Replaces the TPU kernel src/repro/kernels/gather/gather.py::gather_rows
// (_gather_kernel and _gather_kernel_blocked), where scalar-prefetched
// indices drive one row DMA HBM->VMEM per row, a few kept in flight per
// grid step.
//
// Bound on the H100: bytes.  The gather does no arithmetic; it reads B rows
// and writes B rows (2 * B * row_bytes, plus the index), so its floor is
// that traffic over the 3.35 TB/s of device memory.  Reaching it takes
// tens of KB in flight on every SM from the first microsecond: the served
// expansion (3,904 rows of 4 KB) is only about one memory latency's worth
// of rows per SM, and a warp with one row in flight spends three serial
// latencies on it (index, load, store).  This design:
//
// * One warp per pair of adjacent output rows, grid-stride.  Each lane
//   moves the widest aligned unit that divides the row width and the base
//   pointers (16 bytes for f32 rows of 1024) and issues all of its loads of
//   both rows, up to 2 x kVecsPerLane units, before it stores any, so a
//   warp keeps two whole 4 KB rows in flight.
// * A pair whose two indices are equal loads its row once and stores it
//   twice: the sampler pads each request's node list to a fixed length
//   with one repeated node, about half of the served expansion's rows.
// * The warp reads its next pair's indices before it copies this pair.
//
// A copy engine route (1-D TMA bulk copies through a shared-memory ring)
// was measured against this one on the card and gained nothing over it, so
// it is not kept (PERF.md).  The copy moves bits, not values, so it is
// exact in every dtype.  An index outside [0, n_rows) yields a zero row
// instead of a wild read.
#include "helios_common.cuh"

namespace {

constexpr int kVecsPerLane = 8;   // per row and pass: 4 KB at 16-byte units

template <typename V, typename I>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const I* __restrict__ idx,
                                   V* __restrict__ out, int64_t B,
                                   int64_t n_rows, int64_t row_vecs) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  // lanes 0 and 1 read the indices of the pair of rows starting at i0
  const auto pair_index = [&](int64_t i0) -> long long {
    return lane < 2 && i0 + lane < B ? static_cast<long long>(idx[i0 + lane])
                                     : -1;
  };
  long long mine = pair_index(2 * warp);
  for (int64_t i0 = 2 * warp; i0 < B; i0 += 2 * n_warps) {
    const long long next = pair_index(i0 + 2 * n_warps);
    const long long ra = __shfl_sync(0xffffffffu, mine, 0);
    const long long rb = __shfl_sync(0xffffffffu, mine, 1);
    const bool va = ra >= 0 && ra < n_rows, vb = rb >= 0 && rb < n_rows;
    const bool same = ra == rb;
    const bool has_b = i0 + 1 < B;
    const V* sa = table + (va ? ra : 0) * row_vecs;
    const V* sb = table + (vb ? rb : 0) * row_vecs;
    V* da = out + i0 * row_vecs;
    for (int64_t j0 = 0; j0 < row_vecs; j0 += 32 * kVecsPerLane) {
      V a[kVecsPerLane], b[kVecsPerLane];
#pragma unroll
      for (int q = 0; q < kVecsPerLane; ++q) {
        const int64_t j = j0 + lane + 32 * q;
        a[q] = va && j < row_vecs ? sa[j] : V{};
        b[q] = vb && !same && j < row_vecs ? sb[j] : V{};
      }
#pragma unroll
      for (int q = 0; q < kVecsPerLane; ++q) {
        const int64_t j = j0 + lane + 32 * q;
        if (same) b[q] = a[q];
        if (j < row_vecs) {
          da[j] = a[q];
          if (has_b) da[row_vecs + j] = b[q];
        }
      }
    }
    mine = next;
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
  const int threads = 128;
  const int64_t rows_per_block = 2 * (threads / 32);
  int64_t blocks = (B + rows_per_block - 1) / rows_per_block;
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
