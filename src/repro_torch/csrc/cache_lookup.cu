// K1 — fused cache lookup: tier lookup through loc/slot, first-occurrence
// dedup, device-tier and host-tier row gather (zeros for misses), and
// stable compaction of first-occurrence storage and remote misses into
// -1-padded lists in batch order.
//
// Replaces the TPU kernel
// src/repro/kernels/cache_lookup/cache_lookup.py::fused_lookup
// (_fused_kernel).  Same seven outputs: out (B, D), first_idx (B,),
// miss_ids/miss_dest (B,), rem_ids/rem_dest (B,), counts (2,).
//
// What does not carry over: the TPU form walks the batch one id per grid
// step, in order, comparing each id with the whole batch (O(B^2) in all)
// and appending misses through an SMEM counter that only works because
// grid steps are sequential.  Here the work is three launches:
//   1. atomicMin of each batch position into an N-sized first-occurrence
//      table the wrapper filled with B (the oracle's scatter-min, O(B));
//   2. one warp per id: read loc/slot and the first occurrence, copy the
//      device-tier row (device memory) or the host-tier row (pinned host
//      memory, read in place through its UVA device pointer) or zeros into
//      out, and flag first-occurrence storage (1) and remote (2) misses;
//   3. one block walks the flags in tiles with a cub::BlockScan, carrying
//      the running offset between tiles, so both lists keep batch order and
//      match the oracle bit for bit (atomics would lose that order).
//
// Bound on the H100: bytes.  There is no arithmetic beyond indexing; the
// lookup must read the ids, their loc/slot entries and the device-tier
// rows it hits (device memory, 3.35 TB/s), read the host-tier rows it hits
// across PCIe (the slower link), and write B output rows.  Design for that
// bound: the row copy (launch 2) moves whole aligned 16-byte vectors per
// lane with a warp per row so enough rows are in flight to cover the PCIe
// latency of host rows; launches 1 and 3 touch only 4-byte ids and flags.
#include <cub/block/block_scan.cuh>

#include "helios_common.cuh"

namespace {

__global__ void first_occurrence_kernel(const int32_t* __restrict__ ids,
                                        int32_t B, int32_t n_table,
                                        int32_t* __restrict__ first_tab) {
  const int32_t stride = gridDim.x * blockDim.x;
  for (int32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < B;
       i += stride) {
    const int32_t id = ids[i];
    if (id >= 0 && id < n_table) atomicMin(first_tab + id, i);
  }
}

template <typename V>
__global__ void lookup_rows_kernel(const int32_t* __restrict__ ids,
                                   const int32_t* __restrict__ loc,
                                   const int32_t* __restrict__ slot,
                                   const V* __restrict__ dev,
                                   const V* __restrict__ host,
                                   const int32_t* __restrict__ first_tab,
                                   V* __restrict__ out,
                                   int32_t* __restrict__ first_idx,
                                   int32_t* __restrict__ flags, int32_t B,
                                   int32_t n_table, int64_t row_vecs) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = warp; i < B; i += n_warps) {
    const int32_t id = ids[i];
    // an id outside the tables is the caller's error: a zero row, no miss
    const bool ok = id >= 0 && id < n_table;
    const int32_t tier = ok ? loc[id] : -1;
    const int64_t s = ok ? slot[id] : 0;
    if (lane == 0) {
      const int32_t fi = ok ? first_tab[id] : static_cast<int32_t>(i);
      first_idx[i] = fi;
      flags[i] = fi != i ? 0 : tier == 2 ? 1 : tier == 3 ? 2 : 0;
    }
    V* dst = out + i * row_vecs;
    const V* src =
        tier == 0 ? dev + s * row_vecs : tier == 1 ? host + s * row_vecs
                                                   : nullptr;
    if (src == nullptr) {
      for (int64_t j = lane; j < row_vecs; j += 32) dst[j] = V{};
    } else {
#pragma unroll 4
      for (int64_t j = lane; j < row_vecs; j += 32) dst[j] = src[j];
    }
  }
}

constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads)
    compact_misses_kernel(const int32_t* __restrict__ ids,
                          const int32_t* __restrict__ flags, int32_t B,
                          int32_t* __restrict__ miss_ids,
                          int32_t* __restrict__ miss_dest,
                          int32_t* __restrict__ rem_ids,
                          int32_t* __restrict__ rem_dest,
                          int32_t* __restrict__ counts) {
  // Both counts ride one 64-bit scan: storage in the low 32 bits, remote in
  // the high 32; neither can exceed B < 2^31, so no carry crosses over.
  using Scan = cub::BlockScan<long long, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int32_t base = 0; base < B; base += kScanThreads) {
    const int32_t i = base + threadIdx.x;
    const int32_t f = i < B ? flags[i] : 0;
    const long long v = f == 1 ? 1LL : f == 2 ? (1LL << 32) : 0LL;
    long long excl, total;
    Scan(tmp).ExclusiveSum(v, excl, total);
    const long long off = carry + excl;
    if (f == 1) {
      const int32_t p = static_cast<int32_t>(off & 0xffffffffLL);
      miss_ids[p] = ids[i];
      miss_dest[p] = i;
    } else if (f == 2) {
      const int32_t p = static_cast<int32_t>(off >> 32);
      rem_ids[p] = ids[i];
      rem_dest[p] = i;
    }
    __syncthreads();  // every thread has read carry; tmp is free again
    if (threadIdx.x == 0) carry += total;
    __syncthreads();
  }
  const int32_t n_miss = static_cast<int32_t>(carry & 0xffffffffLL);
  const int32_t n_rem = static_cast<int32_t>(carry >> 32);
  for (int32_t i = n_miss + threadIdx.x; i < B; i += kScanThreads) {
    miss_ids[i] = -1;
    miss_dest[i] = -1;
  }
  for (int32_t i = n_rem + threadIdx.x; i < B; i += kScanThreads) {
    rem_ids[i] = -1;
    rem_dest[i] = -1;
  }
  if (threadIdx.x == 0) {
    counts[0] = n_miss;
    counts[1] = n_rem;
  }
}

}  // namespace

// The device pointer of a pinned (page-locked) host allocation.  Under UVA
// it equals the host pointer; asking keeps the kernel honest if it does not.
extern "C" int helios_host_device_ptr(void* host, void** dev_out) {
  return static_cast<int>(cudaHostGetDevicePointer(dev_out, host, 0));
}

// ids (B,) int32 in [0, N); loc/slot (N,) int32 with N = n_table; dev
// (n_dev, row_bytes) in device memory; host (n_host, row_bytes) given by its
// device pointer (pinned); first_tab (N,) int32 filled with B by the
// caller; out (B, row_bytes);
// first_idx, flags, miss_ids, miss_dest, rem_ids, rem_dest (B,) int32;
// counts (2,) int32.  Returns the first non-zero cudaGetLastError() of the
// three launches.
extern "C" int helios_fused_lookup(const void* ids, int32_t B, const void* loc,
                                   const void* slot, int32_t n_table,
                                   const void* dev,
                                   const void* host, int64_t row_bytes,
                                   void* first_tab, void* out, void* first_idx,
                                   void* flags, void* miss_ids,
                                   void* miss_dest, void* rem_ids,
                                   void* rem_dest, void* counts,
                                   void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* id32 = static_cast<const int32_t*>(ids);
  int32_t* ft = static_cast<int32_t*>(first_tab);
  int32_t* fl = static_cast<int32_t*>(flags);

  const int t1 = 256;
  int b1 = (B + t1 - 1) / t1;
  if (b1 > 132 * 16) b1 = 132 * 16;
  first_occurrence_kernel<<<b1, t1, 0, s>>>(id32, B, n_table, ft);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int t2 = 256;
  int64_t b2 = (static_cast<int64_t>(B) + t2 / 32 - 1) / (t2 / 32);
  if (b2 > 132 * 32) b2 = 132 * 32;
  const int w = helios_vec_bytes(row_bytes, dev, host, out);
  helios_dispatch_vec(w, [&](auto tag) {
    using V = decltype(tag);
    lookup_rows_kernel<V><<<b2, t2, 0, s>>>(
        id32, static_cast<const int32_t*>(loc),
        static_cast<const int32_t*>(slot), static_cast<const V*>(dev),
        static_cast<const V*>(host), ft, static_cast<V*>(out),
        static_cast<int32_t*>(first_idx), fl, B, n_table,
        row_bytes / static_cast<int64_t>(sizeof(V)));
  });
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  compact_misses_kernel<<<1, kScanThreads, 0, s>>>(
      id32, fl, B, static_cast<int32_t*>(miss_ids),
      static_cast<int32_t*>(miss_dest), static_cast<int32_t*>(rem_ids),
      static_cast<int32_t*>(rem_dest), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
