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
// grid steps are sequential.
//
// Bound on the H100: bytes.  There is no arithmetic beyond indexing; the
// lookup must read the ids, their loc/slot entries and the device-tier
// rows it hits (device memory, 3.35 TB/s), read the host-tier rows it hits
// across PCIe (the slower link, and at the serving and training shapes the
// larger term), and write B output rows.  Three launches, none of them
// O(N) and none a fill:
//
//   1. dedup: one thread per position inserts its id into an
//      open-addressing hash table (a power of two of at least 2B slots,
//      linear probing; atomicCAS claims a slot for an id, atomicMin keeps
//      the smallest position), records its slot, and appends host-tier
//      hits to a list (one warp-aggregated atomicAdd).  The table lives
//      across calls: each call tags its keys and positions with an epoch
//      that only decreases, so a slot of an older call reads as empty and
//      its position loses every atomicMin, and no call resets the table.
//   2. rows: the first CTAs copy the host-tier rows on that list, a warp
//      per row with every 16-byte load of the row issued before any store,
//      so PCIe has the most bytes in flight from the first microsecond.
//      Each other CTA owns a tile of kTile positions: it writes their
//      first occurrences and miss flags, reduces the tile's storage and
//      remote counts into one 64-bit word, and copies the tile's
//      device-tier rows (device memory) and zero rows, a warp per row.
//   3. compact: one CTA per tile sums the counts of the tiles before it
//      (its offsets) and of all tiles (the totals), scans its flags with
//      cub::BlockScan and scatters storage and remote misses to their
//      places in batch order, writes the -1 padding of its range of list
//      entries, and CTA 0 writes `counts` and clears the host-list count
//      for the next call.  So the lists match the oracle bit for bit.
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "helios_common.cuh"

namespace {

constexpr int kTile = 256;   // positions per CTA (rows and compact kernels)
constexpr int kWarps = kTile / 32;
constexpr int kVecsPerLane = 8;
constexpr unsigned kFull = 0xffffffffu;
using u64 = unsigned long long;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {  // murmur3 fmix32
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  return x ^ (x >> 16);
}

template <typename I>
__device__ __forceinline__ bool in_table(I id, int32_t n_table) {
  return id >= 0 && static_cast<long long>(id) < n_table;
}

// Copies one row of row_vecs units (zeros where src is null), every load
// of a pass of 32 * kVecsPerLane units issued before any store.
template <typename V>
__device__ __forceinline__ void copy_row(const V* __restrict__ src,
                                         V* __restrict__ dst,
                                         int64_t row_vecs, int lane) {
  for (int64_t j0 = 0; j0 < row_vecs; j0 += 32 * kVecsPerLane) {
    V a[kVecsPerLane];
#pragma unroll
    for (int q = 0; q < kVecsPerLane; ++q) {
      const int64_t j = j0 + lane + 32 * q;
      a[q] = src != nullptr && j < row_vecs ? src[j] : V{};
    }
#pragma unroll
    for (int q = 0; q < kVecsPerLane; ++q) {
      const int64_t j = j0 + lane + 32 * q;
      if (j < row_vecs) dst[j] = a[q];
    }
  }
}

template <typename I>
__global__ void __launch_bounds__(kTile)
    dedup_kernel(const I* __restrict__ ids, int32_t B, int32_t n_table,
                 const int32_t* __restrict__ loc, u64* keys, u64* vals,
                 uint32_t mask, uint32_t epoch, int32_t* __restrict__ slot_of,
                 int32_t* __restrict__ host_list, int32_t* host_count) {
  const int32_t i = blockIdx.x * kTile + threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool host = false;
  if (i < B) {
    const I id = ids[i];
    int32_t found = -1;
    if (in_table(id, n_table)) {
      const int32_t tier = loc[id];  // in flight while the slot is found
      const uint32_t uid = static_cast<uint32_t>(id);
      const u64 key = (static_cast<u64>(epoch) << 32) | uid;
      uint32_t s = mix32(uid) & mask;
      for (;;) {
        u64 k = *reinterpret_cast<volatile u64*>(keys + s);
        if ((k >> 32) != epoch) {  // empty for this call: claim it
          const u64 prev = atomicCAS(keys + s, k, key);
          if (prev == k) break;
          k = prev;
          if ((k >> 32) != epoch) continue;  // changed under us: look again
        }
        if (k == key) break;
        s = (s + 1) & mask;
      }
      atomicMin(vals + s, (static_cast<u64>(epoch) << 32) |
                              static_cast<uint32_t>(i));
      found = static_cast<int32_t>(s);
      host = tier == 1;
    }
    slot_of[i] = found;
  }
  const unsigned m = __ballot_sync(kFull, host);
  if (m) {
    const int leader = __ffs(m) - 1;
    int32_t base = 0;
    if (lane == leader) base = atomicAdd(host_count, __popc(m));
    base = __shfl_sync(kFull, base, leader);
    if (host) host_list[base + __popc(m & ((1u << lane) - 1u))] = i;
  }
}

template <typename V, typename I>
__global__ void __launch_bounds__(kTile)
    lookup_rows_kernel(const I* __restrict__ ids, int32_t B, int32_t n_table,
                       const int32_t* __restrict__ loc,
                       const int32_t* __restrict__ slot,
                       const V* __restrict__ dev, const V* __restrict__ host,
                       const u64* __restrict__ vals,
                       const int32_t* __restrict__ slot_of,
                       const int32_t* __restrict__ host_list,
                       const int32_t* __restrict__ host_count,
                       int32_t n_host_ctas, V* __restrict__ out,
                       int32_t* __restrict__ first_idx,
                       int32_t* __restrict__ flags, u64* __restrict__ tile_counts,
                       int64_t row_vecs) {
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  if (static_cast<int32_t>(blockIdx.x) < n_host_ctas) {
    const int32_t n_host = *host_count;
    for (int32_t h = blockIdx.x * kWarps + wib; h < n_host;
         h += n_host_ctas * kWarps) {
      const int32_t i = host_list[h];
      const int64_t s = slot[static_cast<int64_t>(ids[i])];
      copy_row(host + s * row_vecs, out + static_cast<int64_t>(i) * row_vecs,
               row_vecs, lane);
    }
    return;
  }
  const int32_t tile = blockIdx.x - n_host_ctas;
  const int32_t i = tile * kTile + threadIdx.x;
  u64 v = 0;
  if (i < B) {
    const I id = ids[i];
    const bool ok = in_table(id, n_table);
    const int32_t tier = ok ? loc[id] : -1;
    const int32_t fi =
        ok ? static_cast<int32_t>(vals[slot_of[i]] & 0xffffffffull) : i;
    first_idx[i] = fi;
    const int32_t f = fi != i ? 0 : tier == 2 ? 1 : tier == 3 ? 2 : 0;
    flags[i] = f;
    // storage counts in the low 32 bits, remote in the high: neither can
    // exceed B < 2^31, so no carry crosses over
    v = f == 1 ? 1ull : f == 2 ? (1ull << 32) : 0ull;
  }
  using Reduce = cub::BlockReduce<u64, kTile>;
  __shared__ typename Reduce::TempStorage red;
  const u64 total = Reduce(red).Sum(v);
  if (threadIdx.x == 0) tile_counts[tile] = total;
  for (int r = wib; r < kTile; r += kWarps) {
    const int32_t p = tile * kTile + r;
    if (p >= B) break;
    const I id = ids[p];
    const bool ok = in_table(id, n_table);
    const int32_t tier = ok ? loc[id] : -1;
    if (tier == 1) continue;  // a host CTA copies it
    const V* src =
        tier == 0 ? dev + static_cast<int64_t>(slot[id]) * row_vecs : nullptr;
    copy_row(src, out + static_cast<int64_t>(p) * row_vecs, row_vecs, lane);
  }
}

template <typename I>
__global__ void __launch_bounds__(kTile)
    compact_kernel(const I* __restrict__ ids, const int32_t* __restrict__ flags,
                   int32_t B, const u64* __restrict__ tile_counts,
                   int32_t n_tiles, int32_t* __restrict__ miss_ids,
                   int32_t* __restrict__ miss_dest,
                   int32_t* __restrict__ rem_ids,
                   int32_t* __restrict__ rem_dest,
                   int32_t* __restrict__ counts, int32_t* host_count) {
  using Reduce = cub::BlockReduce<u64, kTile>;
  using Scan = cub::BlockScan<u64, kTile>;
  __shared__ union {
    typename Reduce::TempStorage red;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ u64 before_s, total_s;
  const int32_t tile = blockIdx.x;
  u64 before = 0, all = 0;
  for (int32_t t = threadIdx.x; t < n_tiles; t += kTile) {
    const u64 c = tile_counts[t];
    all += c;
    if (t < tile) before += c;
  }
  const u64 b_sum = Reduce(tmp.red).Sum(before);
  __syncthreads();
  const u64 a_sum = Reduce(tmp.red).Sum(all);
  if (threadIdx.x == 0) {
    before_s = b_sum;
    total_s = a_sum;
  }
  __syncthreads();
  const int32_t i = tile * kTile + threadIdx.x;
  const int32_t f = i < B ? flags[i] : 0;
  const u64 v = f == 1 ? 1ull : f == 2 ? (1ull << 32) : 0ull;
  u64 excl;
  Scan(tmp.scan).ExclusiveSum(v, excl);
  const u64 off = before_s + excl;
  if (f == 1) {
    const int32_t p = static_cast<int32_t>(off & 0xffffffffull);
    miss_ids[p] = static_cast<int32_t>(ids[i]);
    miss_dest[p] = i;
  } else if (f == 2) {
    const int32_t p = static_cast<int32_t>(off >> 32);
    rem_ids[p] = static_cast<int32_t>(ids[i]);
    rem_dest[p] = i;
  }
  const int32_t n_miss = static_cast<int32_t>(total_s & 0xffffffffull);
  const int32_t n_rem = static_cast<int32_t>(total_s >> 32);
  if (i < B) {  // list entry i, past the count: padding
    if (i >= n_miss) {
      miss_ids[i] = -1;
      miss_dest[i] = -1;
    }
    if (i >= n_rem) {
      rem_ids[i] = -1;
      rem_dest[i] = -1;
    }
  }
  if (tile == 0 && threadIdx.x == 0) {
    counts[0] = n_miss;
    counts[1] = n_rem;
    *host_count = 0;
  }
}

template <typename I>
int run(const void* ids_v, int32_t B, const int32_t* loc, const int32_t* slot,
        int32_t n_table, const void* dev, const void* host, int64_t row_bytes,
        u64* keys, u64* vals, uint32_t mask, uint32_t epoch,
        int32_t* host_count, int32_t* slot_of, int32_t* host_list,
        u64* tile_counts, int32_t n_host_ctas, void* out, int32_t* first_idx,
        int32_t* flags, int32_t* miss_ids, int32_t* miss_dest,
        int32_t* rem_ids, int32_t* rem_dest, int32_t* counts,
        cudaStream_t s) {
  const I* ids = static_cast<const I*>(ids_v);
  const int32_t n_tiles = (B + kTile - 1) / kTile;
  dedup_kernel<I><<<n_tiles, kTile, 0, s>>>(ids, B, n_table, loc, keys, vals,
                                            mask, epoch, slot_of, host_list,
                                            host_count);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int w = helios_vec_bytes(row_bytes, dev, host, out);
  helios_dispatch_vec(w, [&](auto tag) {
    using V = decltype(tag);
    lookup_rows_kernel<V, I><<<n_host_ctas + n_tiles, kTile, 0, s>>>(
        ids, B, n_table, loc, slot, static_cast<const V*>(dev),
        static_cast<const V*>(host), vals, slot_of, host_list, host_count,
        n_host_ctas, static_cast<V*>(out), first_idx, flags, tile_counts,
        row_bytes / static_cast<int64_t>(sizeof(V)));
  });
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  compact_kernel<I><<<n_tiles, kTile, 0, s>>>(ids, flags, B, tile_counts,
                                              n_tiles, miss_ids, miss_dest,
                                              rem_ids, rem_dest, counts,
                                              host_count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The device pointer of a pinned (page-locked) host allocation.  Under UVA
// it equals the host pointer; asking keeps the kernel honest if it does not.
extern "C" int helios_host_device_ptr(void* host, void** dev_out) {
  return static_cast<int>(cudaHostGetDevicePointer(dev_out, host, 0));
}

// ids (B,) int32 (ids_is_64 == 0) or int64; loc/slot (N,) int32 with N =
// n_table; dev (n_dev, row_bytes) in device memory; host (n_host,
// row_bytes) given by its device pointer (pinned); keys/vals (mask + 1,)
// uint64, the hash table (mask + 1 >= 2B a power of two), every entry
// all-ones or written by an earlier call with a larger epoch; host_count
// one int32, 0 on entry and left 0; slot_of, host_list (B,) int32 and
// tile_counts (ceil(B / 256),) uint64 scratch; out (B, row_bytes);
// first_idx, flags, miss_ids, miss_dest, rem_ids, rem_dest (B,) int32;
// counts (2,) int32.  n_host_ctas >= 1 CTAs copy the host-tier rows.
// Returns the first non-zero cudaGetLastError() of the three launches.
extern "C" int helios_fused_lookup(
    const void* ids, int ids_is_64, int32_t B, const void* loc,
    const void* slot, int32_t n_table, const void* dev, const void* host,
    int64_t row_bytes, void* keys, void* vals, uint32_t mask, uint32_t epoch,
    void* host_count, void* slot_of, void* host_list, void* tile_counts,
    int32_t n_host_ctas, void* out, void* first_idx, void* flags,
    void* miss_ids, void* miss_dest, void* rem_ids, void* rem_dest,
    void* counts, void* stream) {
  if (B <= 0) return 0;
  const auto go = [&](auto tag) {
    using I = decltype(tag);
    return run<I>(ids, B, static_cast<const int32_t*>(loc),
                  static_cast<const int32_t*>(slot), n_table, dev, host,
                  row_bytes, static_cast<u64*>(keys), static_cast<u64*>(vals),
                  mask, epoch, static_cast<int32_t*>(host_count),
                  static_cast<int32_t*>(slot_of),
                  static_cast<int32_t*>(host_list),
                  static_cast<u64*>(tile_counts), n_host_ctas, out,
                  static_cast<int32_t*>(first_idx),
                  static_cast<int32_t*>(flags),
                  static_cast<int32_t*>(miss_ids),
                  static_cast<int32_t*>(miss_dest),
                  static_cast<int32_t*>(rem_ids),
                  static_cast<int32_t*>(rem_dest),
                  static_cast<int32_t*>(counts),
                  static_cast<cudaStream_t>(stream));
  };
  return ids_is_64 ? go(int64_t{}) : go(int32_t{});
}
