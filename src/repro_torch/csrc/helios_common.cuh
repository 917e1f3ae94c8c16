// Shared by every kernel library of the port: the error-string entry point
// the Python wrappers call when a launch returns a non-zero cudaError_t, the
// vector-width dispatch the row-copy kernels use, and the mbarrier, TMA and
// tensor-map helpers of the kernels that stage data with the copy engine.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* helios_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Widest copy unit (16, 8, 4, 2 or 1 bytes) that divides the row width and
// every base pointer, so each row copy is whole aligned vectors and the copy
// stays bit-exact whatever the element type.
static inline int helios_vec_bytes(int64_t row_bytes, const void* a,
                                   const void* b, const void* c) {
  const uintptr_t mix = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) |
                        static_cast<uintptr_t>(row_bytes);
  for (int w = 16; w > 1; w >>= 1)
    if ((mix & (w - 1)) == 0) return w;
  return 1;
}

// Calls f(V{}) with V the unsigned type of ``w`` bytes (tag dispatch: the
// generic lambda at the call site names the copy unit decltype(tag)).
template <typename F>
static inline void helios_dispatch_vec(int w, F&& f) {
  switch (w) {
    case 16: f(uint4{}); break;
    case 8: f(uint2{}); break;
    case 4: f(0u); break;
    case 2: f(static_cast<unsigned short>(0)); break;
    default: f(static_cast<unsigned char>(0)); break;
  }
}

// ---------------------------------------------------------------------------
// Asynchronous copies completing on mbarriers (sm_90), shared by the kernels
// that stage tiles through shared memory with the copy engine (K4, K5).
// ---------------------------------------------------------------------------

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void mbar_init(uint32_t bar,
                                                 uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of the given parity to complete.  A wait that outlasts
// ~2^34 cycles (about 10 s) traps, so a lost load fails the launch instead
// of hanging the card.
static __device__ __forceinline__ void mbar_wait(uint32_t bar,
                                                 uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 34))
      __trap();
  }
}

// TMA: the box at coordinates (c0 innermost .. c3) of a 4-D tensor map into
// shared memory at dst, completing on mbarrier bar.
static __device__ __forceinline__ void tma_load(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int c0, int c1,
                                                int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; the libraries link only the
// runtime, so the runtime looks the driver's entry point up once.  nullptr
// when the driver has none.
static inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}
