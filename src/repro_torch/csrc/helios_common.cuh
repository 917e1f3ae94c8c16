// Shared by every kernel library of the port: the error-string entry point
// the Python wrappers call when a launch returns a non-zero cudaError_t, and
// the vector-width dispatch the row-copy kernels use.
#pragma once

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
