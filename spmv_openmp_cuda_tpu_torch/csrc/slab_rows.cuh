// Streaming reads of a DIA slab, shared by csrc/dia_spmv.cu's dia_rows_kernel
// and csrc/df_spmv.cu's dia_df_kernel: R = 1 or 4 consecutive rows of one
// diagonal, read once through the read-only path without allocating in L1
// (ld.global.nc.L1::no_allocate, with a 256-byte L2 prefetch), so that L1
// keeps the lines of x that neighbouring diagonals read again. R = 4 is one
// 16-byte load of f32 (8 bytes of bf16): the caller keeps p 16-byte (8-byte)
// aligned.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace slab {

template <int R>
__device__ __forceinline__ void rows(const float* p, float (&v)[R]) {
  static_assert(R == 1 || R == 4, "one or four rows a thread");
  if constexpr (R == 4) {
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
        : "l"(p));
  } else {
    asm("ld.global.nc.L1::no_allocate.L2::256B.f32 %0, [%1];" : "=f"(v[0]) : "l"(p));
  }
}

// bf16 words widened to f32 exactly (the word as the high half of the f32
// bits), as __bfloat162float widens them
template <int R>
__device__ __forceinline__ void rows(const __nv_bfloat16* p, float (&v)[R]) {
  static_assert(R == 1 || R == 4, "one or four rows a thread");
  if constexpr (R == 4) {
    uint32_t a, b;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
        : "=r"(a), "=r"(b)
        : "l"(p));
    v[0] = __uint_as_float(a << 16);
    v[1] = __uint_as_float(a & 0xffff0000u);
    v[2] = __uint_as_float(b << 16);
    v[3] = __uint_as_float(b & 0xffff0000u);
  } else {
    unsigned short h;
    asm("ld.global.nc.L1::no_allocate.L2::256B.u16 %0, [%1];" : "=h"(h) : "l"(p));
    v[0] = __uint_as_float((uint32_t)h << 16);
  }
}

}  // namespace slab
