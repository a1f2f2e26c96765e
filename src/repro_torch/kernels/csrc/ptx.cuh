// Thin wrappers over the Hopper PTX the port's kernels use: 16-byte
// cp.async copies into shared memory (with zero fill) and their groups, and
// the int8 tensor-core product mma.sync m16n8k32 with int32 accumulation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_ptx {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without passing through
// registers (L2 only, .cg).  With full == false nothing is read and the 16
// shared bytes are zero-filled (src-size 0): the ragged M and K edges.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a · b on the int8 tensor cores: a is a 16x32 row-major fragment (four
// registers of four int8), b a 32x8 column-major fragment (two registers),
// d a 16x8 int32 fragment.  Thread (g = lane / 4, t = lane % 4) holds
//   a0: A[g][4t..4t+3]   a1: A[g+8][4t..4t+3]
//   a2: A[g][16+4t..]    a3: A[g+8][16+4t..]
//   b0: B[4t..4t+3][g]   b1: B[16+4t..16+4t+3][g]
//   d0, d1: D[g][2t, 2t+1]   d2, d3: D[g+8][2t, 2t+1]
// The int32 sums are exact (no .satfinite, and |sum| < 2^31 for K < 2^17).
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro_ptx
