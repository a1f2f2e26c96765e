// Thin wrappers over the Hopper PTX the port's kernels use: 16-byte
// cp.async copies into shared memory (with zero fill) and their groups, the
// int8 tensor-core product mma.sync m16n8k32 with int32 accumulation, L2
// prefetches, and the thread-block cluster's barrier, transaction barriers
// (mbarrier) and asynchronous stores into another block's shared memory
// (distributed shared memory, DSMEM).
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

// Ask for the 32-byte sector holding p to be brought into L2; nothing waits.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The cluster barrier in two halves: every thread of every block of the
// cluster arrives (release) and later waits (acquire) until all have
// arrived.  Every thread must call both (.aligned).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address of this block's shared variable p in the shared memory of
// block `rank` of the cluster (a .shared::cluster address).
__device__ __forceinline__ unsigned dsmem_addr(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// A shared-memory transaction barrier: one expected arrival, which also
// names how many bytes remote stores will bring (expect_tx); the phase
// completes when the arrival is in and the bytes have all landed.
__device__ __forceinline__ void mbar_init(void* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

// Makes this thread's mbarrier initialisations visible to the cluster.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival on this block's barrier, with release semantics: this
// thread's shared-memory stores before it are visible to the threads that
// see the phase complete.
__device__ __forceinline__ void mbar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the barrier's phase of the given parity has completed; the
// bytes that completed it are then visible to this thread.
__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Store 4 bytes into another block's shared memory (addr and bar are
// .shared::cluster addresses from dsmem_addr, of a block other than this
// one); the store completes 4 bytes of the transaction on that block's
// barrier.  Nothing waits here.
__device__ __forceinline__ void st_async_b32(unsigned addr, unsigned v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(v), "r"(bar)
               : "memory");
}

}  // namespace repro_ptx
