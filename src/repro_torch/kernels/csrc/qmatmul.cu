// Fused pre-quantized matmul for Hopper (sm_90a): int8 x · int8 (or packed
// int4) W → int32 → bias → f32 rescale (one or two Muls) → [ReLU] → round half
// to even → clip to int8 / uint8 [→ a 256-entry activation table].
//
// Replaces the TPU kernels repro/kernels/qmatmul.py::qmatmul (int8 weights)
// and ::qmatmul_packed (int4 nibble pairs), with their shared _epilogue, and
// on the main path repro/kernels/qact_lut.py::qact_lut (the table, below).
//
// What bounds it on an H100 (3.35 TB/s, 1,979 int8 TOP/s, 132 SMs):
//   * decode (M = a few rows), slice A's M = 64 layers, the FC head at M = 16
//     and most conv GEMMs: the weight bytes (or the im2col rows) — device
//     memory.  The kernel must keep enough bytes in flight on every SM, and
//     there must be enough blocks to put them there: a 2048- or 1000-wide
//     layer has only 16–32 column tiles of 64.
//   * prefill (M >= 512) and the 3136-row conv: int8 operations.
// What the design does about it:
//   * Exact split-K fills the card.  The grid is (M tiles, N tiles, splits);
//     split z owns whole 64-byte K stages [z·S/splits, (z+1)·S/splits) of the
//     S = Kp/64.  The planner (kernels/qmatmul.py::choose_splits) picks
//     splits so tiles × splits reaches about 2 × 132 blocks, and 1 where the
//     tiles already fill the card.  A split block writes its int32 partial
//     tile to a workspace slab, takes a per-tile ticket, and the last block to
//     arrive adds the other slabs to its registers, runs the epilogue once on
//     the full sum and zeroes the ticket for the next call.  int32 addition
//     is associative and commutative mod 2^32, so every split and every
//     arrival order gives the bits of the unsplit sum.  The wrapper owns the
//     workspace and the tickets (cached per device and stream).
//   * Loads stay in flight: a ring of STAGES shared-memory stages (6 on the
//     decode route, 4 on the tile route).  Stage s + STAGES - 1 is issued as
//     16-byte cp.async copies before stage s is computed, so the copies of
//     the next stages overlap the tensor-core work on this one.  The weight
//     (Np, Kp) is K-contiguous with Kp % 64 == 0, so its rows are always
//     whole 16-byte chunks.  x goes the same way when K % 16 == 0 and x is
//     16-byte aligned; an x that 16-byte copies cannot describe (the conv
//     stem's im2col rows have K = 147) is staged by the threads, byte by
//     byte, into the same layout: its global loads for stage s + STAGES - 1
//     are issued into registers before stage s is computed and stored to
//     shared memory after it, and the prologue issues the loads of all its
//     stages before it stores any (the stem's whole K is three stages, so
//     its x costs one round trip, not three).  The wrapper chooses the
//     staging from K and the pointer at launch (a template parameter, X16);
//     it is not a fallback.
//   * The int8 tensor cores: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//     (exact int32 accumulation).  mma.sync and not wgmma: the decode route
//     has 16 rows (wgmma's smallest M is 64), and every main-path shape but
//     prefill and the 3136-row conv is bound by bytes, where the product's
//     issue rate does not matter; one instruction for both routes keeps one
//     mainloop.  Inside each 32-deep product step the k order is permuted
//     alike for x and W (fragment position 4t+j ↔ k = 8t+j, 16+4t+j ↔
//     k = 8t+4+j), which a sum does not see: thread (g, t) then reads eight
//     consecutive bytes of a row for its A (rows g, g+8) and B fragments, one
//     64-bit shared load each.  The 16-byte chunks of each row are permuted
//     by a row bit (an XOR swizzle) so those loads hit 32 distinct banks.
//   * Two routes by M, both BN = 64 columns on 4 warps: decode (BM = 16, one
//     16-row fragment, rows past M zero; each warp 16 columns) and tile
//     (BM = 64; each warp a 32 x 32 block, 8 products per 32-deep step).
//   * Packed int4 rides the same mainloop: the (Np, Kp/2) nibble-pair tile
//     lands in shared memory at half the bytes; a thread's 32-bit load holds
//     its 8 consecutive k, sign-extended with __vsub4 and interleaved with
//     __byte_perm (k = 2r low nibble, 2r + 1 high) straight into its B
//     fragment.
//   * The epilogue runs in registers on the full int32 sum: the
//     Cast/Mul/Mul/QuantizeLinear chain never round-trips to device memory.
//   * An activation table rides in the epilogue.  Where the plan folds a
//     LUT step (repro/kernels/qact_lut.py::qact_lut, the paper's Tanh and
//     Sigmoid flows) into the matmul that feeds it, the launch takes the
//     256-byte table too: each thread loads two of its bytes before the
//     prologue (the loads overlap the first stages' copies), stores them to
//     shared memory after it, and the mainloop's first barrier publishes
//     them.  The epilogue computes the int8 code q exactly as without a
//     table, then stores tab[q + 128], int8 or uint8 as the table is.  The
//     table costs no device bytes beyond its own 256 and one shared-memory
//     byte load per output; what it removes is a whole launch, about 5 us of
//     launch floor at the served MLP's shapes, and a write and a read of
//     the activation through device memory.  A uint8 table whose codes feed
//     only int8 matmuls comes shifted by the plan (u - 128, stored as
//     int8), which removes the shift launch too.  The branch is taken at run
//     time on the table pointer, which is uniform across the grid.
//
// Exactness: the int32 sum is order-independent; the epilogue wraps the bias
// add in unsigned arithmetic and uses the IEEE round-to-nearest intrinsics
// (__int2float_rn, __fmul_rn), fmaxf and rintf, so no mul+add can contract
// into an FMA, in the codified op order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using repro_ptx::cp_async16;
using repro_ptx::cp_async_commit;
using repro_ptx::cp_async_wait;
using repro_ptx::mma_s8_16832;

constexpr int BN = 64;        // output columns per block (Np % 64 == 0)
constexpr int BK = 64;        // K bytes per pipeline stage (Kp % 64 == 0)
constexpr int THREADS = 128;  // four warps

// Byte offset of byte c of row r in a tile of 64-byte rows.  The four
// 16-byte chunks of a row are permuted by bit 1 of r, so the 8-byte
// fragment loads of rows g = 0..3 (one half-warp) fall on distinct banks.
__device__ __forceinline__ int off64(int r, int c) {
  return r * 64 + (((c >> 4) ^ (r & 2)) << 4) + (c & 15);
}

// The same for 32-byte rows (a packed weight stage): chunks permuted by bit
// 2 of r, so the 4-byte loads of rows 0..7 (one warp) fall on distinct banks.
__device__ __forceinline__ int off32(int r, int c) {
  return r * 32 + (((c >> 4) ^ ((r >> 2) & 1)) << 4) + (c & 15);
}

// Sign-extend the four 4-bit values held in the low nibbles of each byte.
__device__ __forceinline__ unsigned sext_nibbles(unsigned v) {
  return __vsub4(v ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ uint8_t requant(int acc, int b, float s, float sh, int relu,
                                           int two_mul, float lo, float hi) {
  // int32 + int32 wraps, as the reference's int32 add does
  const int a32 = (int)((unsigned)acc + (unsigned)b);
  float f = __fmul_rn(__int2float_rn(a32), s);
  if (two_mul) f = __fmul_rn(f, sh);
  if (relu) f = fmaxf(f, 0.0f);
  f = fminf(fmaxf(rintf(f), lo), hi);
  return (uint8_t)(int)f;
}

template <int BM, int STAGES, bool PACKED, bool X16>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
               const int* __restrict__ bias, const float* __restrict__ qs,
               const float* __restrict__ qsh, const uint8_t* __restrict__ lut,
               uint8_t* __restrict__ out,
               int* __restrict__ ws, int* __restrict__ tickets, int M, int K, int N,
               int Kp, int relu, int two_mul, int out_uint8) {
  constexpr int WROW = PACKED ? BK / 2 : BK;  // weight bytes per row per stage
  constexpr int MI = BM == 16 ? 1 : 2;        // 16-row fragments per warp
  constexpr int NI = BM == 16 ? 2 : 4;        // 8-column fragments per warp
  constexpr int NACC = MI * NI * 4;           // int32 accumulators per thread
  constexpr int XWORDS = BM * BK / 4 / THREADS;  // byte-staged x words per thread
  __shared__ __align__(128) uint8_t xs[STAGES][BM * BK];
  __shared__ __align__(128) uint8_t wsm[STAGES][BN * WROW];
  __shared__ uint8_t tab[256];  // the activation table, when there is one
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wrow = BM == 16 ? 0 : (warp >> 1) * 32;
  const int wcol = BM == 16 ? warp * 16 : (warp & 1) * 32;
  const int splits = gridDim.z, z = blockIdx.z;
  const int nst = Kp / BK;
  const int s0 = (int)((long long)z * nst / splits);
  const int count = (int)((long long)(z + 1) * nst / splits) - s0;
  const size_t wpitch = PACKED ? (size_t)Kp / 2 : (size_t)Kp;

  // The 16-byte copies of stage s into ring slot `slot`: the weight always,
  // x on the X16 route (rows past M and chunks past K zero-filled).
  auto load_async = [&](int s, int slot) {
    const int k0 = s * BK;
    const uint8_t* wb = w + (size_t)n0 * wpitch + (PACKED ? k0 / 2 : k0);
#pragma unroll
    for (int e = tid; e < BN * (WROW / 16); e += THREADS) {
      const int r = e / (WROW / 16), c = 16 * (e % (WROW / 16));
      cp_async16(&wsm[slot][PACKED ? off32(r, c) : off64(r, c)], wb + r * wpitch + c, true);
    }
    if (X16) {
#pragma unroll
      for (int e = tid; e < BM * 4; e += THREADS) {
        const int r = e >> 2, c = 16 * (e & 3);
        const int gm = m0 + r, gk = k0 + c;
        const bool in = gm < M && gk < K;  // K % 16 == 0: a chunk is all in or all out
        cp_async16(&xs[slot][off64(r, c)], in ? x + (size_t)gm * K + gk : x, in);
      }
    }
  };

  // Byte-staged x: the loads of stage s into registers, then their store.
  auto load_x_bytes = [&](int s, unsigned (&xr)[XWORDS]) {
    const int k0 = s * BK;
#pragma unroll
    for (int i = 0; i < XWORDS; ++i) {
      const int e = tid + i * THREADS;
      const int gm = m0 + (e >> 4), gk = k0 + 4 * (e & 15);
      unsigned v = 0u;
      if (gm < M) {
        const uint8_t* row = reinterpret_cast<const uint8_t*>(x) + (size_t)gm * K;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (gk + b < K) v |= (unsigned)row[gk + b] << (8 * b);
      }
      xr[i] = v;
    }
  };
  auto store_x_bytes = [&](int slot, const unsigned (&xr)[XWORDS]) {
#pragma unroll
    for (int i = 0; i < XWORDS; ++i) {
      const int e = tid + i * THREADS;
      *reinterpret_cast<unsigned*>(&xs[slot][off64(e >> 4, 4 * (e & 15))]) = xr[i];
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  auto compute = [&](int slot) {
    const uint8_t* xsl = xs[slot];
    const uint8_t* wsl = wsm[slot];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wrow + mi * 16 + g;
        const uint2 lo = *reinterpret_cast<const uint2*>(xsl + off64(r, kk + 8 * t));
        const uint2 hi = *reinterpret_cast<const uint2*>(xsl + off64(r + 8, kk + 8 * t));
        a[mi][0] = lo.x;
        a[mi][1] = hi.x;
        a[mi][2] = lo.y;
        a[mi][3] = hi.y;
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int r = wcol + ni * 8 + g;
        unsigned b0, b1;
        if (PACKED) {
          // 4 packed bytes = k 8t..8t+7 of this step: byte j holds k = 2j
          // (low nibble) and 2j + 1 (high nibble)
          const unsigned p = *reinterpret_cast<const unsigned*>(wsl + off32(r, kk / 2 + 4 * t));
          const unsigned ev = sext_nibbles(p & 0x0F0F0F0Fu);
          const unsigned od = sext_nibbles((p >> 4) & 0x0F0F0F0Fu);
          b0 = __byte_perm(ev, od, 0x5140);  // k 0, 1, 2, 3
          b1 = __byte_perm(ev, od, 0x7362);  // k 4, 5, 6, 7
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(wsl + off64(r, kk + 8 * t));
          b0 = v.x;
          b1 = v.y;
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_s8_16832(acc[mi][ni], a[mi], b0, b1);
      }
    }
  };

  // The table's bytes are loaded here and stored after the prologue, so
  // their latency hides behind the first stages' copies.
  uint8_t lut0 = 0, lut1 = 0;
  if (lut != nullptr) {
    lut0 = __ldg(lut + tid);
    lut1 = __ldg(lut + tid + THREADS);
  }

  // prologue: stages 0 .. STAGES-2 in flight (an empty group past the end);
  // byte-staged x loads every prologue stage before it stores any
  unsigned xr[STAGES - 1][XWORDS];
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) {
      load_async(s0 + i, i);
      if (!X16) load_x_bytes(s0 + i, xr[i]);
    }
    cp_async_commit();
  }
  if (!X16) {
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i)
      if (i < count) store_x_bytes(i, xr[i]);
  }
  // Published by the mainloop's first barrier, which every thread of every
  // block reaches (each split owns at least one stage); a split block that
  // returns before the epilogue returns whole.
  if (lut != nullptr) {
    tab[tid] = lut0;
    tab[tid + THREADS] = lut1;
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage i have landed
    __syncthreads();              // everyone's have, and slot (i-1) is free
    const int j = i + STAGES - 1;
    const bool ahead = j < count;
    if (!X16 && ahead) load_x_bytes(s0 + j, xr[0]);
    if (ahead) load_async(s0 + j, j % STAGES);
    cp_async_commit();
    compute(i % STAGES);
    if (!X16 && ahead) store_x_bytes(j % STAGES, xr[0]);
  }
  cp_async_wait<0>();

  // the epilogue's per-column constants, loaded before the split reduction
  int bb[NI][2];
  float sc[NI][2], sh[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int gn = n0 + wcol + ni * 8 + 2 * t;  // gn + 1 < Np always
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bb[ni][e] = bias[gn + e];
      sc[ni][e] = qs[gn + e];
      sh[ni][e] = qsh[gn + e];
    }
  }

  if (splits > 1) {
    // Exact split-K: every split writes its partial tile to its slab, in
    // register order (coalesced); the last to arrive adds the others.
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int* slab = ws + (size_t)tile * splits * NACC * THREADS + tid;
    int* mine = slab + (size_t)z * NACC * THREADS;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) __stcg(mine + ((mi * NI + ni) * 4 + e) * THREADS, acc[mi][ni][e]);
    __threadfence();  // the partials are visible device-wide before the ticket
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(tickets + tile, 1) == splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll 4
    for (int zz = 0; zz < splits; ++zz) {
      if (zz == z) continue;
      const int* src = slab + (size_t)zz * NACC * THREADS;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][ni][e] = (int)((unsigned)acc[mi][ni][e] +
                                   (unsigned)__ldcg(src + ((mi * NI + ni) * 4 + e) * THREADS));
    }
    if (tid == 0) tickets[tile] = 0;  // ready for the next call on this stream
  }

  const float lo = out_uint8 ? 0.0f : -128.0f;
  const float hi = out_uint8 ? 255.0f : 127.0f;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int gn = n0 + wcol + ni * 8 + 2 * t;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wrow + mi * 16 + g + 8 * h;
        if (gm >= M || gn >= N) continue;
        uint8_t q0 =
            requant(acc[mi][ni][2 * h], bb[ni][0], sc[ni][0], sh[ni][0], relu, two_mul, lo, hi);
        uint8_t q1 = requant(acc[mi][ni][2 * h + 1], bb[ni][1], sc[ni][1], sh[ni][1], relu,
                             two_mul, lo, hi);
        if (lut != nullptr) {  // q is an int8 code here: the table's index is q + 128
          q0 = tab[(int)(int8_t)q0 + 128];
          q1 = tab[(int)(int8_t)q1 + 128];
        }
        uint8_t* o = out + (size_t)gm * N + gn;
        if ((N & 1) == 0) {  // gm·N + gn is even: one 16-bit store
          *reinterpret_cast<uint16_t*>(o) = (uint16_t)(q0 | (q1 << 8));
        } else {
          o[0] = q0;
          if (gn + 1 < N) o[1] = q1;
        }
      }
  }
}

template <int BM, int STAGES, bool PACKED, bool X16>
cudaError_t launch_one(cudaStream_t stream, const void* x, const void* w, const void* bias,
                       const void* qs, const void* qsh, const void* lut, void* out, void* ws,
                       void* tickets, int M, int K, int N, int Kp, int Np, int splits, int relu,
                       int two_mul, int out_uint8) {
  const dim3 grid((M + BM - 1) / BM, Np / BN, splits);
  qmatmul_kernel<BM, STAGES, PACKED, X16><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)x, (const uint8_t*)w, (const int*)bias, (const float*)qs,
      (const float*)qsh, (const uint8_t*)lut, (uint8_t*)out, (int*)ws, (int*)tickets, M, K, N,
      Kp, relu, two_mul, out_uint8);
  return cudaGetLastError();
}

template <int BM, int STAGES>
cudaError_t launch(bool packed, bool x16, cudaStream_t s, const void* x, const void* w,
                   const void* bias, const void* qs, const void* qsh, const void* lut, void* out,
                   void* ws, void* tickets, int M, int K, int N, int Kp, int Np, int splits,
                   int relu, int two_mul, int out_uint8) {
#define REPRO_QMM_ARGS s, x, w, bias, qs, qsh, lut, out, ws, tickets, M, K, N, Kp, Np, splits, relu, two_mul, out_uint8
  if (packed && x16) return launch_one<BM, STAGES, true, true>(REPRO_QMM_ARGS);
  if (packed) return launch_one<BM, STAGES, true, false>(REPRO_QMM_ARGS);
  if (x16) return launch_one<BM, STAGES, false, true>(REPRO_QMM_ARGS);
  return launch_one<BM, STAGES, false, false>(REPRO_QMM_ARGS);
#undef REPRO_QMM_ARGS
}

template <int BM, int STAGES>
cudaError_t attrs(bool packed, bool x16, cudaFuncAttributes* a) {
  if (packed && x16) return cudaFuncGetAttributes(a, qmatmul_kernel<BM, STAGES, true, true>);
  if (packed) return cudaFuncGetAttributes(a, qmatmul_kernel<BM, STAGES, true, false>);
  if (x16) return cudaFuncGetAttributes(a, qmatmul_kernel<BM, STAGES, false, true>);
  return cudaFuncGetAttributes(a, qmatmul_kernel<BM, STAGES, false, false>);
}

}  // namespace

// x (M, K) int8 row-major; w (Np, Kp) int8, or (Np, Kp/2) uint8 when packed,
// 16-byte aligned; bias (Np,) int32; qs, qsh (Np,) f32; lut null, or a
// (256,) int8/uint8 table applied to the int8 code (then out_uint8 = 0);
// out (M, N) int8/uint8 with N <= Np.  Kp % 64 == 0, Np % 64 == 0,
// 1 <= K <= Kp, bm in {16, 64}, 1 <= splits <= Kp / 64.  x16 = 1 stages x by 16-byte copies and needs
// K % 16 == 0 and x 16-byte aligned.  With splits > 1, ws holds
// splits · ceil(M/bm) · (Np/64) · bm · 64 int32 and tickets ceil(M/bm) ·
// (Np/64) int32, zero at entry and left zero.  Returns cudaGetLastError().
extern "C" int repro_qmatmul(const void* x, const void* w, const void* bias, const void* qs,
                             const void* qsh, const void* lut, void* out, void* ws,
                             void* tickets, int M, int K, int N, int Kp, int Np, int bm,
                             int splits, int x16, int packed, int relu, int two_mul,
                             int out_uint8, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (Kp % BK || Np % BN || K < 1 || K > Kp || N < 1 || N > Np || splits < 1 ||
      splits > Kp / BK || splits > 65535 || Np / BN > 65535 || (bm != 16 && bm != 64) ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      (x16 && (K % 16 || reinterpret_cast<uintptr_t>(x) % 16)) ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)) || (lut != nullptr && out_uint8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 16)
    return (int)launch<16, 6>(packed != 0, x16 != 0, s, x, w, bias, qs, qsh, lut, out, ws,
                              tickets, M, K, N, Kp, Np, splits, relu, two_mul, out_uint8);
  return (int)launch<64, 4>(packed != 0, x16 != 0, s, x, w, bias, qs, qsh, lut, out, ws,
                            tickets, M, K, N, Kp, Np, splits, relu, two_mul, out_uint8);
}

// The static shared memory (bytes) and registers per thread of the kernel
// instance a launch with (bm, packed, x16) takes, as the driver reports
// them.  Returns the cudaError_t of cudaFuncGetAttributes.
extern "C" int repro_qmatmul_attrs(int bm, int packed, int x16, int* shared_bytes, int* regs) {
  if (bm != 16 && bm != 64) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t rc = bm == 16 ? attrs<16, 6>(packed != 0, x16 != 0, &a)
                                  : attrs<64, 4>(packed != 0, x16 != 0, &a);
  if (rc != cudaSuccess) return (int)rc;
  *shared_bytes = (int)a.sharedSizeBytes;
  *regs = a.numRegs;
  return (int)cudaSuccess;
}
