// Fused pre-quantized matmul for Hopper (sm_90a): int8 x · int8 (or packed
// int4) W → int32 → bias → f32 rescale (one or two Muls) → [ReLU] → round half
// to even → clip to int8 / uint8.
//
// Replaces the TPU kernels repro/kernels/qmatmul.py::qmatmul (int8 weights)
// and ::qmatmul_packed (int4 nibble pairs), with their shared _epilogue.
//
// Bound on an H100: at the token path's decode shapes (M = a few rows,
// K x N = 2048 x 6144) the weight bytes dominate, so the kernel is bound by
// device memory (3.35 TB/s); at prefill shapes (M >= 512) it is bound by
// int8 operations.  This first kernel is deliberately simple: a SIMT tile
// loop on __dp4a (4 int8 products per instruction, int32 accumulation), one
// BM x 64 output tile per block, K staged through shared memory 64 bytes at a
// time.  It does not reach the tensor cores (wgmma) and does not pipeline its
// loads (TMA); both are later work.  What it does about the bound:
//   * the weight is stored K-contiguous as (Np, Kp) by the plan template, so
//     a block streams whole 16-byte runs of W with no transpose, and a packed
//     int4 weight streams half the bytes, unpacked in the shared staging;
//   * small M runs a 16-row tile (BM = 16) so decode does not spend 64-row
//     work per weight byte;
//   * the epilogue runs on the int32 accumulator in registers — the
//     Cast/Mul/Mul/QuantizeLinear chain never round-trips to device memory.
//
// Any K and any alignment of x: x is staged as 32-bit words, read whole when
// K % 4 == 0 and x is 4-byte aligned, else assembled byte by byte (the conv
// route's im2col rows have K = C*kH*kW, e.g. 147 for a 7x7 RGB stem).  The
// bytes beyond K read as zero either way, so the int32 sum is the same.  The
// choice is a template parameter, so the word path compiles as it did
// before the byte path existed.
//
// Exactness: the int32 sum is order-independent; the epilogue uses the
// IEEE round-to-nearest intrinsics (__int2float_rn, __fmul_rn) and rintf, so
// no mul+add can contract into an FMA, in the codified op order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;        // output columns per block
constexpr int BK = 64;        // K bytes (int8 values) per shared-memory stage
constexpr int KW = BK / 4;    // 32-bit words per staged row
constexpr int LDS = KW + 1;   // padded row stride (words) against bank conflicts
constexpr int THREADS = 256;  // (BN / TN) x (BM / TM)
constexpr int TN = 4;         // columns per thread: tx + 16 * j

// Word gk (k = 4*gk .. 4*gk+3) of x row gm, zero beyond the ragged M and K
// edges.  WORDS: K % 4 == 0 and x 4-byte aligned, so the word is one load.
template <bool WORDS>
__device__ __forceinline__ unsigned x_word(const int8_t* __restrict__ x, int gm,
                                           int gk, int M, int K) {
  if (gm >= M) return 0u;
  if (WORDS)
    return gk < K / 4
               ? reinterpret_cast<const unsigned*>(x)[(size_t)gm * (K / 4) + gk]
               : 0u;
  const uint8_t* row = reinterpret_cast<const uint8_t*>(x) + (size_t)gm * K;
  unsigned v = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int k = 4 * gk + b;
    if (k < K) v |= (unsigned)row[k] << (8 * b);
  }
  return v;
}

// Sign-extend the four 4-bit values held in the low nibbles of each byte.
__device__ __forceinline__ int sext_nibbles(unsigned v) {
  return (int)__vsub4(v ^ 0x08080808u, 0x08080808u);
}

template <int BM, int TM, bool PACKED, bool WORDS>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
               const int* __restrict__ bias, const float* __restrict__ qs,
               const float* __restrict__ qsh, uint8_t* __restrict__ out,
               int M, int K, int N, int Kp, int relu, int two_mul,
               int out_uint8) {
  __shared__ int xs[BM][LDS];
  __shared__ int ws[BN][LDS];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // 0..15
  const int ty = tid / (BN / TN);  // 0..BM/TM-1
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  const unsigned* wwords = reinterpret_cast<const unsigned*>(w);

  for (int k0 = 0; k0 < Kp; k0 += BK) {
    const int kw0 = k0 / 4;
    if (!PACKED) {
      // x tile: BM rows x KW words, zero beyond the ragged M and K edges
      for (int e = tid; e < BM * KW; e += THREADS) {
        const int r = e / KW, c = e % KW;
        xs[r][c] = (int)x_word<WORDS>(x, m0 + r, kw0 + c, M, K);
      }
      // W tile: BN rows (output columns) x KW words of the (Np, Kp) weight
      for (int e = tid; e < BN * KW; e += THREADS) {
        const int r = e / KW, c = e % KW;
        ws[r][c] = (int)wwords[(size_t)(n0 + r) * (Kp / 4) + kw0 + c];
      }
    } else {
      // Each packed word holds 8 consecutive k: low nibbles are the even k,
      // high nibbles the odd k.  Stage x with its bytes split the same way,
      // so word 2q holds the even k and word 2q+1 the odd k of group q, and
      // the inner loop stays one dot product over 16 words.
      for (int e = tid; e < BM * (KW / 2); e += THREADS) {
        const int r = e / (KW / 2), q = e % (KW / 2);
        const int gm = m0 + r, gk = kw0 + 2 * q;
        const unsigned a = x_word<WORDS>(x, gm, gk, M, K);
        const unsigned b = x_word<WORDS>(x, gm, gk + 1, M, K);
        xs[r][2 * q] = (int)__byte_perm(a, b, 0x6420);
        xs[r][2 * q + 1] = (int)__byte_perm(a, b, 0x7531);
      }
      for (int e = tid; e < BN * (KW / 2); e += THREADS) {
        const int r = e / (KW / 2), q = e % (KW / 2);
        const unsigned p = wwords[(size_t)(n0 + r) * (Kp / 8) + k0 / 8 + q];
        ws[r][2 * q] = sext_nibbles(p & 0x0F0F0F0Fu);
        ws[r][2 * q + 1] = sext_nibbles((p >> 4) & 0x0F0F0F0Fu);
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty * TM + i][c];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[tx + 16 * j][c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float lo = out_uint8 ? 0.0f : -128.0f;
  const float hi = out_uint8 ? 255.0f : 127.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      // int32 + int32 wraps, as the reference's int32 add does
      const int a32 = (int)((unsigned)acc[i][j] + (unsigned)bias[gn]);
      float f = __fmul_rn(__int2float_rn(a32), qs[gn]);
      if (two_mul) f = __fmul_rn(f, qsh[gn]);
      if (relu) f = fmaxf(f, 0.0f);
      f = fminf(fmaxf(rintf(f), lo), hi);
      out[(size_t)gm * N + gn] = (uint8_t)(int)f;
    }
  }
}

template <int BM, int TM, bool PACKED, bool WORDS>
void launch_one(dim3 grid, cudaStream_t stream, const void* x, const void* w,
                const void* bias, const void* qs, const void* qsh, void* out,
                int M, int K, int N, int Kp, int relu, int two_mul,
                int out_uint8) {
  qmatmul_kernel<BM, TM, PACKED, WORDS><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)x, (const uint8_t*)w, (const int*)bias, (const float*)qs,
      (const float*)qsh, (uint8_t*)out, M, K, N, Kp, relu, two_mul, out_uint8);
}

template <int BM, int TM>
cudaError_t launch(bool packed, const void* x, const void* w, const void* bias,
                   const void* qs, const void* qsh, void* out, int M, int K,
                   int N, int Kp, int Np, int relu, int two_mul, int out_uint8,
                   cudaStream_t stream) {
  dim3 grid(Np / BN, (M + BM - 1) / BM);
  const bool words = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
#define REPRO_QMM_ARGS grid, stream, x, w, bias, qs, qsh, out, M, K, N, Kp, relu, two_mul, out_uint8
  if (packed && words) launch_one<BM, TM, true, true>(REPRO_QMM_ARGS);
  else if (packed) launch_one<BM, TM, true, false>(REPRO_QMM_ARGS);
  else if (words) launch_one<BM, TM, false, true>(REPRO_QMM_ARGS);
  else launch_one<BM, TM, false, false>(REPRO_QMM_ARGS);
#undef REPRO_QMM_ARGS
  return cudaGetLastError();
}

}  // namespace

// x (M, K) int8 row-major; w (Np, Kp) int8, or (Np, Kp/2) uint8 when packed;
// bias (Np,) int32; qs, qsh (Np,) f32; out (M, N) int8/uint8 with N <= Np.
// Kp % 64 == 0, Np % 64 == 0, 1 <= K <= Kp.  Returns cudaGetLastError().
extern "C" int repro_qmatmul(const void* x, const void* w, const void* bias,
                             const void* qs, const void* qsh, void* out, int M,
                             int K, int N, int Kp, int Np, int bm, int packed,
                             int relu, int two_mul, int out_uint8,
                             void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (Kp % BK || Np % BN || K < 1 || K > Kp || N > Np)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 16)
    return (int)launch<16, 1>(packed != 0, x, w, bias, qs, qsh, out, M, K, N,
                              Kp, Np, relu, two_mul, out_uint8, s);
  if (bm == 64)
    return (int)launch<64, 4>(packed != 0, x, w, bias, qs, qsh, out, M, K, N,
                              Kp, Np, relu, two_mul, out_uint8, s);
  return (int)cudaErrorInvalidValue;
}
