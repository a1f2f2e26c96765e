// Fused int8 attention for Hopper (sm_90a): the codified PQ-IR attention
// region (repro/core/patterns.py::emit_qattention) in one kernel —
//   int8 Q·Kᵀ → int32 → ×qk_scale → s·mask + (mask−1)·big → row max →
//   clip(rint((masked − max) / lut_scale), −128, 127) → uint8 exp-LUT gather
//   → int32 row sum den → p_q = clip(rint(w / den · p_scale)) → int8 P·V →
//   int32 → ×rescale → rint → clip.
//
// Replaces the TPU kernel repro/kernels/qattention.py::qattention
// (_qattention_kernel).
//
// Bound on an H100: per query row it reads the row's K and V (T x dh int8
// each) and its mask row (T f32); at the token path's shapes (dh = 128,
// T <= a few thousand) the work is a few hundred int8 operations per byte at
// most, far below the card's operations-per-byte balance, so it is bound by
// device memory.  This first kernel is simple and exact, not fast: one block
// per (batch, query row) in passes over the row's keys — scores and row max,
// LUT weights and den, p_q, context — with the whole row in shared memory
// (4·T bytes).  It cannot use an
// online softmax: the LUT index needs the global row max and p_q needs the
// full integer den, so the row is materialised before either is formed.
// Keys are split over the block's 16 warps in the score pass (a warp per
// key, lanes over dh) and in the context pass (lanes over dh in 4-byte
// words, warps over keys), so both read K and V rows whole and coalesced,
// and each warp keeps several rows' loads in flight: at decode the block's
// loops are bound by load latency, not by bytes.  K and V
// of one batch entry are re-read by its S query blocks through L2; tiling
// several query rows per block, spreading a decode row's keys over several
// blocks, and the tensor cores are later work.
//
// Exactness: every f32 step uses the IEEE round-to-nearest intrinsics
// (__int2float_rn, __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) and rintf,
// so the mask line s·mask + (mask−1)·big never contracts into an FMA and both
// divides are correctly rounded.  Keys beyond the true T do not exist here
// (no padding); the reference's zero-padded keys are inert because
// lut[0] == 0, so both agree.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
qattention_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                  const int8_t* __restrict__ v, const float* __restrict__ mask,
                  const uint8_t* __restrict__ lut, uint8_t* __restrict__ out,
                  int S, int T, int dh, float qk_scale, float big,
                  float lut_scale, float p_scale, float rescale,
                  int out_uint8) {
  extern __shared__ int smem[];
  float* sc = reinterpret_cast<float*>(smem);  // T masked scores, reused as ints
  int* wi = smem;                              // LUT weights, then p_q
  int* qw = smem + T;                          // the query row, dh/4 words
  int* part = qw + dh / 4;                     // WARPS x dh partial contexts
  __shared__ int lut_s[256];
  __shared__ float red_f[WARPS];
  __shared__ int red_i[WARPS];

  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int dw = dh / 4;  // dh % 4 == 0, checked by the wrapper

  const int* qrow = reinterpret_cast<const int*>(q + ((size_t)b * S + s) * dh);
  const int* kb = reinterpret_cast<const int*>(k + (size_t)b * T * dh);
  const float* mrow = mask + ((size_t)b * S + s) * T;
  for (int i = tid; i < dw; i += THREADS) qw[i] = qrow[i];
  for (int i = tid; i < 256; i += THREADS) lut_s[i] = lut[i];
  __syncthreads();

  // pass 1: masked scores, one warp per key (lanes over dh), and the row max
  float mx = __int_as_float((int)0xff800000);  // -inf
#pragma unroll 4
  for (int t = wid; t < T; t += WARPS) {
    int acc = 0;
    for (int i = lane; i < dw; i += 32) acc = __dp4a(qw[i], kb[(size_t)t * dw + i], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const float sf = __fmul_rn(__int2float_rn(acc), qk_scale);
      const float m = mrow[t];
      const float masked = __fadd_rn(__fmul_rn(sf, m), __fmul_rn(__fsub_rn(m, 1.0f), big));
      sc[t] = masked;
      mx = fmaxf(mx, masked);
    }
  }
  if (lane == 0) red_f[wid] = mx;
  __syncthreads();
  mx = red_f[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) mx = fmaxf(mx, red_f[i]);

  // pass 2: quantized score deltas → LUT weights, and their int32 sum
  int den = 0;
  for (int t = tid; t < T; t += THREADS) {
    const float d = __fdiv_rn(__fsub_rn(sc[t], mx), lut_scale);
    const float r = fminf(fmaxf(rintf(d), -128.0f), 127.0f);
    const int w = lut_s[(int)r + 128];
    wi[t] = w;
    den += w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
  if (lane == 0) red_i[wid] = den;
  __syncthreads();
  den = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) den += red_i[i];

  // pass 3: int8 probabilities p_q = clip(rint(w / den · p_scale))
  const float denf = __int2float_rn(den);
  for (int t = tid; t < T; t += THREADS) {
    const float p = __fdiv_rn(__int2float_rn(wi[t]), denf);
    wi[t] = (int)fminf(fmaxf(rintf(__fmul_rn(p, p_scale)), -128.0f), 127.0f);
  }
  __syncthreads();

  // pass 4: context = p_q · V.  Lane l owns head dims 4l..4l+3 (one 32-bit
  // word of each V row, so a warp reads a row's 128 bytes at once); warp w
  // sums the keys t = w (mod WARPS).  The partial sums meet in shared memory.
  const int* vw = reinterpret_cast<const int*>(v + (size_t)b * T * dh);
  for (int i = lane; i < dw; i += 32) {
    int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll 4
    for (int t = wid; t < T; t += WARPS) {
      const int p = wi[t];
      const int x = vw[(size_t)t * dw + i];
      a0 += p * (int)(signed char)x;
      a1 += p * (int)(signed char)(x >> 8);
      a2 += p * (int)(signed char)(x >> 16);
      a3 += p * (int)(signed char)(x >> 24);
    }
    int* pw = part + wid * dh + 4 * i;
    pw[0] = a0; pw[1] = a1; pw[2] = a2; pw[3] = a3;
  }
  __syncthreads();
  const float lo = out_uint8 ? 0.0f : -128.0f;
  const float hi = out_uint8 ? 255.0f : 127.0f;
  uint8_t* orow = out + ((size_t)b * S + s) * dh;
  for (int d = tid; d < dh; d += THREADS) {
    int acc = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += part[w * dh + d];
    const float f = __fmul_rn(__int2float_rn(acc), rescale);
    orow[d] = (uint8_t)(int)fminf(fmaxf(rintf(f), lo), hi);
  }
}

}  // namespace

// q (B, S, dh), k and v (B, T, dh) int8; mask (B, S, T) f32 in {0, 1};
// lut (256,) uint8; out (B, S, dh) int8/uint8.  All contiguous, dh % 4 == 0.
// Returns cudaGetLastError().
extern "C" int repro_qattention(const void* q, const void* k, const void* v,
                                const void* mask, const void* lut, void* out,
                                int B, int S, int T, int dh, float qk_scale,
                                float big, float lut_scale, float p_scale,
                                float rescale, int out_uint8, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  if (T <= 0 || dh <= 0 || dh % 4 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)T + dh / 4 + (size_t)WARPS * dh) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qattention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(S, B);
  qattention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const int8_t*)k, (const int8_t*)v, (const float*)mask,
      (const uint8_t*)lut, (uint8_t*)out, S, T, dh, qk_scale, big, lut_scale,
      p_scale, rescale, out_uint8);
  return (int)cudaGetLastError();
}
