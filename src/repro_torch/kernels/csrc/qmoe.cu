// The codified routed-expert layer (repro_torch/core/moe.py) as five launches
// for Hopper (sm_90a), one plan step: route, plan, gate|up, down, combine.
//
// A layer of 64 experts of SwiGLU (2304 -> 2 x 896 -> 2304, int8) is 396 MB
// of weights; a decode step of 64 tokens x top-8 gives each expert about 8
// rows, so every expert's weights are read once a step and the step is bound
// by device memory (3.35 TB/s: at least 118 us a layer).  At prefill (up to
// 4,608 tokens, ~576 rows an expert) it is bound by the int8 tensor cores.
// What the design does about it:
//   * Grouped, not per expert: one launch covers every expert.  A row tile
//     of a grouped GEMM is (expert, BM rows of its tokens); the grid is fixed
//     for the worst case, ceil(P / BM) + E row tiles for P = tokens x k
//     routed pairs, so a CUDA graph captures it once.  The routing offsets
//     live on the device: each block looks its tile up in them, and a block
//     past the step's real tiles returns at once.
//   * The weights stream as in qmatmul.cu: 64-byte K stages, a cp.async ring
//     (6 stages at BM = 16, 4 at BM = 64), the same XOR-swizzled shared
//     layout and mma.sync.m16n8k32 int8 products with exact int32 sums.
//     The planner takes BM = 16 where the mean rows an expert is at most 16
//     (decode) and 64 otherwise.
//   * gate and up are one GEMM: the stacked weight (E, 2F, D) interleaves 8
//     gate rows and the same 8 features' up rows, so each thread holds a
//     feature's gate and up sums in registers.  The epilogue rescales the
//     gate to int8, looks it up in the SiLU table (256 bytes in shared
//     memory), rescales the up, and writes their requantized product: the
//     hidden never round-trips as int32.
//   * The combination reads each token's k expert rows by the inverse map
//     of the plan and sums pq x y in int32: every order gives the same sum.
//
// Exactness: the router's int32 sums (__dp4a) and every GEMM's are order-
// independent; the float steps use the IEEE round-to-nearest intrinsics
// (__int2float_rn, __fmul_rn, __fdiv_rn) and rintf in the codified order,
// so nothing contracts into an FMA.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using repro_ptx::cp_async16;
using repro_ptx::cp_async_commit;
using repro_ptx::cp_async_wait;
using repro_ptx::mma_s8_16832;

constexpr int BN = 64;        // output columns per block
constexpr int BK = 64;        // K bytes per pipeline stage
constexpr int THREADS = 128;  // four warps
constexpr int MAX_E = 256;    // experts a layer may have
constexpr int MAX_K = 32;     // experts a token may take

__device__ __forceinline__ int off64(int r, int c) {
  return r * 64 + (((c >> 4) ^ (r & 2)) << 4) + (c & 15);
}

// QuantizeLinear(scale 1, zp 0) to int8: round half to even, clip.
__device__ __forceinline__ int rq(float f) { return (int)fminf(fmaxf(rintf(f), -128.0f), 127.0f); }

__device__ __forceinline__ int rescaled(int acc, float qs, float sh) {
  return rq(__fmul_rn(__fmul_rn(__int2float_rn(acc), qs), sh));
}

// 1. One block a token: the router's int32 sums, the ranks (ties to the
// lower id), the exp-table weights of the chosen k and their int8 codes.
__global__ void __launch_bounds__(256)
qmoe_route_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wr,
                  const uint8_t* __restrict__ lut, int D, int E, int k, float rscale,
                  float lut_scale, float p_scale, int* __restrict__ top_e,
                  int8_t* __restrict__ top_q) {
  __shared__ int acc[MAX_E];
  __shared__ int s_best, s_den;
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int8_t* xr = x + (size_t)t * D;
  for (int e = warp; e < E; e += blockDim.x / 32) {
    const int8_t* w = wr + (size_t)e * D;
    int s = 0;
    for (int d = 4 * lane; d < D; d += 128)
      s = __dp4a(*reinterpret_cast<const int*>(xr + d), *reinterpret_cast<const int*>(w + d), s);
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) acc[e] = s;
  }
  if (tid == 0) s_den = 0;
  __syncthreads();
  int rank = E, w = 0;
  if (tid < E) {
    const int ai = acc[tid];
    rank = 0;
    for (int j = 0; j < E; ++j) {
      const int aj = acc[j];
      rank += (aj > ai) || (aj == ai && j < tid);
    }
    if (rank == 0) s_best = ai;
  }
  __syncthreads();
  if (rank < k) {
    const float f = __fmul_rn(__int2float_rn(acc[tid] - s_best), rscale);
    w = lut[rq(__fdiv_rn(f, lut_scale)) + 128];
    atomicAdd(&s_den, w);
  }
  __syncthreads();
  if (rank < k) {
    const float p = __fdiv_rn(__int2float_rn(w), __int2float_rn(s_den));
    top_e[t * k + rank] = tid;
    top_q[t * k + rank] = (int8_t)rq(__fmul_rn(p, p_scale));
  }
}

// 2. One block: the routed pairs grouped by expert.  offs[e] is expert e's
// first slot, tiles[e] its first row tile (E + 1 entries each); order[slot]
// is the pair (token * k + rank) in that slot, slot_of its inverse.
__global__ void __launch_bounds__(1024)
qmoe_plan_kernel(const int* __restrict__ top_e, int P, int E, int bm, int* __restrict__ offs,
                 int* __restrict__ tiles, int* __restrict__ order, int* __restrict__ slot_of) {
  __shared__ int cnt[MAX_E], fill[MAX_E], off[MAX_E];
  const int tid = threadIdx.x;
  for (int e = tid; e < E; e += blockDim.x) cnt[e] = fill[e] = 0;
  __syncthreads();
  for (int p = tid; p < P; p += blockDim.x) atomicAdd(&cnt[top_e[p]], 1);
  __syncthreads();
  if (tid == 0) {
    int o = 0, tl = 0;
    for (int e = 0; e < E; ++e) {
      off[e] = offs[e] = o;
      tiles[e] = tl;
      o += cnt[e];
      tl += (cnt[e] + bm - 1) / bm;
    }
    offs[E] = o;
    tiles[E] = tl;
  }
  __syncthreads();
  for (int p = tid; p < P; p += blockDim.x) {
    const int e = top_e[p];
    const int s = off[e] + atomicAdd(&fill[e], 1);
    order[s] = p;
    slot_of[p] = s;
  }
}

// 3./4. The grouped GEMM over every expert's rows.  GATEUP: a = x (tokens,
// K), rows gathered through order; w = the interleaved (E, 2F, K) gate|up
// weight; out = h (P, F).  Else: a = h (P, K) in slot order; w = (E, N, K)
// down weight; out = y (P, N).
template <int BM, int STAGES, bool GATEUP>
__global__ void __launch_bounds__(THREADS)
qmoe_gemm_kernel(const int8_t* __restrict__ a, const uint8_t* __restrict__ w,
                 const int* __restrict__ offs, const int* __restrict__ tiles,
                 const int* __restrict__ order, const int8_t* __restrict__ silu,
                 int8_t* __restrict__ out, int K, int N, int E, int k, float qs0, float sh0,
                 float qs1, float sh1, float h_scale) {
  constexpr int MI = BM == 16 ? 1 : 2;
  constexpr int NI = BM == 16 ? 2 : 4;
  __shared__ __align__(128) uint8_t xs[STAGES][BM * BK];
  __shared__ __align__(128) uint8_t wsm[STAGES][BN * BK];
  __shared__ int8_t tab[256];
  __shared__ int rows[BM];
  __shared__ int s_e, s_r0, s_m;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, j = blockIdx.y;
  const int wrow = BM == 16 ? 0 : (warp >> 1) * 32;
  const int wcol = BM == 16 ? warp * 16 : (warp & 1) * 32;

  if (tid == 0) {
    int e = -1;
    if (j < tiles[E]) {  // the last expert whose first tile is <= j holds tile j
      int lo = 0, hi = E - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (tiles[mid] <= j) lo = mid; else hi = mid - 1;
      }
      e = lo;
      s_r0 = offs[e] + (j - tiles[e]) * BM;
      s_m = min(BM, offs[e + 1] - s_r0);
    }
    s_e = e;
  }
  __syncthreads();
  const int e = s_e;
  if (e < 0) return;  // past this step's tiles: the whole block leaves
  const int r0 = s_r0, m = s_m;
  if (tid < BM) rows[tid] = tid < m ? (GATEUP ? order[r0 + tid] / k : r0 + tid) : -1;
  if (GATEUP) {
    tab[tid] = silu[tid];
    tab[tid + THREADS] = silu[tid + THREADS];
  }
  __syncthreads();

  const uint8_t* we = w + (size_t)e * N * K + (size_t)n0 * K;
  const int nst = K / BK;
  auto load_async = [&](int s, int slot) {
    const int k0 = s * BK;
#pragma unroll
    for (int i = tid; i < BN * 4; i += THREADS) {
      const int r = i >> 2, c = 16 * (i & 3);
      cp_async16(&wsm[slot][off64(r, c)], we + (size_t)r * K + k0 + c, true);
    }
#pragma unroll
    for (int i = tid; i < BM * 4; i += THREADS) {
      const int r = i >> 2, c = 16 * (i & 3);
      const int src = rows[r];
      cp_async16(&xs[slot][off64(r, c)], src >= 0 ? a + (size_t)src * K + k0 + c : a, src >= 0);
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

  auto compute = [&](int slot) {
    const uint8_t* xsl = xs[slot];
    const uint8_t* wsl = wsm[slot];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wrow + mi * 16 + g;
        const uint2 lo = *reinterpret_cast<const uint2*>(xsl + off64(r, kk + 8 * t));
        const uint2 hi = *reinterpret_cast<const uint2*>(xsl + off64(r + 8, kk + 8 * t));
        af[mi][0] = lo.x;
        af[mi][1] = hi.x;
        af[mi][2] = lo.y;
        af[mi][3] = hi.y;
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint2 v = *reinterpret_cast<const uint2*>(wsl + off64(wcol + ni * 8 + g, kk + 8 * t));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_s8_16832(acc[mi][ni], af[mi], v.x, v.y);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) load_async(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int jn = i + STAGES - 1;
    if (jn < nst) load_async(jn, jn % STAGES);
    cp_async_commit();
    compute(i % STAGES);
  }
  cp_async_wait<0>();

  if (GATEUP) {
    const int F = N / 2;
#pragma unroll
    for (int q = 0; q < NI / 2; ++q) {
      const int f0 = ((n0 + wcol + 16 * q) / 16) * 8 + 2 * t;  // this pair's first feature
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int gm = wrow + mi * 16 + g + 8 * hh;
          if (gm >= m) continue;
          int hv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int s = tab[rescaled(acc[mi][2 * q][2 * hh + c], qs0, sh0) + 128];
            const int u = rescaled(acc[mi][2 * q + 1][2 * hh + c], qs1, sh1);
            hv[c] = rq(__fmul_rn(__fmul_rn(__int2float_rn(s), __int2float_rn(u)), h_scale));
          }
          *reinterpret_cast<uint16_t*>(out + (size_t)(r0 + gm) * F + f0) =
              (uint16_t)((hv[0] & 0xff) | ((hv[1] & 0xff) << 8));
        }
    }
  } else {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int gn = n0 + wcol + ni * 8 + 2 * t;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int gm = wrow + mi * 16 + g + 8 * hh;
          if (gm >= m) continue;
          const int y0 = rescaled(acc[mi][ni][2 * hh], qs0, sh0);
          const int y1 = rescaled(acc[mi][ni][2 * hh + 1], qs0, sh0);
          *reinterpret_cast<uint16_t*>(out + (size_t)(r0 + gm) * N + gn) =
              (uint16_t)((y0 & 0xff) | ((y1 & 0xff) << 8));
        }
    }
  }
}

// 5. One block a token: sum pq x y over its k experts in int32, x 1/127,
// round half to even, clip.
__global__ void __launch_bounds__(256)
qmoe_combine_kernel(const int8_t* __restrict__ y, const int* __restrict__ slot_of,
                    const int8_t* __restrict__ top_q, int D, int k, float out_rescale,
                    int8_t* __restrict__ out) {
  __shared__ int slot[MAX_K], q[MAX_K];
  const int t = blockIdx.x, tid = threadIdx.x;
  if (tid < k) {
    slot[tid] = slot_of[t * k + tid];
    q[tid] = top_q[t * k + tid];
  }
  __syncthreads();
  for (int d4 = tid; d4 < D / 4; d4 += blockDim.x) {
    int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    for (int r = 0; r < k; ++r) {
      const char4 v = reinterpret_cast<const char4*>(y + (size_t)slot[r] * D)[d4];
      s0 += q[r] * v.x;
      s1 += q[r] * v.y;
      s2 += q[r] * v.z;
      s3 += q[r] * v.w;
    }
    char4 o;
    o.x = (signed char)rq(__fmul_rn(__int2float_rn(s0), out_rescale));
    o.y = (signed char)rq(__fmul_rn(__int2float_rn(s1), out_rescale));
    o.z = (signed char)rq(__fmul_rn(__int2float_rn(s2), out_rescale));
    o.w = (signed char)rq(__fmul_rn(__int2float_rn(s3), out_rescale));
    reinterpret_cast<char4*>(out + (size_t)t * D)[d4] = o;
  }
}

template <int BM, int STAGES>
cudaError_t gemms(cudaStream_t s, const void* x, const void* wgu, const void* wd,
                  const void* silu, const int* offs, const int* tiles, const int* order, void* h,
                  void* y, int P, int D, int F, int E, int k, float g_qs, float g_sh, float u_qs,
                  float u_sh, float d_qs, float d_sh, float h_scale) {
  const int row_tiles = (P + BM - 1) / BM + E;
  qmoe_gemm_kernel<BM, STAGES, true><<<dim3(2 * F / BN, row_tiles), THREADS, 0, s>>>(
      (const int8_t*)x, (const uint8_t*)wgu, offs, tiles, order, (const int8_t*)silu,
      (int8_t*)h, D, 2 * F, E, k, g_qs, g_sh, u_qs, u_sh, h_scale);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  qmoe_gemm_kernel<BM, STAGES, false><<<dim3(D / BN, row_tiles), THREADS, 0, s>>>(
      (const int8_t*)h, (const uint8_t*)wd, offs, tiles, order, nullptr, (int8_t*)y, F, D, E, k,
      d_qs, d_sh, 1.0f, 1.0f, 1.0f);
  return cudaGetLastError();
}

}  // namespace

// x (T, D) int8; wr (E, D) int8; wgu (E, 2F, D) int8, rows interleaved by 8
// (gate features 8b..8b+7, then the same features' up rows); wd (E, D, F)
// int8; lut (256,) uint8 exp table; silu (256,) int8.  Scratch: top_e (T, k)
// int32, top_q (T, k) int8, offs and tiles (E + 1) int32, order and slot_of
// (T k) int32, h (T k, F) int8, y (T k, D) int8.  out (T, D) int8.
// D % 64 == 0, F % 64 == 0, 1 <= k <= min(E, 32), E <= 256, bm in {16, 64};
// x, wgu, wd 16-byte aligned.  Five launches on `stream`; returns the first
// cudaError_t.
extern "C" int repro_qmoe(const void* x, const void* wr, const void* wgu, const void* wd,
                          const void* lut, const void* silu, void* out, void* top_e,
                          void* top_q, void* offs, void* tiles, void* order, void* slot_of,
                          void* h, void* y, int T, int D, int F, int E, int k, int bm,
                          float rscale, float lut_scale, float p_scale, float g_qs, float g_sh,
                          float u_qs, float u_sh, float d_qs, float d_sh, float h_scale,
                          float out_rescale, void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  if (D % 64 || F % 64 || E < 1 || E > MAX_E || k < 1 || k > E || k > MAX_K ||
      (bm != 16 && bm != 64) || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wgu) % 16 || reinterpret_cast<uintptr_t>(wd) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int P = T * k;
  qmoe_route_kernel<<<T, 256, 0, s>>>((const int8_t*)x, (const int8_t*)wr, (const uint8_t*)lut,
                                      D, E, k, rscale, lut_scale, p_scale, (int*)top_e,
                                      (int8_t*)top_q);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  qmoe_plan_kernel<<<1, 1024, 0, s>>>((const int*)top_e, P, E, bm, (int*)offs, (int*)tiles,
                                      (int*)order, (int*)slot_of);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  rc = bm == 16 ? gemms<16, 6>(s, x, wgu, wd, silu, (const int*)offs, (const int*)tiles,
                               (const int*)order, h, y, P, D, F, E, k, g_qs, g_sh, u_qs, u_sh,
                               d_qs, d_sh, h_scale)
                : gemms<64, 4>(s, x, wgu, wd, silu, (const int*)offs, (const int*)tiles,
                               (const int*)order, h, y, P, D, F, E, k, g_qs, g_sh, u_qs, u_sh,
                               d_qs, d_sh, h_scale);
  if (rc != cudaSuccess) return (int)rc;
  qmoe_combine_kernel<<<T, 256, 0, s>>>((const int8_t*)y, (const int*)slot_of,
                                        (const int8_t*)top_q, D, k, out_rescale, (int8_t*)out);
  return (int)cudaGetLastError();
}
