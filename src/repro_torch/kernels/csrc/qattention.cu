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
// each) and its mask row (T f32) and does 4·T·dh int8 operations, far below
// the card's operations-per-byte balance, so the bound is device memory.  At
// decode (4 rows of T = 512, dh = 128) that bound is ~0.16 µs a head; what a
// kernel really pays there is latency: a row is a chain of dependent steps
// (scores, row max, den, p_q, context), and one block per row fills 4 of 132
// SMs, each walking its 512 keys in series.  At prefill (512 rows) every SM
// is full, and each row re-reads its batch's K and V through L2.
//
// The design: one row's keys are split over a thread-block cluster of C
// blocks (C in {1, 2, 4, 8, 16}; the grid is (C, S, B), the cluster
// (C, 1, 1)).  Block rank r owns the contiguous keys [r·T/C, (r+1)·T/C).
// The host sizes the block: a warp per two keys, as long as all the blocks
// fit on the card at once (kernels/qattention.py::threads_for).  A warp
// loads 8 key rows at once and adds their 8 dot products over its lanes in
// one transpose butterfly.  No online softmax is possible — the LUT index
// needs the global row max and p_q the full integer den — so the blocks
// meet three times through distributed shared memory (DSMEM), all inside one
// launch, with no global workspace and no second pass:
//   1. each block's max of its masked scores (fmaxf: exact in any order)
//      → every block takes the max of the C maxima and forms its LUT weights
//      and local int32 den;
//   2. the C dens → their integer sum, exact in any order → each block forms
//      p_q and its int32 partial context (dh sums over its keys);
//   3. the C partial contexts → rank r adds them for the head dims
//      d ≡ r (mod C), again exact in any order, and runs the epilogue.
// Each exchange is a push: a block stores its values into slots of the
// blocks that need them (st.async; its own slots by plain stores and one
// arrival), and each store counts its bytes on the receiver's transaction
// barrier (mbarrier), on which the receiver waits.  A block thus waits only
// for the data it needs, not for a barrier round trip of the whole cluster,
// and it leaves only once every store into it has landed.  The one cluster
// barrier (arrive at entry, wait before the first store) only publishes the
// barriers' initialisation.  q, the mask row and the K rows are loaded
// together, the LUT load is issued then and stored later, and a cluster's
// blocks ask their V rows into L2 at entry.  At prefill the rows alone fill
// the card, the planner (kernels/qattention.py::choose_cluster) takes
// C = 1, and a lone block runs the same passes with no exchange at all
// (each warp reduces the warps' maxima and dens itself) and the epilogue
// fused into its last sum; that instance keeps to 32 registers a thread, so
// four 512-thread blocks share an SM.
//
// Operands are strided views: q, k, v, mask and out each come with a batch
// and a row stride (in elements), the innermost stride being 1, so the
// per-head slices of the qkv projection and of the KV cache reach the kernel
// with no copy.  q, k and v are read in 4-byte words, so their bases and
// strides are multiples of 4 bytes (the wrapper checks).
//
// Exactness: every f32 step uses the IEEE round-to-nearest intrinsics
// (__int2float_rn, __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) and rintf,
// so the mask line s·mask + (mask−1)·big never contracts into an FMA and both
// divides are correctly rounded.  Keys beyond the true T do not exist here
// (no padding); the reference's zero-padded keys are inert because
// lut[0] == 0, so both agree.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int UNROLL = 8;  // key rows a warp has in flight (warp_sum8 takes 8)
constexpr int MAX_CLUSTER = 16;

struct Args {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  const float* mask;
  const uint8_t* lut;
  uint8_t* out;
  // batch and row strides in elements: q, k, v, mask, out
  long long q_sb, q_ss, k_sb, k_st, v_sb, v_st, m_sb, m_ss, o_sb, o_ss;
  int T, dh, nk_max;
  float qk_scale, big, lut_scale, p_scale, rescale;
  int out_uint8;
};

// Sums each of the UNROLL = 8 values acc[u] over the warp at once (a
// transpose butterfly: 4 + 2 + 1 + 2 shuffles, not 8 x 5): afterwards
// lanes 4u..4u+3 hold the sum of acc[u].  Integer sums: exact in any order.
__device__ __forceinline__ int warp_sum8(const int (&acc)[8], int lane) {
  int v4[4], v2[2];
  const bool up16 = lane & 16, up8 = lane & 8, up4 = lane & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v4[j] = (up16 ? acc[j + 4] : acc[j]) +
            __shfl_xor_sync(0xffffffffu, up16 ? acc[j] : acc[j + 4], 16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    v2[j] = (up8 ? v4[j + 2] : v4[j]) + __shfl_xor_sync(0xffffffffu, up8 ? v4[j] : v4[j + 2], 8);
  int v = (up4 ? v2[1] : v2[0]) + __shfl_xor_sync(0xffffffffu, up4 ? v2[0] : v2[1], 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// The context's epilogue: ×rescale → round half to even → clip, as a byte.
__device__ __forceinline__ uint8_t epilogue(int acc, float rescale, float lo, float hi) {
  return (uint8_t)(int)fminf(fmaxf(rintf(__fmul_rn(__int2float_rn(acc), rescale)), lo), hi);
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Instantiated twice: a lone block per row (prefill, where the rows fill the
// card) keeps to 32 registers a thread, so four 512-thread blocks share an
// SM; a cluster's blocks (decode) may take 64.  The host's thread planner
// (kernels/qattention.py::WARPS_PER_SM) counts on these caps.
template <int MIN_BLOCKS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS) qattention_kernel(const Args a) {
  namespace px = repro_ptx;
  const int C = gridDim.x;
  const int r = blockIdx.x;  // the block's rank in its (C, 1, 1) cluster
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int nthr = blockDim.x;
  const int warps = nthr >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int T = a.T, dh = a.dh, dw = dh >> 2;  // dh % 4 == 0, checked by the host
  const int lgC = __ffs(C) - 1;                // C is a power of two
  const int nd = (dh + C - 1) >> lgC;          // slots per rank of the context exchange
  const int mine = r < dh ? ((dh - 1 - r) >> lgC) + 1 : 0;  // dims d ≡ r (mod C) this rank finishes
  const bool solo = C == 1;  // one block per row: the exchanges stay inside it
  const int k0 = r * T >> lgC;  // C·T < 2^31, checked by the host
  const int n = ((r + 1) * T >> lgC) - k0;  // >= 1: the host keeps C <= T

  extern __shared__ int smem[];
  float* sc = reinterpret_cast<float*>(smem);  // nk_max masked scores
  int* wi = smem;                              // the same slots: LUT weights, then p_q
  int* part = smem + a.nk_max;                 // warps x dh partial contexts
  int* in_ctx = part + warps * dh;             // C x nd: rank j's sums of this rank's dims
  __shared__ uint32_t lut_s[64];
  __shared__ float red_f[MAX_WARPS];
  __shared__ int red_i[MAX_WARPS];
  __shared__ float in_max[MAX_CLUSTER];  // slot j: rank j's max of its scores
  __shared__ int in_den[MAX_CLUSTER];    // slot j: rank j's den
  __shared__ __align__(8) uint64_t bar[3];  // one transaction barrier per exchange

  // Each exchange's barrier expects the bytes the other C − 1 ranks will
  // store into this block (with one arrival, here) and one more arrival once
  // this block has filled its own slots by plain stores; the cluster
  // barrier's arrive now and wait before the first remote store makes the
  // barriers ready cluster-wide.
  if (!solo && tid == 0) {
    for (int e = 0; e < 3; ++e) px::mbar_init(&bar[e], 2);
    px::fence_mbar_init();
    px::mbar_arrive_expect_tx(&bar[0], 4 * (C - 1));
    px::mbar_arrive_expect_tx(&bar[1], 4 * (C - 1));
    px::mbar_arrive_expect_tx(&bar[2], 4 * (C - 1) * mine);
  }
  if (!solo) px::cluster_arrive();

  const int* qrow = reinterpret_cast<const int*>(a.q + b * a.q_sb + s * a.q_ss);
  const int k_st = (int)a.k_st, v_st = (int)a.v_st;  // row strides < 2^31, checked by the host
  const int8_t* kb = a.k + b * a.k_sb + (long long)k0 * k_st;
  const int8_t* vb = a.v + b * a.v_sb + (long long)k0 * v_st;
  const float* mrow = a.mask + b * a.m_sb + s * a.m_ss + k0;

  // the LUT's load goes out now and its store waits until after the scores;
  // in a cluster the block's V rows are asked into L2 for the context pass
  // (a lone block per row shares them with the row's neighbours through L2)
  uint32_t lutw = 0;
  if (tid < 64) lutw = __ldg(reinterpret_cast<const uint32_t*>(a.lut) + tid);
  if (!solo) {
    const int sectors = (dh + 31) >> 5;
    for (int i = tid; i < n * sectors; i += nthr)
      px::prefetch_l2(vb + (i / sectors) * v_st + (i % sectors) * 32);
  }

  // scores: a warp per key (lanes over dh in 4-byte words), UNROLL keys at
  // a time so their rows and mask values are loaded together
  const float neg_inf = __int_as_float((int)0xff800000);
  float mx = neg_inf;
  for (int t0 = wid; t0 < n; t0 += warps * UNROLL) {
    int acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = 0;
    const int tm = t0 + (lane >> 2) * warps;  // the key whose sum this lane gets
    const float mk = tm < n ? __ldg(mrow + tm) : 0.0f;
    for (int i = lane; i < dw; i += 32) {
      const int qv = __ldg(qrow + i);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = t0 + u * warps;
        if (t < n)
          acc[u] = __dp4a(qv, __ldg(reinterpret_cast<const int*>(kb + t * k_st) + i), acc[u]);
      }
    }
    const int x = warp_sum8(acc, lane);
    if ((lane & 3) == 0 && tm < n) {
      const float sf = __fmul_rn(__int2float_rn(x), a.qk_scale);
      const float masked = __fadd_rn(__fmul_rn(sf, mk), __fmul_rn(__fsub_rn(mk, 1.0f), a.big));
      sc[tm] = masked;
      mx = fmaxf(mx, masked);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red_f[wid] = mx;
  if (tid < 64) lut_s[tid] = lutw;
  __syncthreads();
  if (!solo) px::cluster_wait();

  // exchange 1: every warp forms the block's max from the warps' maxima;
  // in a cluster lane j of warp 0 stores it into slot r of rank j, and the
  // row max is the max of the C slots (fmaxf: the same in any order)
  mx = lane < warps ? red_f[lane] : neg_inf;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (!solo) {
    if (tid == r) {
      in_max[r] = mx;
      px::mbar_arrive(&bar[0]);
    } else if (tid < C) {
      px::st_async_b32(px::dsmem_addr(&in_max[r], tid), __float_as_uint(mx),
                       px::dsmem_addr(&bar[0], tid));
    }
    px::mbar_wait(&bar[0], 0);
    mx = in_max[lane & (C - 1)];  // each group of C lanes holds all C slots
    for (int o = C >> 1; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }

  // quantized score deltas → LUT weights, and their local int32 sum
  const uint8_t* lut_b = reinterpret_cast<const uint8_t*>(lut_s);
  int den = 0;
  for (int t = tid; t < n; t += nthr) {
    const float d = __fdiv_rn(__fsub_rn(sc[t], mx), a.lut_scale);
    const float dq = fminf(fmaxf(rintf(d), -128.0f), 127.0f);
    const int w = lut_b[(int)dq + 128];
    wi[t] = w;
    den += w;
  }
  den = warp_sum(den);
  if (lane == 0) red_i[wid] = den;
  __syncthreads();

  // exchange 2: the block's den likewise; the row's den is the integer sum
  // of the C slots, exact in any order
  den = warp_sum(lane < warps ? red_i[lane] : 0);
  if (!solo) {
    if (tid == r) {
      in_den[r] = den;
      px::mbar_arrive(&bar[1]);
    } else if (tid < C) {
      px::st_async_b32(px::dsmem_addr(&in_den[r], tid), (unsigned)den, px::dsmem_addr(&bar[1], tid));
    }
    px::mbar_wait(&bar[1], 0);
    den = in_den[lane & (C - 1)];
    for (int o = C >> 1; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
  }

  // int8 probabilities p_q = clip(rint(w / den · p_scale))
  const float denf = __int2float_rn(den);
  for (int t = tid; t < n; t += nthr) {
    const float p = __fdiv_rn(__int2float_rn(wi[t]), denf);
    wi[t] = (int)fminf(fmaxf(rintf(__fmul_rn(p, a.p_scale)), -128.0f), 127.0f);
  }
  __syncthreads();

  // partial context p_q · V over the block's keys.  Lane l owns head dims
  // 4l..4l+3 (one 32-bit word of each V row, so a warp reads a row's 128
  // bytes at once); warp w sums the keys t = w (mod warps), UNROLL rows at
  // a time.  The warps' sums meet in shared memory.
  for (int i = lane; i < dw; i += 32) {
    int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    for (int t0 = wid; t0 < n; t0 += warps * UNROLL) {
      int x[UNROLL], p[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = t0 + u * warps;
        x[u] = t < n ? __ldg(reinterpret_cast<const int*>(vb + t * v_st) + i) : 0;
        p[u] = t < n ? wi[t] : 0;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        a0 += p[u] * (int)(signed char)x[u];
        a1 += p[u] * (int)(signed char)(x[u] >> 8);
        a2 += p[u] * (int)(signed char)(x[u] >> 16);
        a3 += p[u] * (int)(signed char)(x[u] >> 24);
      }
    }
    int* pw = part + wid * dh + 4 * i;
    pw[0] = a0; pw[1] = a1; pw[2] = a2; pw[3] = a3;
  }
  __syncthreads();

  // exchange 3: the block's sum for dim d goes to slot (r, d / C) of rank
  // d % C, which adds the C slots of each of its dims — exact in any order
  // — and runs the epilogue ×rescale → rint → clip for them
  // 2^lgG lanes add the warps' sums of one dim together; a lone block runs
  // the epilogue ×rescale → rint → clip on it at once
  const float lo = a.out_uint8 ? 0.0f : -128.0f;
  const float hi = a.out_uint8 ? 255.0f : 127.0f;
  uint8_t* orow = a.out + b * a.o_sb + s * a.o_ss;
  const int lgG = min(31 - __clz(max(nthr / dh, 1)), __ffs(warps) - 1);
  const int G = 1 << lgG;
  for (int base = 0; base < dh << lgG; base += nthr) {
    const int idx = base + tid, d = idx >> lgG, g = idx & (G - 1);
    int acc = 0;
    if (d < dh)
      for (int w = g; w < warps; w += G) acc += part[w * dh + d];
    for (int o = G >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (d >= dh || g) continue;
    const int owner = d & (C - 1);
    if (solo)
      orow[d] = epilogue(acc, a.rescale, lo, hi);
    else if (owner == r)
      in_ctx[r * nd + (d >> lgC)] = acc;
    else
      px::st_async_b32(px::dsmem_addr(&in_ctx[r * nd + (d >> lgC)], owner), (unsigned)acc,
                       px::dsmem_addr(&bar[2], owner));
  }
  if (solo) return;
  __syncthreads();
  if (tid == 0) px::mbar_arrive(&bar[2]);  // this block's own slots are in
  px::mbar_wait(&bar[2], 0);
  // thread (i, j), j = tid mod C, takes slot j of dim i; the C lanes of a
  // dim (C divides 32) add theirs by shuffles and lane j = 0 runs the
  // epilogue
  for (int base = 0; base < mine << lgC; base += nthr) {
    const int idx = base + tid, i = idx >> lgC, j = idx & (C - 1);
    int acc = i < mine ? in_ctx[j * nd + i] : 0;
    for (int o = C >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (i < mine && j == 0) orow[r + (i << lgC)] = epilogue(acc, a.rescale, lo, hi);
  }
  // Every block waits for all the bytes stored into it before it leaves, so
  // no store reaches a block that has left.
}

size_t smem_bytes(int nk_max, int dh, int threads, int cluster) {
  const size_t nd = (dh + cluster - 1) / cluster;
  return ((size_t)nk_max + (size_t)(threads / 32) * dh + cluster * nd) * sizeof(int);
}

using Kernel = void (*)(Args);

// 512-thread blocks an SM holds: 4 alone (32 registers), 2 in a cluster (64).
Kernel kernel_for(int cluster) {
  return cluster == 1 ? qattention_kernel<4> : qattention_kernel<2>;
}

// Once per device: allow all the dynamic shared memory a block can opt into,
// and clusters of 16 (beyond the portable 8).
cudaError_t configure() {
  static bool done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const Kernel kernels[2] = {kernel_for(1), kernel_for(2)};
  for (const Kernel k : kernels) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, k);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

// The launch shape of one (cluster, threads) choice at T keys; invalid
// choices give cudaErrorInvalidValue.
cudaError_t launch_config(int S, int B, int T, int dh, int cluster, int threads,
                          cudaStream_t stream, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr) {
  if (T <= 0 || dh <= 0 || dh % 4 || S > 65535 || B > 65535 || cluster < 1 ||
      cluster > MAX_CLUSTER || (cluster & (cluster - 1)) || cluster > T ||
      (long long)cluster * T >= (1LL << 31) || threads < 32 || threads > MAX_THREADS || threads % 32)
    return cudaErrorInvalidValue;
  const int nk_max = (T + cluster - 1) / cluster;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, S, B);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem_bytes(nk_max, dh, threads, cluster);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = cluster > 1;  // a lone block per row is a plain launch
  return configure();
}

}  // namespace

// q (B, S, dh), k and v (B, T, dh) int8; mask (B, S, T) f32 in {0, 1};
// lut (256,) uint8, 4-byte aligned; out (B, S, dh) int8/uint8.  strides
// holds ten batch and row strides in elements — q, k, v, mask, out — each
// operand's innermost stride being 1; q, k and v bases and strides are
// multiples of 4 bytes, dh % 4 == 0.  The row's keys are split over
// `cluster` blocks of `threads` threads.  Returns a cudaError_t.
extern "C" int repro_qattention(const void* q, const void* k, const void* v,
                                const void* mask, const void* lut, void* out,
                                const long long* strides, int B, int S, int T, int dh,
                                int cluster, int threads, float qk_scale, float big,
                                float lut_scale, float p_scale, float rescale,
                                int out_uint8, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = launch_config(S, B, T, dh, cluster, threads, (cudaStream_t)stream, &cfg, attr);
  if (e != cudaSuccess) return (int)e;
  const Args a{(const int8_t*)q, (const int8_t*)k, (const int8_t*)v, (const float*)mask,
               (const uint8_t*)lut, (uint8_t*)out,
               strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               T, dh, (T + cluster - 1) / cluster,
               qk_scale, big, lut_scale, p_scale, rescale, out_uint8};
  e = cudaLaunchKernelEx(&cfg, kernel_for(cluster), a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of this launch shape the card can hold at once
// (cudaOccupancyMaxActiveClusters): 0 means the shape cannot be scheduled.
extern "C" int repro_qattention_max_clusters(int T, int dh, int cluster, int threads,
                                             int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = launch_config(1, 1, T, dh, cluster, threads, 0, &cfg, attr);
  if (e != cudaSuccess) return (int)e;
  cfg.numAttrs = 1;  // a lone block per row counts as a cluster of one here
  e = cudaOccupancyMaxActiveClusters(count, (const void*)kernel_for(cluster), &cfg);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
