// int8 activation through an exact 256-entry table, for Hopper (sm_90a):
// out[i] = table[(int)(int8_t)x[i] + 128], the table int8 or uint8 (the same
// byte gather either way).
//
// Replaces the TPU kernel repro/kernels/qact_lut.py::qact_lut (_lut_kernel).
// Its one_hot option, which lowers the lookup as a one-hot matmul because
// some TPU generations lack a fast gather, has no counterpart here: a shared
// memory lookup is the GPU's gather.
//
// Bound on an H100: the work is one byte read and one byte written per
// element, 2 * numel bytes at 3.35 TB/s.  At the served MLP's shapes
// (<= 64 rows x 6144) that is under 1 us, so a launch is bound by launch
// latency, not by the card.  So on the main path the table rides in the
// epilogue of the qmatmul that produces the LUT's input (csrc/qmatmul.cu;
// the plan folds it there, core/compile.py::Compiler._fold_lut_epilogues),
// and this kernel serves the LUTs the plan does not fold: one on a graph
// input, or on a value that another step or the graph's outputs read too.
// What the design does about the bytes:
//   * the table is copied to shared memory once per block;
//   * each thread moves 16 bytes per step, one 16-byte load and (when x and
//     out share their alignment) one 16-byte store, in a grid-stride loop;
//   * a byte loop takes the head up to x's first 16-byte boundary and the
//     tail after the last whole 16 bytes, so any base and any numel work.
//
// The index is (int)(int8_t)x + 128: a plain char's signedness is the
// compiler's choice, so it never appears here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // one table entry per thread at the copy

__device__ __forceinline__ uint8_t lookup(const uint8_t* tab, uint8_t code) {
  return tab[(int)(int8_t)code + 128];
}

__device__ __forceinline__ unsigned gather_word(const uint8_t* tab, unsigned v) {
  unsigned o = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    o |= (unsigned)lookup(tab, (uint8_t)(v >> (8 * b))) << (8 * b);
  return o;
}

__global__ void __launch_bounds__(THREADS)
qact_lut_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ lut,
                uint8_t* __restrict__ out, long long n, long long head,
                long long nvec, int vec_store) {
  __shared__ uint8_t tab[256];
  tab[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();

  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  // head: the bytes before x's first 16-byte boundary (fewer than 16)
  if (tid < head) out[tid] = lookup(tab, x[tid]);
  // body: nvec runs of 16 bytes starting at x + head, which is 16-aligned
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (long long i = tid; i < nvec; i += stride) {
    const uint4 v = xv[i];
    uint4 o;
    o.x = gather_word(tab, v.x);
    o.y = gather_word(tab, v.y);
    o.z = gather_word(tab, v.z);
    o.w = gather_word(tab, v.w);
    uint8_t* dst = out + head + 16 * i;
    if (vec_store) {
      *reinterpret_cast<uint4*>(dst) = o;
    } else {  // out is not aligned like x: store the 16 bytes one by one
      const unsigned w[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int b = 0; b < 16; ++b) dst[b] = (uint8_t)(w[b / 4] >> (8 * (b % 4)));
    }
  }
  // tail: the bytes after the last whole 16 (fewer than 16)
  const long long t0 = head + 16 * nvec;
  if (tid < n - t0) out[t0 + tid] = lookup(tab, x[t0 + tid]);
}

}  // namespace

// x (n,) int8 at any alignment; lut (256,) int8 or uint8; out (n,) of lut's
// type.  The caller passes contiguous tensors as flat byte arrays.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_qact_lut(const void* x, const void* lut, void* out,
                              long long n, int max_blocks, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (max_blocks < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  long long head = (long long)((16 - xa % 16) % 16);
  if (head > n) head = n;
  const long long nvec = (n - head) / 16;
  const int vec_store = (xa % 16) == (oa % 16);
  long long blocks = (nvec + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > max_blocks) blocks = max_blocks;
  qact_lut_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const uint8_t*)lut, (uint8_t*)out, n, head, nvec,
      vec_store);
  return (int)cudaGetLastError();
}
