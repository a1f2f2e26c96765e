// The decode step's KV update as one launch, for Hopper (sm_90a): in the
// int8 cache s (N, R, W), every row whose onehot byte h[n, r] is non-zero
// becomes s[n, r, :] * (1 - h) + x[n, 0, :] * h, wrapping in int8 as the
// codified Sub, Mul, Mul and Add do; every other row is left as it is.
//
// No TPU kernel: repro runs the update (serving/token_path.py::_kv_update,
// Add(Mul(S, Sub(1, H)), Mul(X, H))) as four whole-cache elementwise ops.
// The port's compiler matches that region (core/compile.py) and lowers it
// to this step.
//
// Bound on an H100: the four ops move the whole cache six times (three
// reads, three writes of N x R x W bytes: 151 MB a cache at the benchmark's
// decode cell, 16 x 4,096 x 2,304), and a CUDA graph copies it back once
// more.  The update itself needs the N x R onehot bytes read and, at one
// new row a slot, N x W bytes read twice and written once (~0.2 MB), so a
// launch is bound by its latency.
// What the design does about it:
//   * a block takes one slot and 4,096 of its rows: its threads scan the
//     onehot bytes in coalesced loads and list the rows whose byte is
//     non-zero in shared memory;
//   * the block then writes the listed rows together, 16 bytes a thread
//     (every cache the port builds has W = KV heads x head_dim and row
//     strides that are multiples of 16; the wrapper refuses other
//     operands), so any number of non-zero rows a slot is handled, not
//     only one;
//   * the cache is written in place: the executor that owns its buffer
//     passes the buffer, any other caller a copy (kernels/kv_write.py).
//
// Exactness: integer arithmetic only; a sum reduced to int8 is its value
// modulo 256, which is what each wrapping int8 op of the codified update
// keeps, so the row equals theirs bit for bit for any int8 h.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4096;  // the rows of a slot one block scans

__device__ __forceinline__ int8_t update(int8_t s, int8_t x, int h) {
  return (int8_t)((int)s * (1 - h) + (int)x * h);
}

union Vec16 {
  uint4 v;
  int8_t b[16];
};

// grid (N, ceil(R / ROWS)); s (N, R, W) contiguous, h (N, R) contiguous,
// x row n at x + n * x_stride (W contiguous bytes); W, x_stride and both
// bases multiples of 16.
__global__ void __launch_bounds__(THREADS)
kv_write_kernel(int8_t* s, const int8_t* __restrict__ h, const int8_t* __restrict__ x, int R,
                int W, long long x_stride) {
  __shared__ int rows[ROWS];
  __shared__ int count;
  const int n = blockIdx.x, r0 = blockIdx.y * ROWS, tid = threadIdx.x;
  const int r1 = min(R, r0 + ROWS);
  const int8_t* hn = h + (size_t)n * R;
  if (tid == 0) count = 0;
  __syncthreads();
  for (int r = r0 + tid; r < r1; r += THREADS)
    if (hn[r] != 0) rows[atomicAdd(&count, 1)] = r;
  __syncthreads();
  const int listed = count;
  if (listed == 0) return;
  const int per_row = W / 16;
  const int8_t* xn = x + (size_t)n * x_stride;
  for (int i = tid; i < listed * per_row; i += THREADS) {
    const int r = rows[i / per_row], c = (i % per_row) * 16;
    const int hv = hn[r];
    int8_t* dst = s + ((size_t)n * R + r) * W + c;
    Vec16 a, b;
    a.v = *reinterpret_cast<const uint4*>(dst);
    b.v = *reinterpret_cast<const uint4*>(xn + c);
#pragma unroll
    for (int k = 0; k < 16; ++k) a.b[k] = update(a.b[k], b.b[k], hv);
    *reinterpret_cast<uint4*>(dst) = a.v;
  }
}

}  // namespace

// s (N, R, W) int8, written in place; h (N, R, 1) int8; x (N, 1, W) int8
// with row stride x_stride bytes.  Returns cudaErrorInvalidValue for
// operands off 16 bytes, else cudaGetLastError() after the launch.
extern "C" int repro_kv_write(void* s, const void* h, const void* x, int N, int R, int W,
                              long long x_stride, void* stream) {
  if (N <= 0 || R <= 0 || W <= 0) return (int)cudaSuccess;
  const unsigned chunks = (unsigned)((R + ROWS - 1) / ROWS);
  if (chunks > 65535u) return (int)cudaErrorInvalidValue;
  if (W % 16 != 0 || x_stride % 16 != 0 || reinterpret_cast<uintptr_t>(s) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  kv_write_kernel<<<dim3((unsigned)N, chunks), THREADS, 0, (cudaStream_t)stream>>>(
      (int8_t*)s, (const int8_t*)h, (const int8_t*)x, R, W, x_stride);
  return (int)cudaGetLastError();
}
