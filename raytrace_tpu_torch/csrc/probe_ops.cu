// Dev probe P1: ten small kernels, one for each op-support probe of the
// TPU's fused bounce kernel.
//
// Replaces the TPU kernels of tools_dev/probe_pallas.py (each body of
// main, launched by run): there each probe checked that Mosaic lowers one
// operation the fused kernel needs (transcendentals, uint32 PCG math, a
// gather, scalar table reads, loops and branches on data) and that it
// agrees with XLA.  Here each probe is the same function written in K4's
// language, CUDA C++ built with -fmad=false (ops/_build.py), and is held
// against its plain PyTorch version (raytrace_tpu_torch/tools_dev/
// probe_ops.py), which repeats the kernel's operations in the same order:
//
//   0 sin+cos           sinf(x) + cosf(x)
//   1 pcg-rng           one PCG step and word of K4's random_float
//                       (raygen.cuh), over uint32
//   2 onehot-fetch      out[r, c] = rows_t[r, prim[c]]: the column gather
//                       the TPU did as a one-hot matmul, here a direct read
//                       (an id outside [0, cols) gives NaN; the plain
//                       version raises)
//   3 smem-scalar-loop  the table staged in shared memory, then
//                       acc = acc + tab[i, 0] * x for i ascending
//   4 while-loop        a while loop on a runtime count adding x
//   5 lax-cond-datadep  a block-wide sum decides x * 2 or x
//   6 pl-when-datadep   the same sum guards a second, predicated store
//   7 vmem-scalar-read  tab[3, 0] * x
//   8 vmem-dynrow-read  tab[row, 0] * x, row given at run time
//   9 pow-exp-log       xs = x * 0.1; (1 - xs)^5 by JAX's integer_pow
//                       multiplications, b * ((b * b) * (b * b)), then
//                       + expf(-xs) + logf(xs + 1)
//
// The block-wide sum of probes 5 and 6 (the TPU summed its whole (8, 128)
// block) runs in one block of 1024 threads: a butterfly of
// __shfl_xor_sync inside each warp, the 32 warp sums through shared
// memory, and the same butterfly over them in every warp, so every thread
// holds the total without a second barrier.  Only its sign or size
// decides, so its order cannot change the output.
//
// What bounds it: at the probes' (8, 128) shapes each launch moves a few
// KiB and does a few thousand operations, far below a microsecond of the
// card's rates: every probe is bound by its launch, which is what its time
// measures.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raygen.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockSum = 1024;  // the one block of probes 5 and 6

enum Probe {
  kSinCos = 0,
  kPcgRng = 1,
  kOnehotFetch = 2,
  kSmemScalarLoop = 3,
  kWhileLoop = 4,
  kCondDatadep = 5,
  kWhenDatadep = 6,
  kVmemScalarRead = 7,
  kVmemDynrowRead = 8,
  kPowExpLog = 9,
};

__global__ void __launch_bounds__(kThreads) sin_cos(const float* __restrict__ x, int n,
                                                    float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = sinf(x[i]) + cosf(x[i]);
}

__global__ void __launch_bounds__(kThreads) pcg_rng(const uint32_t* __restrict__ u, int n,
                                                    float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t state = u[i];
  out[i] = random_float(state);
}

// rows_t: [rows, cols]; prim: [n]; out: [rows, n].
__global__ void __launch_bounds__(kThreads) onehot_fetch(const float* __restrict__ rows_t,
                                                         int rows, int cols,
                                                         const int* __restrict__ prim, int n,
                                                         float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * n) return;
  const int r = i / n;
  const int p = prim[i % n];
  out[i] = (p >= 0 && p < cols) ? rows_t[r * cols + p] : __int_as_float(0x7fc00000);
}

// tab: [rows, cols], staged whole in dynamic shared memory.
__global__ void __launch_bounds__(kThreads) smem_scalar_loop(const float* __restrict__ tab,
                                                             int rows, int cols,
                                                             const float* __restrict__ x,
                                                             int n, float* __restrict__ out) {
  extern __shared__ float s_tab[];
  for (int j = threadIdx.x; j < rows * cols; j += kThreads) s_tab[j] = tab[j];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float acc = 0.0f;
  for (int r = 0; r < rows; ++r) acc = acc + s_tab[r * cols] * xi;
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads) while_loop(const float* __restrict__ x, int n,
                                                       int count, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float acc = 0.0f;
  int k = 0;
  while (k < count) {
    acc = acc + xi;
    ++k;
  }
  out[i] = acc;
}

// The sum of v over the block's 1024 threads, in every thread.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kBlockSum / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_sums[threadIdx.x & 31];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kBlockSum) cond_datadep(const float* __restrict__ x, int n,
                                                          float* __restrict__ out) {
  const int i = threadIdx.x;
  const float xi = i < n ? x[i] : 0.0f;
  const float s = block_sum(xi);
  if (i < n) out[i] = s > 0.0f ? xi * 2.0f : xi;
}

__global__ void __launch_bounds__(kBlockSum) when_datadep(const float* __restrict__ x, int n,
                                                          float* __restrict__ out) {
  const int i = threadIdx.x;
  const float xi = i < n ? x[i] : 0.0f;
  const float s = block_sum(xi);
  if (i >= n) return;
  out[i] = xi;
  if (s > 1e9f) out[i] = xi * 3.0f;
}

// tab: [rows, cols]; reads tab[row, 0] (row 3 for the scalar-read probe).
__global__ void __launch_bounds__(kThreads) scale_by_row(const float* __restrict__ tab,
                                                         int cols, int row,
                                                         const float* __restrict__ x, int n,
                                                         float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = tab[row * cols] * x[i];
}

__global__ void __launch_bounds__(kThreads) pow_exp_log(const float* __restrict__ x, int n,
                                                        float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xs = x[i] * 0.1f;
  const float b = 1.0f - xs;
  const float b2 = b * b;
  const float b4 = b2 * b2;
  out[i] = b * b4 + expf(-xs) + logf(xs + 1.0f);
}

}  // namespace

// Launches probe `probe` (the Probe numbers above) on `stream` without
// synchronising and returns cudaGetLastError().  x: the probe's [n] input
// (float32; uint32 bits for pcg-rng; the [n] int32 ids for onehot-fetch);
// tab: the [rows, cols] float32 table of probes 2, 3, 7 and 8 (else
// unused); arg: the while loop's count, or the dynamic row; out: [n]
// float32 ([rows, n] for onehot-fetch).  The wrapper checks the shapes:
// n <= 1024 for probes 5 and 6, rows * cols * 4 <= 48 KiB for probe 3.
extern "C" int probe_ops_launch(int probe, const void* x, const void* tab, int n, int rows,
                                int cols, int arg, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(tab);
  float* o = static_cast<float*>(out);
  const int blocks = (n + kThreads - 1) / kThreads;
  switch (probe) {
    case kSinCos:
      sin_cos<<<blocks, kThreads, 0, s>>>(xf, n, o);
      break;
    case kPcgRng:
      pcg_rng<<<blocks, kThreads, 0, s>>>(static_cast<const uint32_t*>(x), n, o);
      break;
    case kOnehotFetch:
      onehot_fetch<<<(rows * n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
          tf, rows, cols, static_cast<const int*>(x), n, o);
      break;
    case kSmemScalarLoop:
      smem_scalar_loop<<<blocks, kThreads, rows * cols * sizeof(float), s>>>(tf, rows, cols,
                                                                             xf, n, o);
      break;
    case kWhileLoop:
      while_loop<<<blocks, kThreads, 0, s>>>(xf, n, arg, o);
      break;
    case kCondDatadep:
      cond_datadep<<<1, kBlockSum, 0, s>>>(xf, n, o);
      break;
    case kWhenDatadep:
      when_datadep<<<1, kBlockSum, 0, s>>>(xf, n, o);
      break;
    case kVmemScalarRead:
      scale_by_row<<<blocks, kThreads, 0, s>>>(tf, cols, 3, xf, n, o);
      break;
    case kVmemDynrowRead:
      scale_by_row<<<blocks, kThreads, 0, s>>>(tf, cols, arg, xf, n, o);
      break;
    case kPowExpLog:
      pow_exp_log<<<blocks, kThreads, 0, s>>>(xf, n, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_ops_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
