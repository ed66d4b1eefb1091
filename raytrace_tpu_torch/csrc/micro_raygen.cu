// Dev probe P3: K4's raygen alone, as a micro-benchmark.
//
// Replaces the TPU kernel of tools_dev/micro_raygen.py (kernel, launched
// by run), which timed the fused kernel's raygen without the bounce loop.
// It computes what that kernel computes: for each cell, with sip = 0 and
// acc = 0, `iters` times
//     batch, s = sip / spp, sip % spp
//     st = init_rng(batch, s, py, px, width, height, spp) + it
//     (st, o, d) = get_ray(st, px, py, s % sqrt_spp, s / sqrt_spp)
//     acc = acc + o.x + o.y + o.z + d.x + d.y + d.z + random_float(st)
//     sip = (sip + 1) % (spp * 24)
// where the cell's pixel id gives px = pix % width, py = pix / width, or,
// in the packedpx variant, px = pix & 2047, py = pix >> 11; the nodof
// variant leaves out the thin-lens sample.  init_rng, random_float and
// get_ray are K4's own (raygen.cuh, which csrc/megakernel.cu includes), so
// this times K4's code; the parameters are the first slots of K4's [40]
// float block (ops/megakernel.py _float_params' layout).  The `+ it` keeps
// the compiler from hoisting the raygen out of the loop.  Built with
// -fmad=false (ops/_build.py).  The grid's y dimension repeats the whole
// function `programs` times (the TPU grid of 8 programs over one (8, 128)
// block), each program computing and writing its own row of the output.
//
// What bounds it: per raygen ~60 integer operations (the PCG steps, the
// sample ids) and ~140 FP32 operations with a sqrt, a division, sinf and
// cosf (counted in tools/smoke_lib.py RAYGEN_OPS), against 8 bytes of
// device memory per cell for the whole loop: the ALUs, once the card is
// full of independent raygens.
//
// Design: two kernels, chosen by the wrapper from the cells' count
// (tools_dev/micro_raygen.py splits).
// - Where the cells fill the card (a cell per pixel-sample of a batch,
//   3,240,000), one thread a cell runs the loop, as one K4 thread owns one
//   pixel's samples.  The parameters sit in __constant__ memory, copied
//   there on the stream before each launch, so no block stages them behind
//   a barrier; the pixel's row is a multiply-high by a divisor's magic
//   number computed on the host.
// - Where they do not (the JAX layout: 8 x 1,024 cells, 20,000 iterations
//   each), one thread a cell would leave most of the card idle behind a
//   chain of 20,000 dependent raygens.  Every iteration has a closed form
//   (sip = it mod (spp * 24), state = init_rng(...) + it), so any lane can
//   compute any iteration: a block takes 32 cells of one program; its
//   kProducers producer warps each compute one iteration of all 32 cells
//   a chunk (kChunk consecutive iterations), writing each raygen's seven
//   terms (o, d and the last random float) into a two-stage ring in shared
//   memory; its consumer warp, one lane a cell, adds the previous chunk's
//   terms in iteration order, seven dependent adds an iteration, as the
//   loop above does, so the sums are its bits.  A __syncthreads() a chunk
//   hands the stages over.  32 cells a block give 256 blocks for the JAX
//   layout: two on each of the 132 multiprocessors but eight, 50 warps of
//   at most 40 registers (24 producer warps a block measured 2.3% faster
//   than 16, PERF.md §6).
// The loop above, one thread a cell with the parameters staged in shared
// memory, stays as a check-only entry point (micro_raygen_sequential_launch).

#include <cuda_runtime.h>
#include <stdint.h>

#include "raygen.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRaygenParams = kRecipSqrtSpp + 1;  // the slots get_ray reads

constexpr int kBase = 0;
constexpr int kNoDof = 1;
constexpr int kPackedPx = 2;

// The split kernel: cells a block (its consumer warp's lanes), producer
// warps, iterations a chunk (one a producer warp), terms a raygen.
constexpr int kCells = 32;
constexpr int kProducers = 24;
constexpr int kChunk = kProducers;
constexpr int kTerms = 7;
constexpr int kSplitThreads = (kProducers + 1) * 32;
// A producer steps its sip by kChunk with one conditional subtraction of
// the period spp * 24, which is at least 24.
static_assert(kChunk <= 24, "a chunk must not exceed the shortest sample period");

__constant__ float c_prm[kRaygenParams];

// Division by the image width, n / d for n >= 0, as a multiply-high by a
// magic number m and two shifts (the branch-free unsigned form of
// Granlund and Montgomery; tools_dev/micro_raygen.py divisor computes m
// and the shifts and holds the same arithmetic to n // d).
struct Divisor {
  uint32_t m;
  int sh1, sh2;
};

__device__ __forceinline__ int divide(int n, Divisor dv) {
  const uint32_t u = static_cast<uint32_t>(n);
  const uint32_t t = __umulhi(dv.m, u);
  return static_cast<int>((t + ((u - t) >> dv.sh1)) >> dv.sh2);
}

// The cell's pixel: packed, or divided by the width (n / d and n % d as C
// computes them, so a negative id divides as in the sequential loop).
template <int kVariant>
__device__ __forceinline__ void decode(int p, int width, Divisor dv, int& px, int& py) {
  if (kVariant == kPackedPx) {
    px = p & 2047;
    py = p >> 11;
  } else {
    py = p >= 0 ? divide(p, dv) : p / width;
    px = p - py * width;
  }
}

// One iteration's raygen of a cell, at sample-in-period sip.
template <int kVariant>
__device__ __forceinline__ void raygen(int it, int sip, int px, int py, int width, int height,
                                       int sqrt_spp, int spp, V3& o, V3& d, float& f) {
  const int batch = sip / spp;
  const int s = sip % spp;
  uint32_t state = init_rng(static_cast<uint32_t>(batch), static_cast<uint32_t>(s),
                            static_cast<uint32_t>(py), static_cast<uint32_t>(px),
                            static_cast<uint32_t>(width), static_cast<uint32_t>(height),
                            static_cast<uint32_t>(spp));
  state += static_cast<uint32_t>(it);
  get_ray(state, c_prm, px, py, s % sqrt_spp, s / sqrt_spp, width, height, kVariant != kNoDof,
          o, d);
  f = random_float(state);
}

// One thread a cell, the whole loop.
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
raygen_cells(const int* __restrict__ pix, int n, int iters, int width, int height, int sqrt_spp,
             Divisor dv, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int px, py;
  decode<kVariant>(pix[i], width, dv, px, py);
  const int spp = sqrt_spp * sqrt_spp;
  const int period = spp * 24;
  float acc = 0.0f;
  int sip = 0;
  for (int it = 0; it < iters; ++it) {
    V3 o, d;
    float f;
    raygen<kVariant>(it, sip, px, py, width, height, sqrt_spp, spp, o, d, f);
    acc = acc + o.x + o.y + o.z + d.x + d.y + d.z + f;
    if (++sip == period) sip = 0;
  }
  out[static_cast<size_t>(blockIdx.y) * n + i] = acc;
}

// A block a (32 cells, program): kProducers producer warps and one
// consumer warp over a two-stage ring of chunks (the header says why).
template <int kVariant>
__global__ void __launch_bounds__(kSplitThreads, 2)
raygen_split(const int* __restrict__ pix, int n, int iters, int width, int height, int sqrt_spp,
             Divisor dv, float* __restrict__ out) {
  __shared__ float ring[2][kChunk][kTerms][kCells];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cell = blockIdx.x * kCells + lane;
  const bool consumer = warp == kProducers;
  const int n_chunks = (iters + kChunk - 1) / kChunk;
  const int spp = sqrt_spp * sqrt_spp;
  const int period = spp * 24;
  int px, py;
  decode<kVariant>(pix[min(cell, n - 1)], width, dv, px, py);
  int sip = warp;  // producer warp w computes iterations w, w + kChunk, ...
  float acc = 0.0f;
  // Step c: the producers write chunk c into stage c & 1 while the
  // consumer adds chunk c - 1 from the other stage; the barrier ends both.
  for (int c = 0; c <= n_chunks; ++c) {
    if (!consumer) {
      const int it = c * kChunk + warp;
      if (it < iters) {
        V3 o, d;
        float f;
        raygen<kVariant>(it, sip, px, py, width, height, sqrt_spp, spp, o, d, f);
        float(&t)[kTerms][kCells] = ring[c & 1][warp];
        t[0][lane] = o.x;
        t[1][lane] = o.y;
        t[2][lane] = o.z;
        t[3][lane] = d.x;
        t[4][lane] = d.y;
        t[5][lane] = d.z;
        t[6][lane] = f;
      }
      sip += kChunk;
      if (sip >= period) sip -= period;
    } else if (c > 0) {
      const int k_end = min(kChunk, iters - (c - 1) * kChunk);
      const float(&ch)[kChunk][kTerms][kCells] = ring[(c - 1) & 1];
      for (int k = 0; k < k_end; ++k) {
#pragma unroll
        for (int j = 0; j < kTerms; ++j) acc = acc + ch[k][j][lane];
      }
    }
    __syncthreads();
  }
  if (consumer && cell < n) out[static_cast<size_t>(blockIdx.y) * n + cell] = acc;
}

// The check-only entry point: the loop one thread a cell, the parameters
// staged in shared memory behind a barrier and the pixel divided by the
// runtime width, as the probe ran before the split.
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
micro_raygen(const float* __restrict__ fparams, const int* __restrict__ pix, int n, int iters,
             int width, int height, int sqrt_spp, float* __restrict__ out) {
  __shared__ float prm[kRaygenParams];
  for (int j = threadIdx.x; j < kRaygenParams; j += kThreads) prm[j] = fparams[j];
  __syncthreads();

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int p = pix[i];
  const int px = kVariant == kPackedPx ? (p & 2047) : p % width;
  const int py = kVariant == kPackedPx ? (p >> 11) : p / width;
  const int spp = sqrt_spp * sqrt_spp;
  const int period = spp * 24;
  float acc = 0.0f;
  int sip = 0;
  for (int it = 0; it < iters; ++it) {
    const int batch = sip / spp;
    const int s = sip % spp;
    uint32_t state = init_rng(static_cast<uint32_t>(batch), static_cast<uint32_t>(s),
                              static_cast<uint32_t>(py), static_cast<uint32_t>(px),
                              static_cast<uint32_t>(width), static_cast<uint32_t>(height),
                              static_cast<uint32_t>(spp));
    state += static_cast<uint32_t>(it);
    V3 o, d;
    get_ray(state, prm, px, py, s % sqrt_spp, s / sqrt_spp, width, height,
            kVariant != kNoDof, o, d);
    acc = acc + o.x + o.y + o.z + d.x + d.y + d.z + random_float(state);
    sip = (sip + 1) % period;
  }
  out[static_cast<size_t>(blockIdx.y) * n + i] = acc;
}

template <int kVariant>
void launch(bool split, dim3 grid_cells, dim3 grid_split, cudaStream_t s, const int* p, int n,
            int iters, int width, int height, int sqrt_spp, Divisor dv, float* o) {
  if (split) {
    raygen_split<kVariant><<<grid_split, kSplitThreads, 0, s>>>(p, n, iters, width, height,
                                                                sqrt_spp, dv, o);
  } else {
    raygen_cells<kVariant><<<grid_cells, kThreads, 0, s>>>(p, n, iters, width, height, sqrt_spp,
                                                           dv, o);
  }
}

}  // namespace

// fparams: [40] float32 (K4's layout), on the card; pix: [n] int32; out:
// [programs, n] float32.  variant: 0 base, 1 nodof, 2 packedpx; split:
// the split kernel, else one thread a cell; (div_m, div_sh1, div_sh2): the
// width's divisor (tools_dev/micro_raygen.py divisor).  Copies the
// parameters into constant memory and launches on `stream` without
// synchronising (two launches on two streams at once would share the
// copy); returns the first CUDA error.
extern "C" int micro_raygen_launch(const void* fparams, const void* pix, int n, int iters,
                                   int width, int height, int sqrt_spp, unsigned div_m,
                                   int div_sh1, int div_sh2, int variant, int programs,
                                   int split, void* out, void* stream) {
  if (variant < kBase || variant > kPackedPx) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && programs > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = cudaMemcpyToSymbolAsync(c_prm, fparams, sizeof(c_prm), 0,
                                                    cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_cells((n + kThreads - 1) / kThreads, programs);
    const dim3 grid_split((n + kCells - 1) / kCells, programs);
    const Divisor dv = {div_m, div_sh1, div_sh2};
    const int* p = static_cast<const int*>(pix);
    float* o = static_cast<float*>(out);
    if (variant == kBase) {
      launch<kBase>(split, grid_cells, grid_split, s, p, n, iters, width, height, sqrt_spp, dv, o);
    } else if (variant == kNoDof) {
      launch<kNoDof>(split, grid_cells, grid_split, s, p, n, iters, width, height, sqrt_spp, dv,
                     o);
    } else {
      launch<kPackedPx>(split, grid_cells, grid_split, s, p, n, iters, width, height, sqrt_spp,
                        dv, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The check-only sequential loop, same arguments as before the split.
extern "C" int micro_raygen_sequential_launch(const void* fparams, const void* pix, int n,
                                              int iters, int width, int height, int sqrt_spp,
                                              int variant, int programs, void* out,
                                              void* stream) {
  if (n > 0 && programs > 0) {
    const dim3 grid((n + kThreads - 1) / kThreads, programs);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* f = static_cast<const float*>(fparams);
    const int* p = static_cast<const int*>(pix);
    float* o = static_cast<float*>(out);
    switch (variant) {
      case kBase:
        micro_raygen<kBase><<<grid, kThreads, 0, s>>>(f, p, n, iters, width, height, sqrt_spp, o);
        break;
      case kNoDof:
        micro_raygen<kNoDof><<<grid, kThreads, 0, s>>>(f, p, n, iters, width, height, sqrt_spp,
                                                       o);
        break;
      case kPackedPx:
        micro_raygen<kPackedPx><<<grid, kThreads, 0, s>>>(f, p, n, iters, width, height,
                                                          sqrt_spp, o);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* micro_raygen_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
