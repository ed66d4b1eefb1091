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
// this times K4's code, and the parameters are K4's [40] float block
// (ops/megakernel.py _float_params' layout), staged in shared memory as K4
// stages them.  The `+ it` keeps the compiler from hoisting the raygen out
// of the loop.  Built with -fmad=false (ops/_build.py).
//
// Design: one thread per cell, as one K4 thread owns one pixel's samples;
// the grid's y dimension repeats the whole function `programs` times (the
// TPU grid of 8 programs over one (8, 128) block), each program writing
// its own row of the output.
//
// What bounds it: per raygen ~30 integer operations (the PCG steps, the
// div/mod of the pixel and sample ids) and ~100 FP32 operations with a
// sqrt, a division, sinf and cosf (counted in chip_smoke.py), against 8
// bytes of device memory per cell for the whole loop: the ALUs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raygen.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRaygenParams = kRecipSqrtSpp + 1;  // the slots get_ray reads

constexpr int kBase = 0;
constexpr int kNoDof = 1;
constexpr int kPackedPx = 2;

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

}  // namespace

// fparams: [40] float32 (K4's layout); pix: [n] int32; out: [programs, n]
// float32.  variant: 0 base, 1 nodof, 2 packedpx.  Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int micro_raygen_launch(const void* fparams, const void* pix, int n, int iters,
                                   int width, int height, int sqrt_spp, int variant,
                                   int programs, void* out, void* stream) {
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
