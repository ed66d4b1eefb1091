// Dev probe P2: the sphere-UV trigonometry of K4's image form, alone.
//
// Replaces the TPU kernel of tools_dev/probe_trig.py (kernel, launched by
// main), which checked that Mosaic lowers arctan2 and arccos:
//     u = (atan2(x, -x + 0.3) / 2 pi) floor-mod 1
//     v = acos(clip(x * 0.5, -1, 1)) / pi
//     out = u + v
// written as csrc/megakernel.cu's image form writes a sphere's UV: native
// atan2f and acosf, the scale by the float reciprocals of 2 pi and pi (as
// PyTorch's CUDA division by a Python number does), and the floor-mod as
// fmodf with its sign fix-up (torch.remainder, K4's rem1).  The probe's
// arguments differ from K4's by operations on the input: K4 takes
// atan2f(n.z, -n.x) and acosf(clamp(-n.y)) of a unit normal, the probe
// atan2f(x, -x + 0.3f) and acosf(clamp(x * 0.5f)); this kernel follows the
// probe.  Built with -fmad=false (ops/_build.py).
//
// What bounds it: 8 bytes of device memory an element against ~10
// operations (atan2f and acosf counted once each), so at 2^24 elements it
// is bound by bytes; at the probe's (8, 128) by its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// float32 roundings of the constants, as K4 holds them.
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);

// torch.remainder(x, 1.0), as csrc/megakernel.cu's rem1.
__device__ __forceinline__ float rem1(float x) {
  const float m = fmodf(x, 1.0f);
  return m < 0.0f ? m + 1.0f : m;
}

__global__ void __launch_bounds__(kThreads) probe_trig(const float* __restrict__ x, int n,
                                                       float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  const float u = rem1(atan2f(xi, -xi + 0.3f) * (1.0f / kTwoPi));
  const float v = acosf(fminf(fmaxf(xi * 0.5f, -1.0f), 1.0f)) * (1.0f / kPi);
  out[i] = u + v;
}

}  // namespace

// x, out: [n] float32.  Launches on `stream` without synchronising and
// returns cudaGetLastError().
extern "C" int probe_trig_launch(const void* x, int n, void* out, void* stream) {
  if (n > 0) {
    probe_trig<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_trig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
