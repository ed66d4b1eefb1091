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
// x - floorf(x) (K4's fract).  The probe's arguments differ from K4's by
// operations on the input: K4 takes atan2f(n.z, -n.x) and
// acosf(clamp(-n.y)) of a unit normal, the probe atan2f(x, -x + 0.3f) and
// acosf(clamp(x * 0.5f)); this kernel follows the probe.  Built with
// -fmad=false (ops/_build.py).
//
// What bounds it: 8 bytes of device memory an element against ~12
// operations (atan2f and acosf counted once each), so at 2^24 elements it
// is bound by bytes on that count; at the probe's (8, 128) by its launch.
// But the library atan2f and acosf run ~88 SASS instructions an element
// on the probe's inputs (tools/smoke_lib.trig_sass), whose issue slots
// take longer than the bytes: on the H100 this kernel is bound by its
// instructions, not its bandwidth (PERF.md §6, P2).  The design keeps
// bytes in flight and instructions few: a grid of the blocks resident at
// once, each thread taking 8 floats an iteration as two 16-byte
// read-only loads, the next iteration's two loads issued before this
// one's trig (32 bytes in flight a thread where one element a thread kept
// 4), a warp's 32 lanes on contiguous float4 at each load and store
// (half_index), two 16-byte stores, the loop's index work shared by 8
// elements, and the floor-mod without fmodf's branches; the head up to
// the first 16-byte boundary and the tail past the last whole 8 run one
// element a thread in the same launch (tools_dev/probe_trig.plan is this
// split in Python).
//
// probe_trig_launch_scalar keeps the kernel as it was first ported (one
// element a thread, the floor-mod as fmodf with its sign fix-up, K4's old
// rem1), a check-only entry point: the two agree byte for byte.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Floats a thread takes an iteration: two float4.
constexpr int kVec = 8;
// float32 roundings of the constants, as K4 holds them.
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);

// torch.remainder(x, 1.0) as fmodf and its sign fix-up (the check-only
// kernel's floor-mod).
__device__ __forceinline__ float rem1(float x) {
  const float m = fmodf(x, 1.0f);
  return m < 0.0f ? m + 1.0f : m;
}

// The floor-mod as csrc/megakernel.cu's fract: x - floorf(x) rounds the
// exact x - floor(x) once, as fmodf's m + 1 does for a negative x, so the
// two agree bit for bit but for the sign of a zero: at x = -0.0 rem1 gives
// -0.0 and fract +0.0.  u is atan2f / 2 pi in [-0.5, 0.5] and v >= 0, so
// u + v is the same float either way (-0.0 + v and +0.0 + v are v).
__device__ __forceinline__ float fract(float x) { return x - floorf(x); }

template <bool kFract>
__device__ __forceinline__ float uv_sum(float x) {
  const float a = atan2f(x, -x + 0.3f) * (1.0f / kTwoPi);
  const float u = kFract ? fract(a) : rem1(a);
  const float v = acosf(fminf(fmaxf(x * 0.5f, -1.0f), 1.0f)) * (1.0f / kPi);
  return u + v;
}

__device__ __forceinline__ float4 uv_sum4(float4 a) {
  return make_float4(uv_sum<true>(a.x), uv_sum<true>(a.y), uv_sum<true>(a.z),
                     uv_sum<true>(a.w));
}

// The split of n elements whose first lies `misalign` floats past a
// 16-byte boundary: `head` elements up to the boundary, `vectors` runs of
// kVec, `tail` after them, over `grid` blocks (at most `resident`, the
// blocks the card holds at once; 0 for no element).
struct Plan {
  int head, vectors, tail, grid;
};

Plan make_plan(int n, int misalign, int resident) {
  Plan p;
  p.head = n < (4 - misalign) % 4 ? n : (4 - misalign) % 4;
  p.vectors = (n - p.head) / kVec;
  p.tail = n - p.head - kVec * p.vectors;
  const int want = (p.vectors + kThreads - 1) / kThreads;
  p.grid = n == 0 ? 0 : (want < 1 ? 1 : (want < resident ? want : resident));
  return p;
}

// The float4 that half h of run i takes: the runs of a warp, 32w to 32w +
// c - 1 (c = 32 but in the last warp), own the 2c float4 from 64w on;
// lane l takes the l-th of each half, so each of a warp's loads and
// stores covers c * 16 contiguous bytes (two float4 a lane side by side
// would leave half of every 32-byte sector to another instruction).
__device__ __forceinline__ int half_index(int i, int h, int vectors) {
  const int w = i & ~31;
  return i + w + h * min(32, vectors - w);
}

// x and out share their misalignment, so one split serves both.  Block 0's
// first head + tail threads take the head and the tail (at most 3 + 7
// elements); every thread then walks the runs of 8 with the grid's stride,
// loading run i + stride before computing run i.
__global__ void __launch_bounds__(kThreads) probe_trig_vec(const float* __restrict__ x, int head,
                                                           int vectors, int tail,
                                                           float* __restrict__ out) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if (tid < head + tail) {
    const int i = tid < head ? tid : tid + kVec * vectors;
    out[i] = uv_sum<true>(__ldg(x + i));
  }
  const float4* __restrict__ xv = reinterpret_cast<const float4*>(x + head);
  float4* __restrict__ ov = reinterpret_cast<float4*>(out + head);
  const int stride = gridDim.x * kThreads;
  int i = tid;
  if (i >= vectors) return;
  float4 a = __ldg(xv + half_index(i, 0, vectors)), b = __ldg(xv + half_index(i, 1, vectors));
  for (;;) {
    const int next = i + stride;
    const bool more = next < vectors;
    float4 na, nb;
    if (more) {
      na = __ldg(xv + half_index(next, 0, vectors));
      nb = __ldg(xv + half_index(next, 1, vectors));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) ov[half_index(i, h, vectors)] = uv_sum4(h == 0 ? a : b);
    if (!more) break;
    a = na;
    b = nb;
    i = next;
  }
}

// The kernel as first ported: one element a thread.
__global__ void __launch_bounds__(kThreads) probe_trig_scalar(const float* __restrict__ x, int n,
                                                              float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = uv_sum<false>(x[i]);
}

// The blocks of probe_trig_vec the card holds at once: its multiprocessors
// times the kernel's resident blocks on one, asked for once.
cudaError_t resident_blocks(int* resident) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_trig_vec, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached = sms * per_sm;
  }
  *resident = cached;
  return cudaSuccess;
}

}  // namespace

// The split probe_trig_launch takes for n elements at `misalign` floats
// past a 16-byte boundary: out[0:5] = head, vectors, tail, grid and the
// resident blocks.  Returns a CUDA error code.
extern "C" int probe_trig_plan(int n, int misalign, int* out) {
  int resident = 0;
  const cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = make_plan(n, misalign, resident);
  out[0] = p.head;
  out[1] = p.vectors;
  out[2] = p.tail;
  out[3] = p.grid;
  out[4] = resident;
  return 0;
}

// x, out: [n] float32, at the same offset from a 16-byte boundary.
// Launches on `stream` without synchronising and returns
// cudaGetLastError() (cudaErrorInvalidValue where the offsets differ).
extern "C" int probe_trig_launch(const void* x, int n, void* out, void* stream) {
  const auto xa = reinterpret_cast<std::uintptr_t>(x);
  const auto oa = reinterpret_cast<std::uintptr_t>(out);
  if (xa % 4 != 0 || xa % 16 != oa % 16) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = make_plan(n, static_cast<int>(xa % 16 / 4), resident);
  if (p.grid > 0) {
    probe_trig_vec<<<p.grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), p.head, p.vectors, p.tail, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// The check-only entry point: the kernel as first ported.
extern "C" int probe_trig_launch_scalar(const void* x, int n, void* out, void* stream) {
  if (n > 0) {
    probe_trig_scalar<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x), n,
                                                             static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_trig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
