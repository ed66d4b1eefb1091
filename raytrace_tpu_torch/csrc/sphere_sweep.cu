// Dense closest hit of rays against a table of world-space spheres.
//
// Replaces the TPU kernel raytrace_tpu/ops/pallas_sweep.py::_sweep_kernel
// (launched by sphere_sweep_pallas).  It computes the same thing: for each
// ray the quadratic in the stable h-form
//     h = d.o - d.c,  c2 = |o|^2 - 2 o.c + k,  disc = h^2 - a c2,
// with k = |c|^2 - r^2 precomputed on the host in float64; a root counts
// when it lies in (T_MIN, T_MAX), the r > 0 gate drops padding rows (which
// also carry k = 3e37, so disc < 0), and the nearer valid root wins.  A
// miss or an inactive ray returns (T_MAX, -1).
//
// What bounds it: R x S ray-sphere tests of ~20 flops and one sqrt each,
// against 33 bytes of device memory per ray (six floats and the alive byte
// in, t and id out).  At the main path's 488 spheres that is ~300 flops per
// byte, far above the H100's fp32 ridge, so the kernel is bound by fp32 ALU
// issue.
//
// Design: one thread per ray in 256-thread blocks.  The table is staged in
// shared memory in tiles of 512 spheres (16 KB; final-one-weekend's 488
// fit in one); all threads of a block read the same sphere at the same
// time, which shared memory serves as a broadcast.  Each thread keeps a
// running minimum with a strict < over ascending sphere ids, so ties go to
// the lowest id without the Pallas kernel's 8-sublane fold.  Inactive rays
// skip the sphere loop.  Built without --use_fast_math, so sqrtf and the
// division round to nearest as IEEE says; nvcc's default FMA contraction
// stays on, so t may differ from the plain PyTorch version in the last bits.

#include <cuda_runtime.h>

namespace {

constexpr float kTMin = 0.001f;    // ops/intersect.py T_MIN
constexpr float kTMax = 10000.0f;  // ops/intersect.py T_MAX
constexpr int kThreads = 256;
constexpr int kTile = 512;         // spheres per shared-memory tile

__global__ void __launch_bounds__(kThreads)
sphere_sweep_kernel(const float4* __restrict__ table, int s8,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const unsigned char* __restrict__ alive, int n,
                    float* __restrict__ t_out, int* __restrict__ id_out) {
  // Sphere j occupies tile[2j] = (cx, cy, cz, r) and tile[2j+1] = (k, pad).
  __shared__ float4 tile[2 * kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n && alive[i] != 0;
  float rox = 0.f, roy = 0.f, roz = 0.f, rdx = 0.f, rdy = 0.f, rdz = 0.f;
  if (active) {
    rox = ox[i]; roy = oy[i]; roz = oz[i];
    rdx = dx[i]; rdy = dy[i]; rdz = dz[i];
  }
  const float d_dot_o = rdx * rox + rdy * roy + rdz * roz;
  const float a = rdx * rdx + rdy * rdy + rdz * rdz;
  const float o_sq = rox * rox + roy * roy + roz * roz;
  const float inv_a = 1.0f / (a == 0.0f ? 1.0f : a);

  float best_t = kTMax;
  int best_id = -1;
  for (int base = 0; base < s8; base += kTile) {
    const int count = min(kTile, s8 - base);
    for (int j = threadIdx.x; j < 2 * count; j += kThreads) {
      tile[j] = table[2 * base + j];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < count; ++j) {
        const float4 s = tile[2 * j];
        const float k = tile[2 * j + 1].x;
        const float dc = s.x * rdx + s.y * rdy + s.z * rdz;
        const float oc = s.x * rox + s.y * roy + s.z * roz;
        const float h = d_dot_o - dc;
        const float c2 = o_sq - 2.0f * oc + k;
        const float disc = h * h - a * c2;
        const bool ok = disc >= 0.0f && s.w > 0.0f;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float t1 = (-h - sq) * inv_a;
        const float t2 = (-h + sq) * inv_a;
        const bool t1_ok = ok && t1 > kTMin && t1 < kTMax;
        const bool t2_ok = ok && t2 > kTMin && t2 < kTMax;
        const float t = t1_ok ? t1 : (t2_ok ? t2 : kTMax);
        if (t < best_t) {
          best_t = t;
          best_id = base + j;
        }
      }
    }
    __syncthreads();
  }
  if (i < n) {
    t_out[i] = best_t;
    id_out[i] = best_id;
  }
}

}  // namespace

// table8: [s8, 8] f32, 16-byte aligned; ox..dz: [n] f32; alive: [n] bool;
// t: [n] f32 out; id: [n] i32 out.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int sphere_sweep_launch(const void* table8, int s8, const void* ox,
                                   const void* oy, const void* oz,
                                   const void* dx, const void* dy,
                                   const void* dz, const void* alive, int n,
                                   void* t, void* id, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    sphere_sweep_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table8), s8,
        static_cast<const float*>(ox), static_cast<const float*>(oy),
        static_cast<const float*>(oz), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(dz),
        static_cast<const unsigned char*>(alive), n, static_cast<float*>(t),
        static_cast<int*>(id));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sphere_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
