// Closest hit of the wavefront's rays against spheres in object space
// (H2): the spheres of a scene with a non-uniform instance scale
// (ellipsoids), which have no world-space table, swept densely, one
// thread a ray.
//
// Replaces no TPU kernel: the JAX package traces this sweep with XLA, an
// einsum over chunks of spheres (raytrace_tpu/ops/spheres.py:40
// intersect_spheres).  For each ray and each sphere s it takes the ray
// into the sphere's object space through its world-to-object matrix M
// (3 x 4: the instance's at the batch time), o' = M o + t, d' = M d (each
// row summed left to right, as the einsum), then solves the quadratic
// against the object-space centre c and radius r in the h-form,
//     oc = o' - c, a = d'.d', h = d'.oc, c2 = oc.oc - r r,
//     disc = h h - a c2, valid where disc >= 0, r > 0 and a > 0,
//     t1 = (-h - sqrt(disc)) / a before t2 = (-h + sqrt(disc)) / a,
// the first of them in (T_MIN, T_MAX); the parameter t is the world ray's,
// since the map is affine.  It returns (t, id) of the nearest hit, the
// lowest id on ties (a strict < over ascending ids), or (T_MAX, -1) on a
// miss or for an inactive ray.
//
// The table (ops/spheres.py object_sphere_table): one 64-byte row a
// sphere, M's 12 floats row-major, then c and r; padding rows have r = 0
// and never hit.  Each block stages it in shared memory in tiles of
// kTile spheres, four float4 a sphere, which all threads read at once (a
// broadcast), as K1's dense sweep does its world table.
//
// Bits.  Built with -fmad=false (ops/_build.py KERNEL_FLAGS) and with
// IEEE sqrtf and division (no fast math), so each operation rounds as
// PyTorch's elementwise kernels do and the kernel matches its plain
// version (ops/spheres.py intersect_spheres) bit for bit.
//
// What bounds it: R x S tests of 65 FP32 operations (the ray moved to
// object space 33, oc 3, a, h and c2 17, disc 3, the max, sqrt and
// reciprocal 3, the roots 6), against 25 bytes in and 8 out a ray and 64
// a sphere: FP32 issue, as K1's dense sweep.  A scene's spheres are few
// (final-one-weekend's 488), so no tree is built over them.

#include <cuda_runtime.h>

namespace {

constexpr float kTMin = 0.001f;    // ops/intersect.py T_MIN
constexpr float kTMax = 10000.0f;  // ops/intersect.py T_MAX
constexpr int kThreads = 256;
constexpr int kTile = 256;         // spheres a shared-memory tile: 16 KiB

__global__ void __launch_bounds__(kThreads)
sphere_obj_kernel(const float4* __restrict__ table, int s8, const float* __restrict__ ox,
                  const float* __restrict__ oy, const float* __restrict__ oz,
                  const float* __restrict__ dx, const float* __restrict__ dy,
                  const float* __restrict__ dz, const unsigned char* __restrict__ alive, int n,
                  float* __restrict__ t_out, int* __restrict__ id_out) {
  // Sphere j: tile[4j] = M row 0, tile[4j+1] = M row 1, tile[4j+2] =
  // M row 2, tile[4j+3] = (c, r).
  __shared__ float4 tile[4 * kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n && alive[i] != 0;
  float rox = 0.f, roy = 0.f, roz = 0.f, rdx = 0.f, rdy = 0.f, rdz = 0.f;
  if (active) {
    rox = ox[i]; roy = oy[i]; roz = oz[i];
    rdx = dx[i]; rdy = dy[i]; rdz = dz[i];
  }
  float best_t = kTMax;
  int best_id = -1;
  for (int base = 0; base < s8; base += kTile) {
    const int count = min(kTile, s8 - base);
    for (int j = threadIdx.x; j < 4 * count; j += kThreads) {
      tile[j] = table[4 * base + j];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < count; ++j) {
        const float4 m0 = tile[4 * j];
        const float4 m1 = tile[4 * j + 1];
        const float4 m2 = tile[4 * j + 2];
        const float4 cr = tile[4 * j + 3];
        const float pox = m0.x * rox + m0.y * roy + m0.z * roz + m0.w;
        const float poy = m1.x * rox + m1.y * roy + m1.z * roz + m1.w;
        const float poz = m2.x * rox + m2.y * roy + m2.z * roz + m2.w;
        const float pdx = m0.x * rdx + m0.y * rdy + m0.z * rdz;
        const float pdy = m1.x * rdx + m1.y * rdy + m1.z * rdz;
        const float pdz = m2.x * rdx + m2.y * rdy + m2.z * rdz;
        const float ocx = pox - cr.x;
        const float ocy = poy - cr.y;
        const float ocz = poz - cr.z;
        const float a = pdx * pdx + pdy * pdy + pdz * pdz;
        const float h = pdx * ocx + pdy * ocy + pdz * ocz;
        const float c2 = ocx * ocx + ocy * ocy + ocz * ocz - cr.w * cr.w;
        const float disc = h * h - a * c2;
        const bool ok = disc >= 0.0f && cr.w > 0.0f && a > 0.0f;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float inv_a = 1.0f / (a == 0.0f ? 1.0f : a);
        const float t1 = (-h - sq) * inv_a;
        const float t2 = (-h + sq) * inv_a;
        const float t = (ok && t1 > kTMin && t1 < kTMax)   ? t1
                        : (ok && t2 > kTMin && t2 < kTMax) ? t2
                                                           : kTMax;
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

// table16: [s8, 16] f32, 16-byte aligned; ox..dz: [n] f32; alive: [n]
// bool; t: [n] f32 out; id: [n] i32 out.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int sphere_obj_launch(const void* table16, int s8, const void* ox, const void* oy,
                                 const void* oz, const void* dx, const void* dy, const void* dz,
                                 const void* alive, int n, void* t, void* id, void* stream) {
  if (n > 0) {
    sphere_obj_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table16), s8, static_cast<const float*>(ox),
        static_cast<const float*>(oy), static_cast<const float*>(oz),
        static_cast<const float*>(dx), static_cast<const float*>(dy),
        static_cast<const float*>(dz), static_cast<const unsigned char*>(alive), n,
        static_cast<float*>(t), static_cast<int*>(id));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sphere_obj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
