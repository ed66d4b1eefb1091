// Dense closest hit of rays against a table of world-space triangles.
//
// Replaces the TPU kernel raytrace_tpu/ops/pallas_tri_sweep.py::_tri_kernel
// (launched by tri_sweep_pallas).  It computes the same thing: for each ray
// and each table row (v0, e1 = v1 - v0, e2 = v2 - v0, valid) the
// Moller-Trumbore test in the Pallas kernel's operation order,
//     p = d x e2, det = e1.p, inv_det = det != 0 ? 1 / det : 0,
//     s = o - v0, u = (s.p) inv_det, q = s x e1, v = (d.q) inv_det,
//     t = (e2.q) inv_det,
// counting a hit when the row is valid, det != 0, u >= 0, v >= 0,
// u + v <= 1 and T_MIN < t < T_MAX.  It returns (t, id, u, v) of the
// nearest hit, or (T_MAX, -1, 0, 0) on a miss or for an inactive ray.
//
// What bounds it: R x T ray-triangle tests of 27 multiplies, 17 adds, 6
// compares and one division each, against 49 bytes of device memory per
// ray (six floats and the alive byte in; t, id, u, v out).  At the
// 15,360-triangle stress scene that is far above the H100's fp32 ridge,
// so the kernel is bound by fp32 ALU issue.
//
// Design: one thread per ray in 256-thread blocks.  The table is staged in
// shared memory in tiles of 512 triangles, 48 bytes each as three float4
// (v0.xyz, valid), (e1.xyz, -), (e2.xyz, -): 24 KB a tile.  All threads of
// a block read the same triangle at the same time, which shared memory
// serves as a broadcast.  Each thread keeps a running minimum with a strict
// < over ascending triangle ids, so ties go to the lowest id without the
// Pallas kernel's 8-sublane fold.  Inactive rays skip the triangle loop.
//
// Bits: built with -fmad=false (ops/_build.py KERNEL_FLAGS), so no
// multiply-add is contracted and each operation rounds as PyTorch's
// elementwise kernels do; the division is IEEE (no fast math).  The
// kernel therefore matches its plain PyTorch version
// (ops/tri_sweep.py tri_sweep_reference) bit for bit on the card.

#include <cuda_runtime.h>

namespace {

constexpr float kTMin = 0.001f;    // ops/intersect.py T_MIN
constexpr float kTMax = 10000.0f;  // ops/intersect.py T_MAX
constexpr int kThreads = 256;
constexpr int kTile = 512;         // triangles per shared-memory tile

__global__ void __launch_bounds__(kThreads)
tri_sweep_kernel(const float4* __restrict__ table, int t8,
                 const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const unsigned char* __restrict__ alive, int n,
                 float* __restrict__ t_out, int* __restrict__ id_out,
                 float* __restrict__ u_out, float* __restrict__ v_out) {
  // Triangle j: tile[3j] = (v0, valid), tile[3j+1] = (e1, -),
  // tile[3j+2] = (e2, -).
  __shared__ float4 tile[3 * kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n && alive[i] != 0;
  float rox = 0.f, roy = 0.f, roz = 0.f, rdx = 0.f, rdy = 0.f, rdz = 0.f;
  if (active) {
    rox = ox[i]; roy = oy[i]; roz = oz[i];
    rdx = dx[i]; rdy = dy[i]; rdz = dz[i];
  }

  float best_t = kTMax, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  for (int base = 0; base < t8; base += kTile) {
    const int count = min(kTile, t8 - base);
    // A table row is four float4: (v0x, v0y, v0z, e1x), (e1y, e1z, e2x,
    // e2y), (e2z, valid, -, -), (-).
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const float4 a = table[4 * (base + j)];
      const float4 b = table[4 * (base + j) + 1];
      const float4 c = table[4 * (base + j) + 2];
      tile[3 * j] = make_float4(a.x, a.y, a.z, c.y);
      tile[3 * j + 1] = make_float4(a.w, b.x, b.y, 0.0f);
      tile[3 * j + 2] = make_float4(b.z, b.w, c.x, 0.0f);
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < count; ++j) {
        const float4 v0 = tile[3 * j];
        const float4 e1 = tile[3 * j + 1];
        const float4 e2 = tile[3 * j + 2];
        const float px = rdy * e2.z - rdz * e2.y;
        const float py = rdz * e2.x - rdx * e2.z;
        const float pz = rdx * e2.y - rdy * e2.x;
        const float det = e1.x * px + e1.y * py + e1.z * pz;
        const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
        const float tx = rox - v0.x;
        const float ty = roy - v0.y;
        const float tz = roz - v0.z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1.z - tz * e1.y;
        const float qy = tz * e1.x - tx * e1.z;
        const float qz = tx * e1.y - ty * e1.x;
        const float v = (rdx * qx + rdy * qy + rdz * qz) * inv_det;
        const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
        const bool ok = v0.w > 0.0f && det != 0.0f && u >= 0.0f && v >= 0.0f &&
                        u + v <= 1.0f && t > kTMin && t < kTMax;
        if (ok && t < best_t) {
          best_t = t;
          best_id = base + j;
          best_u = u;
          best_v = v;
        }
      }
    }
    __syncthreads();
  }
  if (i < n) {
    t_out[i] = best_t;
    id_out[i] = best_id;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

}  // namespace

// table16: [t8, 16] f32, 16-byte aligned; ox..dz: [n] f32; alive: [n]
// bool; t, u, v: [n] f32 out; id: [n] i32 out.  Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int tri_sweep_launch(const void* table16, int t8, const void* ox,
                                const void* oy, const void* oz,
                                const void* dx, const void* dy,
                                const void* dz, const void* alive, int n,
                                void* t, void* id, void* u, void* v,
                                void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    tri_sweep_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table16), t8,
        static_cast<const float*>(ox), static_cast<const float*>(oy),
        static_cast<const float*>(oz), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(dz),
        static_cast<const unsigned char*>(alive), n, static_cast<float*>(t),
        static_cast<int*>(id), static_cast<float*>(u),
        static_cast<float*>(v));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tri_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
