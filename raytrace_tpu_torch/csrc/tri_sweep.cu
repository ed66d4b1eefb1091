// Closest hit of the wavefront's rays against a triangle soup that keeps
// its compiled order (K2): a per-thread, nearest-first walk of the soup's
// tree.
//
// Replaces the TPU kernel raytrace_tpu/ops/pallas_tri_sweep.py::_tri_kernel
// (launched by tri_sweep_pallas), a dense sweep of every ray against every
// triangle, and this file's first version, which kept that sweep and stays
// here as the check-only entry point tri_sweep_dense_launch.  Both compute
// the same thing: for each ray and each triangle (v0, e1 = v1 - v0,
// e2 = v2 - v0) the Moller-Trumbore test in the Pallas kernel's operation
// order,
//     p = d x e2, det = e1.p, inv_det = det != 0 ? 1 / det : 0,
//     s = o - v0, u = (s.p) inv_det, q = s x e1, v = (d.q) inv_det,
//     t = (e2.q) inv_det,
// counting a hit when det != 0, u >= 0, v >= 0, u + v <= 1 and T_MIN < t
// < T_MAX (the dense table's padding rows, valid = 0, never hit), and
// return (t, id, u, v) of the nearest hit, the lowest id on ties, or
// (T_MAX, -1, 0, 0) on a miss or for an inactive ray.
//
// The walk.  The tree is the one the wavefront already builds for a soup
// outside the paged sweep (ops/paged_tri.py build_soup_tree): a
// Morton-permuted copy of the soup's rows, three float4 a triangle, an
// int32 slot -> id table, and one 64-byte row an internal node, over
// leaves of two triangles (the whole soup one leaf up to 40,
// ops/paged_tri.soup_leaf).  Each thread walks it for its ray with
// csrc/tri_tree.cuh's loop, the one K3 and K4 run (Aila and Laine's
// while-while walk, the nearer passing child first, a stack of 24 entries,
// ops/paged_tri.MAX_DEPTH, so a soup of any size that use_bvh=False sends
// here fits), with the same widened box tests and leaf test
// (tri_tree::walk).  Every node row, triangle row and id is read through
// the read-only cache: staging the tree's top rows in shared memory, as
// K4 does its sphere tree's, was measured slower here (PERF.md §6).
//
// Bits.  The walk keeps the lexicographic minimum of (t, id) over the
// triangles it visits; its boxes are conservative, so the dense sweep's
// winner is always visited, and the minimum over any superset holding it
// is that winner, bit for bit.  Built with -fmad=false (ops/_build.py
// KERNEL_FLAGS), so no multiply-add is contracted and each operation
// rounds as PyTorch's elementwise kernels do; the division is IEEE (no
// fast math).  The kernel therefore matches its plain PyTorch version
// (ops/tri_sweep.py tri_sweep_reference) bit for bit on the card, as the
// dense entry does.
//
// What bounds it: the work depends on the data.  Per ray, two box tests
// at every node the walk reaches and 46 FP32 operations a triangle at
// every leaf; the bytes are the rays (25 in, 16 out), 64 a node row, 48 a
// triangle row and 4 an id.  The dense entry does R x T tests of 46
// operations, bound by FP32 issue (tri-stress: 9,437,184 rays x 15,360
// triangles).  The walk trades those for a few dozen node tests and leaf
// triangles a ray, bound by divergence and the dependent row loads, as K3.

#include <cuda_runtime.h>

// The tree walk shared with K3 and K4.
#include "tri_tree.cuh"

namespace {

constexpr float kTMin = 0.001f;    // ops/intersect.py T_MIN
constexpr float kTMax = 10000.0f;  // ops/intersect.py T_MAX
constexpr int kThreads = 256;      // the dense entry's blocks
constexpr int kTile = 512;         // triangles per shared-memory tile
constexpr int kWalkThreads = 128;  // the walk's blocks, as K3's
constexpr int kStack = 24;         // ops/paged_tri.py MAX_DEPTH

struct NoCapture {
  __device__ __forceinline__ void operator()(float4, float4, float4, float, float) const {}
};

__global__ void __launch_bounds__(kWalkThreads)
tri_sweep_kernel(tri_tree::Tree tree, const float* __restrict__ ox,
                 const float* __restrict__ oy, const float* __restrict__ oz,
                 const float* __restrict__ dx, const float* __restrict__ dy,
                 const float* __restrict__ dz, const unsigned char* __restrict__ alive, int n,
                 float* __restrict__ t_out, int* __restrict__ id_out,
                 float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * kWalkThreads + threadIdx.x;
  if (i >= n) return;
  float best_t = kTMax, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  if (alive[i] != 0) {
    const tri_tree::Ray r = tri_tree::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
    tri_tree::Stack<kStack> stack;
    tri_tree::walk<kStack, true>(stack, tree, r, 0, best_t, best_id, best_u, best_v,
                                 NoCapture{});
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

// The dense sweep, kept as a check-only entry point (tri_sweep_dense_launch):
// one thread a ray in 256-thread blocks, the table staged in shared memory
// in tiles of 512 triangles, 48 bytes each as three float4 (v0.xyz, valid),
// (e1.xyz, -), (e2.xyz, -), which all threads of a block read at the same
// time (a broadcast), a running minimum with a strict < over ascending ids.

__global__ void __launch_bounds__(kThreads)
tri_sweep_dense_kernel(const float4* __restrict__ table, int t8,
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
extern "C" int tri_sweep_dense_launch(const void* table16, int t8, const void* ox,
                                const void* oy, const void* oz,
                                const void* dx, const void* dy,
                                const void* dz, const void* alive, int n,
                                void* t, void* id, void* u, void* v,
                                void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    tri_sweep_dense_kernel<<<blocks, kThreads, 0,
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

// tris: [>= n_tris, 12] f32 in the tree's slot order; nodes: [2^depth - 1,
// 16] f32 (both 16-byte aligned); ids: [n_tris] i32, each slot's triangle
// id; ox..dz: [n] f32; alive: [n] bool; t, u, v: [n] f32 out; id: [n] i32
// out.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int tri_sweep_launch(const void* tris, int n_tris, const void* nodes,
                                const void* ids, int depth, int leaf,
                                const void* ox, const void* oy, const void* oz,
                                const void* dx, const void* dy, const void* dz,
                                const void* alive, int n, void* t, void* id, void* u,
                                void* v, void* stream) {
  if (depth > kStack) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const tri_tree::Tree tree{static_cast<const float4*>(tris),
                              static_cast<const float4*>(nodes),
                              static_cast<const int*>(ids), n_tris, depth, leaf};
    tri_sweep_kernel<<<(n + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        tree, static_cast<const float*>(ox), static_cast<const float*>(oy),
        static_cast<const float*>(oz), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(dz),
        static_cast<const unsigned char*>(alive), n, static_cast<float*>(t),
        static_cast<int*>(id), static_cast<float*>(u), static_cast<float*>(v));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tri_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
