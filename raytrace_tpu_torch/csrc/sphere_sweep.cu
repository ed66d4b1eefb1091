// Closest hit of the wavefront's rays against a table of world-space
// spheres (K1): the scene's prefix spheres densely, then a per-thread,
// nearest-first walk of a tree over the rest.
//
// Replaces the TPU kernel raytrace_tpu/ops/pallas_sweep.py::_sweep_kernel
// (launched by sphere_sweep_pallas), a dense sweep of every ray against
// every sphere, and this file's first version, which kept that sweep and
// stays here as the check-only entry point sphere_sweep_dense_launch.
// Both compute the same thing: for each ray the quadratic in the stable
// h-form against each sphere (csrc/sphere_tree.cuh sphere_t, the test K4
// runs), the nearer valid root in (T_MIN, T_MAX), and (t, id) of the
// nearest hit, the lowest id on ties, or (T_MAX, -1) on a miss or for an
// inactive ray.
//
// The walk.  A scene whose compiler put its spheres in Morton clusters
// has a dense prefix of large spheres (SceneStatic.sph_prefix; 0 for
// other scenes); the tree (ops/sphere_tree.py build_sphere_tree, the one
// K4's clustered forms walk) holds every sphere past it in a Morton order
// of their centres.  Each thread first tests the prefix in ascending id,
// the table staged in shared memory in tiles of 512 spheres as in the
// dense sweep, then walks the tree seeded with the prefix's best, with
// csrc/sphere_tree.cuh's sweep_sphere_tree, K4's own walk (the nearer
// passing child first, each child box widened by the ray's rounding
// margin, a hit kept as the lexicographic minimum of (t, id)): the prefix
// then the tree, as K4's clustered forms sweep.  Its stack has 24 entries (ops/sphere_sweep.py
// WALK_DEPTH), so a tree over any sphere count the port holds fits, not
// only the fused gate's 16,384.  After the prefix, the block copies the
// tree's top `staged` node rows (ops/sphere_tree.py STAGE_BYTES) into the
// same shared memory, since every ray reads them and each step of the walk
// waits on its row; the other rows, the sphere rows and the ids are read
// through the read-only cache.  Launched without a tree (a scene with too
// few spheres past its prefix for the walk to pay, ops/sphere_sweep.py
// SPHERE_FLAT_MAX), the prefix is every sphere: the dense loop.
//
// Bits.  The walk's boxes are conservative, so the dense sweep's winner
// is always visited, and the lexicographic minimum over any superset
// holding it is that winner, bit for bit, whatever the order.  Built with
// -fmad=false (ops/_build.py KERNEL_FLAGS), as K4 is, so no multiply-add
// is contracted and each operation rounds as PyTorch's elementwise
// kernels do; sqrtf and the division round to nearest (no fast math).
// So both entry points match the plain PyTorch version
// (ops/sphere_sweep.py sphere_sweep_reference) bit for bit on the card.
//
// What bounds it: the work depends on the data.  Per ray, the prefix's
// tests (~25 FP32 operations and a sqrt each), two box tests at every
// node the walk reaches and the spheres of every leaf it reaches; the
// bytes are the rays (25 in, 8 out), 64 a node row, 32 a sphere row and 4
// an id.  The dense entry does R x S tests, bound by FP32 issue (~300
// flops a byte at final-one-weekend's 488 spheres); the walk trades them
// for a few dozen node tests and leaf spheres a ray, bound by divergence
// and the dependent row loads, as K3 and K4's walks are.

#include <cuda_runtime.h>

// The sphere test and the sphere tree's walk, shared with K4.
#include "sphere_tree.cuh"

namespace {

constexpr float kTMax = sphere_tree::kTMax;
constexpr int kThreads = 256;      // the dense entry's blocks
constexpr int kWalkThreads = 128;  // the walk's blocks, as K3's
constexpr int kTile = 512;         // spheres per shared-memory tile
constexpr int kStack = 24;         // ops/sphere_sweep.py WALK_DEPTH
constexpr int kMaxStaged = 255;    // ops/sphere_tree.py STAGE_BYTES / 64 rows

struct Vec {
  float x, y, z;
};

__global__ void __launch_bounds__(kWalkThreads)
sphere_sweep_kernel(const float4* __restrict__ table, int n_dense, sphere_tree::SphereTree tree,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const unsigned char* __restrict__ alive, int n,
                    float* __restrict__ t_out, int* __restrict__ id_out) {
  // A tile of the prefix, sphere j at smem[2j] = (cx, cy, cz, r) and
  // smem[2j+1] = (k, pad); then the tree's top node rows, four float4 each.
  __shared__ float4 smem[2 * kTile];
  static_assert(4 * kMaxStaged <= 2 * kTile, "the staged rows fit the tile");

  const int i = blockIdx.x * kWalkThreads + threadIdx.x;
  const bool active = i < n && alive[i] != 0;
  Vec o = {0.f, 0.f, 0.f}, d = {0.f, 0.f, 0.f};
  if (active) {
    o = {ox[i], oy[i], oz[i]};
    d = {dx[i], dy[i], dz[i]};
  }
  const float d_dot_o = d.x * o.x + d.y * o.y + d.z * o.z;
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  const float o_sq = o.x * o.x + o.y * o.y + o.z * o.z;
  const float inv_a = 1.0f / (a == 0.0f ? 1.0f : a);

  float best_t = kTMax;
  int best_id = -1;
  for (int base = 0; base < n_dense; base += kTile) {
    const int count = min(kTile, n_dense - base);
    for (int j = threadIdx.x; j < 2 * count; j += kWalkThreads) smem[j] = table[2 * base + j];
    __syncthreads();
    if (active) {
      for (int j = 0; j < count; ++j) {
        sphere_tree::test_sphere(smem[2 * j], smem[2 * j + 1].x, o, d, d_dot_o, a, o_sq, inv_a,
                                 base + j, best_t, best_id);
      }
    }
    __syncthreads();
  }
  if (tree.n > 0) {
    for (int j = threadIdx.x; j < 4 * tree.staged; j += kWalkThreads) {
      smem[j] = __ldg(tree.nodes + j);
    }
    __syncthreads();
    if (active) {
      tree.staged_nodes = smem;
      tri_tree::Stack<kStack> stack;
      sphere_tree::sweep_sphere_tree<false>(tree, stack, 0.0f, o, d, d_dot_o, a, o_sq, inv_a,
                                            best_t, best_id);
    }
  }
  if (i < n) {
    t_out[i] = best_t;
    id_out[i] = best_id;
  }
}

// The dense sweep, kept as a check-only entry point
// (sphere_sweep_dense_launch): one thread a ray in 256-thread blocks, the
// table staged in shared memory in tiles of 512 spheres (16 KB), which all
// threads of a block read at the same time (a broadcast), a running
// minimum with a strict < over ascending sphere ids.
__global__ void __launch_bounds__(kThreads)
sphere_sweep_dense_kernel(const float4* __restrict__ table, int s8,
                          const float* __restrict__ ox, const float* __restrict__ oy,
                          const float* __restrict__ oz, const float* __restrict__ dx,
                          const float* __restrict__ dy, const float* __restrict__ dz,
                          const unsigned char* __restrict__ alive, int n,
                          float* __restrict__ t_out, int* __restrict__ id_out) {
  // Sphere j occupies tile[2j] = (cx, cy, cz, r) and tile[2j+1] = (k, pad).
  __shared__ float4 tile[2 * kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n && alive[i] != 0;
  Vec o = {0.f, 0.f, 0.f}, d = {0.f, 0.f, 0.f};
  if (active) {
    o = {ox[i], oy[i], oz[i]};
    d = {dx[i], dy[i], dz[i]};
  }
  const float d_dot_o = d.x * o.x + d.y * o.y + d.z * o.z;
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  const float o_sq = o.x * o.x + o.y * o.y + o.z * o.z;
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
        sphere_tree::test_sphere(tile[2 * j], tile[2 * j + 1].x, o, d, d_dot_o, a, o_sq, inv_a,
                                 base + j, best_t, best_id);
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

// table8: [s8, 8] f32, 16-byte aligned, its first n_dense rows swept
// densely; rows, nodes, ids: the tree over the spheres past them
// (ops/sphere_tree.py SphereTree: [n_tree, 8] f32, [2^depth - 1, 16] f32,
// [n_tree] i32; none for n_tree = 0), the first `staged` node rows staged
// in shared memory; ox..dz: [n] f32; alive: [n] bool; t: [n] f32 out; id:
// [n] i32 out.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int sphere_sweep_launch(const void* table8, int n_dense, const void* rows,
                                   const void* nodes, const void* ids, int n_tree, int depth,
                                   int leaf, int staged, const void* ox, const void* oy,
                                   const void* oz, const void* dx, const void* dy,
                                   const void* dz, const void* alive, int n, void* t, void* id,
                                   void* stream) {
  if (n_dense < 0 || n_tree < 0 ||
      (n_tree > 0 && (depth < 0 || depth > kStack || leaf < 1 || staged < 0 ||
                      staged > kMaxStaged || staged > (1 << depth) - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const sphere_tree::SphereTree tree{static_cast<const float4*>(rows), nullptr,
                                 static_cast<const float4*>(nodes), nullptr,
                                 static_cast<const int*>(ids), n_tree, depth, leaf,
                                 n_tree > 0 ? staged : 0};
    sphere_sweep_kernel<<<(n + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table8), n_dense, tree, static_cast<const float*>(ox),
        static_cast<const float*>(oy), static_cast<const float*>(oz),
        static_cast<const float*>(dx), static_cast<const float*>(dy),
        static_cast<const float*>(dz), static_cast<const unsigned char*>(alive), n,
        static_cast<float*>(t), static_cast<int*>(id));
  }
  return static_cast<int>(cudaGetLastError());
}

// The dense sweep: table8: [s8, 8] f32, 16-byte aligned; ox..dz: [n] f32;
// alive: [n] bool; t: [n] f32 out; id: [n] i32 out.  Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int sphere_sweep_dense_launch(const void* table8, int s8, const void* ox,
                                         const void* oy, const void* oz, const void* dx,
                                         const void* dy, const void* dz, const void* alive,
                                         int n, void* t, void* id, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    sphere_sweep_dense_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table8), s8, static_cast<const float*>(ox),
        static_cast<const float*>(oy), static_cast<const float*>(oz),
        static_cast<const float*>(dx), static_cast<const float*>(dy),
        static_cast<const float*>(dz), static_cast<const unsigned char*>(alive), n,
        static_cast<float*>(t), static_cast<int*>(id));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sphere_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
