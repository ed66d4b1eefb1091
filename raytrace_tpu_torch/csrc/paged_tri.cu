// Closest hit of rays against a triangle soup of any size (K3): a
// per-thread, nearest-first walk of an implicit binary tree.
//
// Replaces the TPU kernel raytrace_tpu/ops/pallas_paged_tri.py::_paged_kernel
// (launched by paged_tri_sweep), whose flat walk (every page box, then
// every cluster box of each page that passes, in ascending order) was
// shaped by the TPU's lane gathers, and this file's first version, which
// kept that walk.  It computes what the dense sweep over the same soup
// computes (csrc/tri_sweep.cu): (t, id, u, v) of the nearest hit, ties to
// the lowest id, or (T_MAX, -1, 0, 0) on a miss or for an inactive ray.
//
// The soup is in Morton order of its centroids (ops/paged_tri.py).  The
// tree (build_tri_tree) is implicit: leaf k holds triangles [k L, (k+1) L)
// and is node K - 1 + k; node n has children 2n + 1 and 2n + 2; each
// internal node is one 64-byte row, four float4: both children's boxes
// (left min xyz, left max xyz, right min xyz, right max xyz) and each
// child's reach (its box's largest |coordinate|).  A box holding no real
// triangle is the point (BIG, BIG, BIG) with reach 0, which never passes.
//
// Walk (Aila and Laine, "Understanding the Efficiency of Ray Traversal on
// GPUs", HPG 2009: the while-while loop, a short stack, the nearer child
// first): at an internal node both children's boxes are slab-tested, each
// widened for this ray by (|o|_inf + reach) 2^-18 against the rounding of
// the slab and Moller-Trumbore tests far from the origin, and pruned as
// the TPU kernel prunes (enter <= exit, exit > T_MIN, enter < best_t *
// 1.0001 + 1e-4, |d| kept at least 1e-30 in 1 / d).  Of two that pass,
// the one entered first is walked and the other pushed with its entry t,
// which is tested against the best t again when it is popped (the same
// test, as best t only falls).  At a leaf each triangle is tested with
// csrc/tri_sweep.cu's operations in its order.
//
// Bits.  The walk no longer visits ids in ascending order, so a hit
// replaces the best one when t < best_t, or t == best_t and id < best_id:
// the lexicographic minimum of (t, id) over the triangles visited.  The
// boxes are conservative (widened, and the test passes for any best t at
// or above a hit's own t whose point lies on its triangle), so the dense
// sweep's winner is always visited, and the lexicographic minimum over any
// superset holding it is that winner: the dense sweep's (t, id, u, v), bit
// for bit, whatever the order.  Built with -fmad=false (ops/_build.py
// KERNEL_FLAGS), so every operation rounds as the plain PyTorch versions'
// (ops/paged_tri.py tri_tree_sweep_reference, ops/tri_sweep.py).
//
// What bounds it on the H100: the work depends on the data.  Per ray, two
// box tests (32 FP32 operations each with the widening) at every node the
// walk reaches and 46 operations a triangle at every leaf; the bytes are
// the rays (25 in, 16 out), 64 per node row and 48 per triangle row, of
// which the top of the tree and the triangles a warp's rays share stay in
// the 50 MB L2 (final-one-weekend --mesh-geometry's 33.6 MB of nodes at
// L = 4 and 98 MB of triangles).  So it is bound by FP32 issue and by
// divergence: a warp's 32 rays walk different paths, each step waits on a
// dependent 64-byte load, and the warp runs until its longest walk ends.
// The design keeps a node's row to one 64-byte line, the stack in local
// memory (L1, 192 bytes a thread; 48 registers, no spills), and the leaf
// small: L = 4 (ops/paged_tri.py LEAF), timed on the card against 8 and 16
// (PERF.md).  Two options were built and timed on the card and left out
// (PERF.md): the top 8 or 10 levels of the tree in shared memory (slower:
// a block's copy of up to 64 KB costs more than the L2 hits it saves, and
// fewer blocks fit an SM), and a persistent grid taking rays 32 at a time
// from an atomic counter (1-2% faster on K3 alone, which the host-bound
// mesh path cannot show).

#include <cuda_runtime.h>

namespace {

constexpr float kTMin = 0.001f;    // ops/intersect.py T_MIN
constexpr float kTMax = 10000.0f;  // ops/intersect.py T_MAX
constexpr float kSlabEps = 1e-30f; // ops/paged_tri.py _SLAB_EPS
constexpr float kRounding = 0x1p-18f;  // ops/paged_tri.py TREE_ROUNDING
constexpr int kStack = 24;         // ops/paged_tri.py MAX_DEPTH
constexpr int kThreads = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, o_inf;
};

__device__ __forceinline__ float slab_inv(float d) {
  return 1.0f / (fabsf(d) < kSlabEps ? (d < 0.0f ? -kSlabEps : kSlabEps) : d);
}

// The slab test of the ray against the box (lo, hi) widened by the ray's
// margin, pruned by its best t; *te is the entry t.
__device__ __forceinline__ bool box_passes(float lx, float ly, float lz,
                                           float hx, float hy, float hz,
                                           float reach, const Ray& r,
                                           float best_t, float* te_out) {
  const float m = (r.o_inf + reach) * kRounding;
  float a0 = (lx - m - r.ox) * r.ivx;
  float a1 = (hx + m - r.ox) * r.ivx;
  float te = fminf(a0, a1);
  float tx = fmaxf(a0, a1);
  a0 = (ly - m - r.oy) * r.ivy;
  a1 = (hy + m - r.oy) * r.ivy;
  te = fmaxf(te, fminf(a0, a1));
  tx = fminf(tx, fmaxf(a0, a1));
  a0 = (lz - m - r.oz) * r.ivz;
  a1 = (hz + m - r.oz) * r.ivz;
  te = fmaxf(te, fminf(a0, a1));
  tx = fminf(tx, fmaxf(a0, a1));
  *te_out = te;
  return te <= tx && tx > kTMin && te < best_t * 1.0001f + 1e-4f;
}

struct Tree {
  const float4* tris;   // [>= n_tris, 3] (v0, valid), (e1, -), (e2, -)
  const float4* nodes;  // [K - 1, 4]
  int n_tris, depth, leaf;
};

__global__ void __launch_bounds__(kThreads)
paged_tri_kernel(Tree tree, const float* __restrict__ ox,
                 const float* __restrict__ oy,
                 const float* __restrict__ oz,
                 const float* __restrict__ dx,
                 const float* __restrict__ dy,
                 const float* __restrict__ dz,
                 const unsigned char* __restrict__ alive, int n,
                 float* __restrict__ t_out, int* __restrict__ id_out,
                 float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float best_t = kTMax, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  if (alive[i] != 0) {
    Ray r;
    r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
    r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
    r.ivx = slab_inv(r.dx); r.ivy = slab_inv(r.dy); r.ivz = slab_inv(r.dz);
    r.o_inf = fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
    const int first_leaf = (1 << tree.depth) - 1;
    int stack_node[kStack];
    float stack_te[kStack];
    int sp = 0;
    int node = 0;
    while (node >= 0) {
      if (node < first_leaf) {
        const float4* row = tree.nodes + 4 * node;
        const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2),
                     e = __ldg(row + 3);
        float tl, tr;
        const bool hl = box_passes(a.x, a.y, a.z, a.w, b.x, b.y, e.x, r,
                                   best_t, &tl);
        const bool hr = box_passes(b.z, b.w, c.x, c.y, c.z, c.w, e.y, r,
                                   best_t, &tr);
        const int left = 2 * node + 1;
        if (hl && hr) {
          const bool left_first = tl <= tr;
          node = left_first ? left : left + 1;
          stack_node[sp] = left_first ? left + 1 : left;
          stack_te[sp] = left_first ? tr : tl;
          ++sp;
          continue;
        }
        if (hl || hr) {
          node = hl ? left : left + 1;
          continue;
        }
      } else {
        const int j0 = (node - first_leaf) * tree.leaf;
        const int j1 = min(j0 + tree.leaf, tree.n_tris);
        for (int j = j0; j < j1; ++j) {
          const float4 v0 = __ldg(tree.tris + 3 * j);
          const float4 e1 = __ldg(tree.tris + 3 * j + 1);
          const float4 e2 = __ldg(tree.tris + 3 * j + 2);
          const float px = r.dy * e2.z - r.dz * e2.y;
          const float py = r.dz * e2.x - r.dx * e2.z;
          const float pz = r.dx * e2.y - r.dy * e2.x;
          const float det = e1.x * px + e1.y * py + e1.z * pz;
          const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
          const float tx = r.ox - v0.x;
          const float ty = r.oy - v0.y;
          const float tz = r.oz - v0.z;
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1.z - tz * e1.y;
          const float qy = tz * e1.x - tx * e1.z;
          const float qz = tx * e1.y - ty * e1.x;
          const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
          const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
          const bool ok = det != 0.0f && u >= 0.0f && v >= 0.0f &&
                          u + v <= 1.0f && t > kTMin && t < kTMax;
          if (ok && (t < best_t || (t == best_t && j < best_id))) {
            best_t = t;
            best_id = j;
            best_u = u;
            best_v = v;
          }
        }
      }
      // Pop the nearest pending sibling that still passes.
      node = -1;
      while (sp > 0) {
        --sp;
        if (stack_te[sp] < best_t * 1.0001f + 1e-4f) {
          node = stack_node[sp];
          break;
        }
      }
    }
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

}  // namespace

// tris: [>= n_tris, 12] f32; nodes: [2^depth - 1, 16] f32 (both 16-byte
// aligned); ox..dz: [n] f32; alive: [n] bool; t, u, v: [n] f32 out; id:
// [n] i32 out.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int paged_tri_launch(const void* tris, int n_tris,
                                const void* nodes, int depth, int leaf,
                                const void* ox, const void* oy,
                                const void* oz, const void* dx,
                                const void* dy, const void* dz,
                                const void* alive, int n, void* t, void* id,
                                void* u, void* v, void* stream) {
  if (depth > kStack) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const Tree tree{static_cast<const float4*>(tris),
                    static_cast<const float4*>(nodes), n_tris, depth, leaf};
    paged_tri_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        tree, static_cast<const float*>(ox), static_cast<const float*>(oy),
        static_cast<const float*>(oz), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(dz),
        static_cast<const unsigned char*>(alive), n, static_cast<float*>(t),
        static_cast<int*>(id), static_cast<float*>(u),
        static_cast<float*>(v));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* paged_tri_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
