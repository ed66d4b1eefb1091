// Closest hit of the wavefront's rays against spheres in object space
// (H2): the spheres of a scene with a non-uniform instance scale
// (ellipsoids), which have no world-space table.  The scene's dense
// prefix of large spheres is swept densely, then a per-thread,
// nearest-first walk of a tree over the world boxes of the rest.
//
// Replaces no TPU kernel: the JAX package traces this sweep with XLA, an
// einsum over chunks of spheres (raytrace_tpu/ops/spheres.py:40
// intersect_spheres).  The test (obj_t) is that function's: for a ray and
// a sphere s it takes the ray into the sphere's object space through its
// world-to-object matrix M (3 x 4: the instance's at the batch time),
// o' = M o + t, d' = M d (each row summed left to right, as the einsum),
// then solves the quadratic against the object-space centre c and radius
// r in the h-form,
//     oc = o' - c, a = d'.d', h = d'.oc, c2 = oc.oc - r r,
//     disc = h h - a c2, valid where disc >= 0, r > 0 and a > 0,
//     t1 = (-h - sqrt(disc)) / a before t2 = (-h + sqrt(disc)) / a,
// the first of them in (T_MIN, T_MAX); the parameter t is the world ray's,
// since the map is affine.  The launch returns (t, id) of the nearest hit,
// the lowest id on ties, or (T_MAX, -1) on a miss or for an inactive ray.
//
// The table (ops/spheres.py object_sphere_table): one 64-byte row a
// sphere, M's 12 floats row-major, then c and r; padding rows have r = 0
// and never hit.
//
// The walk.  The first n_dense rows (the compiler's prefix of large
// spheres, SceneStatic.sph_prefix, or the leading spheres whose boxes are
// large: ops/sphere_obj.py tree_prefix) are tested in ascending id, the
// table staged in shared memory in tiles of kTile spheres, a strict <
// update.  The rest lie in a tree (ops/sphere_obj.py build_object_tree,
// built by ops/sphere_tree.py build_box_nodes, the builder of K1's and
// K4's sphere trees): a permuted copy of their rows in the Morton order of
// their box centres, an int32 slot -> id table, and one 64-byte row an
// internal node, both children's boxes, each child's reach and rounding
// coefficient.  The block stages the tree's top `staged` node rows in the
// same shared memory, and each thread walks it with csrc/tri_tree.cuh's
// walk_tree, the loop of every tree walk of the port (the nearer passing
// child first, a 24-entry stack).  At a leaf each sphere is tested with
// obj_t and a hit replaces the best one when t < best_t, or t == best_t
// and id < best_id, the id read only for a hit at or below the best t.
// A ray whose margin at the root (below) is at least 1 / kFlatRatio of
// the root box's largest side (a ray from far away, whose margin grows as
// |o|^2) is not walked: its warp sweeps
// the rest of the table for it, each lane a 32nd of the rows, and takes
// the lexicographic minimum over the lanes: the same bits, without the
// long chain of dependent loads a walk that culls little would be.
// Launched without a tree (at most ops/sphere_sweep.py SPHERE_FLAT_MAX
// spheres past the prefix), the prefix is every row: the dense loop.
//
// The boxes.  Sphere s is the ellipsoid {x : |M x + t - c| <= r}; with A
// the inverse of M's 3 x 3 part (in float64 on the host of the build),
// its box is centred at A (c - t) with half-extent r |A[i, :]|_2 on axis
// i, the ellipsoid's exact box.  The margin.  A hit the f32 test reports
// at t' lies near, not on, the ellipsoid.  Let L be M's 3 x 3 part, sigma
// = |L|_2, nu the largest |A[i, :]|_2, kappa = |L|_F |A|_2, u = 2^-24,
// and X = sigma |o| + |t| + |c| + r, which bounds |o'| + |c| + r.  (1)
// The quadratic in the computed o' and d': its discriminant's error is
// below ~18 u a X^2 and the roots' own below 4 u of their size, so the
// computed object-space point lies within 22 u X^2 / r of the sphere (the
// derivation of ops/megakernel.sphere_cluster_pretest).  (2) o' = M o + t,
// four terms a row with no contraction, is off by at most 4 u (|L|_F |o|
// + |t|) <= 7 u X.  (3) d' is off by at most 3 u |L|_F |d|, times t', and
// t' |d| <= |A|_2 t' |d'| <= |A|_2 (|oc| + 2 r) <= 2 |A|_2 X: 6 u kappa X.
// The true object point of the world point o + t' d is so within (30 + 6
// kappa) u X^2 / r of the sphere (X >= r), and the world point within nu
// times that of the ellipsoid's box on every axis.  Each node widens its
// children's boxes for the ray by (|o| + reach)^2 coef, the margin of
// K1's tree, with reach the most (|t| + |c| + r) / sigma and coef the
// most nu sigma^2 (36 + 8 kappa) u / r over the spheres below it: the
// same bound with a fifth to spare for the f32 rounding of reach, coef
// and the margin itself.  The boxes are also widened by 1e-5 of their
// size, and since nu sigma >= 1 / sqrt(3) the margin is at least 41 u
// |o|, above the slab test's own rounding.  A sphere whose box or margin
// is not finite (a singular map) gets a box of +/-1e30 and no margin,
// which every ray passes.
//
// The drift.  A tree built once for a scene whose sphere instances do not
// move (ops/sphere_obj.py build_object_tree with static) takes its boxes
// from the first batch's rows and is walked at every batch time with that
// batch's rows, and a static instance's map differs in its last bits
// between batch times: ops/transforms.py interpolate_instances lerps its
// translation T and scale s, (1 - tau) v + tau v, each within 3 u of v,
// while its rotation is the same bits at every time.  So between two
// times each row of L moves by at most 10 u of itself (the reciprocal
// scale and the product round once more at each time), |dL|_F <= 10 u
// |L|_F, and t = -L T, three products and two sums a row, by at most 24 u
// |L|_F |T| <= 24 u kappa |t| (T = -A t).  A point x of a later batch's
// ellipsoid has |x| <= |A|_2 X0 (1 + 30 u kappa), X0 = |t| + |c| + r, so
// (kappa < 10^5) |L x + t - c| <= r + |dL x + dt| <= r + 36 u kappa X0:
// x lies in the
// first batch's ellipsoid grown to radius r + 36 u kappa X0, whose box is
// the first box widened by 36 u kappa X0 |A[i, :]|_2 <= 36 u kappa nu X0 on
// axis i.  The once-built tree widens each box by 40 u kappa nu X0 for
// that (ops/sphere_obj.py STATIC_DRIFT).  reach and coef move by some 10 u
// of themselves, within the fifth the margin spares.
//
// Bits.  The walk's boxes are conservative, so the dense sweep's winner is
// always visited, and the lexicographic minimum of (t, id) over any
// superset holding it is that winner, bit for bit, whatever the order
// (the argument of csrc/tri_tree.cuh).  Built with -fmad=false
// (ops/_build.py KERNEL_FLAGS) and with IEEE sqrtf and division (no fast
// math), so each operation rounds as PyTorch's elementwise kernels do and
// the kernel matches its plain versions (ops/sphere_obj.py
// object_tree_sweep_reference, the walk, and ops/spheres.py
// intersect_spheres, the dense sweep) bit for bit.  The dense loop of the
// kernel's first version stays as the check-only entry point
// sphere_obj_dense_launch.
//
// What bounds it: the work depends on the data.  Per ray, the prefix's
// tests (65 FP32 operations each: the ray moved to object space 33, oc 3,
// a, h and c2 17, disc 3, the max, sqrt and reciprocal 3, the roots 6),
// two box tests at every node the walk reaches and the spheres of every
// leaf it reaches; the bytes are the rays (25 in, 8 out), 64 a node row,
// 64 a sphere row and 4 an id.  The dense entry does R x S tests, bound by
// FP32 issue; the walk trades them for a few dozen node tests and leaf
// spheres a ray, bound by divergence and the dependent row loads, as K1's
// walk is.

#include <cuda_runtime.h>

#include "tri_tree.cuh"

namespace {

constexpr float kTMin = tri_tree::kTMin;
constexpr float kTMax = tri_tree::kTMax;
constexpr int kThreads = 256;      // the dense entry's blocks
constexpr int kWalkThreads = 128;  // the walk's blocks, as K1's
constexpr int kTile = 256;         // spheres a shared-memory tile: 16 KiB
constexpr int kStack = 24;         // ops/sphere_obj.py WALK_DEPTH
constexpr int kMaxStaged = 255;    // ops/sphere_tree.py STAGE_BYTES / 64 rows
// A ray whose margin at the root is at least 1 / kFlatRatio of the root
// box's largest side is swept by its warp.  Set on the card (PERF.md §6):
// walking every ray, or sweeping every ray so, took fow-ellipsoids' batch
// several times as long as ratios near this one did.
constexpr float kFlatRatio = 2.0f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The object-space test of one ray against one sphere (the rows of M, then
// (c, r)): its t, or kTMax for no hit.
__device__ __forceinline__ float obj_t(const Ray& q, float4 m0, float4 m1, float4 m2,
                                       float4 cr) {
  const float pox = m0.x * q.ox + m0.y * q.oy + m0.z * q.oz + m0.w;
  const float poy = m1.x * q.ox + m1.y * q.oy + m1.z * q.oz + m1.w;
  const float poz = m2.x * q.ox + m2.y * q.oy + m2.z * q.oz + m2.w;
  const float pdx = m0.x * q.dx + m0.y * q.dy + m0.z * q.dz;
  const float pdy = m1.x * q.dx + m1.y * q.dy + m1.z * q.dz;
  const float pdz = m2.x * q.dx + m2.y * q.dy + m2.z * q.dz;
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
  return (ok && t1 > kTMin && t1 < kTMax)   ? t1
         : (ok && t2 > kTMin && t2 < kTMax) ? t2
                                            : kTMax;
}

// The tree over the spheres past the prefix (ops/sphere_tree.py
// SphereTree with 64-byte rows): slot j's rows rows[4j .. 4j + 3] hold
// sphere ids[j]; n slots; the node rows, the first `staged` also in
// shared memory.
struct Tree {
  const float4* rows;
  const float4* nodes;
  const int* ids;
  int n, depth, leaf, staged;
};

__global__ void __launch_bounds__(kWalkThreads)
sphere_obj_kernel(const float4* __restrict__ table, int s8, int n_dense, Tree tree,
                  const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const unsigned char* __restrict__ alive, int n,
                  float* __restrict__ t_out, int* __restrict__ id_out) {
  // A tile of the prefix, sphere j at smem[4j .. 4j + 3]; then the tree's
  // top node rows, four float4 each.
  __shared__ float4 smem[4 * kTile];
  static_assert(4 * kMaxStaged <= 4 * kTile, "the staged rows fit the tile");

  const int i = blockIdx.x * kWalkThreads + threadIdx.x;
  const bool active = i < n && alive[i] != 0;
  Ray q = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) q = {ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};

  float best_t = kTMax;
  int best_id = -1;
  for (int base = 0; base < n_dense; base += kTile) {
    const int count = min(kTile, n_dense - base);
    for (int j = threadIdx.x; j < 4 * count; j += kWalkThreads) smem[j] = table[4 * base + j];
    __syncthreads();
    if (active) {
      for (int j = 0; j < count; ++j) {
        const float t = obj_t(q, smem[4 * j], smem[4 * j + 1], smem[4 * j + 2], smem[4 * j + 3]);
        if (t < best_t) {
          best_t = t;
          best_id = base + j;
        }
      }
    }
    __syncthreads();
  }
  if (tree.n > 0) {
    for (int j = threadIdx.x; j < 4 * tree.staged; j += kWalkThreads) {
      smem[j] = __ldg(tree.nodes + j);
    }
    __syncthreads();
    const float onorm = sqrtf(q.ox * q.ox + q.oy * q.oy + q.oz * q.oz);
    const auto row = [&](int node, float4& ra, float4& rb, float4& rc, float4& re) {
      if (node < tree.staged) {
        const float4* p = smem + 4 * node;
        ra = p[0];
        rb = p[1];
        rc = p[2];
        re = p[3];
      } else {
        const float4* p = tree.nodes + 4 * node;
        ra = __ldg(p);
        rb = __ldg(p + 1);
        rc = __ldg(p + 2);
        re = __ldg(p + 3);
      }
    };
    // The rounding margin: (|o| + reach)^2 coef (the header).
    const auto margin = [&](float4 e, bool right) {
      const float s = onorm + (right ? e.y : e.x);
      return s * s * (right ? e.w : e.z);
    };
    // A ray whose margin at the root is at least 1 / kFlatRatio of the
    // root box's largest side (a ray from far away: the margin grows as
    // |o|^2) is not walked: the boxes would cull little for it, and its
    // walk would be a long chain of dependent loads.
    bool flat = false;
    if (active && tree.depth > 0) {
      float4 a, b, c, e;
      row(0, a, b, c, e);
      const float side = fmaxf(fmaxf(fmaxf(a.w, c.y) - fminf(a.x, b.z),
                                     fmaxf(b.x, c.z) - fminf(a.y, b.w)),
                               fmaxf(b.y, c.w) - fminf(a.z, c.x));
      flat = fmaxf(margin(e, false), margin(e, true)) * kFlatRatio >= side;
    }
    // Each such ray of the warp is swept by the whole warp, one after
    // another: lane l tests rows n_dense + l, n_dense + l + 32, ... in
    // ascending id with a strict <, the warp takes the lexicographic
    // minimum of (t, id) over its lanes, and the ray's lane keeps it
    // against its prefix's best: the dense loop's bits.
    const int lane = threadIdx.x & 31;
    unsigned pending = __ballot_sync(0xffffffffu, flat);
    while (pending != 0u) {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1u;
      const Ray fr = {__shfl_sync(0xffffffffu, q.ox, src), __shfl_sync(0xffffffffu, q.oy, src),
                      __shfl_sync(0xffffffffu, q.oz, src), __shfl_sync(0xffffffffu, q.dx, src),
                      __shfl_sync(0xffffffffu, q.dy, src), __shfl_sync(0xffffffffu, q.dz, src)};
      float ft = kTMax;
      int fid = -1;
      for (int j = n_dense + lane; j < s8; j += 32) {
        const float4* p = table + 4 * j;
        const float t = obj_t(fr, __ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
        if (t < ft) {
          ft = t;
          fid = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, ft, off);
        const int oid = __shfl_xor_sync(0xffffffffu, fid, off);
        if (ot < ft || (ot == ft && oid < fid)) {
          ft = ot;
          fid = oid;
        }
      }
      if (lane == src && (ft < best_t || (ft == best_t && fid < best_id))) {
        best_t = ft;
        best_id = fid;
      }
    }
    if (active && !flat) {
      const tri_tree::Ray r = tri_tree::make_ray(q.ox, q.oy, q.oz, q.dx, q.dy, q.dz);
      tri_tree::Stack<kStack> stack;
      tri_tree::walk_tree(
          stack, tree.depth, r, best_t, row, margin,
          [&](int k) {
            const int j0 = k * tree.leaf;
            const int j1 = min(j0 + tree.leaf, tree.n);
            for (int j = j0; j < j1; ++j) {
              const float4* p = tree.rows + 4 * j;
              const float t = obj_t(q, __ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
              // A real hit may win; the id is read only for one at or
              // below the best t.
              if (t < kTMax && t <= best_t) {
                const int id = __ldg(tree.ids + j);
                if (t < best_t || id < best_id) {
                  best_t = t;
                  best_id = id;
                }
              }
            }
          });
    }
  }
  if (i < n) {
    t_out[i] = best_t;
    id_out[i] = best_id;
  }
}

// The dense sweep, kept as a check-only entry point (sphere_obj_dense_launch):
// one thread a ray in 256-thread blocks, the table staged in shared memory
// in tiles of kTile spheres, which all threads read at once (a broadcast),
// a running minimum with a strict < over ascending sphere ids.
__global__ void __launch_bounds__(kThreads)
sphere_obj_dense_kernel(const float4* __restrict__ table, int s8, const float* __restrict__ ox,
                        const float* __restrict__ oy, const float* __restrict__ oz,
                        const float* __restrict__ dx, const float* __restrict__ dy,
                        const float* __restrict__ dz, const unsigned char* __restrict__ alive,
                        int n, float* __restrict__ t_out, int* __restrict__ id_out) {
  // Sphere j: tile[4j] = M row 0, tile[4j+1] = M row 1, tile[4j+2] =
  // M row 2, tile[4j+3] = (c, r).
  __shared__ float4 tile[4 * kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n && alive[i] != 0;
  Ray q = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) q = {ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
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
        const float t = obj_t(q, tile[4 * j], tile[4 * j + 1], tile[4 * j + 2], tile[4 * j + 3]);
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

// table16: [s8, 16] f32, 16-byte aligned, its first n_dense rows swept
// densely; rows, nodes, ids: the tree over the spheres past them
// (ops/sphere_tree.py SphereTree: [n_tree, 16] f32, [2^depth - 1, 16] f32,
// [n_tree] i32; none for n_tree = 0), the first `staged` node rows staged
// in shared memory (a ray whose margin at the root is at least the root's
// largest side over kFlatRatio sweeps rows n_dense .. s8 - 1 densely
// instead); ox..dz: [n] f32; alive: [n] bool; t: [n] f32 out; id:
// [n] i32 out.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int sphere_obj_launch(const void* table16, int s8, int n_dense, const void* rows,
                                 const void* nodes, const void* ids, int n_tree, int depth,
                                 int leaf, int staged, const void* ox,
                                 const void* oy, const void* oz, const void* dx, const void* dy,
                                 const void* dz, const void* alive, int n, void* t, void* id,
                                 void* stream) {
  if (n_dense < 0 || n_dense > s8 || n_tree < 0 ||
      (n_tree > 0 && (depth < 0 || depth > kStack || leaf < 1 || staged < 0 ||
                      staged > kMaxStaged || staged > (1 << depth) - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const Tree tree{static_cast<const float4*>(rows), static_cast<const float4*>(nodes),
                    static_cast<const int*>(ids), n_tree, depth, leaf,
                    n_tree > 0 ? staged : 0};
    sphere_obj_kernel<<<(n + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table16), s8, n_dense, tree,
        static_cast<const float*>(ox),
        static_cast<const float*>(oy), static_cast<const float*>(oz),
        static_cast<const float*>(dx), static_cast<const float*>(dy),
        static_cast<const float*>(dz), static_cast<const unsigned char*>(alive), n,
        static_cast<float*>(t), static_cast<int*>(id));
  }
  return static_cast<int>(cudaGetLastError());
}

// The dense sweep: table16: [s8, 16] f32, 16-byte aligned; ox..dz: [n]
// f32; alive: [n] bool; t: [n] f32 out; id: [n] i32 out.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int sphere_obj_dense_launch(const void* table16, int s8, const void* ox,
                                       const void* oy, const void* oz, const void* dx,
                                       const void* dy, const void* dz, const void* alive,
                                       int n, void* t, void* id, void* stream) {
  if (n > 0) {
    sphere_obj_dense_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
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
