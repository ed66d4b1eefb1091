// The closest-hit walk of an implicit binary tree: a per-thread,
// nearest-first walk that the paged triangle sweep K3 (csrc/paged_tri.cu)
// and the triangle sweep K2 (csrc/tri_sweep.cu) run for each ray of the
// wavefront, over a soup's tree, the sphere sweep K1 (csrc/sphere_sweep.cu)
// over the spheres' tree (csrc/sphere_tree.cuh), and the fused bounce
// kernel K4 (csrc/megakernel.cu) at each bounce of its triangle forms and
// of its clustered sphere forms.  Every kernel includes this file, so the
// walks cannot drift apart: one loop (walk_tree), given how to read a
// node's row, how far to widen its children's boxes and how to test a
// leaf.
//
// The tree (ops/paged_tri.py build_tri_tree) is implicit: leaf k holds the
// triangle rows [k L, (k+1) L) and is node K - 1 + k; node n has children
// 2n + 1 and 2n + 2; each internal node is one 64-byte row, four float4:
// both children's boxes (left min xyz, left max xyz, right min xyz, right
// max xyz) and each child's reach (its box's largest |coordinate|).  A box
// holding no real triangle is the point (BIG, BIG, BIG) with reach 0,
// which never passes.  A triangle row is three float4, (v0, -), (e1, -),
// (e2, -).  K3's soup is in Morton order itself, so a row's slot is its
// id; K2's and K4's soup keeps its compiled order, and the tree is built
// over a Morton-permuted copy of its rows with an int32 slot -> id table
// (ops/paged_tri.py build_soup_tree), read here only for a hit at or
// below the best t.
//
// Walk (Aila and Laine, "Understanding the Efficiency of Ray Traversal on
// GPUs", HPG 2009: the while-while loop, a short stack, the nearer child
// first): at an internal node both children's boxes are slab-tested, each
// widened for this ray by (|o|_inf + reach) 2^-18 against the rounding of
// the slab and Moller-Trumbore tests far from the origin, and pruned as
// the TPU kernels prune (enter <= exit, exit > T_MIN, enter < best_t *
// 1.0001 + 1e-4, |d| kept at least 1e-30 in 1 / d).  Of two that pass,
// the one entered first is walked and the other pushed with its entry t,
// which is tested against the best t again when it is popped (the same
// test, as best t only falls).  At a leaf each triangle is tested with
// csrc/tri_sweep.cu's operations in its order.
//
// Bits.  The walk does not visit ids in ascending order, so a hit
// replaces the best one when t < best_t, or t == best_t and id < best_id:
// the lexicographic minimum of (t, id) over the triangles visited and the
// seed the caller passes in (K4: the sphere sweep's best, whose ids are
// below every triangle's, so a sphere keeps an equal-t hit as in the dense
// order).  The boxes are conservative (widened, and the test passes for
// any best t at or above a hit's own t whose point lies on its triangle),
// so the dense sweep's winner is always visited, and the lexicographic
// minimum over any superset holding it is that winner, bit for bit,
// whatever the order.  A file that includes this one is built with
// -fmad=false (ops/_build.py KERNEL_FLAGS), so every operation rounds as
// the plain PyTorch versions' (ops/paged_tri.py tri_tree_sweep_reference,
// ops/tri_sweep.py).

#pragma once

#include <cuda_runtime.h>

namespace tri_tree {

constexpr float kTMin = 0.001f;        // ops/intersect.py T_MIN
constexpr float kTMax = 10000.0f;      // ops/intersect.py T_MAX
constexpr float kSlabEps = 1e-30f;     // ops/paged_tri.py _SLAB_EPS
constexpr float kRounding = 0x1p-18f;  // ops/paged_tri.py TREE_ROUNDING

// A ray with what the box tests reuse: 1 / d and |o|_inf.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, o_inf;
};

__device__ __forceinline__ float slab_inv(float d) {
  return 1.0f / (fabsf(d) < kSlabEps ? (d < 0.0f ? -kSlabEps : kSlabEps) : d);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ivx = slab_inv(dx); r.ivy = slab_inv(dy); r.ivz = slab_inv(dz);
  r.o_inf = fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
  return r;
}

// The slab test of the ray against the box (lo, hi) widened by m on every
// side, pruned by its best t; *te_out is the entry t.
__device__ __forceinline__ bool box_passes(float lx, float ly, float lz, float hx, float hy,
                                           float hz, float m, const Ray& r, float best_t,
                                           float* te_out) {
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

// The Moller-Trumbore test of the ray against the triangle (v0, e1, e2)
// in csrc/tri_sweep.cu's operation order: true on a hit in (T_MIN, T_MAX),
// with its t and barycentrics u, v.  Every triangle walk's leaf test (K2,
// K3, K4 through walk below, and the BVH walk H1 of csrc/bvh_walk.cu).
__device__ __forceinline__ bool tri_hit(const Ray& r, float4 v0, float4 e1, float4 e2,
                                        float& t, float& u, float& v) {
  const float px = r.dy * e2.z - r.dz * e2.y;
  const float py = r.dz * e2.x - r.dx * e2.z;
  const float pz = r.dx * e2.y - r.dy * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0.x;
  const float ty = r.oy - v0.y;
  const float tz = r.oz - v0.z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  return det != 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTMin && t < kTMax;
}

// The walk's stack: one entry a level at most.  A caller that runs two
// walks one after the other (K4's sphere and triangle walks) passes both
// the same stack.
template <int kStack>
struct Stack {
  int node[kStack];
  float te[kStack];
};

// The nearest-first walk of an implicit tree of `depth` levels, updating
// best_t through `leaf`.  row(node, a, b, c, e) reads internal node's
// 64-byte row (both children's boxes in a, b, c); margin(e, right) gives
// the left or right child's widening from its fourth float4; leaf(k) tests leaf
// k's primitives against the ray and lowers best_t (and the caller's id)
// where one wins.  The triangle walk below and K4's sphere walk
// (csrc/megakernel.cu) are this loop with their own three.
template <int kStack, typename Row, typename Margin, typename Leaf>
__device__ __forceinline__ void walk_tree(Stack<kStack>& stack, int depth, const Ray& r,
                                          float& best_t, Row row, Margin margin, Leaf leaf) {
  const int first_leaf = (1 << depth) - 1;
  int sp = 0;
  int node = 0;
  while (node >= 0) {
    if (node < first_leaf) {
      float4 a, b, c, e;
      row(node, a, b, c, e);
      float tl, tr;
      const bool hl = box_passes(a.x, a.y, a.z, a.w, b.x, b.y, margin(e, false), r, best_t, &tl);
      const bool hr = box_passes(b.z, b.w, c.x, c.y, c.z, c.w, margin(e, true), r, best_t, &tr);
      const int left = 2 * node + 1;
      if (hl && hr) {
        const bool left_first = tl <= tr;
        node = left_first ? left : left + 1;
        stack.node[sp] = left_first ? left + 1 : left;
        stack.te[sp] = left_first ? tr : tl;
        ++sp;
        continue;
      }
      if (hl || hr) {
        node = hl ? left : left + 1;
        continue;
      }
    } else {
      leaf(node - first_leaf);
    }
    // Pop the nearest pending sibling that still passes.
    node = -1;
    while (sp > 0) {
      --sp;
      if (stack.te[sp] < best_t * 1.0001f + 1e-4f) {
        node = stack.node[sp];
        break;
      }
    }
  }
}

struct Tree {
  const float4* tris;  // [>= n_tris, 3] (v0, -), (e1, -), (e2, -)
  const float4* nodes;  // [K - 1, 4]
  const int* ids;       // [n_tris] slot -> id (kIds), else unused
  int n_tris, depth, leaf;
};

// The triangle walk of one ray, updating (best_t, best_id, best_u,
// best_v) as the lexicographic minimum of (t, id); a triangle's id is its
// slot, or with kIds id_base + ids[slot].  on_hit(v0, e1, e2, u, v) runs
// at each update (K4 captures the hit point there).  Each child box is
// widened by (|o|_inf + reach) 2^-18.
template <int kStack, bool kIds, typename OnHit>
__device__ __forceinline__ void walk(Stack<kStack>& stack, const Tree& tree, const Ray& r,
                                     int id_base, float& best_t, int& best_id, float& best_u,
                                     float& best_v, OnHit on_hit) {
  walk_tree(
      stack, tree.depth, r, best_t,
      [&](int node, float4& a, float4& b, float4& c, float4& e) {
        const float4* row = tree.nodes + 4 * node;
        a = __ldg(row);
        b = __ldg(row + 1);
        c = __ldg(row + 2);
        e = __ldg(row + 3);
      },
      [&](float4 e, bool right) { return (r.o_inf + (right ? e.y : e.x)) * kRounding; },
      [&](int k) {
        const int j0 = k * tree.leaf;
        const int j1 = min(j0 + tree.leaf, tree.n_tris);
        for (int j = j0; j < j1; ++j) {
          const float4 v0 = __ldg(tree.tris + 3 * j);
          const float4 e1 = __ldg(tree.tris + 3 * j + 1);
          const float4 e2 = __ldg(tree.tris + 3 * j + 2);
          float t, u, v;
          const bool ok = tri_hit(r, v0, e1, e2, t, u, v);
          if constexpr (kIds) {
            // The id table is read only for a hit that may win.
            if (ok && t <= best_t) {
              const int id = id_base + __ldg(tree.ids + j);
              if (t < best_t || id < best_id) {
                best_t = t;
                best_id = id;
                best_u = u;
                best_v = v;
                on_hit(v0, e1, e2, u, v);
              }
            }
          } else {
            if (ok && (t < best_t || (t == best_t && j < best_id))) {
              best_t = t;
              best_id = j;
              best_u = u;
              best_v = v;
              on_hit(v0, e1, e2, u, v);
            }
          }
        }
      });
}

}  // namespace tri_tree
