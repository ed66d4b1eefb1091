// Binned-SAH BVH builder: the port's copy of the JAX package's
// native/bvh_builder.cc (the replacement for the reference's driver-built
// BLAS/TLAS, raytracer/src/acceleration.rs), the same code, so both
// packages build the same tree bit for bit.
//
// Exposed as a C ABI consumed from Python via ctypes
// (raytrace_tpu_torch/models/bvh_native.py, which builds it with g++ at
// first use into raytrace_tpu_torch/build/).
// Output format is what the device traversal kernel wants: one f32 row of
// 16 per internal node holding BOTH children's AABBs plus the two child
// links bitcast into float slots 12/13:
//
//   row = [c0.min xyz, c0.max xyz, c1.min xyz, c1.max xyz,
//          bits(c0_link), bits(c1_link), 0, 0]
//
// A link >= 0 is an internal node index; a link < 0 encodes a leaf as
//   link = -(1 + (first_tri << 5 | tri_count))
// over the REORDERED triangle array (the builder also outputs the
// permutation).  Leaves hold at most LEAF_MAX (<=31) triangles.
//
// Build: top-down binned SAH (16 bins, largest-extent axis fallback,
// full-SAH axis choice), median split when SAH degenerates.  Single
// threaded; ~2M tris/s is plenty for host-side scene compilation.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AABB {
  float mn[3] = {3e38f, 3e38f, 3e38f};
  float mx[3] = {-3e38f, -3e38f, -3e38f};

  void grow(const AABB& o) {
    for (int i = 0; i < 3; ++i) {
      mn[i] = std::min(mn[i], o.mn[i]);
      mx[i] = std::max(mx[i], o.mx[i]);
    }
  }
  void grow_point(const float* p) {
    for (int i = 0; i < 3; ++i) {
      mn[i] = std::min(mn[i], p[i]);
      mx[i] = std::max(mx[i], p[i]);
    }
  }
  float half_area() const {
    float d0 = std::max(0.f, mx[0] - mn[0]);
    float d1 = std::max(0.f, mx[1] - mn[1]);
    float d2 = std::max(0.f, mx[2] - mn[2]);
    return d0 * d1 + d1 * d2 + d2 * d0;
  }
};

struct Builder {
  const float* tri_mn;  // [T,3]
  const float* tri_mx;  // [T,3]
  int leaf_max;
  int32_t max_depth = 0;
  std::vector<int32_t> order;       // triangle permutation being built
  std::vector<float> centroids;     // [T,3]
  std::vector<float> rows;          // 16 floats per internal node

  AABB tri_box(int32_t t) const {
    AABB b;
    for (int i = 0; i < 3; ++i) {
      b.mn[i] = tri_mn[3 * t + i];
      b.mx[i] = tri_mx[3 * t + i];
    }
    return b;
  }

  static int32_t leaf_link(int32_t first, int32_t count) {
    return -(1 + ((first << 5) | count));
  }

  // Builds the subtree over order[lo, hi); returns a child link.
  int32_t build(int32_t lo, int32_t hi, int32_t depth = 0) {
    if (depth > max_depth) max_depth = depth;
    int32_t n = hi - lo;
    if (n <= leaf_max) return leaf_link(lo, n);

    // Centroid bounds for binning.
    AABB cb;
    for (int32_t i = lo; i < hi; ++i) cb.grow_point(&centroids[3 * order[i]]);

    constexpr int NBINS = 16;
    int best_axis = -1, best_bin = -1;
    float best_cost = 3e38f;

    for (int axis = 0; axis < 3; ++axis) {
      float lo_c = cb.mn[axis], hi_c = cb.mx[axis];
      if (hi_c - lo_c < 1e-12f) continue;
      float scale = NBINS / (hi_c - lo_c);

      AABB bins[NBINS];
      int32_t counts[NBINS] = {0};
      for (int32_t i = lo; i < hi; ++i) {
        int32_t t = order[i];
        int b = std::min(NBINS - 1,
                         (int)((centroids[3 * t + axis] - lo_c) * scale));
        bins[b].grow(tri_box(t));
        counts[b]++;
      }
      AABB right[NBINS];
      AABB acc;
      for (int b = NBINS - 1; b >= 1; --b) {
        acc.grow(bins[b]);
        right[b] = acc;
      }
      AABB left;
      int32_t nleft = 0;
      for (int b = 0; b < NBINS - 1; ++b) {
        left.grow(bins[b]);
        nleft += counts[b];
        int32_t nright = n - nleft;
        if (nleft == 0 || nright == 0) continue;
        float cost = left.half_area() * nleft + right[b + 1].half_area() * nright;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }

    int32_t mid;
    if (best_axis < 0) {
      mid = lo + n / 2;  // degenerate: median split on the order
    } else {
      float lo_c = cb.mn[best_axis];
      float scale = NBINS / (cb.mx[best_axis] - lo_c);
      auto it = std::partition(
          order.begin() + lo, order.begin() + hi, [&](int32_t t) {
            int b = std::min(NBINS - 1,
                             (int)((centroids[3 * t + best_axis] - lo_c) * scale));
            return b <= best_bin;
          });
      mid = (int32_t)(it - order.begin());
      if (mid == lo || mid == hi) mid = lo + n / 2;
    }

    // Reserve this node's row, then recurse.
    int32_t node = (int32_t)(rows.size() / 16);
    rows.resize(rows.size() + 16, 0.f);

    int32_t l0 = build(lo, mid, depth + 1);
    int32_t l1 = build(mid, hi, depth + 1);

    // Child AABBs over their triangle ranges (from links or recursion —
    // recompute from ranges for simplicity: ranges are [lo,mid),[mid,hi)).
    AABB b0, b1;
    for (int32_t i = lo; i < mid; ++i) b0.grow(tri_box(order[i]));
    for (int32_t i = mid; i < hi; ++i) b1.grow(tri_box(order[i]));

    float* r = &rows[(size_t)node * 16];
    std::memcpy(r + 0, b0.mn, 12);
    std::memcpy(r + 3, b0.mx, 12);
    std::memcpy(r + 6, b1.mn, 12);
    std::memcpy(r + 9, b1.mx, 12);
    std::memcpy(r + 12, &l0, 4);
    std::memcpy(r + 13, &l1, 4);
    return node;
  }
};

}  // namespace

extern "C" {

// Returns the number of internal nodes (rows) written, or -1 on error.
// rows_out must have capacity >= 16 * max(1, num_tris) floats.
// order_out must have capacity num_tris int32s.
// root_out receives [0] the root link (negative = single-leaf scene) and
// [1] the tree depth.
int32_t rtpu_build_bvh(const float* tri_mn, const float* tri_mx,
                       int32_t num_tris, int32_t leaf_max,
                       float* rows_out, int32_t* order_out,
                       int32_t* root_out) {
  if (num_tris <= 0 || leaf_max <= 0 || leaf_max > 31) return -1;
  Builder b;
  b.tri_mn = tri_mn;
  b.tri_mx = tri_mx;
  b.leaf_max = leaf_max;
  b.order.resize(num_tris);
  for (int32_t i = 0; i < num_tris; ++i) b.order[i] = i;
  b.centroids.resize((size_t)num_tris * 3);
  for (int32_t t = 0; t < num_tris; ++t)
    for (int i = 0; i < 3; ++i)
      b.centroids[3 * (size_t)t + i] =
          0.5f * (tri_mn[3 * (size_t)t + i] + tri_mx[3 * (size_t)t + i]);
  b.rows.reserve((size_t)num_tris * 4);

  int32_t root = b.build(0, num_tris);
  root_out[0] = root;
  root_out[1] = b.max_depth;

  std::memcpy(order_out, b.order.data(), (size_t)num_tris * 4);
  int32_t n_nodes = (int32_t)(b.rows.size() / 16);
  std::memcpy(rows_out, b.rows.data(), b.rows.size() * 4);
  return n_nodes;
}

}  // extern "C"
