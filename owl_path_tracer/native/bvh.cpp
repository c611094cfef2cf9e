// Native binned-SAH BVH builder.
//
// The runtime counterpart of the OptiX acceleration-structure build the
// reference gets from hardware (owlGroupBuildAccel, application.cpp:131-140):
// scene compilation for large meshes (dragon-class, 10^5..10^7 triangles)
// needs a fast host-side builder, and the pure-numpy one (ops/bvh.py) is the
// semantic reference but ~20x slower.  Same output contract as FlatBVH:
// depth-first node arrays (node_min/max [NN,3], node_a/node_b [NN] with
// node_b<0 tagging leaves holding -count), plus the triangle permutation.
//
// Build: `make -C owl_path_tracer/native` -> libowlpt_native.so
// Binding: ctypes (owl_path_tracer/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr float kInf = std::numeric_limits<float>::infinity();

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
  Vec3 lo{kInf, kInf, kInf};
  Vec3 hi{-kInf, -kInf, -kInf};
  void grow(const Aabb& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const float* verts;
  const int32_t* tris;
  int64_t n_tris;
  int32_t max_leaf;

  std::vector<Aabb> tri_bounds;
  std::vector<Vec3> centroids;
  std::vector<int32_t> order;

  std::vector<float> node_min, node_max;
  std::vector<int32_t> node_a, node_b;

  int32_t alloc_node() {
    node_min.insert(node_min.end(), {0, 0, 0});
    node_max.insert(node_max.end(), {0, 0, 0});
    node_a.push_back(0);
    node_b.push_back(0);
    return static_cast<int32_t>(node_a.size()) - 1;
  }

  void set_bounds(int32_t node, const Aabb& b) {
    node_min[3 * node + 0] = b.lo.x;
    node_min[3 * node + 1] = b.lo.y;
    node_min[3 * node + 2] = b.lo.z;
    node_max[3 * node + 0] = b.hi.x;
    node_max[3 * node + 1] = b.hi.y;
    node_max[3 * node + 2] = b.hi.z;
  }

  void prepare() {
    tri_bounds.resize(n_tris);
    centroids.resize(n_tris);
    order.resize(n_tris);
    for (int64_t i = 0; i < n_tris; ++i) {
      Aabb b;
      for (int c = 0; c < 3; ++c) {
        const float* p = verts + 3ll * tris[3 * i + c];
        b.grow(Vec3{p[0], p[1], p[2]});
      }
      tri_bounds[i] = b;
      centroids[i] = {(b.lo.x + b.hi.x) * 0.5f, (b.lo.y + b.hi.y) * 0.5f,
                      (b.lo.z + b.hi.z) * 0.5f};
      order[i] = static_cast<int32_t>(i);
    }
  }

  // Split [begin,end) of `order`; returns mid or begin (= make leaf).
  int64_t find_split(int64_t begin, int64_t end, const Aabb& bounds) {
    int64_t n = end - begin;
    Aabb cb;  // centroid bounds
    for (int64_t i = begin; i < end; ++i) cb.grow(centroids[order[i]]);
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 1e-12f) return begin;

    float lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
    float scale = kBins * (1.0f - 1e-6f) / ext[axis];

    Aabb bin_bounds[kBins];
    int64_t bin_count[kBins] = {0};
    for (int64_t i = begin; i < end; ++i) {
      const Vec3& c = centroids[order[i]];
      float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
      int b = static_cast<int>((v - lo) * scale);
      b = std::min(std::max(b, 0), kBins - 1);
      bin_bounds[b].grow(tri_bounds[order[i]]);
      ++bin_count[b];
    }

    // sweep: left prefix / right suffix SAH
    Aabb right[kBins];
    Aabb acc;
    int64_t rcount[kBins];
    int64_t rc = 0;
    for (int b = kBins - 1; b >= 0; --b) {
      acc.grow(bin_bounds[b]);
      rc += bin_count[b];
      right[b] = acc;
      rcount[b] = rc;
    }
    Aabb lacc;
    int64_t lc = 0;
    float best_cost = kInf;
    int best_bin = -1;
    for (int b = 0; b < kBins - 1; ++b) {
      lacc.grow(bin_bounds[b]);
      lc += bin_count[b];
      if (lc == 0 || rcount[b + 1] == 0) continue;
      float cost = lacc.half_area() * lc + right[b + 1].half_area() * rcount[b + 1];
      if (cost < best_cost) {
        best_cost = cost;
        best_bin = b;
      }
    }
    float parent_area = bounds.half_area();
    if (best_bin < 0) return begin;
    if (parent_area > 0 && best_cost / parent_area >= static_cast<float>(n) &&
        n <= max_leaf)
      return begin;

    auto mid_it = std::partition(
        order.begin() + begin, order.begin() + end, [&](int32_t t) {
          const Vec3& c = centroids[t];
          float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
          int b = static_cast<int>((v - lo) * scale);
          b = std::min(std::max(b, 0), kBins - 1);
          return b <= best_bin;
        });
    int64_t mid = mid_it - order.begin();
    if (mid == begin || mid == end) {
      // degenerate: median split on the axis
      mid = begin + n / 2;
      std::nth_element(order.begin() + begin, order.begin() + mid,
                       order.begin() + end, [&](int32_t a, int32_t b2) {
                         const Vec3 &ca = centroids[a], &cb2 = centroids[b2];
                         float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                         float vb = axis == 0 ? cb2.x : (axis == 1 ? cb2.y : cb2.z);
                         return va < vb;
                       });
    }
    return mid;
  }

  void build() {
    prepare();
    struct Item {
      int32_t node;
      int64_t begin, end;
    };
    std::vector<Item> stack;
    int32_t root = alloc_node();
    stack.push_back({root, 0, n_tris});
    while (!stack.empty()) {
      Item it = stack.back();
      stack.pop_back();
      Aabb b;
      for (int64_t i = it.begin; i < it.end; ++i) b.grow(tri_bounds[order[i]]);
      set_bounds(it.node, b);
      int64_t n = it.end - it.begin;
      int64_t mid = it.begin;
      if (n > max_leaf) mid = find_split(it.begin, it.end, b);
      if (mid == it.begin || mid == it.end) {
        node_a[it.node] = static_cast<int32_t>(it.begin);
        node_b[it.node] = static_cast<int32_t>(-n);
        continue;
      }
      int32_t l = alloc_node();
      int32_t r = alloc_node();
      node_a[it.node] = l;
      node_b[it.node] = r;
      stack.push_back({r, mid, it.end});
      stack.push_back({l, it.begin, mid});
    }
  }
};

}  // namespace

extern "C" {

// Returns number of nodes (<= 2*n_tris), or -1 on error.
// Output buffers must be sized for 2*n_tris nodes and n_tris order entries.
int64_t owlpt_build_bvh(const float* vertices, int64_t n_verts,
                        const int32_t* tri_idx, int64_t n_tris,
                        int32_t max_leaf, float* out_node_min,
                        float* out_node_max, int32_t* out_node_a,
                        int32_t* out_node_b, int32_t* out_tri_order) {
  (void)n_verts;
  if (n_tris <= 0 || max_leaf <= 0) return -1;
  Builder b{vertices, tri_idx, n_tris, max_leaf, {}, {}, {}, {}, {}, {}, {}};
  b.build();
  int64_t n_nodes = static_cast<int64_t>(b.node_a.size());
  if (n_nodes > 2 * n_tris) return -1;
  std::memcpy(out_node_min, b.node_min.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_node_max, b.node_max.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_node_a, b.node_a.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(out_node_b, b.node_b.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(out_tri_order, b.order.data(), sizeof(int32_t) * n_tris);
  return n_nodes;
}

// Cluster extraction in leaf order: fills padded [K, C] triangle clusters
// directly (matches ops/cluster.py build_clusters layout) so Python never
// loops over leaves for big scenes.
int64_t owlpt_extract_clusters(
    const float* vertices, const int32_t* tri_idx, int64_t n_tris,
    const float* node_min, const float* node_max, const int32_t* node_a,
    const int32_t* node_b, int64_t n_nodes, const int32_t* tri_order,
    int32_t cluster_size,
    // outputs sized for k_max = number of leaves:
    float* cmin, float* cmax,        // [K,3]
    float* blob,                     // [K, C*9] (p0,e1,e2 per tri)
    int32_t* tid                     // [K, C], -1 padded
) {
  int64_t k = 0;
  const int32_t c = cluster_size;
  for (int64_t nidx = 0; nidx < n_nodes; ++nidx) {
    if (node_b[nidx] >= 0) continue;  // internal
    int32_t start = node_a[nidx];
    int32_t cnt = -node_b[nidx];
    if (cnt > c) return -1;
    std::memcpy(cmin + 3 * k, node_min + 3 * nidx, 3 * sizeof(float));
    std::memcpy(cmax + 3 * k, node_max + 3 * nidx, 3 * sizeof(float));
    float* bl = blob + k * (9ll * c);
    int32_t* td = tid + k * c;
    for (int32_t j = 0; j < c; ++j) {
      if (j < cnt) {
        int32_t t = tri_order[start + j];
        const float* p0 = vertices + 3ll * tri_idx[3 * t + 0];
        const float* p1 = vertices + 3ll * tri_idx[3 * t + 1];
        const float* p2 = vertices + 3ll * tri_idx[3 * t + 2];
        for (int a = 0; a < 3; ++a) bl[9 * j + a] = p0[a];
        for (int a = 0; a < 3; ++a) bl[9 * j + 3 + a] = p1[a] - p0[a];
        for (int a = 0; a < 3; ++a) bl[9 * j + 6 + a] = p2[a] - p0[a];
        td[j] = t;
      } else {
        for (int a = 0; a < 9; ++a) bl[9 * j + a] = 0.f;
        td[j] = -1;
      }
    }
    ++k;
  }
  return k;
}

}  // extern "C"
