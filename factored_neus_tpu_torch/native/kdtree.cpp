// 3-D KD-tree nearest-neighbour queries and the greedy radius downsample
// of the Chamfer evaluations: host-side native component of the PyTorch
// port (C ABI for ctypes).  The port's own copy of
// factored_neus_tpu/native/kdtree.cpp, built into the port's library
// (factored_neus_tpu_torch/native/__init__.py).
//
// A median-split KD-tree with iterative best-first search, built once per
// cloud and queried from plain threads (no external dependencies).
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct Node {
  float split;
  int32_t axis;       // -1 for leaf
  int32_t left, right;  // children or [begin,end) into indices for leaves
};

struct Tree {
  std::vector<Node> nodes;
  std::vector<int32_t> indices;
  std::vector<float> pts;  // [n*3]
  int64_t n;
};

constexpr int kLeafSize = 16;

int32_t build(Tree& t, int32_t* idx, int64_t count, int64_t offset) {
  int32_t node_id = (int32_t)t.nodes.size();
  t.nodes.push_back({});
  if (count <= kLeafSize) {
    t.nodes[node_id] = {0.f, -1, (int32_t)offset, (int32_t)(offset + count)};
    return node_id;
  }
  // split on the widest axis at the median
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < count; ++i) {
    const float* p = &t.pts[3 * idx[i]];
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], p[a]);
      hi[a] = std::max(hi[a], p[a]);
    }
  }
  int axis = 0;
  for (int a = 1; a < 3; ++a)
    if (hi[a] - lo[a] > hi[axis] - lo[axis]) axis = a;
  int64_t mid = count / 2;
  std::nth_element(idx, idx + mid, idx + count,
                   [&](int32_t a, int32_t b) {
                     return t.pts[3 * a + axis] < t.pts[3 * b + axis];
                   });
  float split = t.pts[3 * idx[mid] + axis];
  int32_t left = build(t, idx, mid, offset);
  int32_t right = build(t, idx + mid, count - mid, offset + mid);
  t.nodes[node_id] = {split, (int32_t)axis, left, right};
  return node_id;
}

inline void query_one(const Tree& t, const float* q, float* best_d2,
                      int32_t* best_i) {
  float bd = std::numeric_limits<float>::max();
  int32_t bi = -1;
  // manual stack of (node, min possible d2 along path)
  struct Item { int32_t node; float d2; };
  Item stack[64];
  int sp = 0;
  stack[sp++] = {0, 0.f};
  while (sp) {
    Item it = stack[--sp];
    if (it.d2 >= bd) continue;
    const Node& nd = t.nodes[it.node];
    if (nd.axis < 0) {
      for (int32_t i = nd.left; i < nd.right; ++i) {
        const float* p = &t.pts[3 * t.indices[i]];
        float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < bd) {
          bd = d2;
          bi = t.indices[i];
        }
      }
      continue;
    }
    float diff = q[nd.axis] - nd.split;
    int32_t near = diff < 0 ? nd.left : nd.right;
    int32_t far = diff < 0 ? nd.right : nd.left;
    float far_d2 = diff * diff;
    if (far_d2 < bd) stack[sp++] = {far, far_d2};
    stack[sp++] = {near, it.d2};
  }
  *best_d2 = bd;
  *best_i = bi;
}

}  // namespace

extern "C" {

void* kdtree_build(const float* pts, int64_t n) {
  Tree* t = new Tree();
  t->n = n;
  t->pts.assign(pts, pts + 3 * n);
  t->indices.resize(n);
  for (int64_t i = 0; i < n; ++i) t->indices[i] = (int32_t)i;
  t->nodes.reserve(2 * n / kLeafSize + 4);
  if (n > 0) build(*t, t->indices.data(), n, 0);
  return t;
}

void kdtree_free(void* handle) { delete (Tree*)handle; }

// nearest neighbor for each query point; writes distances (not squared) and
// indices.  Multithreaded over queries.
void kdtree_query(const void* handle, const float* queries, int64_t m,
                  float* out_dist, int32_t* out_idx) {
  const Tree* t = (const Tree*)handle;
  if (t->n == 0) {
    for (int64_t i = 0; i < m; ++i) {
      out_dist[i] = std::numeric_limits<float>::max();
      out_idx[i] = -1;
    }
    return;
  }
  int n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
  if (m < 4096) n_threads = 1;
  std::vector<std::thread> threads;
  std::atomic<int64_t> next(0);
  constexpr int64_t kChunk = 4096;
  auto worker = [&]() {
    for (;;) {
      int64_t begin = next.fetch_add(kChunk);
      if (begin >= m) break;
      int64_t end = std::min(begin + kChunk, m);
      for (int64_t i = begin; i < end; ++i) {
        float d2;
        int32_t bi;
        query_one(*t, &queries[3 * i], &d2, &bi);
        out_dist[i] = std::sqrt(d2);
        out_idx[i] = bi;
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    for (int i = 0; i < n_threads; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
}

// count of tree points within `radius` of each query (used by the DTU
// density-based downsampling, ref:evaluation/dtu_eval.py:85-93)
void kdtree_query_radius_count(const void* handle, const float* queries,
                               int64_t m, float radius, int32_t* out_count) {
  const Tree* t = (const Tree*)handle;
  if (t->n == 0) {  // empty tree: node 0 does not exist
    for (int64_t i = 0; i < m; ++i) out_count[i] = 0;
    return;
  }
  float r2 = radius * radius;
  int n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
  if (m < 4096) n_threads = 1;
  std::atomic<int64_t> next(0);
  constexpr int64_t kChunk = 4096;
  auto worker = [&]() {
    for (;;) {
      int64_t begin = next.fetch_add(kChunk);
      if (begin >= m) break;
      int64_t end = std::min(begin + kChunk, m);
      for (int64_t i = begin; i < end; ++i) {
        const float* q = &queries[3 * i];
        int32_t cnt = 0;
        struct Item { int32_t node; float d2; };
        Item stack[64];
        int sp = 0;
        stack[sp++] = {0, 0.f};
        while (sp) {
          Item it = stack[--sp];
          if (it.d2 > r2) continue;
          const Node& nd = t->nodes[it.node];
          if (nd.axis < 0) {
            for (int32_t j = nd.left; j < nd.right; ++j) {
              const float* p = &t->pts[3 * t->indices[j]];
              float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
              if (dx * dx + dy * dy + dz * dz <= r2) ++cnt;
            }
            continue;
          }
          float diff = q[nd.axis] - nd.split;
          int32_t near = diff < 0 ? nd.left : nd.right;
          int32_t far = diff < 0 ? nd.right : nd.left;
          float far_d2 = diff * diff;
          if (far_d2 <= r2) stack[sp++] = {far, far_d2};
          stack[sp++] = {near, it.d2};
        }
        out_count[i] = cnt;
      }
    }
  };
  std::vector<std::thread> threads;
  if (n_threads == 1) {
    worker();
  } else {
    for (int i = 0; i < n_threads; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
}

// Greedy density downsample (the DTU protocol's radius-suppression pass,
// ref:evaluation/dtu_eval.py:85-93): walk points in order; if not yet
// suppressed, keep it and suppress every neighbor within `radius`.
// Sequential by construction (order matters), all in native code.
void kdtree_greedy_downsample(const float* pts, int64_t n, float radius,
                              uint8_t* out_keep) {
  Tree* t = (Tree*)kdtree_build(pts, n);
  float r2 = radius * radius;
  std::vector<uint8_t> suppressed(n, 0);
  std::vector<int32_t> stack_nodes;
  for (int64_t i = 0; i < n; ++i) {
    if (suppressed[i]) {
      out_keep[i] = 0;
      continue;
    }
    out_keep[i] = 1;
    const float* q = &pts[3 * i];
    // suppress neighbors in radius
    struct Item { int32_t node; float d2; };
    Item stack[64];
    int sp = 0;
    stack[sp++] = {0, 0.f};
    while (sp) {
      Item it = stack[--sp];
      if (it.d2 > r2) continue;
      const Node& nd = t->nodes[it.node];
      if (nd.axis < 0) {
        for (int32_t j = nd.left; j < nd.right; ++j) {
          int32_t pi = t->indices[j];
          const float* p = &t->pts[3 * pi];
          float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
          if (dx * dx + dy * dy + dz * dz <= r2) suppressed[pi] = 1;
        }
        continue;
      }
      float diff = q[nd.axis] - nd.split;
      int32_t near = diff < 0 ? nd.left : nd.right;
      int32_t far = diff < 0 ? nd.right : nd.left;
      float far_d2 = diff * diff;
      if (far_d2 <= r2) stack[sp++] = {far, far_d2};
      stack[sp++] = {near, it.d2};
    }
  }
  delete t;
}

}  // extern "C"
