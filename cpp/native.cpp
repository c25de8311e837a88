// Native host runtime for colmap_pcd_tpu.
//
// The reference's host-side native core is FLANN (kd-tree, via PCL) and the
// C++ CorrespondenceGraph (src/base/correspondence_graph.{h,cc}); this file
// provides the same roles for this build's host side:
//
//   * kdtree_*   — exact 3D kd-tree: build once over the lidar map, batched
//                  1-NN / radius queries, OpenMP-parallel. Used as the
//                  host-side NN path (oracle + overlap with device work);
//                  the blocked brute-force scan (ops/pointcloud.nn_query)
//                  remains the device-side implementation.
//   * cg_*       — correspondence graph: CSR adjacency over (image, feature)
//                  keys with bulk build and batched queries, replacing
//                  Python-dict walks in the mapper's hot loop.
//
// C ABI only (loaded via ctypes; no pybind11 in this image). Build: `make`.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// kd-tree (3D, median split, leaf size 16)

struct KdNode {
  float split;
  int32_t axis;      // -1 for leaf
  int32_t left;      // node index
  int32_t right;     // node index; for leaves: [left, right) into indices
};

struct KdTree {
  std::vector<float> pts;       // [n,3]
  std::vector<int32_t> indices; // permutation
  std::vector<KdNode> nodes;
  int32_t n;
};

static int32_t kd_build_rec(KdTree* t, int32_t lo, int32_t hi, int depth) {
  int32_t node_id = (int32_t)t->nodes.size();
  t->nodes.push_back({});
  if (hi - lo <= 16) {
    t->nodes[node_id] = {0.f, -1, lo, hi};
    return node_id;
  }
  // pick widest axis
  float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
  for (int32_t i = lo; i < hi; i++) {
    const float* p = &t->pts[3 * t->indices[i]];
    for (int a = 0; a < 3; a++) {
      mn[a] = std::min(mn[a], p[a]);
      mx[a] = std::max(mx[a], p[a]);
    }
  }
  int axis = 0;
  for (int a = 1; a < 3; a++)
    if (mx[a] - mn[a] > mx[axis] - mn[axis]) axis = a;
  int32_t mid = (lo + hi) / 2;
  std::nth_element(
      t->indices.begin() + lo, t->indices.begin() + mid, t->indices.begin() + hi,
      [&](int32_t a, int32_t b) { return t->pts[3 * a + axis] < t->pts[3 * b + axis]; });
  float split = t->pts[3 * t->indices[mid] + axis];
  int32_t l = kd_build_rec(t, lo, mid, depth + 1);
  int32_t r = kd_build_rec(t, mid, hi, depth + 1);
  t->nodes[node_id] = {split, (int32_t)axis, l, r};
  return node_id;
}

void* kdtree_build(const float* pts, int32_t n) {
  KdTree* t = new KdTree();
  t->n = n;
  t->pts.assign(pts, pts + 3 * (size_t)n);
  t->indices.resize(n);
  for (int32_t i = 0; i < n; i++) t->indices[i] = i;
  t->nodes.reserve(2 * n / 16 + 64);
  if (n > 0) kd_build_rec(t, 0, n, 0);
  return t;
}

static void kd_nn_rec(const KdTree* t, int32_t node_id, const float* q,
                      float* best_d2, int32_t* best_i) {
  const KdNode& nd = t->nodes[node_id];
  if (nd.axis < 0) {
    for (int32_t i = nd.left; i < nd.right; i++) {
      const int32_t idx = t->indices[i];
      const float* p = &t->pts[3 * idx];
      float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
      float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < *best_d2) {
        *best_d2 = d2;
        *best_i = idx;
      }
    }
    return;
  }
  float diff = q[nd.axis] - nd.split;
  int32_t near = diff <= 0 ? nd.left : nd.right;
  int32_t far = diff <= 0 ? nd.right : nd.left;
  kd_nn_rec(t, near, q, best_d2, best_i);
  if (diff * diff < *best_d2) kd_nn_rec(t, far, q, best_d2, best_i);
}

void kdtree_nn(const void* handle, const float* queries, int32_t nq,
               int32_t* out_idx, float* out_d2) {
  const KdTree* t = (const KdTree*)handle;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int32_t i = 0; i < nq; i++) {
    float best = 1e30f;
    int32_t bi = -1;
    if (t->n > 0) kd_nn_rec(t, 0, &queries[3 * i], &best, &bi);
    out_idx[i] = bi;
    out_d2[i] = best;
  }
}

static void kd_radius_rec(const KdTree* t, int32_t node_id, const float* q,
                          float r2, std::vector<int32_t>& out) {
  const KdNode& nd = t->nodes[node_id];
  if (nd.axis < 0) {
    for (int32_t i = nd.left; i < nd.right; i++) {
      const int32_t idx = t->indices[i];
      const float* p = &t->pts[3 * idx];
      float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
      if (dx * dx + dy * dy + dz * dz <= r2) out.push_back(idx);
    }
    return;
  }
  float diff = q[nd.axis] - nd.split;
  int32_t near = diff <= 0 ? nd.left : nd.right;
  int32_t far = diff <= 0 ? nd.right : nd.left;
  kd_radius_rec(t, near, q, r2, out);
  if (diff * diff <= r2) kd_radius_rec(t, far, q, r2, out);
}

// Batched radius query with a per-query cap; returns counts.
void kdtree_radius(const void* handle, const float* queries, int32_t nq,
                   float radius, int32_t cap, int32_t* out_idx,
                   int32_t* out_count) {
  const KdTree* t = (const KdTree*)handle;
  float r2 = radius * radius;
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<int32_t> buf;
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int32_t i = 0; i < nq; i++) {
      buf.clear();
      if (t->n > 0) kd_radius_rec(t, 0, &queries[3 * i], r2, buf);
      int32_t m = std::min((int32_t)buf.size(), cap);
      for (int32_t k = 0; k < m; k++) out_idx[(size_t)i * cap + k] = buf[k];
      out_count[i] = m;
    }
  }
}

void kdtree_free(void* handle) { delete (KdTree*)handle; }

// ---------------------------------------------------------------------------
// correspondence graph: CSR adjacency over packed (image_id << 20 | feat) keys

struct CorrGraph {
  std::unordered_map<int64_t, int32_t> key_to_slot;
  std::vector<int64_t> slot_to_key;
  std::vector<int32_t> deg;       // temporary
  std::vector<int64_t> csr_off;
  std::vector<int64_t> csr_val;   // neighbor keys
  bool finalized = false;
  std::vector<std::pair<int64_t, int64_t>> edges;
};

void* cg_create() { return new CorrGraph(); }

void cg_add_matches(void* handle, const int64_t* keys1, const int64_t* keys2,
                    int32_t n) {
  CorrGraph* g = (CorrGraph*)handle;
  g->finalized = false;
  g->edges.reserve(g->edges.size() + n);
  for (int32_t i = 0; i < n; i++) g->edges.push_back({keys1[i], keys2[i]});
}

static void cg_finalize(CorrGraph* g) {
  if (g->finalized) return;
  g->key_to_slot.clear();
  g->slot_to_key.clear();
  auto slot = [&](int64_t k) -> int32_t {
    auto it = g->key_to_slot.find(k);
    if (it != g->key_to_slot.end()) return it->second;
    int32_t s = (int32_t)g->slot_to_key.size();
    g->key_to_slot.emplace(k, s);
    g->slot_to_key.push_back(k);
    return s;
  };
  std::vector<std::pair<int32_t, int64_t>> dir;
  dir.reserve(2 * g->edges.size());
  for (auto& e : g->edges) {
    dir.push_back({slot(e.first), e.second});
    dir.push_back({slot(e.second), e.first});
  }
  size_t ns = g->slot_to_key.size();
  g->csr_off.assign(ns + 1, 0);
  for (auto& d : dir) g->csr_off[d.first + 1]++;
  for (size_t i = 0; i < ns; i++) g->csr_off[i + 1] += g->csr_off[i];
  g->csr_val.resize(dir.size());
  std::vector<int64_t> cur(g->csr_off.begin(), g->csr_off.end() - 1);
  for (auto& d : dir) g->csr_val[cur[d.first]++] = d.second;
  g->finalized = true;
}

// Batched correspondence lookup: for each query key, write up to cap
// neighbor keys; returns counts.
void cg_find(void* handle, const int64_t* keys, int32_t nq, int32_t cap,
             int64_t* out_keys, int32_t* out_count) {
  CorrGraph* g = (CorrGraph*)handle;
  cg_finalize(g);
  for (int32_t i = 0; i < nq; i++) {
    auto it = g->key_to_slot.find(keys[i]);
    if (it == g->key_to_slot.end()) {
      out_count[i] = 0;
      continue;
    }
    int64_t lo = g->csr_off[it->second], hi = g->csr_off[it->second + 1];
    int32_t m = (int32_t)std::min<int64_t>(hi - lo, cap);
    for (int32_t k = 0; k < m; k++) out_keys[(size_t)i * cap + k] = g->csr_val[lo + k];
    out_count[i] = m;
  }
}

int64_t cg_num_nodes(void* handle) {
  CorrGraph* g = (CorrGraph*)handle;
  cg_finalize(g);
  return (int64_t)g->slot_to_key.size();
}

void cg_free(void* handle) { delete (CorrGraph*)handle; }

// One-shot bulk CSR build over packed (image<<20|feat) edge arrays, exported
// as flat arrays so Python can run fully vectorized batched queries with zero
// per-query C calls. Caller allocates out_keys[2n], out_off[2n+1], out_nbr[2n]
// (upper bounds); returns the number of unique keys M (out_off has M+1
// entries, out_nbr holds out_off[M] neighbor keys grouped by source key).
int64_t cg_build_csr(const int64_t* k1, const int64_t* k2, int64_t n_edges,
                     int64_t* out_keys, int64_t* out_off, int64_t* out_nbr) {
  std::vector<std::pair<int64_t, int64_t>> dir;
  dir.resize(2 * (size_t)n_edges);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n_edges; i++) {
    dir[2 * i] = {k1[i], k2[i]};
    dir[2 * i + 1] = {k2[i], k1[i]};
  }
  std::sort(dir.begin(), dir.end());
  int64_t m = 0;
  int64_t total = (int64_t)dir.size();
  out_off[0] = 0;
  for (int64_t i = 0; i < total; i++) {
    if (i == 0 || dir[i].first != dir[i - 1].first) {
      out_keys[m] = dir[i].first;
      out_off[m] = i;
      m++;
    }
    out_nbr[i] = dir[i].second;
  }
  out_off[m] = total;
  return m;
}

}  // extern "C"
