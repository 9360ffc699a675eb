// Native runtime components for the distribution ray tracer.
//
// The reference implements its accelerator builds and scene parsing in C++
// (bvh.cpp:27-227, grid.cpp:30-97, scene.cpp:474-740); these are init-time
// host paths that feed static tables to the device, and Python is too slow for
// them at dragon scale (100k triangles).  This library provides:
//
//  - drt_build_bvh: 12-bucket SAH BVH over object AABBs, flat array layout
//    (left child = i, right = i+1; leaf index = first-object offset) exactly
//    matching bvh.cpp's build_recursive semantics and the NumPy fallback
//    builder in accel/bvh.py (stable centroid sorts, double-precision SAH).
//  - drt_grid_insert: uniform-grid cell insertion (grid.cpp:75-92) emitting
//    CSR arrays.
//  - drt_parse_floats: bulk whitespace-separated float tokenizer for P3F
//    mesh blocks (scene.cpp:565-594).
//
// C ABI only; loaded from Python via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kLeafThreshold = 2;  // bvh.cpp:65
constexpr int kBuckets = 12;       // bvh.cpp:66

struct Node {
  double bmin[3], bmax[3];
  bool leaf = false;
  int index = 0;
  int nobjs = 0;
};

inline double area(const double lo[3], const double hi[3]) {
  double e0 = hi[0] - lo[0], e1 = hi[1] - lo[1], e2 = hi[2] - lo[2];
  return 2.0 * (e0 * e1 + e0 * e2 + e1 * e2);
}

struct Builder {
  const float* bmin;
  const float* bmax;
  std::vector<double> centroid;  // n*3
  std::vector<int64_t> order;
  std::vector<Node> nodes;

  void build(int64_t n) {
    centroid.resize(n * 3);
    order.resize(n);
    for (int64_t i = 0; i < n; i++) {
      order[i] = i;
      for (int a = 0; a < 3; a++)
        centroid[i * 3 + a] = 0.5 * ((double)bmin[i * 3 + a] +
                                     (double)bmax[i * 3 + a]);
    }
    Node root;
    for (int a = 0; a < 3; a++) {
      double lo = std::numeric_limits<double>::infinity();
      double hi = -lo;
      for (int64_t i = 0; i < n; i++) {
        lo = std::min(lo, (double)bmin[i * 3 + a]);
        hi = std::max(hi, (double)bmax[i * 3 + a]);
      }
      root.bmin[a] = lo - 1e-3;  // EPSILON pad (bvh.cpp:39-40)
      root.bmax[a] = hi + 1e-3;
    }
    nodes.push_back(root);
    recurse(0, n, 0);
  }

  void obj_bounds(int64_t i, double lo[3], double hi[3]) const {
    for (int a = 0; a < 3; a++) {
      lo[a] = bmin[i * 3 + a];
      hi[a] = bmax[i * 3 + a];
    }
  }

  void recurse(int64_t left, int64_t right, int node) {
    int64_t n = right - left;
    if (n <= kLeafThreshold) {
      nodes[node].leaf = true;
      nodes[node].index = (int)left;
      nodes[node].nobjs = (int)n;
      return;
    }
    double parent_area = area(nodes[node].bmin, nodes[node].bmax);

    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = 0;
    int64_t best_split = left;

    for (int axis = 0; axis < 3; axis++) {
      std::stable_sort(order.begin() + left, order.begin() + right,
                       [&](int64_t a, int64_t b) {
                         return centroid[a * 3 + axis] <
                                centroid[b * 3 + axis];
                       });
      double lo_b = nodes[node].bmin[axis];
      double hi_b = nodes[node].bmax[axis];
      double scale = (hi_b - lo_b) > 0.0 ? kBuckets / (hi_b - lo_b) : 0.0;

      int64_t counts[kBuckets] = {0};
      double blo[kBuckets][3], bhi[kBuckets][3];
      for (int b = 0; b < kBuckets; b++)
        for (int a = 0; a < 3; a++) {
          blo[b][a] = std::numeric_limits<double>::infinity();
          bhi[b][a] = -blo[b][a];
        }
      for (int64_t i = left; i < right; i++) {
        int64_t o = order[i];
        int bi = std::min((int64_t)(kBuckets - 1),
                          (int64_t)((centroid[o * 3 + axis] - lo_b) * scale));
        if (bi < 0) bi = 0;
        counts[bi]++;
        for (int a = 0; a < 3; a++) {
          blo[bi][a] = std::min(blo[bi][a], (double)bmin[o * 3 + a]);
          bhi[bi][a] = std::max(bhi[bi][a], (double)bmax[o * 3 + a]);
        }
      }
      for (int i = 1; i < kBuckets; i++) {
        double llo[3], lhi[3], rlo[3], rhi[3];
        for (int a = 0; a < 3; a++) {
          llo[a] = std::numeric_limits<double>::infinity();
          lhi[a] = -llo[a];
          rlo[a] = llo[a];
          rhi[a] = -llo[a];
        }
        int64_t lc = 0, rc = 0;
        for (int j = 0; j < i; j++) {
          lc += counts[j];
          for (int a = 0; a < 3; a++) {
            llo[a] = std::min(llo[a], blo[j][a]);
            lhi[a] = std::max(lhi[a], bhi[j][a]);
          }
        }
        for (int j = i; j < kBuckets; j++) {
          rc += counts[j];
          for (int a = 0; a < 3; a++) {
            rlo[a] = std::min(rlo[a], blo[j][a]);
            rhi[a] = std::max(rhi[a], bhi[j][a]);
          }
        }
        double cost =
            1.0 + (lc * area(llo, lhi) + rc * area(rlo, rhi)) / parent_area;
        // 0 * inf = nan never beats (matches bvh.cpp FLT_MAX arithmetic)
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_split = left + lc;
        }
      }
    }

    if (best_split <= left || best_split >= right ||
        best_cost >= (double)n) {  // fallback leaf (bvh.cpp:193-196)
      nodes[node].leaf = true;
      nodes[node].index = (int)left;
      nodes[node].nobjs = (int)n;
      return;
    }

    std::stable_sort(order.begin() + left, order.begin() + right,
                     [&](int64_t a, int64_t b) {
                       return centroid[a * 3 + best_axis] <
                              centroid[b * 3 + best_axis];
                     });

    int li = (int)nodes.size();
    nodes[node].leaf = false;
    nodes[node].index = li;

    Node ln, rn;
    for (int a = 0; a < 3; a++) {
      ln.bmin[a] = std::numeric_limits<double>::infinity();
      ln.bmax[a] = -ln.bmin[a];
      rn.bmin[a] = ln.bmin[a];
      rn.bmax[a] = -ln.bmin[a];
    }
    for (int64_t i = left; i < best_split; i++) {
      int64_t o = order[i];
      for (int a = 0; a < 3; a++) {
        ln.bmin[a] = std::min(ln.bmin[a], (double)bmin[o * 3 + a]);
        ln.bmax[a] = std::max(ln.bmax[a], (double)bmax[o * 3 + a]);
      }
    }
    for (int64_t i = best_split; i < right; i++) {
      int64_t o = order[i];
      for (int a = 0; a < 3; a++) {
        rn.bmin[a] = std::min(rn.bmin[a], (double)bmin[o * 3 + a]);
        rn.bmax[a] = std::max(rn.bmax[a], (double)bmax[o * 3 + a]);
      }
    }
    nodes.push_back(ln);
    nodes.push_back(rn);
    recurse(left, best_split, li);
    recurse(best_split, right, li + 1);
  }
};

}  // namespace

extern "C" {

// Returns node count (<= 2n); caller provides capacity-2n output buffers.
int64_t drt_build_bvh(int64_t n, const float* bmin, const float* bmax,
                      float* node_min, float* node_max, uint8_t* node_leaf,
                      int32_t* node_index, int32_t* node_nobjs,
                      int32_t* order_out) {
  Builder b;
  b.bmin = bmin;
  b.bmax = bmax;
  b.build(n);
  int64_t nn = (int64_t)b.nodes.size();
  for (int64_t i = 0; i < nn; i++) {
    const Node& nd = b.nodes[i];
    for (int a = 0; a < 3; a++) {
      node_min[i * 3 + a] = (float)nd.bmin[a];
      node_max[i * 3 + a] = (float)nd.bmax[a];
    }
    node_leaf[i] = nd.leaf ? 1 : 0;
    node_index[i] = nd.index;
    node_nobjs[i] = nd.nobjs;
  }
  for (int64_t i = 0; i < n; i++) order_out[i] = (int32_t)b.order[i];
  return nn;
}

// Uniform grid insertion (grid.cpp:75-92).  Phase 1 (entries=null): returns
// the total entry count.  Phase 2: fills cell_of_entry/obj_of_entry.
int64_t drt_grid_insert(int64_t n, const float* bmin, const float* bmax,
                        const double* gmin, const double* gmax,
                        int32_t nx, int32_t ny, int32_t nz,
                        int64_t* cell_of_entry, int32_t* obj_of_entry) {
  const int64_t dims[3] = {nx, ny, nz};
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t lo[3], hi[3];
    for (int a = 0; a < 3; a++) {
      double w = gmax[a] - gmin[a];
      double flo = ((double)bmin[i * 3 + a] - gmin[a]) * dims[a] / w;
      double fhi = ((double)bmax[i * 3 + a] - gmin[a]) * dims[a] / w;
      // clamp then truncate, as grid.cpp:80-85
      flo = flo < 0 ? 0 : (flo > dims[a] - 1 ? dims[a] - 1 : flo);
      fhi = fhi < 0 ? 0 : (fhi > dims[a] - 1 ? dims[a] - 1 : fhi);
      lo[a] = (int64_t)flo;
      hi[a] = (int64_t)fhi;
    }
    if (cell_of_entry) {
      for (int64_t z = lo[2]; z <= hi[2]; z++)
        for (int64_t y = lo[1]; y <= hi[1]; y++)
          for (int64_t x = lo[0]; x <= hi[0]; x++) {
            cell_of_entry[total] = x + nx * (y + (int64_t)ny * z);
            obj_of_entry[total] = (int32_t)i;
            total++;
          }
    } else {
      total += (hi[0] - lo[0] + 1) * (hi[1] - lo[1] + 1) * (hi[2] - lo[2] + 1);
    }
  }
  return total;
}

// Chebyshev (chessboard) distance transform over the grid's occupancy mask,
// for proximity-cloud empty-space skipping in the DDA (grid traversal).
// Exact for the chessboard metric via the classic two-pass chamfer scan with
// unit weights over the 26-neighbourhood.  dist[c] = 0 for occupied cells,
// else the chebyshev distance to the nearest occupied cell, clamped to cap.
void drt_chebyshev_dist(int32_t nx, int32_t ny, int32_t nz,
                        const uint8_t* occupied, int32_t* dist, int32_t cap) {
  const int64_t sx = 1, sy = nx, sz = (int64_t)nx * ny;
  const int64_t total = sz * nz;
  for (int64_t i = 0; i < total; i++) dist[i] = occupied[i] ? 0 : cap;
  // forward pass: neighbours with (dz,dy,dx) lexicographically before (0,0,0)
  for (int64_t z = 0; z < nz; z++)
    for (int64_t y = 0; y < ny; y++)
      for (int64_t x = 0; x < nx; x++) {
        int64_t c = x * sx + y * sy + z * sz;
        int32_t d = dist[c];
        if (d == 0) continue;
        for (int dz = -1; dz <= 0; dz++)
          for (int dy = -1; dy <= 1; dy++)
            for (int dx = -1; dx <= 1; dx++) {
              if (dz == 0 && (dy > 0 || (dy == 0 && dx >= 0))) continue;
              int64_t X = x + dx, Y = y + dy, Z = z + dz;
              if (X < 0 || X >= nx || Y < 0 || Y >= ny || Z < 0) continue;
              int32_t v = dist[X * sx + Y * sy + Z * sz] + 1;
              if (v < d) d = v;
            }
        dist[c] = d;
      }
  // backward pass: the mirrored neighbour half-set
  for (int64_t z = nz - 1; z >= 0; z--)
    for (int64_t y = ny - 1; y >= 0; y--)
      for (int64_t x = nx - 1; x >= 0; x--) {
        int64_t c = x * sx + y * sy + z * sz;
        int32_t d = dist[c];
        if (d == 0) continue;
        for (int dz = 0; dz <= 1; dz++)
          for (int dy = -1; dy <= 1; dy++)
            for (int dx = -1; dx <= 1; dx++) {
              if (dz == 0 && (dy < 0 || (dy == 0 && dx <= 0))) continue;
              int64_t X = x + dx, Y = y + dy, Z = z + dz;
              if (X < 0 || X >= nx || Y < 0 || Y >= ny || Z >= nz) continue;
              int32_t v = dist[X * sx + Y * sy + Z * sz] + 1;
              if (v < d) d = v;
            }
        if (d > cap) d = cap;
        dist[c] = d;
      }
}

}  // extern "C"

#include <thread>

// ---------------------------------------------------------------------------
// Reference-semantics CPU closest-hit traversal benchmark.
//
// This is the reference's hot loop — BVH::Traverse (bvh.cpp:231-311) under
// the OpenMP pixel loop (main.cpp:603) — re-implemented over our flat node
// tables and packed object rows, multithreaded with std::thread: an
// independent reference for the device traversals' primary winners and a
// native-CPU baseline on the host that drives the device.  Semantics mirrored: explicit stack with near-child
// ordering by entry t, inside-AABB t := 0 (bvh.cpp:256-257), stack pops
// pruned by stack.t < hitRec.t (bvh.cpp:300-308), strict-< closest update,
// and the reference primitive formulas (scene.cpp:44-278).

namespace bench {

constexpr float kEps = 1e-3f;  // EPSILON (macros.h)
constexpr float kInf = std::numeric_limits<float>::max();

struct Ray {
  float o[3], d[3], inv[3];
};

inline bool aabb_entry(const Ray& r, const float* lo, const float* hi,
                       float* t_out) {
  float tmin = -kInf, tmax = kInf;
  bool inside = true;
  for (int a = 0; a < 3; a++) {
    float ta = (lo[a] - r.o[a]) * r.inv[a];
    float tb = (hi[a] - r.o[a]) * r.inv[a];
    float tn = r.inv[a] >= 0 ? ta : tb;
    float tf = r.inv[a] >= 0 ? tb : ta;
    if (tn > tmin) tmin = tn;
    if (tf < tmax) tmax = tf;
    inside = inside && r.o[a] > lo[a] && r.o[a] < hi[a];
  }
  if (!(tmin < tmax) || !(tmax > 0)) return false;
  float t = tmin < 0 ? tmax : tmin;
  *t_out = inside ? 0.0f : t;  // bvh.cpp:256-257
  return true;
}

// packed object rows as in SceneData.packed_objects: 12 params + type
inline bool obj_hit(const Ray& r, const float* p, int32_t type, float* t,
                    float time, bool motion) {
  if (type == 0) {  // sphere (scene.cpp:152-197)
    float c[3] = {p[0], p[1], p[2]};
    if (motion) c[1] += time;  // velocity.y hardwired (scene.cpp:159-161)
    float rad = p[3];
    float oc[3] = {r.o[0] - c[0], r.o[1] - c[1], r.o[2] - c[2]};
    float a = r.d[0] * r.d[0] + r.d[1] * r.d[1] + r.d[2] * r.d[2];
    float b = 2 * (oc[0] * r.d[0] + oc[1] * r.d[1] + oc[2] * r.d[2]);
    float cq = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - rad * rad;
    float disc = b * b - 4 * a * cq;
    if (disc < 0) return false;
    float sq = std::sqrt(disc);
    float t1 = (-b - sq) / (2 * a), t2 = (-b + sq) / (2 * a);
    float ts = t1 > kEps ? t1 : t2;
    if (!(ts > kEps)) return false;
    *t = ts;
    return true;
  }
  if (type == 1) {  // triangle Moller-Trumbore (scene.cpp:44-92)
    const float* v0 = p;
    const float* e1 = p + 3;
    const float* e2 = p + 6;
    float h[3] = {r.d[1] * e2[2] - r.d[2] * e2[1],
                  r.d[2] * e2[0] - r.d[0] * e2[2],
                  r.d[0] * e2[1] - r.d[1] * e2[0]};
    float a = e1[0] * h[0] + e1[1] * h[1] + e1[2] * h[2];
    if (a == 0) return false;
    float f = 1.0f / a;
    float s[3] = {r.o[0] - v0[0], r.o[1] - v0[1], r.o[2] - v0[2]};
    float u = f * (s[0] * h[0] + s[1] * h[1] + s[2] * h[2]);
    if (u < 0 || u > 1) return false;
    float q[3] = {s[1] * e1[2] - s[2] * e1[1],
                  s[2] * e1[0] - s[0] * e1[2],
                  s[0] * e1[1] - s[1] * e1[0]};
    float v = f * (q[0] * r.d[0] + q[1] * r.d[1] + q[2] * r.d[2]);
    if (v < 0 || u + v > 1) return false;
    float ts = f * (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]);
    if (!(ts > kEps)) return false;
    *t = ts;
    return true;
  }
  if (type == 2) {  // infinite plane (scene.cpp:118-149)
    float denom = r.d[0] * p[0] + r.d[1] * p[1] + r.d[2] * p[2];
    if (std::fabs(denom) < kEps) return false;
    float ts = -(r.o[0] * p[0] + r.o[1] * p[1] + r.o[2] * p[2] + p[3]) /
               denom;
    if (!(ts > 0)) return false;
    *t = ts;
    return true;
  }
  // aaBox slab (scene.cpp:218-278)
  float tmin = -kInf, tmax = kInf;
  for (int a = 0; a < 3; a++) {
    float ta = (p[a] - r.o[a]) * r.inv[a];
    float tb = (p[3 + a] - r.o[a]) * r.inv[a];
    float lo2 = ta < tb ? ta : tb, hi2 = ta < tb ? tb : ta;
    if (lo2 > tmin) tmin = lo2;
    if (hi2 < tmax) tmax = hi2;
  }
  if (!(tmin <= tmax) || !(tmin > kEps)) return false;
  *t = tmin;
  return true;
}

struct TraverseArgs {
  int64_t n_nodes;
  const float* node_min;
  const float* node_max;
  const uint8_t* node_leaf;
  const int32_t* node_index;
  const int32_t* node_nobjs;
  const int32_t* order;
  const float* obj12;
  const int32_t* obj_type;
  const float* o;
  const float* d;
  const float* time;
  int motion;
  float* t_out;
  int32_t* id_out;
};

void traverse_range(const TraverseArgs& A, int64_t r0, int64_t r1) {
  struct StackEntry {
    int32_t node;
    float t;
  };
  std::vector<StackEntry> stack;
  stack.reserve(64);
  for (int64_t ri = r0; ri < r1; ri++) {
    Ray r;
    for (int a = 0; a < 3; a++) {
      r.o[a] = A.o[ri * 3 + a];
      r.d[a] = A.d[ri * 3 + a];
      r.inv[a] = 1.0f / r.d[a];
    }
    float tm = A.time ? A.time[ri] : 0.0f;
    float best = kInf;
    int32_t best_id = -1;
    stack.clear();
    float t0;
    int32_t curr = 0;
    // root AABB gate (bvh.cpp:239-244)
    bool walking = A.n_nodes > 0 &&
                   aabb_entry(r, A.node_min, A.node_max, &t0);
    while (walking) {
      if (!A.node_leaf[curr]) {
        int32_t left = A.node_index[curr], right = left + 1;
        float tl, tr;
        bool hl = aabb_entry(r, A.node_min + left * 3,
                             A.node_max + left * 3, &tl) && tl < best;
        bool hr = aabb_entry(r, A.node_min + right * 3,
                             A.node_max + right * 3, &tr) && tr < best;
        if (hl && hr) {  // near-child first (bvh.cpp:269-282)
          int32_t nearc = tl <= tr ? left : right;
          int32_t farc = tl <= tr ? right : left;
          stack.push_back({farc, tl <= tr ? tr : tl});
          curr = nearc;
          continue;
        }
        if (hl) { curr = left; continue; }
        if (hr) { curr = right; continue; }
      } else {
        int32_t first = A.node_index[curr], n = A.node_nobjs[curr];
        for (int32_t k = 0; k < n; k++) {
          int32_t oid = A.order[first + k];
          float t;
          if (obj_hit(r, A.obj12 + (int64_t)oid * 12, A.obj_type[oid],
                      &t, tm, A.motion) &&
              t < best) {  // strict < (bvh.cpp:296 / main.cpp:321)
            best = t;
            best_id = oid;
          }
        }
      }
      // pop, pruned by stack.t < hitRec.t (bvh.cpp:300-308)
      walking = false;
      while (!stack.empty()) {
        StackEntry e = stack.back();
        stack.pop_back();
        if (e.t < best) {
          curr = e.node;
          walking = true;
          break;
        }
      }
    }
    A.t_out[ri] = best;
    A.id_out[ri] = best_id;
  }
}

}  // namespace bench

// Multithreaded reference-semantics closest-hit over the flat BVH tables
// (the reference's omp parallel for also pays its thread overhead inside
// the timed region, main.cpp:603 under main.cpp:1074-1078).
extern "C" void drt_traverse_closest(
    int64_t n_nodes, const float* node_min, const float* node_max,
    const uint8_t* node_leaf, const int32_t* node_index,
    const int32_t* node_nobjs, const int32_t* order,
    const float* obj12, const int32_t* obj_type,
    int64_t n_rays, const float* o, const float* d, const float* time,
    int32_t motion, int32_t n_threads, float* t_out, int32_t* id_out) {
  bench::TraverseArgs A{n_nodes, node_min, node_max, node_leaf,
                        node_index, node_nobjs, order, obj12, obj_type,
                        o, d, time, motion, t_out, id_out};
  if (n_threads <= 1) {
    bench::traverse_range(A, 0, n_rays);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n_rays + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; t++) {
    int64_t r0 = t * per;
    int64_t r1 = std::min(n_rays, r0 + per);
    if (r0 >= r1) break;
    threads.emplace_back([&A, r0, r1] { bench::traverse_range(A, r0, r1); });
  }
  for (auto& th : threads) th.join();
}

extern "C" {

// Bulk float tokenizer: parses up to max_out whitespace-separated floats
// starting at text[*pos]; advances *pos past the last consumed token.
// Returns the number parsed.
int64_t drt_parse_floats(const char* text, int64_t len, int64_t* pos,
                         double* out, int64_t max_out) {
  const char* p = text + *pos;
  const char* end = text + len;
  int64_t count = 0;
  while (count < max_out) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      p++;
    if (p >= end) break;
    char* after = nullptr;
    double v = strtod(p, &after);
    if (after == p) break;  // not a number
    out[count++] = v;
    p = after;
  }
  *pos = p - text;
  return count;
}

}  // extern "C"
