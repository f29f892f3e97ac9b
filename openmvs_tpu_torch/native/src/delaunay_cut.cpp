// Graph-cut surface extraction over a Delaunay tetrahedralization.
//
// Native equivalent of the reference's visibility-weighting + s-t cut stage
// (libs/MVS/SceneReconstruct.cpp:916-1119, Labatut-Pons'07): for every
// (point, view) ray, walk the tetrahedra crossed by the camera-point segment
// accumulating directed facet weights alpha*(1-exp(-d^2/2sigma^2)), add a
// t-edge at the cell just behind the point, tie camera cells to the source,
// add the facet quality term, then solve min-cut (maxflow.cpp).
//
// The tetrahedralization itself comes from the host (scipy.spatial.Delaunay,
// i.e. Qhull): vertices, tets (4 ids), tet neighbors (scipy convention:
// neighbor[t][j] opposite vertex j, -1 on the hull).  All infinite cells are
// merged into a single "outside" node, which is topologically equivalent
// (the outside of the convex hull is one connected region).

#include <string>
#include <atomic>
#include <chrono>
#include <cmath>
#include <unordered_map>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include "maxflow.h"

namespace {

struct V3 {
  double x, y, z;
};
inline V3 operator-(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator+(const V3& a, const V3& b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator*(const V3& a, double s) { return {a.x * s, a.y * s, a.z * s}; }
inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double norm(const V3& a) { return std::sqrt(dot(a, a)); }

struct TetMesh {
  const double* verts;
  const int32_t* tets;    // (nt, 4)
  const int32_t* neigh;   // (nt, 4)
  int64_t nv, nt;

  V3 vert(int64_t i) const { return {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]}; }
  // outward-oriented plane of facet j of tet t (normal away from vertex j)
  void facet_plane(int64_t t, int j, V3& n, double& d) const {
    const int32_t* tv = tets + 4 * t;
    int a = (j + 1) & 3, b = (j + 2) & 3, c = (j + 3) & 3;
    V3 A = vert(tv[a]), B = vert(tv[b]), C = vert(tv[c]);
    n = cross(B - A, C - A);
    d = dot(n, A);
    if (dot(n, vert(tv[j])) > d) {  // flip so vertex j is on negative side
      n = n * -1.0;
      d = -d;
    }
  }
  // circumcenter of tet t
  V3 circumcenter(int64_t t) const {
    const int32_t* tv = tets + 4 * t;
    V3 a = vert(tv[0]), b = vert(tv[1]), c = vert(tv[2]), d4 = vert(tv[3]);
    V3 ba = b - a, ca = c - a, da = d4 - a;
    double l1 = dot(ba, ba), l2 = dot(ca, ca), l3 = dot(da, da);
    V3 c1 = cross(ca, da), c2 = cross(da, ba), c3 = cross(ba, ca);
    double denom = 2.0 * dot(ba, c1);
    if (std::fabs(denom) < 1e-30) return a;
    return a + (c1 * l1 + c2 * l2 + c3 * l3) * (1.0 / denom);
  }
  int facet_index_of_neighbor(int64_t t, int64_t nb) const {
    const int32_t* nn = neigh + 4 * t;
    for (int j = 0; j < 4; ++j)
      if (nn[j] == nb) return j;
    return -1;
  }
  bool contains(int64_t t, const V3& p, double eps) const {
    for (int j = 0; j < 4; ++j) {
      V3 n;
      double d;
      facet_plane(t, j, n, d);
      double nl = norm(n);
      if (nl < 1e-300) continue;
      if ((dot(n, p) - d) / nl > eps) return false;
    }
    return true;
  }
};

// walk from tet `start` to the tet containing point q; returns -1 if q is
// outside the hull (and sets exit_tet/exit_facet to the hull crossing)
int64_t locate(const TetMesh& m, int64_t start, const V3& q, int64_t* exit_tet, int* exit_facet,
               int64_t max_steps = 1 << 20) {
  int64_t t = start;
  int64_t prev = -1;
  for (int64_t step = 0; step < max_steps; ++step) {
    int best_j = -1;
    double best_viol = 1e-12;
    for (int j = 0; j < 4; ++j) {
      if (m.neigh[4 * t + j] == prev && prev >= 0) continue;
      V3 n;
      double d;
      m.facet_plane(t, j, n, d);
      double nl = norm(n);
      if (nl < 1e-300) continue;
      double viol = (dot(n, q) - d) / nl;
      if (viol > best_viol) {
        best_viol = viol;
        best_j = j;
      }
    }
    if (best_j < 0) return t;  // inside
    int64_t nb = m.neigh[4 * t + best_j];
    if (nb < 0) {
      if (exit_tet) *exit_tet = t;
      if (exit_facet) *exit_facet = best_j;
      return -1;
    }
    prev = t;
    t = nb;
  }
  return t;  // give up; good enough
}

}  // namespace

extern "C" {

// Each hull facet gets its OWN outside node (index nt + h, h in hull-scan
// order over (t, j)), mirroring CGAL's per-infinite-cell nodes: infinite
// cells interconnect at zero cost (quality of an infinite facet is 0 in the
// reference, SceneReconstruct.cpp:724-725,1113), so the sink region can
// extend past the hull for free behind the surface.  The reference
// additionally walks each camera->point ray through the *outside* web of
// infinite cells, accumulating crossing weights from the camera's own
// (source-linked) infinite cell to the hull-entry facet; we model each such
// corridor as one arc from a per-camera source node (nt + n_hull + cam) to
// the hull-entry node with the ray's full weight — cuttable at the same cost,
// no outside walk needed.
// inside_out: (nt + n_hull) bytes.  Returns n_hull (>=0) on success, <0 error.
int64_t omvs_delaunay_graph_cut(
    const double* verts, int64_t nv,
    const int32_t* tets, const int32_t* neigh, int64_t nt,
    const int32_t* vert_tet,
    const double* cam_centers, int64_t ncam,
    const double* cam_P,       // (ncam, 3, 4) row-major projection matrices
    const int32_t* cam_wh,     // (ncam, 2) image width, height
    const int64_t* view_indptr, const int32_t* view_cam, const float* view_weight,
    double sigma, double kqual, double kinf,
    int32_t use_free_space, double kb, double kf, double k_rel, double k_abs,
    double k_outl,
    uint8_t* inside_out) {
  TetMesh m{verts, tets, neigh, nv, nt};
  const double inv2s2 = 0.5 / (sigma * sigma);

  // enumerate hull facets -> outside node ids
  std::vector<int64_t> hull_id(4 * nt, -1);
  int64_t n_hull = 0;
  for (int64_t t = 0; t < nt; ++t)
    for (int j = 0; j < 4; ++j)
      if (neigh[4 * t + j] < 0) hull_id[4 * t + j] = nt + (n_hull++);

  std::vector<float> f(4 * nt, 0.f);   // capacity tet -> neighbor_j
  std::vector<float> g(4 * nt, 0.f);   // capacity outside -> tet (hull facets)
  const int64_t n_nodes = nt + n_hull + ncam;
  std::vector<float> s_cap(n_nodes, 0.f), t_cap(n_nodes, 0.f);
  // outside-corridor arcs: (camera, hull node) -> accumulated capacity
  std::unordered_map<int64_t, float> corridor;
  // cameras are always sources
  for (int64_t c = 0; c < ncam; ++c) s_cap[nt + n_hull + c] = (float)kinf;

  // hull-facet edge adjacency: for the outside wedge walk.  Two hull facets
  // are adjacent when they share an edge.  adj[3*h + k] = neighbor hull node
  // (or -1) across edge k of hull facet h.
  std::vector<int64_t> hull_adj;
  std::vector<int64_t> hull_tet, hull_j;
  {
    std::unordered_map<int64_t, int64_t> edge2hull;  // packed edge -> hull idx
    int64_t nh = 0;
    for (int64_t t = 0; t < nt; ++t)
      for (int j = 0; j < 4; ++j)
        if (neigh[4 * t + j] < 0) { hull_tet.push_back(t); hull_j.push_back(j); ++nh; }
    hull_adj.assign(3 * nh, -1);
    auto pack = [&](int64_t a, int64_t b) {
      if (a > b) std::swap(a, b);
      return a * (int64_t)nv + b;
    };
    for (int64_t h = 0; h < nh; ++h) {
      int64_t t = hull_tet[h];
      int j = (int)hull_j[h];
      const int32_t* tv = tets + 4 * t;
      int fa = (j + 1) & 3, fb = (j + 2) & 3, fc = (j + 3) & 3;
      int64_t vs3[3] = {tv[fa], tv[fb], tv[fc]};
      for (int k = 0; k < 3; ++k) {
        int64_t key = pack(vs3[k], vs3[(k + 1) % 3]);
        auto it = edge2hull.find(key);
        if (it == edge2hull.end()) {
          edge2hull[key] = h;
        } else {
          int64_t h2 = it->second;
          // fill first free slot on both
          for (int kk = 0; kk < 3; ++kk) if (hull_adj[3*h+kk] < 0) { hull_adj[3*h+kk] = h2; break; }
          for (int kk = 0; kk < 3; ++kk) if (hull_adj[3*h2+kk] < 0) { hull_adj[3*h2+kk] = h; break; }
        }
      }
    }
  }
  // hull index of facet (t, j) = hull_id[4t+j] - nt
  // outward unit normal + a vertex of hull facet h
  auto hull_plane = [&](int64_t h, V3& n, V3& a) {
    int64_t t = hull_tet[h];
    int j = (int)hull_j[h];
    double d;
    m.facet_plane(t, j, n, d);       // oriented away from vertex j = outward
    double nl = norm(n);
    if (nl > 1e-300) n = n * (1.0 / nl);
    const int32_t* tv = tets + 4 * t;
    a = m.vert(tv[(j + 1) & 3]);
  };
  // Walk the ray (origin p, unit dir u toward the camera, length len) along
  // the OUTSIDE of the hull starting from wedge (hull facet) h0 at parameter
  // t_cur: the reference walks camera->point rays through the infinite-cell
  // web accumulating crossing weights on infinite-infinite facets
  // (SceneReconstruct.cpp:968-975 via intersect()); here the outside is
  // decomposed into one wedge per hull facet and each wedge crossing adds an
  // arc next->current (camera->point direction) with the ray's full weight.
  // Returns the final wedge (to be tied to the camera source node).
  struct Arc { int64_t from, to; float cap; };
  std::vector<Arc> extra_arcs;
  auto outside_walk = [&](int64_t h0, const V3& p, const V3& u, double len,
                          double t0, float alpha) -> int64_t {
    int64_t h = h0;
    double t_cur = t0;
    int64_t prev = -1;
    for (int step = 0; step < 64; ++step) {
      int64_t best_h = -1;
      double best_s = 1e30;
      int64_t t1 = hull_tet[h];
      int j1 = (int)hull_j[h];
      const int32_t* tv1 = tets + 4 * t1;
      V3 n1, a1;
      hull_plane(h, n1, a1);
      for (int k = 0; k < 3; ++k) {
        int64_t h2 = hull_adj[3 * h + k];
        if (h2 < 0 || h2 == prev) continue;
        // shared edge = the two common vertices
        int64_t t2 = hull_tet[h2];
        int j2 = (int)hull_j[h2];
        const int32_t* tv2 = tets + 4 * t2;
        int64_t e1 = -1, e2 = -1;
        for (int x = 0; x < 4; ++x) {
          if (x == j1) continue;
          int64_t vx = tv1[x];
          for (int y = 0; y < 4; ++y) {
            if (y == j2) continue;
            if (tv2[y] == vx) { (e1 < 0 ? e1 : e2) = vx; break; }
          }
        }
        if (e2 < 0) continue;
        V3 n2, a2;
        hull_plane(h2, n2, a2);
        V3 A = m.vert(e1), B = m.vert(e2);
        // wedge boundary plane: contains the shared edge, spanned by the
        // mean outward normal
        V3 bn = cross(B - A, n1 + n2);
        double denom = dot(bn, u);
        if (std::fabs(denom) < 1e-300) continue;
        double sx = (dot(bn, A) - dot(bn, p)) / denom;
        if (sx > t_cur + 1e-12 && sx < best_s) { best_s = sx; best_h = h2; }
      }
      if (best_h < 0 || best_s >= len) break;  // clear of the hull / at camera
#pragma omp critical(extra_arcs_vec)
      extra_arcs.push_back({nt + best_h, nt + h, alpha});
      prev = h;
      h = best_h;
      t_cur = best_s;
    }
    return h;
  };

  // locate cameras once: cell containing each camera (or outside)
  std::vector<int64_t> cam_cell(ncam, -1);
  for (int64_t c = 0; c < ncam; ++c) {
    V3 q{cam_centers[3 * c], cam_centers[3 * c + 1], cam_centers[3 * c + 2]};
    cam_cell[c] = locate(m, 0, q, nullptr, nullptr);
  }

  // link to the source every hull facet that faces a camera and falls inside
  // its frustum (fetchCellFacets<POSITIVE> + s = kInf,
  // SceneReconstruct.cpp:384-416,904-911): the whole camera-visible side of
  // the hull is free space by construction.
  for (int64_t c = 0; c < ncam; ++c) {
    if (cam_cell[c] >= 0) { s_cap[cam_cell[c]] = (float)kinf; continue; }
    V3 cc{cam_centers[3 * c], cam_centers[3 * c + 1], cam_centers[3 * c + 2]};
    const double* P = cam_P + 12 * c;
    const double w_img = cam_wh[2 * c], h_img = cam_wh[2 * c + 1];
    for (int64_t h = 0; h < n_hull; ++h) {
      int64_t t = hull_tet[h];
      int j = (int)hull_j[h];
      V3 n, a;
      hull_plane(h, n, a);
      if (dot(n, cc - a) <= 0) continue;  // back-facing
      // frustum test: accept unless all 3 vertices are outside the same
      // image boundary (conservative, like the reference's AABB classify)
      const int32_t* tv = tets + 4 * t;
      bool all_left = true, all_right = true, all_top = true, all_bot = true,
           all_behind = true;
      for (int x = 0; x < 4; ++x) {
        if (x == j) continue;
        V3 v3 = m.vert(tv[x]);
        double px = P[0] * v3.x + P[1] * v3.y + P[2] * v3.z + P[3];
        double py = P[4] * v3.x + P[5] * v3.y + P[6] * v3.z + P[7];
        double pz = P[8] * v3.x + P[9] * v3.y + P[10] * v3.z + P[11];
        if (pz <= 0) continue;
        all_behind = false;
        double ix = px / pz, iy = py / pz;
        if (ix >= 0) all_left = false;
        if (ix <= w_img) all_right = false;
        if (iy >= 0) all_top = false;
        if (iy <= h_img) all_bot = false;
      }
      if (all_behind || all_left || all_right || all_top || all_bot) continue;
      s_cap[nt + h] = (float)kinf;
    }
  }

#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t v = 0; v < nv; ++v) {
    int64_t beg = view_indptr[v], end = view_indptr[v + 1];
    if (beg >= end) continue;
    V3 p = m.vert(v);
    for (int64_t k = beg; k < end; ++k) {
      int32_t cam = view_cam[k];
      float alpha = view_weight[k];
      V3 c{cam_centers[3 * cam], cam_centers[3 * cam + 1], cam_centers[3 * cam + 2]};
      V3 dirv = c - p;
      double len = norm(dirv);
      if (len < 1e-12) continue;
      V3 u = dirv * (1.0 / len);

      // --- forward walk: point -> camera ---
      // start just off the vertex toward the camera
      double eps = 1e-6 * len;
      V3 q0 = p + u * eps;
      int64_t fexit_t = -1; int fexit_j = -1;
      int64_t t = locate(m, vert_tet[v], q0, &fexit_t, &fexit_j, 4096);
      if (t < 0 && fexit_t >= 0) {
        // the point sits on the hull and the ray leaves immediately: walk the
        // outside wedges toward the camera, then tie the last wedge to it
        int64_t h0 = hull_id[4 * fexit_t + fexit_j] - nt;
        int64_t hl = outside_walk(h0, p, u, len, 0.0, alpha);
#pragma omp critical(corridor_map)
        corridor[cam * (int64_t)(nt + n_hull) + (nt + hl)] += alpha;
      }
      if (t >= 0) {
        V3 a = p;  // segment p -> c
        int64_t prev = -1;
        double t_cur = 0.0;
        bool reached = false;
        for (int step = 0; step < 1 << 16; ++step) {
          // find exit facet of tet t for segment a + s*(c-a), s in (t_cur, 1]
          int best_j = -1;
          double best_s = 1e30;
          for (int j = 0; j < 4; ++j) {
            if (m.neigh[4 * t + j] == prev && prev >= 0) continue;
            V3 n;
            double d;
            m.facet_plane(t, j, n, d);
            double denom = dot(n, dirv);
            if (denom <= 1e-300) continue;  // not exiting through this facet
            double s = (d - dot(n, p)) / denom;
            if (s > t_cur - 1e-12 && s < best_s) {
              best_s = s;
              best_j = j;
            }
          }
          if (best_j < 0 || best_s >= 1.0) {
            // only a genuine containment means the camera is inside tet t;
            // otherwise the walk got numerically stuck — drop the ray
            if (m.contains(t, c, 1e-9 * len)) {
#pragma omp critical(scap)
              s_cap[t] = (float)kinf;
            }
            reached = true;
            break;
          }
          int64_t nb = m.neigh[4 * t + best_j];
          double dist = best_s * len;  // distance from the point to crossing
          float w = alpha * (float)(1.0 - std::exp(-dist * dist * inv2s2));
          if (nb < 0) {
            // exits the hull toward the camera: weight on outside->tet
            // direction, then continue along the outside wedges to the camera
#pragma omp atomic
            g[4 * t + best_j] += w;
            int64_t h0 = hull_id[4 * t + best_j] - nt;
            int64_t hl = outside_walk(h0, p, u * len, 1.0, best_s, alpha);
#pragma omp critical(corridor_map)
            corridor[cam * (int64_t)(nt + n_hull) + (nt + hl)] += alpha;
            reached = true;
            break;
          }
          // reference direction camera->point: capacity nb -> t
          int j_nb = m.facet_index_of_neighbor(nb, t);
          if (j_nb >= 0) {
#pragma omp atomic
            f[4 * nb + j_nb] += w;
          }
          prev = t;
          t = nb;
          t_cur = best_s;
        }
        (void)reached;
      }

      // --- backward walk: point -> endpoint behind the surface ---
      V3 e = p - u * sigma;  // endpoint sigma behind the point
      V3 dirb = e - p;
      double lenb = sigma;
      V3 q1 = p - u * eps;
      int64_t exit_t = -1; int exit_j = -1;
      int64_t tb = locate(m, vert_tet[v], q1, &exit_t, &exit_j, 4096);
      if (tb < 0) {
        if (exit_t >= 0) {
#pragma omp atomic
          t_cap[hull_id[4 * exit_t + exit_j]] += alpha;
        }
        continue;
      }
      {
        int64_t prev = -1;
        double t_cur = 0.0;
        int64_t t2 = tb;
        bool ended = false;
        for (int step = 0; step < 1 << 12; ++step) {
          int best_j = -1;
          double best_s = 1e30;
          for (int j = 0; j < 4; ++j) {
            if (m.neigh[4 * t2 + j] == prev && prev >= 0) continue;
            V3 n;
            double d;
            m.facet_plane(t2, j, n, d);
            double denom = dot(n, dirb);
            if (denom <= 1e-300) continue;
            double s = (d - dot(n, p)) / denom;
            if (s > t_cur - 1e-12 && s < best_s) {
              best_s = s;
              best_j = j;
            }
          }
          if (best_j < 0 || best_s >= 1.0) {
#pragma omp atomic
            t_cap[t2] += alpha;  // endpoint cell gets the t-edge
            ended = true;
            break;
          }
          int64_t nb = m.neigh[4 * t2 + best_j];
          double dist = best_s * lenb;
          float w = alpha * (float)(1.0 - std::exp(-dist * dist * inv2s2));
          // direction point-side -> behind-side: capacity t2 -> nb
#pragma omp atomic
          f[4 * t2 + best_j] += w;
          if (nb < 0) {
#pragma omp atomic
            t_cap[hull_id[4 * t2 + best_j]] += alpha;
            ended = true;
            break;
          }
          prev = t2;
          t2 = nb;
          t_cur = best_s;
        }
        (void)ended;
      }
    }
  }

  // --- free-space-support t-edge reinforcement (DELAUNAY_WEAKSURF,
  // SceneReconstruct.cpp:1021-1090): for interface points, multiply the
  // t-edge of the cell kb*sigma behind the point by (beta - gamma), where
  // beta is the max free-space support toward the camera and gamma the mean
  // of min/max support behind the point.
  if (use_free_space) {
    // fs(cell) = sum of incoming crossing weights (freeSpaceSupport,
    // SceneReconstruct.cpp:680-690)
    auto fs = [&](int64_t t) -> double {
      double w = 0;
      for (int j = 0; j < 4; ++j) {
        int64_t nb = neigh[4 * t + j];
        if (nb >= 0) {
          int jn = m.facet_index_of_neighbor(nb, t);
          if (jn >= 0) w += f[4 * nb + jn];
        } else {
          w += g[4 * t + j];
        }
      }
      return w;
    };
    // walk cells crossed by segment p -> p + dir*len, calling cb(cell);
    // returns the final cell (or -1 if the walk exits the hull)
    auto walk = [&](int64_t v, const V3& p, const V3& dir, double len,
                    auto&& cb) -> int64_t {
      V3 u = dir * (1.0 / std::max(norm(dir), 1e-300));
      V3 q0 = p + u * (1e-6 * len);
      int64_t t = locate(m, vert_tet[v], q0, nullptr, nullptr, 4096);
      if (t < 0) return -1;
      int64_t prev = -1;
      double t_cur = 0.0;
      V3 seg = u * len;
      for (int step = 0; step < 1 << 12; ++step) {
        cb(t);
        int best_j = -1;
        double best_s = 1e30;
        for (int j = 0; j < 4; ++j) {
          if (m.neigh[4 * t + j] == prev && prev >= 0) continue;
          V3 n;
          double d;
          m.facet_plane(t, j, n, d);
          double denom = dot(n, seg);
          if (denom <= 1e-300) continue;
          double sx = (d - dot(n, p)) / denom;
          if (sx > t_cur - 1e-12 && sx < best_s) { best_s = sx; best_j = j; }
        }
        if (best_j < 0 || best_s >= 1.0) return t;
        int64_t nb = m.neigh[4 * t + best_j];
        if (nb < 0) return -1;
        prev = t;
        t = nb;
        t_cur = best_s;
      }
      return t;
    };
#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t v = 0; v < nv; ++v) {
      int64_t beg = view_indptr[v], end = view_indptr[v + 1];
      if (beg >= end) continue;
      V3 p = m.vert(v);
      for (int64_t k = beg; k < end; ++k) {
        int32_t cam = view_cam[k];
        V3 c{cam_centers[3 * cam], cam_centers[3 * cam + 1], cam_centers[3 * cam + 2]};
        V3 toCam = c - p;
        double len = norm(toCam);
        if (len < 1e-12) continue;
        V3 u = toCam * (1.0 / len);
        double beta = 0;
        walk(v, p, u, sigma * kf, [&](int64_t t) {
          double w = fs(t);
          if (w > beta) beta = w;
        });
        if (beta <= 0) continue;
        double gmin = 1e300, gmax = 0;
        int64_t endc = walk(v, p, u * -1.0, sigma * kb, [&](int64_t t) {
          double w = fs(t);
          if (w < gmin) gmin = w;
          if (w > gmax) gmax = w;
        });
        if (endc < 0 || gmin > gmax) continue;
        double gamma = 0.5 * (gmin + gmax);
        double epsAbs = beta - gamma;
        double epsRel = gamma / beta;
        if (epsRel < k_rel && epsAbs > k_abs && gamma < k_outl) {
#pragma omp critical(tcap_mul)
          t_cap[endc] = (float)std::min((double)t_cap[endc] * epsAbs, 3.4e34);
        }
      }
    }
  }

  const bool dbg_t = getenv("OMVS_CUT_DEBUG") != nullptr;
  static auto now = [] { return std::chrono::steady_clock::now(); };
  auto t_walk_end = now();

  // --- build graph & solve ---
  const char* mfenv = getenv("OMVS_MAXFLOW");
  const bool use_dinic = mfenv && std::string(mfenv) == "dinic";
  omvs::MaxFlow mf_d(use_dinic ? n_nodes : 0);
  omvs::IBFS mf_i(use_dinic ? 0 : n_nodes);
  // thin dispatch: both solvers share the identical API
  auto mf_add_terminal = [&](int64_t v, double cs, double ct) {
    if (use_dinic) mf_d.add_terminal(v, cs, ct); else mf_i.add_terminal(v, cs, ct);
  };
  auto mf_add_edge = [&](int64_t a, int64_t b, double cab, double cba) {
    if (use_dinic) mf_d.add_edge(a, b, cab, cba); else mf_i.add_edge(a, b, cab, cba);
  };
  auto mf_compute = [&]() { return use_dinic ? mf_d.compute() : mf_i.compute(); };
  auto mf_source_side = [&](int64_t v) {
    return use_dinic ? mf_d.is_source_side(v) : mf_i.is_source_side(v);
  };
  constexpr double kMaxCap = 3.4e34;
  for (int64_t t = 0; t < n_nodes; ++t)
    mf_add_terminal(t, s_cap[t], std::min((double)t_cap[t], kMaxCap));
  for (const auto& kv : corridor) {
    int64_t cam = kv.first / (nt + n_hull);
    int64_t hnode = kv.first % (nt + n_hull);
    mf_add_edge(nt + n_hull + cam, hnode, kv.second, 0.0);
  }
  {
    // merge duplicate wedge arcs before insertion
    std::unordered_map<int64_t, float> merged;
    for (const Arc& a : extra_arcs)
      merged[a.from * (int64_t)(nt + n_hull) + a.to] += a.cap;
    for (const auto& kv : merged) {
      int64_t from = kv.first / (nt + n_hull);
      int64_t to = kv.first % (nt + n_hull);
      mf_add_edge(from, to, kv.second, 0.0);
    }
  }

  // facet quality: cos of the angle between the facet plane and the cell's
  // circumscribed sphere (SceneReconstruct.cpp:719-758).  The normal is
  // oriented toward the cell's apex (vertex j) so that a well-shaped cell —
  // circumcenter far on the cell side — yields cos ~ +1 and hence quality
  // cost q = (1 - cos) ~ 0; slivers yield cos ~ 0 -> q ~ kQual.
  auto plane_sphere_cos = [&](int64_t t, int j) -> double {
    const int32_t* tv = tets + 4 * t;
    int a = (j + 1) & 3, b = (j + 2) & 3, cc = (j + 3) & 3;
    V3 A = m.vert(tv[a]), B = m.vert(tv[b]), C = m.vert(tv[cc]);
    V3 fn = cross(B - A, C - A);
    double fl = dot(fn, fn);
    if (fl == 0) return 0.5;
    if (dot(fn, m.vert(tv[j]) - A) < 0) fn = fn * -1.0;  // orient toward apex
    V3 ct = m.circumcenter(t) - A;
    double cl = dot(ct, ct);
    if (cl == 0) return 0.5;
    double v = dot(fn, ct) / std::sqrt(fl * cl);
    return v < -1 ? -1 : (v > 1 ? 1 : v);
  };

  for (int64_t t = 0; t < nt; ++t) {
    for (int j = 0; j < 4; ++j) {
      int64_t nb = m.neigh[4 * t + j];
      if (nb < 0) {
        // infinite side cos = 1 -> q = (1 - min(cos_t, 1)) = (1 - cos_t)
        double q = (1.0 - plane_sphere_cos(t, j)) * kqual;
        mf_add_edge(t, hull_id[4 * t + j], f[4 * t + j] + q, g[4 * t + j] + q);
      } else if (nb > t) {
        int j_nb = m.facet_index_of_neighbor(nb, t);
        double q = (1.0 - std::min(plane_sphere_cos(t, j), plane_sphere_cos(nb, j_nb))) * kqual;
        mf_add_edge(t, nb, f[4 * t + j] + q, f[4 * nb + j_nb] + q);
      }
    }
  }

  auto t_build_end = now();
  mf_compute();
  auto t_flow_end = now();
  if (dbg_t) {
    fprintf(stderr, "[cut] graph build %.1fs, maxflow %.1fs\n",
            std::chrono::duration<double>(t_build_end - t_walk_end).count(),
            std::chrono::duration<double>(t_flow_end - t_build_end).count());
  }
  for (int64_t t = 0; t < nt + n_hull; ++t) inside_out[t] = mf_source_side(t) ? 0 : 1;

  if (getenv("OMVS_CUT_DEBUG")) {
    double sum_s = 0, sum_t = 0, sum_f = 0, sum_g = 0, sum_q = 0;
    int64_t n_s = 0, n_t = 0;
    for (int64_t t = 0; t < n_nodes; ++t) {
      sum_s += s_cap[t] >= kMaxCap ? 0 : s_cap[t];
      sum_t += t_cap[t];
      if (s_cap[t] > 0) ++n_s;
      if (t_cap[t] > 0) ++n_t;
    }
    for (int64_t i = 0; i < 4 * nt; ++i) { sum_f += f[i]; sum_g += g[i]; }
    for (int64_t t = 0; t < nt; ++t)
      for (int j = 0; j < 4; ++j) {
        int64_t nb = m.neigh[4 * t + j];
        if (nb > t) sum_q += (1.0 - plane_sphere_cos(t, j)) * kqual;
      }
    fprintf(stderr,
            "[cut] nt=%lld  s:%lld cells  t:%lld cells sum=%.3g  f_sum=%.3g "
            "g_sum=%.3g q_sum=%.3g sigma=%.4g\n",
            (long long)nt, (long long)n_s, (long long)n_t, sum_t, sum_f, sum_g,
            sum_q, sigma);
  }
  return n_hull;
}

}  // extern "C"
