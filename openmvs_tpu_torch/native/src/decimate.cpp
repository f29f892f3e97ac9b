// Quadric edge-collapse mesh decimation (Garland-Heckbert) + small-component
// removal.  Role equivalent of the reference's Mesh::Clean decimation path,
// which delegates to vcglib's TriEdgeCollapseQuadric (libs/MVS/Mesh.cpp:685-790);
// this is an independent implementation of the standard algorithm.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Sym4 {
  // symmetric 4x4 quadric, upper triangle: a11..a44
  double m[10] = {0};
  void add_plane(double a, double b, double c, double d) {
    m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
    m[4] += b * b; m[5] += b * c; m[6] += b * d;
    m[7] += c * c; m[8] += c * d;
    m[9] += d * d;
  }
  void add(const Sym4& o) {
    for (int i = 0; i < 10; ++i) m[i] += o.m[i];
  }
  double eval(double x, double y, double z) const {
    return m[0] * x * x + 2 * m[1] * x * y + 2 * m[2] * x * z + 2 * m[3] * x +
           m[4] * y * y + 2 * m[5] * y * z + 2 * m[6] * y +
           m[7] * z * z + 2 * m[8] * z + m[9];
  }
  // solve for minimizing point; false if near-singular
  bool optimal(double& x, double& y, double& z) const {
    double A[3][3] = {{m[0], m[1], m[2]}, {m[1], m[4], m[5]}, {m[2], m[5], m[7]}};
    double b[3] = {-m[3], -m[6], -m[8]};
    // Cramer with determinant guard
    double det = A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1]) -
                 A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0]) +
                 A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
    if (std::fabs(det) < 1e-12) return false;
    double inv = 1.0 / det;
    x = inv * (b[0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1]) -
               A[0][1] * (b[1] * A[2][2] - A[1][2] * b[2]) +
               A[0][2] * (b[1] * A[2][1] - A[1][1] * b[2]));
    y = inv * (A[0][0] * (b[1] * A[2][2] - A[1][2] * b[2]) -
               b[0] * (A[1][0] * A[2][2] - A[1][2] * A[2][0]) +
               A[0][2] * (A[1][0] * b[2] - b[1] * A[2][0]));
    z = inv * (A[0][0] * (A[1][1] * b[2] - b[1] * A[2][1]) -
               A[0][1] * (A[1][0] * b[2] - b[1] * A[2][0]) +
               b[0] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]));
    return std::isfinite(x) && std::isfinite(y) && std::isfinite(z);
  }
};

struct HeapEntry {
  double cost;
  int64_t v0, v1;
  uint64_t stamp;  // v0_version * K + v1_version snapshot
  bool operator<(const HeapEntry& o) const { return cost > o.cost; }  // min-heap
};

}  // namespace

extern "C" {

// In/out: verts (nv,3) f64, faces (nf,3) i32.  Writes the decimated mesh into
// out_* buffers (caller-allocated at input size) and returns counts via
// out_nv/out_nf.  target_nf: stop when face count <= target.
int omvs_decimate(const double* verts_in, int64_t nv, const int32_t* faces_in, int64_t nf,
                  int64_t target_nf, double* out_verts, int32_t* out_faces,
                  int64_t* out_nv, int64_t* out_nf) {
  std::vector<double> V(verts_in, verts_in + 3 * nv);
  std::vector<int32_t> F(faces_in, faces_in + 3 * nf);
  std::vector<char> fdead(nf, 0);
  std::vector<uint32_t> vversion(nv, 0);
  std::vector<char> vdead(nv, 0);

  // vertex -> incident faces (grow-only; stale entries filtered on use)
  std::vector<std::vector<int64_t>> vfaces(nv);
  for (int64_t fi = 0; fi < nf; ++fi)
    for (int k = 0; k < 3; ++k) vfaces[F[3 * fi + k]].push_back(fi);

  // initial quadrics
  std::vector<Sym4> Q(nv);
  for (int64_t fi = 0; fi < nf; ++fi) {
    const int32_t* f = &F[3 * fi];
    const double *a = &V[3 * f[0]], *b = &V[3 * f[1]], *c = &V[3 * f[2]];
    double u[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    double w[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    double n[3] = {u[1] * w[2] - u[2] * w[1], u[2] * w[0] - u[0] * w[2], u[0] * w[1] - u[1] * w[0]};
    double l = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (l < 1e-30) continue;
    n[0] /= l; n[1] /= l; n[2] /= l;
    double d = -(n[0] * a[0] + n[1] * a[1] + n[2] * a[2]);
    for (int k = 0; k < 3; ++k) Q[f[k]].add_plane(n[0], n[1], n[2], d);
  }

  auto edge_cost = [&](int64_t v0, int64_t v1, double* pos) -> double {
    Sym4 q = Q[v0];
    q.add(Q[v1]);
    // midpoint default: stays defined even if every candidate eval is
    // NaN (degenerate/NaN input vertices propagate into the quadric)
    double x = (V[3 * v0] + V[3 * v1]) / 2;
    double y = (V[3 * v0 + 1] + V[3 * v1 + 1]) / 2;
    double z = (V[3 * v0 + 2] + V[3 * v1 + 2]) / 2;
    if (!q.optimal(x, y, z)) {
      // optimal() may clobber x/y/z with non-finite values before failing:
      // reset to the midpoint so the position stays defined even if every
      // candidate eval below is NaN
      x = (V[3 * v0] + V[3 * v1]) / 2;
      y = (V[3 * v0 + 1] + V[3 * v1 + 1]) / 2;
      z = (V[3 * v0 + 2] + V[3 * v1 + 2]) / 2;
      // try endpoints and midpoint
      double cands[3][3] = {
          {V[3 * v0], V[3 * v0 + 1], V[3 * v0 + 2]},
          {V[3 * v1], V[3 * v1 + 1], V[3 * v1 + 2]},
          {(V[3 * v0] + V[3 * v1]) / 2, (V[3 * v0 + 1] + V[3 * v1 + 1]) / 2,
           (V[3 * v0 + 2] + V[3 * v1 + 2]) / 2}};
      double best = 1e300;
      for (auto& cd : cands) {
        double cost = q.eval(cd[0], cd[1], cd[2]);
        if (cost < best) {
          best = cost;
          x = cd[0]; y = cd[1]; z = cd[2];
        }
      }
    }
    pos[0] = x; pos[1] = y; pos[2] = z;
    return q.eval(x, y, z);
  };

  std::priority_queue<HeapEntry> heap;
  auto push_edge = [&](int64_t v0, int64_t v1) {
    if (v0 > v1) std::swap(v0, v1);
    double pos[3];
    double cost = edge_cost(v0, v1, pos);
    heap.push({cost, v0, v1, (uint64_t)vversion[v0] << 32 | vversion[v1]});
  };

  // seed heap with all edges
  {
    std::vector<std::pair<int64_t, int64_t>> edges;
    edges.reserve(3 * nf);
    for (int64_t fi = 0; fi < nf; ++fi) {
      const int32_t* f = &F[3 * fi];
      for (int k = 0; k < 3; ++k) {
        int64_t a = f[k], b = f[(k + 1) % 3];
        if (a > b) std::swap(a, b);
        edges.emplace_back(a, b);
      }
    }
    std::sort(edges.begin(), edges.end());
    edges.erase(std::unique(edges.begin(), edges.end()), edges.end());
    for (auto& e : edges) push_edge(e.first, e.second);
  }

  int64_t live_faces = nf;
  std::vector<int64_t> tmp;
  while (live_faces > target_nf && !heap.empty()) {
    HeapEntry e = heap.top();
    heap.pop();
    if (vdead[e.v0] || vdead[e.v1]) continue;
    if (e.stamp != ((uint64_t)vversion[e.v0] << 32 | vversion[e.v1])) continue;

    double pos[3];
    edge_cost(e.v0, e.v1, pos);

    // gather live incident faces
    auto prune = [&](int64_t v) {
      auto& lst = vfaces[v];
      lst.erase(std::remove_if(lst.begin(), lst.end(),
                               [&](int64_t fi) {
                                 if (fdead[fi]) return true;
                                 const int32_t* f = &F[3 * fi];
                                 return f[0] != v && f[1] != v && f[2] != v;
                               }),
                lst.end());
    };
    prune(e.v0);
    prune(e.v1);

    // normal-flip guard: collapsing must not invert any surviving face
    bool flip = false;
    for (int64_t v : {e.v0, e.v1}) {
      for (int64_t fi : vfaces[v]) {
        const int32_t* f = &F[3 * fi];
        bool has_other = false;
        for (int k = 0; k < 3; ++k)
          if (f[k] == (v == e.v0 ? e.v1 : e.v0)) has_other = true;
        if (has_other) continue;  // face dies
        double p[3][3];
        for (int k = 0; k < 3; ++k) {
          int64_t vid = f[k];
          if (vid == v) {
            p[k][0] = pos[0]; p[k][1] = pos[1]; p[k][2] = pos[2];
          } else {
            p[k][0] = V[3 * vid]; p[k][1] = V[3 * vid + 1]; p[k][2] = V[3 * vid + 2];
          }
        }
        double u[3] = {p[1][0] - p[0][0], p[1][1] - p[0][1], p[1][2] - p[0][2]};
        double w[3] = {p[2][0] - p[0][0], p[2][1] - p[0][1], p[2][2] - p[0][2]};
        double nn[3] = {u[1] * w[2] - u[2] * w[1], u[2] * w[0] - u[0] * w[2],
                        u[0] * w[1] - u[1] * w[0]};
        // old normal
        const double *a = &V[3 * f[0]], *b = &V[3 * f[1]], *c = &V[3 * f[2]];
        double uo[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
        double wo[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
        double no[3] = {uo[1] * wo[2] - uo[2] * wo[1], uo[2] * wo[0] - uo[0] * wo[2],
                        uo[0] * wo[1] - uo[1] * wo[0]};
        if (nn[0] * no[0] + nn[1] * no[1] + nn[2] * no[2] < 0) {
          flip = true;
          break;
        }
      }
      if (flip) break;
    }
    if (flip) continue;

    // collapse v1 -> v0 at pos
    V[3 * e.v0] = pos[0]; V[3 * e.v0 + 1] = pos[1]; V[3 * e.v0 + 2] = pos[2];
    Q[e.v0].add(Q[e.v1]);
    vdead[e.v1] = 1;
    ++vversion[e.v0];

    // kill shared faces, rewire v1 faces
    for (int64_t fi : vfaces[e.v1]) {
      int32_t* f = &F[3 * fi];
      bool has_v0 = (f[0] == e.v0 || f[1] == e.v0 || f[2] == e.v0);
      if (has_v0) {
        if (!fdead[fi]) {
          fdead[fi] = 1;
          --live_faces;
        }
      } else {
        for (int k = 0; k < 3; ++k)
          if (f[k] == e.v1) f[k] = (int32_t)e.v0;
        vfaces[e.v0].push_back(fi);
      }
    }

    // re-push edges of the one-ring
    tmp.clear();
    for (int64_t fi : vfaces[e.v0]) {
      if (fdead[fi]) continue;
      const int32_t* f = &F[3 * fi];
      for (int k = 0; k < 3; ++k)
        if (f[k] != e.v0) tmp.push_back(f[k]);
    }
    std::sort(tmp.begin(), tmp.end());
    tmp.erase(std::unique(tmp.begin(), tmp.end()), tmp.end());
    for (int64_t v : tmp)
      if (!vdead[v]) push_edge(e.v0, v);
  }

  // compact output
  std::vector<int64_t> vmap(nv, -1);
  int64_t nvo = 0;
  for (int64_t fi = 0; fi < nf; ++fi) {
    if (fdead[fi]) continue;
    const int32_t* f = &F[3 * fi];
    if (f[0] == f[1] || f[1] == f[2] || f[0] == f[2]) continue;
    for (int k = 0; k < 3; ++k) {
      int64_t v = f[k];
      if (vmap[v] < 0) {
        vmap[v] = nvo;
        out_verts[3 * nvo] = V[3 * v];
        out_verts[3 * nvo + 1] = V[3 * v + 1];
        out_verts[3 * nvo + 2] = V[3 * v + 2];
        ++nvo;
      }
    }
  }
  int64_t nfo = 0;
  for (int64_t fi = 0; fi < nf; ++fi) {
    if (fdead[fi]) continue;
    const int32_t* f = &F[3 * fi];
    if (f[0] == f[1] || f[1] == f[2] || f[0] == f[2]) continue;
    for (int k = 0; k < 3; ++k) out_faces[3 * nfo + k] = (int32_t)vmap[f[k]];
    ++nfo;
  }
  *out_nv = nvo;
  *out_nf = nfo;
  return 0;
}

}  // extern "C"
