// Z-buffer triangle rasterization: mesh -> per-pixel face id / depth /
// barycentric maps.  Role equivalent of the reference's TRasterMeshBase
// pipeline (libs/MVS/Mesh.h:227-309, used by SceneRefine.cpp:102-125 and
// SceneTexture.cpp ListCameraFaces) with perspective-correct barycentrics.
//
// The caller projects vertices to image space (u, v) and camera depth z;
// rasterization is band-parallel over image rows (each thread owns a row
// band and scans all faces whose bbox intersects it — no z-buffer races).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// proj: (nv, 3) float64 — u, v (pixel coords), z (camera depth; z <= 0 means
// behind the camera).  faces: (nf, 3) int32.
// Outputs: face_id (H, W) int32 (-1 = empty), depth (H, W) float32,
// bary (H, W, 3) float32 (perspective-correct).
int omvs_rasterize(const double* proj, int64_t nv, const int32_t* faces, int64_t nf,
                   int64_t H, int64_t W,
                   int32_t* face_id, float* depth, float* bary) {
  for (int64_t i = 0; i < H * W; ++i) {
    face_id[i] = -1;
    depth[i] = 0.f;
  }
  if (bary)
    for (int64_t i = 0; i < 3 * H * W; ++i) bary[i] = 0.f;

  const int n_bands = std::max(1, (int)std::min<int64_t>(16, H / 64 + 1));
  const int64_t band_h = (H + n_bands - 1) / n_bands;

#pragma omp parallel for schedule(dynamic)
  for (int band = 0; band < n_bands; ++band) {
    const int64_t y_beg = band * band_h;
    const int64_t y_end = std::min<int64_t>(H, y_beg + band_h);
    for (int64_t fi = 0; fi < nf; ++fi) {
      const int32_t* fv = faces + 3 * fi;
      const double* p0 = proj + 3 * fv[0];
      const double* p1 = proj + 3 * fv[1];
      const double* p2 = proj + 3 * fv[2];
      if (p0[2] <= 0 || p1[2] <= 0 || p2[2] <= 0) continue;  // behind camera
      const double minx = std::min({p0[0], p1[0], p2[0]});
      const double maxx = std::max({p0[0], p1[0], p2[0]});
      const double miny = std::min({p0[1], p1[1], p2[1]});
      const double maxy = std::max({p0[1], p1[1], p2[1]});
      int64_t x0 = (int64_t)std::ceil(minx), x1 = (int64_t)std::floor(maxx);
      int64_t y0 = (int64_t)std::ceil(miny), y1 = (int64_t)std::floor(maxy);
      x0 = std::max<int64_t>(x0, 0);
      x1 = std::min<int64_t>(x1, W - 1);
      y0 = std::max(y0, y_beg);
      y1 = std::min(y1, y_end - 1);
      if (x0 > x1 || y0 > y1) continue;
      // screen-space edge functions
      const double ax = p1[0] - p0[0], ay = p1[1] - p0[1];
      const double bx = p2[0] - p0[0], by = p2[1] - p0[1];
      const double det = ax * by - ay * bx;
      if (std::fabs(det) < 1e-12) continue;
      const double inv_det = 1.0 / det;
      const double iz0 = 1.0 / p0[2], iz1 = 1.0 / p1[2], iz2 = 1.0 / p2[2];
      for (int64_t y = y0; y <= y1; ++y) {
        const double py = (double)y - p0[1];
        for (int64_t x = x0; x <= x1; ++x) {
          const double px = (double)x - p0[0];
          double l1 = (px * by - py * bx) * inv_det;   // weight of p1
          double l2 = (ax * py - ay * px) * inv_det;   // weight of p2
          double l0 = 1.0 - l1 - l2;
          if (l0 < -1e-9 || l1 < -1e-9 || l2 < -1e-9) continue;
          // perspective-correct interpolation
          const double izp = l0 * iz0 + l1 * iz1 + l2 * iz2;
          const double z = 1.0 / izp;
          const int64_t idx = y * W + x;
          if (face_id[idx] >= 0 && depth[idx] <= (float)z) continue;
          face_id[idx] = (int32_t)fi;
          depth[idx] = (float)z;
          if (bary) {
            bary[3 * idx + 0] = (float)(l0 * iz0 * z);
            bary[3 * idx + 1] = (float)(l1 * iz1 * z);
            bary[3 * idx + 2] = (float)(l2 * iz2 * z);
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
