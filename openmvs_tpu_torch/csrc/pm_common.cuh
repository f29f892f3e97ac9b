// Device arithmetic shared by the PatchMatch kernels (pm_score.cu,
// pm_score_v2.cu, pm_score_views.cu, pm_geom_views.cu): the samplers, the
// ZNCC epilogue and the geometric-consistency term. K2, K3, K2-mv and K3-mv
// share geom_cons; K1/K2 and K1-v2 share the samplers and the epilogue, and
// K1-v2's texel warp (pm_score_v2.cu) is K1's op for op, so the kernels
// round each step the same way and agree to the bit where they compute the
// same function (chip_smoke.py checks K1-v2 against K1 with torch.equal).
//
// Rounding: the plain versions in ops/pm_kernel.py fuse the multiply-adds
// that XLA's CPU backend fuses in the JAX package (utils/fmath.py), and the
// code here writes exactly those as __fmaf_rn. The sources are built with
// -fmad=false so nvcc contracts nothing else, and without fast math (which
// would change division and sqrt).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TEXELS 128

namespace pm {

// Row r of M @ (a, b, c) as a fused multiply-add chain.
__device__ __forceinline__ float row3(const float* m, float a, float b, float c) {
  return __fmaf_rn(m[2], c, __fmaf_rn(m[1], b, m[0] * a));
}

// Top-left corner (xi, yi) of the bilinear footprint of (x, y), clamped so
// the 2x2 footprint lies in the Hp x Wp image, and the fractional offsets.
// fmaxf/fminf drop a NaN operand, so a non-finite coordinate (masked by the
// caller) still indexes inside the image.
__device__ __forceinline__ void bilinear_index(int Hp, int Wp, float x, float y,
                                               int& xi, int& yi, float& fx,
                                               float& fy) {
  const float x0 = floorf(x), y0 = floorf(y);
  fx = x - x0;
  fy = y - y0;
  xi = (int)fminf(fmaxf(x0, 0.f), (float)(Wp - 2));
  yi = (int)fminf(fmaxf(y0, 0.f), (float)(Hp - 2));
}

// Bilinear blend with the plain version's fused multiply-adds: each row
// blends as fma(v_right, fx, v_left * (1 - fx)); the texel loop (TEXEL)
// fuses the upper row's term of the vertical blend, the geometric term the
// lower row's (the contractions XLA makes in the two places).
template <bool TEXEL>
__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11,
                                       float fx, float fy) {
  const float top = __fmaf_rn(v01, fx, v00 * (1.f - fx));
  const float bot = __fmaf_rn(v11, fx, v10 * (1.f - fx));
  return TEXEL ? __fmaf_rn(top, 1.f - fy, bot * fy)
               : __fmaf_rn(bot, fy, top * (1.f - fy));
}

template <bool TEXEL>
__device__ __forceinline__ float bilinear(const float* __restrict__ img, int Hp,
                                          int Wp, float x, float y) {
  int xi, yi;
  float fx, fy;
  bilinear_index(Hp, Wp, x, y, xi, yi, fx, fy);
  const float* r0 = img + (size_t)yi * Wp + xi;
  return blend<TEXEL>(__ldg(r0), __ldg(r0 + 1), __ldg(r0 + Wp),
                      __ldg(r0 + Wp + 1), fx, fy);
}

// Nearest pixel, both axes rounded half to even (rintf), as torch.round and
// the XLA path round.
__device__ __forceinline__ void nearest_index(int Hp, int Wp, float x, float y,
                                              int& xi, int& yi) {
  xi = (int)fminf(fmaxf(rintf(x), 0.f), (float)(Wp - 1));
  yi = (int)fminf(fmaxf(rintf(y), 0.f), (float)(Hp - 1));
}

__device__ __forceinline__ float nearest(const float* __restrict__ img, int Hp,
                                         int Wp, float x, float y) {
  int xi, yi;
  nearest_index(Hp, Wp, x, y, xi, yi);
  return __ldg(img + (size_t)yi * Wp + xi);
}

// Per-view constants of the scorers, staged once per block.
struct ViewConsts {
  float h, w;          // valid extent of the neighbour view
  float hl[9], hm[3];  // plane-induced homography (Hl = Tl, Hm = Tm)
  float tr[9], tn[3];  // back-projection of the geometric term (K2)
};

// ZNCC epilogue: 1 - clip(num * rsqrt(norm_sq0 * (ssq - ssum^2 / sum_w)),
// -1, 1), or th_robust where the normaliser is <= 1e-16 or a texel left the
// view. The reciprocal square root is rounded from double: the same result
// as the plain version on every device (rsqrtf is approximate).
__device__ __forceinline__ float zncc_score(float num, float ssum, float ssq,
                                            float sum_w, float norm_sq0,
                                            bool inb, float th_robust) {
  const float norm_sq1 = __fmaf_rn(-(ssum * ssum), 1.f / sum_w, ssq);
  const float nrm_sq = norm_sq0 * norm_sq1;
  const float rs = (float)(1.0 / sqrt((double)fmaxf(nrm_sq, 1e-30f)));
  const float ncc = fminf(fmaxf(num * rs, -1.f), 1.f);
  return (nrm_sq <= 1e-16f || !inb) ? th_robust : 1.f - ncc;
}

// The same pointer, opaque to the compiler, so it cannot fold a base
// offset into every gather's address (which costs 64-bit arithmetic per
// gather): each address is then one 32-bit multiply-add and one wide add.
__device__ __forceinline__ const float* opaque(const float* p) {
  asm("" : "+l"(p));
  return p;
}

// Forward-backward geometric penalty of one (candidate, pixel) in [0, 4]
// (DepthMap.cpp:535-551): X = X0 * d through (tl, tm) into the neighbour,
// the neighbour depth map sampled bilinear (blend, then the similarity
// check |z1 - d1| < 0.03 z1), back through (tr, tn), and
// min(sqrt(dist * (dist + 2)), 4) of the reprojection distance to (u, v);
// 4 where the check fails. d is the raw candidate depth: d <= 0 marks an
// invalid hypothesis, which is never consistent.
__device__ __forceinline__ float geom_cons(const float* tl, const float* tm,
                                           const float* tr, const float* tn,
                                           float h_j, float w_j,
                                           const float* __restrict__ dm, int Hd,
                                           int Wd, float d, float xa, float xb,
                                           float xc, float u, float v) {
  const float Xa = xa * d, Xb = xb * d, Xc = xc * d;
  const float X1a = row3(tl, Xa, Xb, Xc) + tm[0];
  const float X1b = row3(tl + 3, Xa, Xb, Xc) + tm[1];
  const float z1 = row3(tl + 6, Xa, Xb, Xc) + tm[2];
  const bool zok = z1 > 1e-8f;
  const float iz = zok ? 1.f / z1 : 0.f;
  const float x1 = X1a * iz, y1 = X1b * iz;
  const bool inside = zok && d > 0.f && x1 >= 1.f && x1 <= w_j - 2.f &&
                      y1 >= 1.f && y1 <= h_j - 2.f;
  const float d1 = bilinear<false>(dm, Hd, Wd, x1, y1);
  const bool similar = inside && d1 > 0.f && fabsf(z1 - d1) < 0.03f * z1;
  const float ba = x1 * d1, bb = y1 * d1;
  const float XBa = row3(tr, ba, bb, d1) + tn[0];
  const float XBb = row3(tr + 3, ba, bb, d1) + tn[1];
  const float zb = row3(tr + 6, ba, bb, d1) + tn[2];
  const bool zbok = zb > 1e-8f;
  const float izb = zbok ? 1.f / zb : 0.f;
  const float du = __fmaf_rn(-XBa, izb, u);
  const float dv = __fmaf_rn(-XBb, izb, v);
  const float dist = sqrtf(__fmaf_rn(du, du, dv * dv));
  const float cons = fminf(sqrtf(dist * (dist + 2.f)), 4.f);
  return (similar && zbok) ? cons : 4.f;
}

}  // namespace pm
