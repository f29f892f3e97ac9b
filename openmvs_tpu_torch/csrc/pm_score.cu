// PatchMatch scorer kernels K1 and K2 for Hopper (sm_90a).
//
// Replaces, in the JAX package (openmvs_tpu/ops/pm_kernel.py):
//   K1  _score_view_pallas       (pm_kernel.py:819, pallas_call at :933)
//   K2  _score_view_geom_pallas  (pm_kernel.py:979, pallas_call at :1106)
// One template, pm_score<NEAREST, GEOM>: K1 is GEOM=false, K2 GEOM=true.
//
// What it computes (the XLA CPU path, patchmatch.py:285-480, which the
// port's plain versions in ops/pm_kernel.py repeat): for every candidate
// c and pixel p, the 25 texels of a 9x9 window (step 2) are warped through
// the plane-induced homography of (depth, normal) into the neighbour view,
// sampled bilinear (exact) or nearest (NEAREST: both axes rounded half to
// even, rintf), and accumulated into the bilaterally weighted ZNCC
//   num = sum val*wtm, ssum = sum val*w, ssq = sum val^2*w,
//   score = 1 - clip(num * rsqrt(norm_sq0 * (ssq - ssum^2/sum_w)), -1, 1),
// or th_robust where the normaliser is <= 1e-16 or any texel warps out of
// [1, w-2] x [1, h-2]. K2 also writes the forward-backward geometric
// penalty min(sqrt(dist*(dist+2)), 4) against the neighbour depth map, or
// 4 where the blend-then-check similarity test fails.
//
// Bound on an H100 at the main path's shape (C=11, 480x640, T=25): about
// 50 fp32 operations per texel in exact mode (an fma counted as two) ->
// 4.4 GFLOP, 65 us at 67 TFLOP/s; the bytes that must move (w/wtm once,
// the candidate maps and the output) are about 150 MB, 45 us at 3.35 TB/s.
// So the bound is fp32 issue (nearest mode: about 37 operations per texel,
// and the bytes bound it). chip_smoke.py computes it from each run's
// shapes; in practice the scattered neighbour-image reads decide the time.
//
// Design (simple first): one thread per (candidate, pixel), a loop over
// the texels; per-view constants (size, Hl, Hm, Tr, Tn, goff and the
// texel warps Hl @ goff) are staged once per block in shared memory;
// image and depth-map reads go through __ldg (read-only cache), and the
// bilinear blend is done by hand in fp32 (the texture unit's weights keep
// only 8 fractional bits). The ZNCC epilogue is fused, and K2 computes the
// geometric term in the same thread from the same back-projection. There
// is no patch window and so no out-of-patch invalidation: those are
// artefacts of the TPU's VMEM. Not done yet: shared-memory image tiles,
// and fusing the view loop with the min-mean aggregation.
//
// Rounding: the plain version fuses the multiply-adds that XLA's CPU
// backend fuses in the JAX package (utils/fmath.py), and the kernel writes
// exactly those as __fmaf_rn. It is built with -fmad=false so nvcc
// contracts nothing else, and without fast math (which would change
// division and sqrt); the reciprocal square root is rounded from double.
// Each rounding step is then the plain version's, so the kernel equals it
// to the bit in all but rare double-rounding cases, and nearest sampling
// at an exact .5 picks the same pixel.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// into a shared library with a plain C interface, loaded through ctypes
// (ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TEXELS 128

namespace {

struct ViewConsts {
  float h, w;          // valid extent of the neighbour view
  float hl[9], hm[3];  // plane-induced homography (Hl = Tl, Hm = Tm)
  float tr[9], tn[3];  // back-projection of the geometric term
};

// Bilinear sample with the plain version's fused multiply-adds: each row
// blends as fma(v_right, fx, v_left * (1 - fx)); the texel loop (TEXEL)
// fuses the upper row's term of the vertical blend, the geometric term the
// lower row's (the contractions XLA makes in the two places).
template <bool TEXEL>
__device__ __forceinline__ float bilinear(const float* __restrict__ img,
                                          int Hp, int Wp, float x, float y) {
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  // fmaxf/fminf drop a NaN operand, so a non-finite coordinate (masked by
  // the caller) still indexes inside the image
  int xi = (int)fminf(fmaxf(x0, 0.f), (float)(Wp - 2));
  int yi = (int)fminf(fmaxf(y0, 0.f), (float)(Hp - 2));
  const float* r0 = img + (size_t)yi * Wp + xi;
  float v00 = __ldg(r0), v01 = __ldg(r0 + 1);
  float v10 = __ldg(r0 + Wp), v11 = __ldg(r0 + Wp + 1);
  float top = __fmaf_rn(v01, fx, v00 * (1.f - fx));
  float bot = __fmaf_rn(v11, fx, v10 * (1.f - fx));
  return TEXEL ? __fmaf_rn(top, 1.f - fy, bot * fy)
               : __fmaf_rn(bot, fy, top * (1.f - fy));
}

// Row r of M @ (a, b, c) as a fused multiply-add chain.
__device__ __forceinline__ float row3(const float* m, float a, float b, float c) {
  return __fmaf_rn(m[2], c, __fmaf_rn(m[1], b, m[0] * a));
}

__device__ __forceinline__ float nearest(const float* __restrict__ img,
                                         int Hp, int Wp, float x, float y) {
  int xi = (int)fminf(fmaxf(rintf(x), 0.f), (float)(Wp - 1));
  int yi = (int)fminf(fmaxf(rintf(y), 0.f), (float)(Hp - 1));
  return __ldg(img + (size_t)yi * Wp + xi);
}

template <bool NEAREST, bool GEOM>
__global__ void __launch_bounds__(256)
pm_score(const float* __restrict__ img, int Hp, int Wp,
         const float* __restrict__ size, const float* __restrict__ Hl,
         const float* __restrict__ Hm, const float* __restrict__ Tr,
         const float* __restrict__ Tn, const float* __restrict__ dm,
         int Hd, int Wd, const float* __restrict__ depth,
         const float* __restrict__ normal, const float* __restrict__ inv_nd,
         const float* __restrict__ X0, const float* __restrict__ uv,
         const float* __restrict__ goff, int T,
         const float* __restrict__ w, const float* __restrict__ wtm,
         const float* __restrict__ sum_w, const float* __restrict__ norm_sq0,
         float* __restrict__ score_out, float* __restrict__ cons_out,
         int C, int H, int W, float th_robust) {
  __shared__ ViewConsts vc;
  __shared__ float s_goff[MAX_TEXELS * 3];
  __shared__ float s_sg[MAX_TEXELS * 3];  // Hl @ goff per texel

  const int tid = threadIdx.x;
  if (tid == 0) {
    vc.h = size[0];
    vc.w = size[1];
    for (int i = 0; i < 9; ++i) vc.hl[i] = Hl[i];
    for (int i = 0; i < 3; ++i) vc.hm[i] = Hm[i];
    if (GEOM) {
      for (int i = 0; i < 9; ++i) vc.tr[i] = Tr[i];
      for (int i = 0; i < 3; ++i) vc.tn[i] = Tn[i];
    }
  }
  for (int i = tid; i < 3 * T; i += blockDim.x) s_goff[i] = goff[i];
  __syncthreads();
  for (int k = tid; k < T; k += blockDim.x) {
    float ga = s_goff[3 * k], gb = s_goff[3 * k + 1], gc = s_goff[3 * k + 2];
    for (int r = 0; r < 3; ++r) s_sg[3 * k + r] = row3(vc.hl + 3 * r, ga, gb, gc);
  }
  __syncthreads();

  const int HW = H * W;
  const long long n = (long long)C * HW;
  const long long i = (long long)blockIdx.x * blockDim.x + tid;
  if (i >= n) return;
  const int p = (int)(i % HW);

  const float d = depth[i];
  const float ind = inv_nd[i];
  const float nx = normal[3 * i], ny = normal[3 * i + 1], nz = normal[3 * i + 2];
  const float xa = X0[3 * p], xb = X0[3 * p + 1], xc = X0[3 * p + 2];
  const float* hl = vc.hl;
  const float* hm = vc.hm;
  const float h_j = vc.h, w_j = vc.w;

  const float sx0 = row3(hl, xa, xb, xc);
  const float sy0 = row3(hl + 3, xa, xb, xc);
  const float sz0 = row3(hl + 6, xa, xb, xc);
  const float inv_d = 1.f / d;

  float num = 0.f, ssum = 0.f, ssq = 0.f;
  bool inb = true;
  for (int k = 0; k < T; ++k) {
    const float n_goff = __fmaf_rn(nz, s_goff[3 * k + 2],
                                   __fmaf_rn(ny, s_goff[3 * k + 1], nx * s_goff[3 * k]));
    const float scale = __fmaf_rn(n_goff, ind, inv_d);
    const float sx = __fmaf_rn(hm[0], scale, sx0 + s_sg[3 * k]);
    const float sy = __fmaf_rn(hm[1], scale, sy0 + s_sg[3 * k + 1]);
    const float sz = __fmaf_rn(hm[2], scale, sz0 + s_sg[3 * k + 2]);
    const bool zok = sz > 1e-8f;
    const float izs = zok ? 1.f / sz : 0.f;
    const float px = sx * izs, py = sy * izs;
    inb = inb && zok && px >= 1.f && px <= w_j - 2.f && py >= 1.f && py <= h_j - 2.f;
    const float val = NEAREST ? nearest(img, Hp, Wp, px, py)
                              : bilinear<true>(img, Hp, Wp, px, py);
    const float wk = w[(size_t)k * HW + p];
    const float wtmk = wtm[(size_t)k * HW + p];
    num = __fmaf_rn(val, wtmk, num);
    ssum = __fmaf_rn(val, wk, ssum);
    ssq = __fmaf_rn(val * val, wk, ssq);
  }
  const float norm_sq1 = __fmaf_rn(-(ssum * ssum), 1.f / sum_w[p], ssq);
  const float nrm_sq = norm_sq0[p] * norm_sq1;
  // the reciprocal square root rounded from double: the same result as
  // the plain version on every device (rsqrtf is approximate)
  const float rs = (float)(1.0 / sqrt((double)fmaxf(nrm_sq, 1e-30f)));
  const float ncc = fminf(fmaxf(num * rs, -1.f), 1.f);
  score_out[i] = (nrm_sq <= 1e-16f || !inb) ? th_robust : 1.f - ncc;

  if (GEOM) {
    const float* tr = vc.tr;
    const float* tn = vc.tn;
    const float Xa = xa * d, Xb = xb * d, Xc = xc * d;
    const float X1a = row3(hl, Xa, Xb, Xc) + hm[0];
    const float X1b = row3(hl + 3, Xa, Xb, Xc) + hm[1];
    const float z1 = row3(hl + 6, Xa, Xb, Xc) + hm[2];
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
    const float du = __fmaf_rn(-XBa, izb, uv[2 * p]);
    const float dv = __fmaf_rn(-XBb, izb, uv[2 * p + 1]);
    const float dist = sqrtf(__fmaf_rn(du, du, dv * dv));
    const float cons = fminf(sqrtf(dist * (dist + 2.f)), 4.f);
    cons_out[i] = (similar && zbok) ? cons : 4.f;
  }
}

}  // namespace

extern "C" {

int pm_max_texels() { return MAX_TEXELS; }

const char* pm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch K1 (geom = 0) or K2 (geom = 1) on `stream`. Pointers are device
// pointers of contiguous float32 tensors in the layouts of the JAX
// package's score_view_pallas / score_view_geom_pallas. Returns the CUDA
// error of the launch (0 = success); does not synchronise.
int pm_score_view(const float* img, int Hp, int Wp, const float* size,
                  const float* Hl, const float* Hm, const float* Tr,
                  const float* Tn, const float* dm, int Hd, int Wd,
                  const float* depth, const float* normal,
                  const float* inv_nd, const float* X0, const float* uv,
                  const float* goff, int T, const float* w, const float* wtm,
                  const float* sum_w, const float* norm_sq0, float* score,
                  float* cons, int C, int H, int W, float th_robust,
                  int nearest, int geom, void* stream) {
  if (T > MAX_TEXELS || T < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)C * H * W;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
#define PM_ARGS img, Hp, Wp, size, Hl, Hm, Tr, Tn, dm, Hd, Wd, depth, normal, \
    inv_nd, X0, uv, goff, T, w, wtm, sum_w, norm_sq0, score, cons, C, H, W, th_robust
  if (geom) {
    if (nearest) pm_score<true, true><<<blocks, threads, 0, s>>>(PM_ARGS);
    else pm_score<false, true><<<blocks, threads, 0, s>>>(PM_ARGS);
  } else {
    if (nearest) pm_score<true, false><<<blocks, threads, 0, s>>>(PM_ARGS);
    else pm_score<false, false><<<blocks, threads, 0, s>>>(PM_ARGS);
  }
#undef PM_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
