// PatchMatch scorer kernels K1 and K2 and the geometric kernel K3 for
// Hopper (sm_90a).
//
// Replaces, in the JAX package (openmvs_tpu/ops/pm_kernel.py):
//   K1  _score_view_pallas       (pm_kernel.py:819, pallas_call at :933)
//   K2  _score_view_geom_pallas  (pm_kernel.py:979, pallas_call at :1106)
//   K3  geom_term_pallas         (pm_kernel.py:691, pallas_call at :742)
// K1 and K2 are one template, pm_score<NEAREST, GEOM>: K1 is GEOM=false, K2
// GEOM=true. K3, pm_geom_term, is K2's geometric half on its own; both
// call pm::geom_cons (pm_common.cuh).
//
// What K1/K2 compute (the XLA CPU path, patchmatch.py:285-480, which the
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
// 4 where the blend-then-check similarity test fails. K3 writes only that
// penalty, from the raw candidate depth (zeros mark invalid hypotheses)
// and its own forward transform (Tl, Tm).
//
// Bound on an H100 at the main path's shape (C=11, 480x640, T=25): about
// 50 fp32 operations per texel in exact mode (an fma counted as two) ->
// 4.4 GFLOP, 65 us at 67 TFLOP/s; the bytes that must move (w/wtm once,
// the candidate maps and the output) are about 150 MB, 45 us at 3.35 TB/s.
// So the bound is fp32 issue (nearest mode: about 37 operations per texel,
// and the bytes bound it). chip_smoke.py computes it from each run's
// shapes; in practice the scattered neighbour-image reads decide the time.
// K3 moves the raw depth in and the penalty out (27 MB at C=11) plus X0,
// uv and the depth map (7 MB) for about 83 operations per (c, p): it is
// bound by bytes, about 10 us.
//
// Design (simple first): one thread per (candidate, pixel), a loop over
// the texels; per-view constants (size, Hl, Hm, Tr, Tn, goff and the
// texel warps Hl @ goff) are staged once per block in shared memory;
// image and depth-map reads go through __ldg (read-only cache), and the
// bilinear blend is done by hand in fp32 (the texture unit's weights keep
// only 8 fractional bits). The ZNCC epilogue is fused, and K2 computes the
// geometric term in the same thread from the same back-projection. There
// is no patch window and so no out-of-patch invalidation or neutral 2.0 on
// a window miss: those are artefacts of the TPU's VMEM. K1 with the
// neighbour window staged in shared memory is K1-v2 (pm_score_v2.cu).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// into a shared library with a plain C interface, loaded through ctypes
// (ops/_build.py).

#include "pm_common.cuh"

namespace {

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
  __shared__ pm::ViewConsts vc;
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
    for (int r = 0; r < 3; ++r) s_sg[3 * k + r] = pm::row3(vc.hl + 3 * r, ga, gb, gc);
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

  const float sx0 = pm::row3(hl, xa, xb, xc);
  const float sy0 = pm::row3(hl + 3, xa, xb, xc);
  const float sz0 = pm::row3(hl + 6, xa, xb, xc);
  const float inv_d = 1.f / d;

  // the texel loop is written out here rather than through small inline
  // helpers: the same arithmetic, but built through helpers K1 took 0.41 ms
  // in exact mode at C=11, 480x640 against 0.37 ms in this form
  // (chip_smoke.py, H100 80GB HBM3)
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
    const float val = NEAREST ? pm::nearest(img, Hp, Wp, px, py)
                              : pm::bilinear<true>(img, Hp, Wp, px, py);
    const float wk = w[(size_t)k * HW + p];
    const float wtmk = wtm[(size_t)k * HW + p];
    num = __fmaf_rn(val, wtmk, num);
    ssum = __fmaf_rn(val, wk, ssum);
    ssq = __fmaf_rn(val * val, wk, ssq);
  }
  score_out[i] = pm::zncc_score(num, ssum, ssq, sum_w[p], norm_sq0[p], inb, th_robust);

  if (GEOM) {
    // packed data has Tl == Hl and Tm == Hm, so K2 reuses the warp constants
    cons_out[i] = pm::geom_cons(hl, hm, vc.tr, vc.tn, h_j, w_j, dm, Hd, Wd, d,
                                xa, xb, xc, uv[2 * p], uv[2 * p + 1]);
  }
}

struct GeomConsts {
  float h, w;
  float tl[9], tm[3], tr[9], tn[3];
};

__global__ void __launch_bounds__(256)
pm_geom_term_kernel(const float* __restrict__ dm, int Hd, int Wd,
                    const float* __restrict__ size, const float* __restrict__ Tl,
                    const float* __restrict__ Tm, const float* __restrict__ Tr,
                    const float* __restrict__ Tn, const float* __restrict__ depth,
                    const float* __restrict__ X0, const float* __restrict__ uv,
                    float* __restrict__ cons_out, int C, int H, int W) {
  __shared__ GeomConsts gc;
  const int tid = threadIdx.x;
  if (tid == 0) {
    gc.h = size[0];
    gc.w = size[1];
    for (int k = 0; k < 9; ++k) gc.tl[k] = Tl[k];
    for (int k = 0; k < 3; ++k) gc.tm[k] = Tm[k];
    for (int k = 0; k < 9; ++k) gc.tr[k] = Tr[k];
    for (int k = 0; k < 3; ++k) gc.tn[k] = Tn[k];
  }
  __syncthreads();

  const int HW = H * W;
  const long long n = (long long)C * HW;
  const long long i = (long long)blockIdx.x * blockDim.x + tid;
  if (i >= n) return;
  const int p = (int)(i % HW);
  cons_out[i] = pm::geom_cons(gc.tl, gc.tm, gc.tr, gc.tn, gc.h, gc.w, dm, Hd, Wd,
                              depth[i], X0[3 * p], X0[3 * p + 1], X0[3 * p + 2],
                              uv[2 * p], uv[2 * p + 1]);
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

// Launch K3 on `stream`: cons (C, H, W) from the raw candidate depths
// depth (C, H, W), X0 (H, W, 3), uv (H, W, 2) and the neighbour depth map
// dm (Hd, Wd), in the layouts of the JAX package's geom_term_pallas.
// Returns the CUDA error of the launch; does not synchronise.
int pm_geom_term(const float* dm, int Hd, int Wd, const float* size,
                 const float* Tl, const float* Tm, const float* Tr,
                 const float* Tn, const float* depth, const float* X0,
                 const float* uv, float* cons, int C, int H, int W,
                 void* stream) {
  const long long n = (long long)C * H * W;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  pm_geom_term_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      dm, Hd, Wd, size, Tl, Tm, Tr, Tn, depth, X0, uv, cons, C, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
