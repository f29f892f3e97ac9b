// Multi-view PatchMatch scorer for Hopper (sm_90a): K1-mv and K2-mv.
//
// Replaces, in the JAX package (openmvs_tpu/ops/pm_kernel.py), the
// per-view launches of
//   K1  _score_view_pallas       (pm_kernel.py:819, pallas_call at :933)
//   K2  _score_view_geom_pallas  (pm_kernel.py:979, pallas_call at :1106)
// together with the view loop of score_hypotheses around them
// (openmvs_tpu/ops/patchmatch.py:562-621: finish_view, then the min-mean of
// the best two views). One launch scores C candidate planes against V <= 12
// neighbour views and writes only the (C, H, W) aggregate; the per-view
// (C, H, W) scores never reach device memory.
//
// What it computes, for each candidate c, pixel p and view j in view order:
// K1's bilaterally weighted ZNCC (texel loop op for op as pm_score.cu), the
// geometric term g_j by GEOM mode (GEOM_NONE: none; GEOM_FUSED: pm::geom_cons
// as K2 computes it; GEOM_PRE: read from a precomputed (V, C, H, W) stack, as
// the split sweep and OMVS_GEOM_FUSED=0 give it), then finish_view:
//   s = s * bonus, or fma(s, bonus, wg * g_j);
//   where d0 > 0: s = fma(1 - f_blend, s, f_blend * delta);
//   s = min(s, 2); s = 2 for a padded view slot (size h == 0);
// and folds s into the running best two (s0, s1). The output is s0 for one
// view, else (s1 < th_robust ? 0.5 (s0 + s1) : s0).
//
// Rounding equals the plain version (ops/pm_kernel.py score_views_plain) bit
// for bit: the texel loop uses __fmaf_rn at K1's sites (built -fmad=false);
// the epilogue's fma is fmath.fma, a float64 product and sum rounded once to
// float32; min, max and the clamp propagate NaN as torch.minimum,
// torch.maximum and torch.clamp do (degenerate candidates score NaN).
//
// Bound on an H100 at the main path's shape (C=11, V=4, 480x640, T=25):
// V x K1's per-view operations, less the view-independent part of the warp,
// about 16.5 GFLOP in exact mode -> 0.25 ms at 67 TFLOP/s; the bytes (w and
// wtm once, 61 MB; the candidate maps, bonus and delta, 95 MB; the V images
// and the output) are about 180 MB, 0.055 ms at 3.35 TB/s. So it is bound
// by fp32 operations; chip_smoke.py computes the bound from each run's
// shapes.
//
// Design. The per-view K1 reads each pixel's 25 w and 25 wtm (200 B) once
// per candidate and per view: C x V x 61 MB per score_hypotheses call,
// streamed through the 50 MB L2 a plane at a time, so almost none of it is
// reused. Here a block owns a run of P consecutive pixels and stages their
// weights in shared memory once, with cp.async (T x P floats each, P = 64
// for C >= 4), overlapped with staging the per-view constants (size, Hl,
// Hm, Tr, Tn and the texel warps Hl @ goff, 3T floats a view). The block's
// threads split over (pixel, candidate): G = 256 / P candidate groups, each
// thread walking candidates c = g, g + G, ... of its pixel. For each
// candidate it first computes the view-independent part of every texel's
// warp (n . goff_k and scale_k = n_goff_k / (n . X0 d) + 1 / d) once into
// its own column of shared memory, then loops over the views in order, so
// each (view, c, p) accumulates its texels in texel order and the views
// fold into (s0, s1) in view order. Shared memory per block is
// 4 (4 T V + 2 T P + 256 T + 3 T + 26 V) bytes, 41 KB at C >= 4, V = 4; at
// C = 1 a block takes 256 pixels (79 KB, above the 48 KB default, so the
// launch raises the kernel's dynamic shared-memory limit). The texel loop
// is bound by instruction throughput, not by occupancy (capping registers for
// more resident blocks made it slower), so it is written for fewer
// instructions: the texel warps are read as one float4, the weights as one
// float2, image addresses are a 32-bit offset from an opaque per-view base
// (cuobjdump -sass showed 64-bit address arithmetic for every gather
// before), and the reciprocal is selected, not branched around. No tensor
// cores: the work is gathers and fp32 arithmetic.
//
// Band skipping (OMVS_ACTIVE, the port of the JAX package's tile_act
// flags, openmvs_tpu/ops/pm_kernel.py:117-170, :534-605): an optional array
// band_act of ceil(H / 16) bytes flags each band of 16 image rows (the JAX
// package's 8-row tile of the row-pair compacted lattice) active (non-zero)
// or skipped. A skipped pixel's raw score is th_robust in every view and its
// geometric term 0: it runs no texel loop and no geometric term, only
// finish_view and the min-mean. A block whose pixels all lie in skipped
// bands also stages no weights, so it reads no image, no texel weight and
// no neighbour depth map. The flags are a template argument (BANDS) as
// well: a null band_act launches the instantiation without them, the
// unflagged kernel as it was.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// into a shared library with a plain C interface, loaded through ctypes
// (ops/_build.py).

#include "pm_common.cuh"

#define MAX_VIEWS 12

namespace {

enum { GEOM_NONE = 0, GEOM_FUSED = 1, GEOM_PRE = 2 };

constexpr int THREADS = 256;
constexpr int BAND_ROWS = 16;
constexpr size_t MAX_SMEM = 227 * 1024;
constexpr int VC_FLOATS = sizeof(pm::ViewConsts) / sizeof(float);

// 4-byte asynchronous copy into shared memory; zero-fills when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// utils/fmath.fma: a * b + c in float64 (the product is exact), rounded
// once to float32
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return (float)__dadd_rn(__dmul_rn((double)a, (double)b), (double)c);
}

// pm::bilinear<true> and pm::nearest, the same values, with 32-bit offsets
// into the image plane (the launcher checks Hp * Wp < 2^31): 64-bit index
// arithmetic was a sixth of the texel loop's instructions
__device__ __forceinline__ float bilinear_texel(const float* __restrict__ img,
                                                int Hp, int Wp, float x, float y) {
  int xi, yi;
  float fx, fy;
  pm::bilinear_index(Hp, Wp, x, y, xi, yi, fx, fy);
  const float* r0 = img + (yi * Wp + xi);
  const float* r1 = r0 + Wp;
  return pm::blend<true>(__ldg(r0), __ldg(r0 + 1), __ldg(r1), __ldg(r1 + 1), fx, fy);
}

__device__ __forceinline__ float nearest_texel(const float* __restrict__ img,
                                               int Hp, int Wp, float x, float y) {
  int xi, yi;
  pm::nearest_index(Hp, Wp, x, y, xi, yi);
  return __ldg(img + (yi * Wp + xi));
}

// floats of dynamic shared memory: texel warps (V, T) float4, weights
// (T, P) float2, scales (T, threads), goff (T, 3), view constants (V)
size_t smem_bytes(int V, int T, int P, int threads) {
  return sizeof(float) * ((size_t)4 * T * V + (size_t)2 * T * P +
                          (size_t)T * threads + 3 * T + (size_t)V * VC_FLOATS);
}

// whether every band of the block's pixels p0..last is skipped
__device__ __forceinline__ bool block_skipped(const unsigned char* band_act, int p0,
                                              int last, int W) {
  for (int b = (p0 / W) / BAND_ROWS; b <= (last / W) / BAND_ROWS; ++b)
    if (band_act[b]) return false;
  return true;
}

template <bool NEAREST, int GEOM, bool BANDS>
__global__ void __launch_bounds__(THREADS)
pm_score_views(const float* __restrict__ img, int Hp, int Wp,
               const float* __restrict__ size, const float* __restrict__ Hl,
               const float* __restrict__ Hm, const float* __restrict__ Tr,
               const float* __restrict__ Tn, const float* __restrict__ dm,
               int Hd, int Wd, const float* __restrict__ gterm,
               const float* __restrict__ depth, const float* __restrict__ normal,
               const float* __restrict__ inv_nd, const float* __restrict__ bonus,
               const float* __restrict__ delta, const float* __restrict__ X0,
               const float* __restrict__ uv, const float* __restrict__ f_blend,
               const float* __restrict__ d0, const float* __restrict__ goff,
               int T, const float* __restrict__ w, const float* __restrict__ wtm,
               const float* __restrict__ sum_w, const float* __restrict__ norm_sq0,
               float* __restrict__ out, int V, int C, int H, int W, int P,
               float th_robust, float geom_weight,
               const unsigned char* __restrict__ band_act) {
  extern __shared__ float4 smem4[];
  float4* s_sg = smem4;                                    // (V, T): Hl_j @ goff_k
  float2* s_wt = reinterpret_cast<float2*>(s_sg + T * V);  // (T, P): (w, wtm)
  float* s_scale = reinterpret_cast<float*>(s_wt + T * P); // (T, threads)
  float* s_goff = s_scale + T * blockDim.x;                // (T, 3)
  pm::ViewConsts* vc = reinterpret_cast<pm::ViewConsts*>(s_goff + 3 * T);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int HW = H * W;
  const int p0 = blockIdx.x * P;

  // a block wholly in skipped bands (a test uniform over the block) stages
  // no weights
  const bool block_off =
      BANDS && block_skipped(band_act, p0, min(p0 + P, HW) - 1, W);

  // the tile's weights, read from device memory once per launch
  for (int idx = block_off ? T * P : tid; idx < T * P; idx += nt) {
    const int k = idx / P;
    const int q = p0 + idx % P;
    const bool ok = q < HW;
    const size_t src = (size_t)k * HW + (ok ? q : 0);
    cp_async4(&s_wt[idx].x, w + src, ok);
    cp_async4(&s_wt[idx].y, wtm + src, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // per-view constants while the weights are in flight
  for (int j = tid; j < V; j += nt) {
    pm::ViewConsts& c = vc[j];
    c.h = size[2 * j];
    c.w = size[2 * j + 1];
    for (int i = 0; i < 9; ++i) c.hl[i] = Hl[9 * j + i];
    for (int i = 0; i < 3; ++i) c.hm[i] = Hm[3 * j + i];
    if (GEOM == GEOM_FUSED) {
      for (int i = 0; i < 9; ++i) c.tr[i] = Tr[9 * j + i];
      for (int i = 0; i < 3; ++i) c.tn[i] = Tn[3 * j + i];
    }
  }
  for (int i = tid; i < 3 * T; i += nt) s_goff[i] = goff[i];
  __syncthreads();
  for (int i = tid; i < V * T; i += nt) {
    const int j = i / T, k = i % T;
    const float ga = s_goff[3 * k], gb = s_goff[3 * k + 1], gc = s_goff[3 * k + 2];
    const float* hl = vc[j].hl;
    s_sg[j * T + k] = make_float4(pm::row3(hl, ga, gb, gc), pm::row3(hl + 3, ga, gb, gc),
                                  pm::row3(hl + 6, ga, gb, gc), 0.f);
  }
  cp_async_wait_all();
  __syncthreads();

  const int pl = tid % P;
  const int G = nt / P;
  const int p = p0 + pl;
  if (p >= HW) return;
  // a skipped pixel runs no texel loop and no geometric term: every view's
  // raw score is th_robust and its geometric term 0
  const bool act = !BANDS || band_act[(p / W) / BAND_ROWS];
  const int Tk = act ? T : 0;   // the texels this pixel scores

  const float xa = X0[3 * p], xb = X0[3 * p + 1], xc = X0[3 * p + 2];
  const float sw = sum_w[p], nsq0 = norm_sq0[p];
  const float fb = f_blend[p], lowres = d0[p];
  float u = 0.f, v = 0.f;
  if (GEOM == GEOM_FUSED) {
    u = uv[2 * p];
    v = uv[2 * p + 1];
  }
  float* my_scale = s_scale + tid;

  for (int c = tid / P; c < C; c += G) {
    const size_t i = (size_t)c * HW + p;
    const float d = depth[i];
    const float ind = inv_nd[i];
    const float nx = normal[3 * i], ny = normal[3 * i + 1], nz = normal[3 * i + 2];
    const float bon = bonus[i];
    const float dl = delta[i];
    const float inv_d = 1.f / d;
    // the view-independent part of each texel's warp
    for (int k = 0; k < Tk; ++k) {
      const float n_goff = __fmaf_rn(nz, s_goff[3 * k + 2],
                                     __fmaf_rn(ny, s_goff[3 * k + 1], nx * s_goff[3 * k]));
      my_scale[k * nt] = __fmaf_rn(n_goff, ind, inv_d);
    }

    const float inf = __int_as_float(0x7f800000);
    float s0 = inf, s1 = inf;
    for (int j = 0; j < V; ++j) {
      const pm::ViewConsts& cv = vc[j];
      const float* hl = cv.hl;
      const float4* sg = s_sg + T * j;
      const float* imj = pm::opaque(img + (size_t)j * Hp * Wp);
      const float hm0 = cv.hm[0], hm1 = cv.hm[1], hm2 = cv.hm[2];
      const float h_j = cv.h, w_j = cv.w;
      const float x_max = w_j - 2.f, y_max = h_j - 2.f;
      const float sx0 = pm::row3(hl, xa, xb, xc);
      const float sy0 = pm::row3(hl + 3, xa, xb, xc);
      const float sz0 = pm::row3(hl + 6, xa, xb, xc);

      // K1's texel loop (pm_score.cu), written out as there; the reciprocal
      // is taken unconditionally and selected, which rounds the same
      float num = 0.f, ssum = 0.f, ssq = 0.f;
      bool inb = true;
      for (int k = 0; k < Tk; ++k) {
        const float scale = my_scale[k * nt];
        const float4 g = sg[k];
        const float sx = __fmaf_rn(hm0, scale, sx0 + g.x);
        const float sy = __fmaf_rn(hm1, scale, sy0 + g.y);
        const float sz = __fmaf_rn(hm2, scale, sz0 + g.z);
        const bool zok = sz > 1e-8f;
        const float rz = 1.f / sz;
        const float izs = zok ? rz : 0.f;
        const float px = sx * izs, py = sy * izs;
        inb = inb && zok && px >= 1.f && px <= x_max && py >= 1.f && py <= y_max;
        const float val = NEAREST ? nearest_texel(imj, Hp, Wp, px, py)
                                  : bilinear_texel(imj, Hp, Wp, px, py);
        const float2 wt = s_wt[k * P + pl];
        num = __fmaf_rn(val, wt.y, num);
        ssum = __fmaf_rn(val, wt.x, ssum);
        ssq = __fmaf_rn(val * val, wt.x, ssq);
      }
      const float s = act ? pm::zncc_score(num, ssum, ssq, sw, nsq0, inb, th_robust)
                          : th_robust;

      // finish_view
      float sv;
      if (GEOM == GEOM_NONE) {
        sv = s * bon;
      } else {
        float g;
        if (GEOM == GEOM_FUSED) {
          // packed data has Tl == Hl and Tm == Hm, as for K2
          g = act ? pm::geom_cons(hl, cv.hm, cv.tr, cv.tn, h_j, w_j,
                                  dm + (size_t)j * Hd * Wd, Hd, Wd, d, xa, xb, xc, u, v)
                  : 0.f;
        } else {
          g = act ? gterm[((size_t)j * C + c) * HW + p] : 0.f;
        }
        sv = fma_f64(s, bon, geom_weight * g);
      }
      if (lowres > 0.f) sv = fma_f64(1.f - fb, sv, fb * dl);
      sv = sv > 2.f ? 2.f : sv;   // torch.clamp(max=2): NaN stays NaN
      if (!(h_j > 0.f)) sv = 2.f; // a padded view slot
      s1 = nan_min(s1, nan_max(s0, sv));
      s0 = nan_min(s0, sv);
    }
    out[i] = (V == 1 || !(s1 < th_robust)) ? s0 : 0.5f * (s0 + s1);
  }
}

#define MV_PARAMS                                                              \
  const float *img, int Hp, int Wp, const float *size, const float *Hl,        \
      const float *Hm, const float *Tr, const float *Tn, const float *dm,      \
      int Hd, int Wd, const float *gterm, const float *depth,                  \
      const float *normal, const float *inv_nd, const float *bonus,            \
      const float *delta, const float *X0, const float *uv,                    \
      const float *f_blend, const float *d0, const float *goff, int T,         \
      const float *w, const float *wtm, const float *sum_w,                    \
      const float *norm_sq0, float *out, int V, int C, int H, int W, int P,    \
      float th_robust, float geom_weight, const unsigned char *band_act
#define MV_ARGS                                                                \
  img, Hp, Wp, size, Hl, Hm, Tr, Tn, dm, Hd, Wd, gterm, depth, normal, inv_nd, \
      bonus, delta, X0, uv, f_blend, d0, goff, T, w, wtm, sum_w, norm_sq0,     \
      out, V, C, H, W, P, th_robust, geom_weight, band_act

constexpr int MAX_DEVICES = 64;

template <bool NEAREST, int GEOM, bool BANDS>
cudaError_t launch(MV_PARAMS, int threads, size_t bytes, cudaStream_t s) {
  auto kern = pm_score_views<NEAREST, GEOM, BANDS>;
  // raise the dynamic shared-memory limit once per device and size, so a
  // launch captured into a CUDA graph makes no attribute call
  static size_t limit[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (bytes > 48 * 1024 && (dev >= MAX_DEVICES || limit[dev] < bytes)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) limit[dev] = bytes;
  }
  const unsigned blocks = (unsigned)((H * W + P - 1) / P);
  kern<<<blocks, threads, bytes, s>>>(MV_ARGS);
  return cudaGetLastError();
}

template <bool BANDS>
cudaError_t dispatch(MV_PARAMS, int nearest, int geom, int threads, size_t bytes,
                     cudaStream_t s) {
  if (nearest) {
    if (geom == GEOM_FUSED) return launch<true, GEOM_FUSED, BANDS>(MV_ARGS, threads, bytes, s);
    if (geom == GEOM_PRE) return launch<true, GEOM_PRE, BANDS>(MV_ARGS, threads, bytes, s);
    return launch<true, GEOM_NONE, BANDS>(MV_ARGS, threads, bytes, s);
  }
  if (geom == GEOM_FUSED) return launch<false, GEOM_FUSED, BANDS>(MV_ARGS, threads, bytes, s);
  if (geom == GEOM_PRE) return launch<false, GEOM_PRE, BANDS>(MV_ARGS, threads, bytes, s);
  return launch<false, GEOM_NONE, BANDS>(MV_ARGS, threads, bytes, s);
}

}  // namespace

extern "C" {

int pm_views_max_views() { return MAX_VIEWS; }

// Launch the multi-view scorer on `stream`: out (C, H, W) from V neighbour
// views. Stacks are contiguous float32 on the card: img (V, Hp, Wp), size
// (V, 2), Hl (V, 3, 3), Hm (V, 3); geom 1 (fused) also Tr (V, 3, 3), Tn
// (V, 3), dm (V, Hd, Wd) and uv (H, W, 2); geom 2 (precomputed) gterm
// (V, C, H, W). The candidate maps depth, inv_nd, bonus, delta are
// (C, H, W), normal (C, H, W, 3); X0 (H, W, 3), f_blend, d0, sum_w and
// norm_sq0 (H, W); goff (T, 3), w and wtm (T, H, W); band_act, if not null,
// ceil(H / 16) bytes, 0 for a skipped band of 16 rows. Unused pointers may
// be null. Returns the CUDA error of the launch (0 = success); does not
// synchronise.
int pm_score_views_launch(const float* img, int Hp, int Wp, const float* size,
                          const float* Hl, const float* Hm, const float* Tr,
                          const float* Tn, const float* dm, int Hd, int Wd,
                          const float* gterm, const float* depth,
                          const float* normal, const float* inv_nd,
                          const float* bonus, const float* delta,
                          const float* X0, const float* uv,
                          const float* f_blend, const float* d0,
                          const float* goff, int T, const float* w,
                          const float* wtm, const float* sum_w,
                          const float* norm_sq0, float* out, int V, int C,
                          int H, int W, float th_robust, float geom_weight,
                          int nearest, int geom, const unsigned char* band_act,
                          void* stream) {
  if (T < 1 || T > MAX_TEXELS || V < 1 || V > MAX_VIEWS || geom < 0 || geom > 2 ||
      (long long)Hp * Wp >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if ((long long)C * H * W == 0) return 0;
  // candidate groups per block: enough to cover C in few rounds, while a
  // block still holds a run of at least 32 pixels
  const int G = C >= 4 ? 4 : (C >= 2 ? 2 : 1);
  int P = THREADS / G;
  while (P > 32 && smem_bytes(V, T, P, P * G) > MAX_SMEM) P /= 2;
  const int threads = P * G;
  const size_t bytes = smem_bytes(V, T, P, threads);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      band_act ? dispatch<true>(MV_ARGS, nearest, geom, threads, bytes, s)
               : dispatch<false>(MV_ARGS, nearest, geom, threads, bytes, s);
  return (int)e;
}

}  // extern "C"
