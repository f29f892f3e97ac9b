// K1-v2: the PatchMatch scorer K1 with the neighbour image window staged in
// shared memory, for Hopper (sm_90a).
//
// Replaces, in the JAX package's dev timing script
// (scripts/dev_kernel_variants.py): score_view_v2 (:282, pallas_call at
// :324, body _texel_kernel_v2 :57), K1 with a dynamically anchored window
// of the neighbour image (r0/c0 from the tile's warp minimum, :104-108)
// held in fast memory.
//
// What it computes: exactly K1 (pm_score.cu, pm_score<NEAREST, false>),
// bit for bit. It is the same function with another memory path: every
// texel is warped as K1 warps it, op for op (pixel_warp, warp_texel below),
// and sampled and accumulated by the same pm_common.cuh code; nearest
// sampling rounds both axes half to even (not v2's fy < 0.5 row
// rule, :155), and no texel is invalidated for leaving the window (v2's
// out-of-window invalidation, :117/:120, is a VMEM artefact).
//
// Design: one block covers one candidate x an 8 x 32 pixel tile (256
// threads). Pass 1 warps every texel of the tile and reduces the bounding
// box of the image pixels the in-bounds texels read (warp shuffles, then
// shared atomics): v2's dynamic r0/c0 without the 8/128 alignment, and
// with the far edge too. If the box fits the budget (V2_WINDOW_FLOATS,
// 32 KB of dynamic shared memory, below the 48 KB default limit, so no
// cudaFuncSetAttribute), the block copies it from device memory into
// shared memory with coalesced row reads. Pass 2 warps the texels again
// (the same instructions, so the same coordinates) and reads each sample
// from the window where its footprint lies inside it, else through __ldg;
// a block whose box is over budget reads everything through __ldg. The
// optional in_window output marks the (candidate, pixel)s whose texels all
// came from the window.
//
// Bound: the same as K1 (fp32 issue in exact mode, bytes in nearest mode,
// about 65/49 us at C=11, 480x640, T=25 on an H100); the window costs one
// extra pass of warp arithmetic and replaces scattered L1/L2 reads of the
// image by shared-memory reads.
//
// Built like pm_score.cu (ops/_build.py).

#include <climits>

#include "pm_common.cuh"

#define V2_TILE_W 32
#define V2_TILE_H 8
#define V2_WINDOW_FLOATS 8192

namespace {

// Per-pixel terms of the warp that do not depend on the texel.
struct PixelWarp {
  float sx0, sy0, sz0;  // Hl @ X0
  float inv_d, ind;     // 1 / depth, 1 / (n . X0 * depth)
  float nx, ny, nz;     // candidate normal
};

__device__ __forceinline__ PixelWarp pixel_warp(const float* hl, float d, float ind,
                                                float nx, float ny, float nz,
                                                float xa, float xb, float xc) {
  PixelWarp pw;
  pw.sx0 = pm::row3(hl, xa, xb, xc);
  pw.sy0 = pm::row3(hl + 3, xa, xb, xc);
  pw.sz0 = pm::row3(hl + 6, xa, xb, xc);
  pw.inv_d = 1.f / d;
  pw.ind = ind;
  pw.nx = nx;
  pw.ny = ny;
  pw.nz = nz;
  return pw;
}

// Warp texel k (offset g = goff[k], sg = Hl @ goff[k]) through the
// candidate's plane into the neighbour view: pixel (px, py); the return
// value is the texel's in-bounds test (z > 1e-8, [1, w-2] x [1, h-2]).
__device__ __forceinline__ bool warp_texel(const PixelWarp& pw, const float* g,
                                           const float* sg, const float* hm,
                                           float h_j, float w_j, float& px,
                                           float& py) {
  const float n_goff = __fmaf_rn(pw.nz, g[2], __fmaf_rn(pw.ny, g[1], pw.nx * g[0]));
  const float scale = __fmaf_rn(n_goff, pw.ind, pw.inv_d);
  const float sx = __fmaf_rn(hm[0], scale, pw.sx0 + sg[0]);
  const float sy = __fmaf_rn(hm[1], scale, pw.sy0 + sg[1]);
  const float sz = __fmaf_rn(hm[2], scale, pw.sz0 + sg[2]);
  const bool zok = sz > 1e-8f;
  const float izs = zok ? 1.f / sz : 0.f;
  px = sx * izs;
  py = sy * izs;
  return zok && px >= 1.f && px <= w_j - 2.f && py >= 1.f && py <= h_j - 2.f;
}

template <bool NEAREST>
__global__ void __launch_bounds__(V2_TILE_W * V2_TILE_H)
pm_score_v2(const float* __restrict__ img, int Hp, int Wp,
            const float* __restrict__ size, const float* __restrict__ Hl,
            const float* __restrict__ Hm, const float* __restrict__ depth,
            const float* __restrict__ normal, const float* __restrict__ inv_nd,
            const float* __restrict__ X0, const float* __restrict__ goff, int T,
            const float* __restrict__ w, const float* __restrict__ wtm,
            const float* __restrict__ sum_w, const float* __restrict__ norm_sq0,
            float* __restrict__ score_out, uint8_t* __restrict__ in_window,
            int H, int W, float th_robust) {
  extern __shared__ float s_win[];
  __shared__ pm::ViewConsts vc;
  __shared__ float s_goff[MAX_TEXELS * 3];
  __shared__ float s_sg[MAX_TEXELS * 3];
  __shared__ int s_box[4];  // first/last column, first/last row read

  const int nthreads = V2_TILE_W * V2_TILE_H;
  const int tid = threadIdx.y * V2_TILE_W + threadIdx.x;
  if (tid == 0) {
    s_box[0] = INT_MAX;
    s_box[1] = INT_MIN;
    s_box[2] = INT_MAX;
    s_box[3] = INT_MIN;
    vc.h = size[0];
    vc.w = size[1];
    for (int k = 0; k < 9; ++k) vc.hl[k] = Hl[k];
    for (int k = 0; k < 3; ++k) vc.hm[k] = Hm[k];
  }
  for (int k = tid; k < 3 * T; k += nthreads) s_goff[k] = goff[k];
  __syncthreads();
  for (int k = tid; k < T; k += nthreads) {
    const float ga = s_goff[3 * k], gb = s_goff[3 * k + 1], gc = s_goff[3 * k + 2];
    for (int r = 0; r < 3; ++r) s_sg[3 * k + r] = pm::row3(vc.hl + 3 * r, ga, gb, gc);
  }
  __syncthreads();

  const int x = blockIdx.x * V2_TILE_W + threadIdx.x;
  const int y = blockIdx.y * V2_TILE_H + threadIdx.y;
  const bool live = x < W && y < H;
  const int HW = H * W;
  const int p = y * W + x;
  const long long i = (long long)blockIdx.z * HW + p;
  const float h_j = vc.h, w_j = vc.w;
  const int reach = NEAREST ? 0 : 1;  // footprint beyond the corner index

  // pass 1: the box of image pixels that the in-bounds texels read
  PixelWarp pw;
  int cx0 = INT_MAX, cx1 = INT_MIN, ry0 = INT_MAX, ry1 = INT_MIN;
  if (live) {
    pw = pixel_warp(vc.hl, depth[i], inv_nd[i], normal[3 * i], normal[3 * i + 1],
                    normal[3 * i + 2], X0[3 * p], X0[3 * p + 1], X0[3 * p + 2]);
    for (int k = 0; k < T; ++k) {
      float px, py;
      if (!warp_texel(pw, s_goff + 3 * k, s_sg + 3 * k, vc.hm, h_j, w_j, px, py))
        continue;
      int xi, yi;
      if (NEAREST) {
        pm::nearest_index(Hp, Wp, px, py, xi, yi);
      } else {
        float fx, fy;
        pm::bilinear_index(Hp, Wp, px, py, xi, yi, fx, fy);
      }
      cx0 = min(cx0, xi);
      cx1 = max(cx1, xi + reach);
      ry0 = min(ry0, yi);
      ry1 = max(ry1, yi + reach);
    }
  }
  cx0 = __reduce_min_sync(0xffffffffu, cx0);
  cx1 = __reduce_max_sync(0xffffffffu, cx1);
  ry0 = __reduce_min_sync(0xffffffffu, ry0);
  ry1 = __reduce_max_sync(0xffffffffu, ry1);
  if (threadIdx.x == 0) {
    atomicMin(&s_box[0], cx0);
    atomicMax(&s_box[1], cx1);
    atomicMin(&s_box[2], ry0);
    atomicMax(&s_box[3], ry1);
  }
  __syncthreads();
  const int c0 = s_box[0], c1 = s_box[1], r0 = s_box[2], r1 = s_box[3];
  const bool any = c0 <= c1 && r0 <= r1;
  const bool staged =
      any && (long long)(c1 - c0 + 1) * (r1 - r0 + 1) <= V2_WINDOW_FLOATS;
  const int ww = staged ? c1 - c0 + 1 : 0;
  if (staged) {
    const int n_win = ww * (r1 - r0 + 1);
    for (int k = tid; k < n_win; k += nthreads) {
      const int rr = k / ww;
      s_win[k] = __ldg(img + (size_t)(r0 + rr) * Wp + c0 + (k - rr * ww));
    }
  }
  __syncthreads();
  if (!live) return;

  // pass 2: K1's texel loop, each sample from the window where it lies inside
  float num = 0.f, ssum = 0.f, ssq = 0.f;
  bool inb = true, all_in = staged;
  for (int k = 0; k < T; ++k) {
    float px, py;
    inb = warp_texel(pw, s_goff + 3 * k, s_sg + 3 * k, vc.hm, h_j, w_j, px, py) && inb;
    float val;
    if (NEAREST) {
      int xi, yi;
      pm::nearest_index(Hp, Wp, px, py, xi, yi);
      const bool in = staged && xi >= c0 && xi <= c1 && yi >= r0 && yi <= r1;
      val = in ? s_win[(yi - r0) * ww + (xi - c0)] : __ldg(img + (size_t)yi * Wp + xi);
      all_in = all_in && in;
    } else {
      int xi, yi;
      float fx, fy;
      pm::bilinear_index(Hp, Wp, px, py, xi, yi, fx, fy);
      const bool in = staged && xi >= c0 && xi + 1 <= c1 && yi >= r0 && yi + 1 <= r1;
      float v00, v01, v10, v11;
      if (in) {
        const float* q = s_win + (yi - r0) * ww + (xi - c0);
        v00 = q[0];
        v01 = q[1];
        v10 = q[ww];
        v11 = q[ww + 1];
      } else {
        const float* q = img + (size_t)yi * Wp + xi;
        v00 = __ldg(q);
        v01 = __ldg(q + 1);
        v10 = __ldg(q + Wp);
        v11 = __ldg(q + Wp + 1);
      }
      val = pm::blend<true>(v00, v01, v10, v11, fx, fy);
      all_in = all_in && in;
    }
    const float wk = w[(size_t)k * HW + p];
    const float wtmk = wtm[(size_t)k * HW + p];
    num = __fmaf_rn(val, wtmk, num);
    ssum = __fmaf_rn(val, wk, ssum);
    ssq = __fmaf_rn(val * val, wk, ssq);
  }
  score_out[i] = pm::zncc_score(num, ssum, ssq, sum_w[p], norm_sq0[p], inb, th_robust);
  if (in_window != nullptr) in_window[i] = all_in ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch K1-v2 on `stream`, with the arguments and layouts of K1
// (pm_score_view with geom = 0). in_window, if not null, is a (C, H, W)
// uint8 output: 1 where all texels of the (candidate, pixel) were read from
// the staged window. Returns the CUDA error of the launch; does not
// synchronise.
int pm_score_view_v2(const float* img, int Hp, int Wp, const float* size,
                     const float* Hl, const float* Hm, const float* depth,
                     const float* normal, const float* inv_nd, const float* X0,
                     const float* goff, int T, const float* w, const float* wtm,
                     const float* sum_w, const float* norm_sq0, float* score,
                     uint8_t* in_window, int C, int H, int W, float th_robust,
                     int nearest, void* stream) {
  if (T > MAX_TEXELS || T < 1 || C > 65535) return (int)cudaErrorInvalidValue;
  if ((long long)C * H * W == 0) return 0;
  const dim3 block(V2_TILE_W, V2_TILE_H);
  const dim3 grid((W + V2_TILE_W - 1) / V2_TILE_W, (H + V2_TILE_H - 1) / V2_TILE_H, C);
  const size_t smem = V2_WINDOW_FLOATS * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
#define V2_ARGS img, Hp, Wp, size, Hl, Hm, depth, normal, inv_nd, X0, goff, T, w, \
    wtm, sum_w, norm_sq0, score, in_window, H, W, th_robust
  if (nearest) pm_score_v2<true><<<grid, block, smem, s>>>(V2_ARGS);
  else pm_score_v2<false><<<grid, block, smem, s>>>(V2_ARGS);
#undef V2_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
