// wzncc_volume: the masked bilateral-weighted ZNCC cost volumes of B
// rectified pairs in one launch, for Hopper (sm_90a).
//
// Replaces, in the JAX package, the jitted _wzncc_volume0
// (openmvs_tpu/ops/sgm.py:335-377, which evaluates wzncc_weights at :303
// inside it) followed by the jitted mask_volume (:464). The port's plain
// version, mask_volume(_wzncc_volumes(...)) in openmvs_tpu_torch/ops/sgm.py,
// is a Python loop of 3 sums x 49 texels of element-wise launches per chunk
// of disparities.
//
// What it computes: out (B, H, W, D) uint8 from the left images' weights w
// and tw (T, B, H, W), sum_w and norm_sq0 (B, H, W) (wzncc_weights), the
// unshifted right images (B, H, W), d_mins (B,) and, optionally, the
// per-pixel windows lo and hi (B, H, W) int16. For pixel (b, y, x) and
// disparity index i, texel k = (dy, dx) of the (2 half_y + 1) x
// (2 half_x + 1) window reads
//   t_k = right[b, y + dy, c + d_min]   with c = x + dx + i,
// and 0 unless 0 <= y + dy < H, 0 <= c < W and 0 <= c + d_min < W (the
// plain version's zero-filled shift followed by zero padding). Then
//   s = sum w_k t_k,  sq = sum (w_k t_k) t_k,  nom = sum tw_k t_k,
// each summed as XLA's CPU backend reduces a stacked axis of T <= 64 terms:
// the first k_split terms in order from the first term, the rest likewise,
// then the two partial sums added (k_split = T for T <= 32; 25 of 49);
//   norm_sq1 = sq - (s s) / sum_w                 (IEEE division)
//   v        = max(fma(norm_sq0, norm_sq1, 1e-3), 1e-12)
//   ncc      = nom * (float)(1 / sqrt((double)v))
//   cost     = 255 if ncc <= 0, else rint((1 - min(ncc, 1)) 255)
// with fma in float64 rounded once to float32, as utils/fmath.py computes
// it, and cost 255 where x + i + d_min leaves [0, W) or, with lo and hi,
// where i + d_min leaves [lo, hi). Every step is the plain version's
// operation in its order; the build's -fmad=false keeps each multiply and
// add apart, so the card equals the CPU to the bit.
//
// Design: one warp per pixel, lane = disparity. A lane handles NC
// disparities i0 + lane + 32 c (c < NC) per pass over the window, so the
// pixel's weights, brought to every lane by shuffles from the two registers
// that hold them (lane k and k - 32 load w_k and tw_k), serve NC
// disparities. A texel's reads across the warp are 32 consecutive floats
// of one right-image row; the warps of a block are neighbouring pixels of
// a row, whose windows overlap, so most reads hit L1. A pass stores 32
// consecutive bytes per c.
//
// Bound on an H100: operations. Per (pixel, disparity) 6 fp32 operations a
// texel (three products, three adds), about 8 in the epilogue, and the
// float64 fma, division and square root; at (2, 480, 640) with D = 64 some
// 11.6 GFLOP of fp32, 0.17 ms at 67 TFLOP/s, against 0.07 ms for the bytes
// (w and tw dominate). chip_smoke.py computes the bound from each run's
// shapes. The shuffles and the texel index arithmetic are not counted: the
// kernel issues more instructions than the bound counts.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// into a shared library with a plain C interface, loaded through ctypes
// (ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TEXELS 64  // a pixel's weights fit two registers of each lane

namespace {

constexpr int WARPS = 8;  // pixels per block
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* w;         // (T, B, H, W)
  const float* tw;        // (T, B, H, W)
  const float* sum_w;     // (B, H, W)
  const float* norm_sq0;  // (B, H, W)
  const float* right;     // (B, H, W), unshifted
  const int* d_mins;      // (B,)
  const int16_t* lo;      // (B, H, W) or null
  const int16_t* hi;      // (B, H, W) or null
  uint8_t* out;           // (B, H, W, D)
  int B, H, W, D, half_x, half_y, T, k_split;
};

template <int NC>
__global__ void __launch_bounds__(WARPS * 32)
wzncc_volume_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const long long plane = (long long)p.B * p.H * p.W;
  const long long pix = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pix >= plane) return;  // the whole warp leaves together
  const int hw = p.H * p.W;
  const int b = (int)(pix / hw);
  const int rem = (int)(pix - (long long)b * hw);
  const int y = rem / p.W;
  const int x = rem - y * p.W;

  // the pixel's weights: lane k holds w_k and tw_k in *_a, lane k - 32 in *_b
  const float w_a = lane < p.T ? p.w[lane * plane + pix] : 0.f;
  const float w_b = lane + 32 < p.T ? p.w[(lane + 32) * plane + pix] : 0.f;
  const float tw_a = lane < p.T ? p.tw[lane * plane + pix] : 0.f;
  const float tw_b = lane + 32 < p.T ? p.tw[(lane + 32) * plane + pix] : 0.f;
  const float sum_w = p.sum_w[pix];
  const float norm_sq0 = p.norm_sq0[pix];
  const int d_min = p.d_mins[b];
  const bool masked = p.lo != nullptr;
  const int lo = masked ? (int)p.lo[pix] : 0;
  const int hi = masked ? (int)p.hi[pix] : 0;
  const float* img = p.right + (long long)b * hw;
  const double eps = (double)1e-3f;

  for (int i0 = 0; i0 < p.D; i0 += 32 * NC) {
    // the partial sums being added (s, sq, nom) and the first one, kept
    float s[NC], sq[NC], nom[NC], s0[NC], sq0[NC], nom0[NC];
    int k = 0;
    for (int dy = -p.half_y; dy <= p.half_y; ++dy) {
      const int yy = y + dy;
      const bool row_in = yy >= 0 && yy < p.H;
      const float* row = img + (long long)(row_in ? yy : 0) * p.W;
      for (int dx = -p.half_x; dx <= p.half_x; ++dx, ++k) {
        const float wk = __shfl_sync(FULL, k < 32 ? w_a : w_b, k & 31);
        const float twk = __shfl_sync(FULL, k < 32 ? tw_a : tw_b, k & 31);
        if (k == p.k_split) {  // the second partial sum starts
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            s0[c] = s[c];
            sq0[c] = sq[c];
            nom0[c] = nom[c];
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = x + dx + i0 + 32 * c + lane;
          const int src = col + d_min;
          const float t = row_in && col >= 0 && col < p.W && src >= 0 && src < p.W
                              ? row[src] : 0.f;
          const float wt = wk * t;
          const float wtt = wt * t;
          const float twt = twk * t;
          if (k == 0 || k == p.k_split) {
            s[c] = wt;
            sq[c] = wtt;
            nom[c] = twt;
          } else {
            s[c] = s[c] + wt;
            sq[c] = sq[c] + wtt;
            nom[c] = nom[c] + twt;
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = i0 + 32 * c + lane;
      if (i >= p.D) continue;
      float S = s[c], SQ = sq[c], NOM = nom[c];
      if (p.k_split < p.T) {
        S = s0[c] + S;
        SQ = sq0[c] + SQ;
        NOM = nom0[c] + NOM;
      }
      const float norm_sq1 = SQ - (S * S) / sum_w;
      float v = (float)((double)norm_sq0 * (double)norm_sq1 + eps);
      v = fmaxf(v, 1e-12f);
      const float ncc = NOM * (float)(1.0 / sqrt((double)v));
      float cost = ncc <= 0.f ? 255.f : rintf((1.f - fminf(ncc, 1.f)) * 255.f);
      const int d = i + d_min;
      if (x + d < 0 || x + d >= p.W) cost = 255.f;
      if (masked && !(d >= lo && d < hi)) cost = 255.f;
      p.out[pix * p.D + i] = (uint8_t)cost;
    }
  }
}

}  // namespace

extern "C" {

int wzncc_volume_max_texels() { return MAX_TEXELS; }

// Launch on `stream`: out (B, H, W, D) uint8 from w, tw (T, B, H, W),
// sum_w, norm_sq0, right (B, H, W) float32, d_mins (B,) int32 and lo, hi
// (B, H, W) int16 (both null: no window), all contiguous on the card, with
// T = (2 half_x + 1)(2 half_y + 1) <= MAX_TEXELS and k_split the terms of
// the first partial sum. Returns the CUDA error of the launch (0 =
// success); does not synchronise.
int wzncc_volume_launch(const float* w, const float* tw, const float* sum_w,
                        const float* norm_sq0, const float* right,
                        const int* d_mins, const int16_t* lo, const int16_t* hi,
                        uint8_t* out, int B, int H, int W, int D, int half_x,
                        int half_y, int k_split, void* stream) {
  const int T = (2 * half_x + 1) * (2 * half_y + 1);
  if (B < 0 || H < 0 || W < 0 || D < 1 || half_x < 0 || half_y < 0 ||
      T > MAX_TEXELS || k_split < 1 || k_split > T || ((lo == nullptr) != (hi == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W;
  if (n == 0) return 0;
  const long long blocks = (n + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Params p{w, tw, sum_w, norm_sq0, right, d_mins, lo, hi, out,
                 B, H, W, D, half_x, half_y, T, k_split};
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks);
  const int chunks = (D + 31) / 32;
  if (chunks >= 4)
    wzncc_volume_kernel<4><<<grid, WARPS * 32, 0, s>>>(p);
  else if (chunks >= 2)
    wzncc_volume_kernel<2><<<grid, WARPS * 32, 0, s>>>(p);
  else
    wzncc_volume_kernel<1><<<grid, WARPS * 32, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
