// K3-mv: the geometric terms of C candidate depth maps against all V
// neighbour views in one launch, for Hopper (sm_90a).
//
// Replaces, in the JAX package, V calls of
//   K3  geom_term_pallas  (openmvs_tpu/ops/pm_kernel.py:691, pallas_call at :742)
// that _geom_all_views (openmvs_tpu/ops/patchmatch.py:996) stacks into the
// (V, C, H, W) terms the split geometric sweep scores with. The port's
// per-view K3 (pm_score.cu, pm_geom_term) stays as the direct counterpart
// of geom_term_pallas, off the sweep.
//
// What it computes: out[j, c, p] = pm::geom_cons (pm_common.cuh) of the raw
// candidate depth depth[c, p] against view j, called exactly as the per-view
// K3 and K2-mv's fused term call it, so the three agree bit for bit and the
// geometric routes of the sweep give the same depth maps.
//
// Bound on an H100 at the split sweep's shape (C=11, V=4, 480x640): the raw
// depths in, the (V, C, H, W) terms out, X0, uv and the V depth maps once,
// about 79 MB, 0.024 ms at 3.35 TB/s; about 83 fp32 operations per
// (view, candidate, pixel), 0.017 ms at 67 TFLOP/s. So its bound is bytes
// (chip_smoke.py computes it from each run's shapes). In fact it runs at
// about 3.7x that bound and is limited by instruction issue: a term takes
// about 175 SASS instructions (the view loop of pm_geom_views<4> is about
// 700 for four terms, chip_smoke.py phase build), most of them the two IEEE
// reciprocals and two IEEE square roots with their range checks and slow
// paths, the bilinear index and its gather address, which the bit-equality
// with the plain version keeps. Branching out at each failed check, and
// selected reciprocals with 32-bit gather offsets, were no faster.
//
// Design. The per-view K3 runs one thread per (c, p): it pays a 64-bit
// i % HW and re-reads X0 and uv for every candidate, thread 0 of every block
// stages the constants alone behind a barrier, V launches read the
// candidate depths V times, and torch.stack copies the result once more.
// Here one launch writes the stack in place: a thread owns PIX = 4
// consecutive pixels of one candidate (the grid's y index) and loads their
// X0, uv and depths once as 16-byte loads, then walks the views in order,
// computing four independent terms per view and storing them as one 16-byte
// write. The per-view constants (V <= 12, 26 floats each) are staged once
// per block by all threads at once. Offsets into the stack are 32-bit (the
// launcher checks V * C * H * W < 2^31). Where H * W is not a multiple of 4
// or a pointer is not 16-byte aligned, a thread owns one pixel (PIX = 1).
// At C=11, 480x640 the grid is 300 x 11 blocks of 256 threads: about six
// waves of 132 SMs at four resident blocks each (56 registers a thread).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// into a shared library with a plain C interface, loaded through ctypes
// (ops/_build.py).

#include "pm_common.cuh"

#define MAX_VIEWS 12

namespace {

constexpr int THREADS = 256;
// per view: h, w, Tl (9), Tm (3), Tr (9), Tn (3)
constexpr int VC = 26;

template <int PIX>
__global__ void __launch_bounds__(THREADS)
pm_geom_views(const float* __restrict__ dms, int Hd, int Wd,
              const float* __restrict__ sizes, const float* __restrict__ Tl,
              const float* __restrict__ Tm, const float* __restrict__ Tr,
              const float* __restrict__ Tn, const float* __restrict__ depth,
              const float* __restrict__ X0, const float* __restrict__ uv,
              float* __restrict__ out, int V, int C, int HW) {
  __shared__ float s_vc[MAX_VIEWS * VC];
  for (int i = threadIdx.x; i < V * VC; i += blockDim.x) {
    const int j = i / VC, f = i - j * VC;
    float val;
    if (f < 2) val = sizes[2 * j + f];
    else if (f < 11) val = Tl[9 * j + f - 2];
    else if (f < 14) val = Tm[3 * j + f - 11];
    else if (f < 23) val = Tr[9 * j + f - 14];
    else val = Tn[3 * j + f - 23];
    s_vc[i] = val;
  }
  __syncthreads();

  const int p = (blockIdx.x * blockDim.x + threadIdx.x) * PIX;
  if (p >= HW) return;
  const int c = blockIdx.y;
  const int cp = c * HW + p;

  float d[PIX], x[3 * PIX], u[2 * PIX];
  if constexpr (PIX == 4) {
    const float4 dv = *reinterpret_cast<const float4*>(depth + cp);
    d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
    const float4* xq = reinterpret_cast<const float4*>(X0 + 3 * p);
    const float4* uq = reinterpret_cast<const float4*>(uv + 2 * p);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 a = __ldg(xq + k);
      x[4 * k] = a.x; x[4 * k + 1] = a.y; x[4 * k + 2] = a.z; x[4 * k + 3] = a.w;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float4 a = __ldg(uq + k);
      u[4 * k] = a.x; u[4 * k + 1] = a.y; u[4 * k + 2] = a.z; u[4 * k + 3] = a.w;
    }
  } else {
    d[0] = depth[cp];
    for (int k = 0; k < 3; ++k) x[k] = X0[3 * p + k];
    for (int k = 0; k < 2; ++k) u[k] = uv[2 * p + k];
  }

  for (int j = 0; j < V; ++j) {
    const float* g = s_vc + j * VC;
    const float* dm = dms + (size_t)j * Hd * Wd;
    float r[PIX];
#pragma unroll
    for (int q = 0; q < PIX; ++q)
      r[q] = pm::geom_cons(g + 2, g + 11, g + 14, g + 23, g[0], g[1], dm, Hd, Wd,
                           d[q], x[3 * q], x[3 * q + 1], x[3 * q + 2], u[2 * q],
                           u[2 * q + 1]);
    float* o = out + (j * C * HW + cp);
    if constexpr (PIX == 4) *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
    else o[0] = r[0];
  }
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

extern "C" {

int pm_geom_views_max_views() { return MAX_VIEWS; }

// Launch K3-mv on `stream`: out (V, C, H, W) from the raw candidate depths
// depth (C, H, W), X0 (H, W, 3), uv (H, W, 2), the neighbour depth maps
// dms (V, Hd, Wd) and their constants sizes (V, 2), Tl and Tr (V, 3, 3),
// Tm and Tn (V, 3): contiguous float32 on the card. Returns the CUDA error
// of the launch (0 = success); does not synchronise.
int pm_geom_views_launch(const float* dms, int Hd, int Wd, const float* sizes,
                         const float* Tl, const float* Tm, const float* Tr,
                         const float* Tn, const float* depth, const float* X0,
                         const float* uv, float* out, int V, int C, int H, int W,
                         void* stream) {
  const long long HW = (long long)H * W;
  if (V < 1 || V > MAX_VIEWS || C > 65535 || (long long)V * C * HW >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (C * HW == 0) return 0;
  const bool vec = HW % 4 == 0 && aligned16(depth) && aligned16(X0) &&
                   aligned16(uv) && aligned16(out);
  const int pix = vec ? 4 : 1;
  const long long groups = (HW + pix - 1) / pix;
  const dim3 grid((unsigned)((groups + THREADS - 1) / THREADS), (unsigned)C);
  cudaStream_t s = (cudaStream_t)stream;
#define GV_ARGS dms, Hd, Wd, sizes, Tl, Tm, Tr, Tn, depth, X0, uv, out, V, C, (int)HW
  if (vec) pm_geom_views<4><<<grid, THREADS, 0, s>>>(GV_ARGS);
  else pm_geom_views<1><<<grid, THREADS, 0, s>>>(GV_ARGS);
#undef GV_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
