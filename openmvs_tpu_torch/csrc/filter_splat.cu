// filter_splat: the cross-view depth filter for Hopper (sm_90a): each
// neighbour's depth map splatted into the reference view through a z-buffer,
// then the keep-or-drop decision per reference pixel.
//
// Replaces no TPU kernel: the JAX package filters on the host in NumPy
// (openmvs_tpu/ops/filters.py: project_depth_to_view, filter_depth_adjust,
// filter_depth_strict; FilterDepthMap, SceneDensify.cpp:1050-1302), as the
// port's host path does (openmvs_tpu_torch/ops/filters.py). On the card the
// host's splat left the device idle for most of a densify job; these kernels
// do the same work where the maps were estimated. They repeat the host's
// arithmetic op for op, so the filtered maps equal the host's bit for bit
// where NumPy's BLAS contracts as the `fused` flag says (the wrapper probes
// it, ops/filter_kernel.blas_fuses).
//
// filter_splat_kernel, one launch per (reference view, neighbour): a thread
// per source pixel with a depth > 0 projects it in float64 in the host's
// order of operations (K^-1 as numpy.linalg.inv gives it, camera to world,
// world to the reference camera, K, the divide; each 3x3 product the
// BLAS's chain over k, fused or not), keeps z > 0, floors the pixel and
// offers the float32 z to the 4 texels (0,0), (1,0), (0,1), (1,1) in the
// frame. A texel of the neighbour's layer of the z-buffer stack holds one
// 64-bit word: the z's bits above, and below them the complement of the key
// (offset << 30 | source pixel index); one atomicMin keeps the least z and,
// among equal z, the greatest key, the write NumPy's fancy assignment leaves
// last (offsets outer, source pixels in row-major order inner). The result
// does not depend on the order of the atomics. z > 0, so its bits order as
// the floats do; EMPTY (INT64_MAX) is above every z, inf included.
//
// filter_decide_kernel<ADJUST>, one launch per reference view: a thread per
// pixel reads the view's depth and confidence and its n_nb layers (a
// layer's winner confidence gathered from the neighbour's map by the key),
// and writes the new depth and confidence: ADJUST the confidence-weighted
// average in float64 in filter_depth_adjust's order of sums, else
// filter_depth_strict's counts with the 4-neighbour shifts. ADJUST resets
// each layer word it read to EMPTY, so the next view finds the stack clear;
// the strict mode reads its neighbours' words, so filter_clear_kernel clears
// the stack after it.
//
// Bound on an H100: bytes. A splat reads the source depths (4 B a pixel)
// and writes its layer (8 B a reference pixel, once, though atomics touch
// it up to 4 times a source pixel; a layer of 800x600 is 3.84 MB and lives
// in the 50 MB L2); about 60 float64 operations a valid source pixel
// (0.03 GFLOP a splat at 800x600) are far below 34 TFLOP/s. The decide reads
// the view's maps and its layers and writes 8 B a pixel. The design keeps
// the projection in registers (no intermediate arrays: the host makes 20 of
// them a splat) and the z-buffer in one 64-bit word, so one atomic pass
// replaces the host's min pass and its second pass for the confidences.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// into a shared library with a plain C interface, loaded through ctypes
// (ops/_build.py). Every multiply-add below is written as the intrinsic it
// must be, so the flag only guards against contraction elsewhere.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_NB = 12;  // _build.MAX_VIEWS: DenseOptions.max_views
constexpr unsigned long long EMPTY = 0x7fffffffffffffffULL;
constexpr unsigned KEY_BITS = 30;  // source pixel index below the offset
constexpr unsigned KEY_MASK = (1u << KEY_BITS) - 1u;

// the 3x3 matrices of one (source, reference) pair, row-major float64
struct Cams {
  double kinv[9];  // source K^-1
  double rs[9];    // source R (world to camera)
  double cs[3];    // source C
  double rr[9];    // reference R
  double cr[3];    // reference C
  double kr[9];    // reference K
};

static_assert(sizeof(Cams) == 42 * sizeof(double), "Cams: 42 float64, no padding");

struct NbConf {
  const float* conf[MAX_NB];  // each neighbour's confidence map
};

// one step of the BLAS's chain over k: acc + a * b, fused or rounded twice
__device__ __forceinline__ double madd(double a, double b, double acc, bool fused) {
  return fused ? __fma_rn(a, b, acc) : __dadd_rn(__dmul_rn(a, b), acc);
}

// (v @ M.T)[j] = sum_k v[k] M[j][k], k in order
__device__ __forceinline__ double row_t(const double* v, const double* m, int j, bool fused) {
  double acc = __dmul_rn(v[0], m[j * 3]);
  acc = madd(v[1], m[j * 3 + 1], acc, fused);
  return madd(v[2], m[j * 3 + 2], acc, fused);
}

// (v @ M)[j] = sum_k v[k] M[k][j], k in order
__device__ __forceinline__ double col(const double* v, const double* m, int j, bool fused) {
  double acc = __dmul_rn(v[0], m[j]);
  acc = madd(v[1], m[3 + j], acc, fused);
  return madd(v[2], m[6 + j], acc, fused);
}

__global__ void __launch_bounds__(THREADS)
filter_splat_kernel(const float* __restrict__ depth, int hs, int ws, Cams c,
                    unsigned long long* __restrict__ layer, int hr, int wr, bool fused) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= hs * ws) return;
  const float d32 = depth[i];
  if (!(d32 > 0.0f)) return;
  const int y = i / ws;
  const double d = (double)d32;
  // Camera.unproject: [x, y, 1] @ K^-1.T, times the depth, @ R + C
  const double uv1[3] = {(double)(i - y * ws), (double)y, 1.0};
  double cam[3], t[3], xc[3];
  for (int j = 0; j < 3; ++j) cam[j] = __dmul_rn(row_t(uv1, c.kinv, j, fused), d);
  // Camera.world_to_cam of the reference: (X - C) @ R.T
  for (int j = 0; j < 3; ++j) t[j] = __dsub_rn(__dadd_rn(col(cam, c.rs, j, fused), c.cs[j]),
                                               c.cr[j]);
  for (int j = 0; j < 3; ++j) xc[j] = row_t(t, c.rr, j, fused);
  const double z = xc[2];
  if (!(z > 0.0)) return;
  const double fx = floor(__ddiv_rn(row_t(xc, c.kr, 0, fused), z));
  const double fy = floor(__ddiv_rn(row_t(xc, c.kr, 1, fused), z));
  const unsigned long long zbits =
      (unsigned long long)__float_as_uint(__double2float_rn(z)) << 32;
  for (unsigned off = 0; off < 4; ++off) {
    // bounds in float64: NaN and values past int64 fall out as the host's do
    const double ax = fx + (double)(off & 1u), ay = fy + (double)(off >> 1);
    if (!(ax >= 0.0 && ax < (double)wr && ay >= 0.0 && ay < (double)hr)) continue;
    const unsigned key = (off << KEY_BITS) | (unsigned)i;
    atomicMin(layer + (long long)ay * wr + (long long)ax, zbits | (0xffffffffu - key));
  }
}

// the projected depth of a layer word: 0 where no depth landed or its z is
// not finite (the host's zbuf[~isfinite(zbuf)] = 0)
__device__ __forceinline__ float word_depth(unsigned long long v) {
  if (v == EMPTY) return 0.0f;
  const float z = __uint_as_float((unsigned)(v >> 32));
  return isfinite(z) ? z : 0.0f;
}

__device__ __forceinline__ float word_conf(unsigned long long v, const float* conf) {
  if (v == EMPTY) return 0.0f;
  return conf[(0xffffffffu - (unsigned)v) & KEY_MASK];
}

// _is_depth_similar in float32: |d0 - d1| < th * d0
__device__ __forceinline__ bool similar(float d0, float d1, float th) {
  return fabsf(__fsub_rn(d0, d1)) < __fmul_rn(th, d0);
}

template <bool ADJUST>
__global__ void __launch_bounds__(THREADS)
filter_decide_kernel(const float* __restrict__ depth_ref, const float* __restrict__ conf_ref,
                     unsigned long long* __restrict__ stack, NbConf nb, int n_nb, int h, int w,
                     float th_a, float th_b, int n_min_views, int n_min_adjust, double d_min,
                     double d_max, float* __restrict__ out) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int hw = h * w;
  if (p >= hw) return;
  const float dr = depth_ref[p], cr = conf_ref[p];
  const bool valid = dr > 0.0f;
  bool keep;
  float new_depth, new_conf;
  if (ADJUST) {
    // filter_depth_adjust: th_a the agreement threshold
    double pos = valid ? (double)cr : 0.0;
    double avg = __dmul_rn((double)dr, pos);
    double neg = 0.0;
    int n_pos = 0, n_seen = 0;
    // unrolled over MAX_NB, so each neighbour's pointer is read from the
    // launch's parameters and not from a copy on the stack
#pragma unroll
    for (int j = 0; j < MAX_NB; ++j) {
      if (j >= n_nb) break;
      unsigned long long* word = stack + (long long)j * hw + p;
      const unsigned long long v = *word;
      *word = EMPTY;
      const float dp = word_depth(v), cp = word_conf(v, nb.conf[j]);
      const bool has = dp > 0.0f;
      const bool agree = has && similar(dr, dp, th_a);
      n_seen += has;
      avg = __dadd_rn(avg, agree ? (double)__fmul_rn(dp, cp) : 0.0);
      pos = __dadd_rn(pos, agree ? (double)cp : 0.0);
      n_pos += agree;
      neg = __dadd_rn(neg, (has && !agree) ? (double)cp : 0.0);
    }
    // np.maximum(pos, 1e-12), NaN kept
    const double den = (pos != pos || pos > 1e-12) ? pos : 1e-12;
    const double a = __ddiv_rn(avg, den);
    keep = valid && n_seen >= n_min_views && n_pos >= n_min_adjust && pos > neg &&
           a >= d_min && a <= d_max;
    new_depth = __double2float_rn(a);
    new_conf = __double2float_rn(__dsub_rn(pos, neg));
  } else {
    // filter_depth_strict: th_a strict at the pixel, th_b loose at its 4
    // neighbours (x - 1, x + 1, y - 1, y + 1)
    const int y = p / w, x = p - y * w;
    int n_good = 0, n_seen = 0, n_good_d = 0, n_seen_d = 0;
    for (int j = 0; j < n_nb; ++j) {
      const unsigned long long* layer = stack + (long long)j * hw;
      const float dp = word_depth(layer[p]);
      const bool has = dp > 0.0f;
      n_seen += has;
      n_good += has && similar(dr, dp, th_a);
      const float shifted[4] = {x > 0 ? word_depth(layer[p - 1]) : 0.0f,
                                x < w - 1 ? word_depth(layer[p + 1]) : 0.0f,
                                y > 0 ? word_depth(layer[p - w]) : 0.0f,
                                y < h - 1 ? word_depth(layer[p + w]) : 0.0f};
      for (int k = 0; k < 4; ++k) {
        const bool hs = shifted[k] > 0.0f;
        n_seen_d += hs;
        n_good_d += hs && similar(dr, shifted[k], th_b);
      }
    }
    keep = valid && n_good >= n_min_views && n_good * 100 >= n_seen * 75 &&
           n_good_d >= n_min_views * 2 && n_good_d * 100 >= n_seen_d * 65;
    new_depth = dr;
    new_conf = cr;
  }
  out[p] = keep ? new_depth : 0.0f;
  out[hw + p] = keep ? new_conf : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
filter_clear_kernel(unsigned long long* __restrict__ stack, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) stack[i] = EMPTY;
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// The limit on neighbours a decide launch takes (DenseOptions.max_views).
int filter_max_neighbours() { return MAX_NB; }

// Launch on `stream`: splat the source depth (hs, ws) float32 into `layer`
// (hr, wr) 64-bit words, the cameras 42 float64 in Cams' order (host
// memory, copied into the launch). Returns the CUDA error of the launch
// (0 = success); does not synchronise.
int filter_splat_launch(const float* depth, int hs, int ws, const double* cams,
                        unsigned long long* layer, int hr, int wr, int fused, void* stream) {
  if (hs < 0 || ws < 0 || hr < 1 || wr < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)hs * ws;
  if (n >= (1LL << KEY_BITS) || (long long)hr * wr >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Cams c;
  memcpy(&c, cams, sizeof(Cams));
  filter_splat_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      depth, hs, ws, c, layer, hr, wr, fused != 0);
  return (int)cudaGetLastError();
}

// Launch on `stream`: the decision of one reference view (h, w) from its
// depth and confidence (float32) and the n_nb layers of `stack` (n_nb, h,
// w), `confs` the n_nb neighbours' confidence maps (host array of device
// pointers); out (2, h, w) float32, depth then confidence. adjust != 0:
// th_a the adjust threshold; else th_a strict, th_b loose. Returns the CUDA
// error of the launch; does not synchronise.
int filter_decide_launch(const float* depth_ref, const float* conf_ref,
                         unsigned long long* stack, const unsigned long long* confs,
                         int n_nb, int h, int w, int adjust, float th_a, float th_b,
                         int n_min_views, int n_min_adjust, double d_min, double d_max,
                         float* out, void* stream) {
  if (n_nb < 0 || n_nb > MAX_NB || h < 1 || w < 1 || (long long)h * w >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  NbConf nb;
  for (int j = 0; j < MAX_NB; ++j)
    nb.conf[j] = j < n_nb ? (const float*)confs[j] : nullptr;
  const unsigned blocks = blocks_for((long long)h * w);
  cudaStream_t s = (cudaStream_t)stream;
  if (adjust)
    filter_decide_kernel<true><<<blocks, THREADS, 0, s>>>(
        depth_ref, conf_ref, stack, nb, n_nb, h, w, th_a, th_b, n_min_views, n_min_adjust,
        d_min, d_max, out);
  else
    filter_decide_kernel<false><<<blocks, THREADS, 0, s>>>(
        depth_ref, conf_ref, stack, nb, n_nb, h, w, th_a, th_b, n_min_views, n_min_adjust,
        d_min, d_max, out);
  return (int)cudaGetLastError();
}

// Launch on `stream`: set n words of `stack` to EMPTY.
int filter_clear_launch(unsigned long long* stack, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  filter_clear_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(stack, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
