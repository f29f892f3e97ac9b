// K1-v2: the PatchMatch scorer K1 with the tile's patch weights and a
// window of the neighbour image staged in shared memory by the Tensor
// Memory Accelerator (TMA), for Hopper (sm_90a).
//
// Replaces, in the JAX package's dev timing script
// (scripts/dev_kernel_variants.py): score_view_v2 (:282, pallas_call at
// :324, body _texel_kernel_v2 :57), K1 with a dynamically anchored window
// of the neighbour image (r0/c0 from the tile's warp minimum, :104-108)
// held in fast memory.
//
// What it computes: exactly K1 (pm_score.cu, pm_score<NEAREST, false>),
// bit for bit. Every texel is warped as K1 warps it, op for op, and sampled
// and accumulated by the same pm_common.cuh code in K1's texel order; nearest
// sampling rounds both axes half to even (not v2's fy < 0.5 row rule, :155),
// and no texel is invalidated for leaving the window (v2's out-of-window
// invalidation, :117/:120, is a VMEM artefact). The window changes where a
// sample is read, never its value.
//
// Design. A block owns an 8 x 32 pixel tile (256 threads, one pixel each;
// warp r is tile row r) and walks all C candidates.
// - Weights: the tile's w and wtm are a (T, 8, 32) box of each (T, H, W)
//   plane. One thread stages both with two 3-D TMA loads onto an mbarrier at
//   the start, so they leave device memory once per tile and not once per
//   candidate (K1 reads them C times).
// - Window: for each candidate the block warps the centre texel (T / 2) of
//   its pixels only, and the bounding box of the in-bounds warps centres a
//   fixed 32 x 64 window of the neighbour image (margins of about 12 to 16
//   pixels for the patch's reach; the window's first column is rounded to a
//   multiple of 4, as a TMA box must start 16-byte aligned in its innermost
//   dimension). One thread loads it with a 2-D TMA box into a
//   ring of two buffers: while the block scores candidate c, the load for
//   c + 1 is in flight. The block's one __syncthreads per candidate both
//   publishes the warp votes for c + 1 and frees the buffer that c - 1 read;
//   the consumers wait on the buffer's mbarrier, whose n-th use (candidate
//   c = 2n + buffer) completes phase n.
// - Sampling: each texel is warped once and sampled from the window, so the
//   texel loop holds no image read. Where a footprint leaves the window the
//   loop only notes it: if some texel also left the view, the score is
//   th_robust whatever the samples; otherwise (none on the dev script's
//   inputs or the synthetic scene; chip_smoke.py's phase variants spreads
//   the depths to reach it) the pixel's loop runs again with every sample
//   read from the image through __ldg, the same values. TMA fills elements
//   outside the image with zeros, but a footprint index is clamped into the
//   image, so no sample that counts reads one.
// - Instruction count (K1-mv's measures, pm_score_views.cu): goff and the
//   texel warps Hl @ goff are read as one float4 each, image offsets are
//   32-bit from an opaque base, the reciprocal is selected rather than
//   branched around, and Hl @ X0 is computed once per pixel, not once per
//   candidate. The texel loop is unrolled by 5 (T = 25 on the main path).
//   A first build that kept the __ldg fallback inside the loop, as a
//   predicated gather every texel issued, was 16-19% slower.
// The tensor maps are encoded on the host per call with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint so that
// the library needs no link against libcuda, and passed as
// __grid_constant__ parameters. TMA needs 16-byte-aligned row strides: the
// wrapper (ops/pm_kernel.py) passes the image and the weights with a row
// pitch that is a multiple of 4 floats, padding a copy where needed. Shared
// memory is 2 x 8 KB of window, 2 x T KB of weights and 32 B a texel of
// constants: 68 KB at T=25, so the launch raises the kernel's
// dynamic shared-memory limit once per device; T is at most 96.
//
// Bound: the same as K1 (fp32 operations, about 65/49 us in exact/nearest
// mode at C=11, 480x640, T=25 on an H100); the texel loop, like K1-mv's, is
// limited by instruction issue.
//
// Built like pm_score.cu (ops/_build.py).

#include <cuda.h>

#include <climits>

#include "pm_common.cuh"

#define V2_TILE_W 32
#define V2_TILE_H 8
#define V2_WIN_W 64
#define V2_WIN_H 32
#define V2_MAX_TEXELS 96

namespace {

constexpr int THREADS = V2_TILE_W * V2_TILE_H;
constexpr int WARPS = THREADS / 32;
constexpr int WIN_FLOATS = V2_WIN_W * V2_WIN_H;
constexpr uint32_t WIN_BYTES = WIN_FLOATS * sizeof(float);
constexpr size_t MAX_SMEM = 227 * 1024;
constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

// Byte offsets of the parts of dynamic shared memory from a 128-byte-aligned
// base: the two window buffers, the weights (T, 8, 32) of w and wtm, goff
// and Hl @ goff (T float4 each), the warp votes (2 slots x WARPS x 4 ints)
// and three mbarriers (window buffers 0 and 1, weights).
struct Layout {
  size_t win, w, wtm, g, sg, part, bars, bytes;
};

__host__ __device__ inline Layout layout(int T) {
  Layout L;
  L.win = 0;
  L.w = L.win + 2 * (size_t)WIN_BYTES;
  L.wtm = align128(L.w + (size_t)T * THREADS * sizeof(float));
  L.g = align128(L.wtm + (size_t)T * THREADS * sizeof(float));
  L.sg = align128(L.g + (size_t)T * sizeof(float4));
  L.part = align128(L.sg + (size_t)T * sizeof(float4));
  L.bars = align128(L.part + 2 * WARPS * 4 * sizeof(int));
  L.bytes = L.bars + 3 * sizeof(uint64_t) + 128;  // + slack to align the base
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1u) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of the given parity has completed. A load that never
// lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
        "r"(bar)
      : "memory");
}

// One candidate's operands at one pixel.
struct Cand {
  float d, ind, nx, ny, nz;
};

template <bool NEAREST>
__global__ void __launch_bounds__(THREADS)
pm_score_v2(const __grid_constant__ CUtensorMap img_map,
            const __grid_constant__ CUtensorMap w_map,
            const __grid_constant__ CUtensorMap wtm_map,
            const float* __restrict__ img, int Hp, int Wp, int pitch,
            const float* __restrict__ size, const float* __restrict__ Hl,
            const float* __restrict__ Hm, const float* __restrict__ depth,
            const float* __restrict__ normal, const float* __restrict__ inv_nd,
            const float* __restrict__ X0, const float* __restrict__ goff, int T,
            const float* __restrict__ sum_w, const float* __restrict__ norm_sq0,
            float* __restrict__ score_out, uint8_t* __restrict__ in_window,
            int C, int H, int W, float th_robust) {
  extern __shared__ unsigned char smem_raw[];
  const Layout L = layout(T);
  unsigned char* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  float* s_win = reinterpret_cast<float*>(base + L.win);  // 2 buffers
  const float* s_w = reinterpret_cast<const float*>(base + L.w);
  const float* s_wtm = reinterpret_cast<const float*>(base + L.wtm);
  float4* s_g = reinterpret_cast<float4*>(base + L.g);
  float4* s_sg = reinterpret_cast<float4*>(base + L.sg);
  int* s_part = reinterpret_cast<int*>(base + L.part);
  const uint32_t bar_win = smem_addr(base + L.bars);  // buffer b at + 8 b
  const uint32_t bar_w = bar_win + 16;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx0 = blockIdx.x * V2_TILE_W, ty0 = blockIdx.y * V2_TILE_H;
  const int x = tx0 + lane, y = ty0 + warp;
  const bool live = x < W && y < H;
  const int HW = H * W;
  const int p = y * W + x;

  if (tid == 0) {
    mbar_init(bar_win);
    mbar_init(bar_win + 8);
    mbar_init(bar_w);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const float h_j = __ldg(size), w_j = __ldg(size + 1);
  float hl[9];
  for (int k = 0; k < 9; ++k) hl[k] = __ldg(Hl + k);
  const float hm0 = __ldg(Hm), hm1 = __ldg(Hm + 1), hm2 = __ldg(Hm + 2);
  for (int k = tid; k < T; k += THREADS) {
    const float ga = __ldg(goff + 3 * k), gb = __ldg(goff + 3 * k + 1),
                gc = __ldg(goff + 3 * k + 2);
    s_g[k] = make_float4(ga, gb, gc, 0.f);
    s_sg[k] = make_float4(pm::row3(hl, ga, gb, gc), pm::row3(hl + 3, ga, gb, gc),
                          pm::row3(hl + 6, ga, gb, gc), 0.f);
  }
  __syncthreads();  // barriers initialised, texel constants staged
  if (tid == 0) {
    mbar_expect_tx(bar_w, 2u * T * THREADS * sizeof(float));
    tma_load_3d(smem_addr(s_w), &w_map, tx0, ty0, 0, bar_w);
    tma_load_3d(smem_addr(s_wtm), &wtm_map, tx0, ty0, 0, bar_w);
  }

  // per pixel, for all candidates
  float xa = 0.f, xb = 0.f, xc = 0.f, sw = 1.f, nsq0 = 0.f;
  if (live) {
    xa = X0[3 * p];
    xb = X0[3 * p + 1];
    xc = X0[3 * p + 2];
    sw = sum_w[p];
    nsq0 = norm_sq0[p];
  }
  const float sx0 = pm::row3(hl, xa, xb, xc);
  const float sy0 = pm::row3(hl + 3, xa, xb, xc);
  const float sz0 = pm::row3(hl + 6, xa, xb, xc);
  const float x_max = w_j - 2.f, y_max = h_j - 2.f;
  const float4 g_cen = s_g[T / 2], sg_cen = s_sg[T / 2];
  const float* im = pm::opaque(img);

  auto load = [&](int c) {
    Cand k = {1.f, 0.f, 0.f, 0.f, 0.f};
    if (live) {
      const int i = c * HW + p;
      k.d = depth[i];
      k.ind = inv_nd[i];
      k.nx = normal[3 * i];
      k.ny = normal[3 * i + 1];
      k.nz = normal[3 * i + 2];
    }
    return k;
  };
  // the tile's in-bounds centre-texel warps, reduced per warp into slot
  auto vote = [&](const Cand& k, int slot) {
    int vx0 = INT_MAX, vx1 = INT_MIN, vy0 = INT_MAX, vy1 = INT_MIN;
    if (live) {
      const float n_goff = __fmaf_rn(k.nz, g_cen.z, __fmaf_rn(k.ny, g_cen.y, k.nx * g_cen.x));
      const float scale = __fmaf_rn(n_goff, k.ind, 1.f / k.d);
      const float sx = __fmaf_rn(hm0, scale, sx0 + sg_cen.x);
      const float sy = __fmaf_rn(hm1, scale, sy0 + sg_cen.y);
      const float sz = __fmaf_rn(hm2, scale, sz0 + sg_cen.z);
      const bool zok = sz > 1e-8f;
      const float rz = 1.f / sz;
      const float izs = zok ? rz : 0.f;
      const float px = sx * izs, py = sy * izs;
      if (zok && px >= 1.f && px <= x_max && py >= 1.f && py <= y_max) {
        vx0 = vx1 = (int)floorf(px);
        vy0 = vy1 = (int)floorf(py);
      }
    }
    vx0 = __reduce_min_sync(0xffffffffu, vx0);
    vx1 = __reduce_max_sync(0xffffffffu, vx1);
    vy0 = __reduce_min_sync(0xffffffffu, vy0);
    vy1 = __reduce_max_sync(0xffffffffu, vy1);
    if (lane == 0) {
      int* q = s_part + (slot * WARPS + warp) * 4;
      q[0] = vx0;
      q[1] = vx1;
      q[2] = vy0;
      q[3] = vy1;
    }
  };
  // the window's origin from the votes in slot: the box of the voted
  // footprints, centred (any origin if no pixel voted)
  auto anchor = [&](int slot, int& ax, int& ay) {
    int vx0 = INT_MAX, vx1 = INT_MIN, vy0 = INT_MAX, vy1 = INT_MIN;
    if (lane < WARPS) {
      const int* q = s_part + (slot * WARPS + lane) * 4;
      vx0 = q[0];
      vx1 = q[1];
      vy0 = q[2];
      vy1 = q[3];
    }
    vx0 = __reduce_min_sync(0xffffffffu, vx0);
    vx1 = __reduce_max_sync(0xffffffffu, vx1);
    vy0 = __reduce_min_sync(0xffffffffu, vy0);
    vy1 = __reduce_max_sync(0xffffffffu, vy1);
    const int reach = NEAREST ? 0 : 1;  // footprint beyond the corner index
    // a TMA box starts on a 16-byte column (a load from any other column
    // faults): round the column to the nearest multiple of 4 floats
    ax = vx0 <= vx1 ? (((vx0 + vx1 + reach) >> 1) - V2_WIN_W / 2 + 2) & ~3 : 0;
    ay = vy0 <= vy1 ? ((vy0 + vy1 + reach) >> 1) - V2_WIN_H / 2 : 0;
  };
  auto load_window = [&](int b, int ax, int ay) {
    const uint32_t bar = bar_win + 8 * b;
    mbar_expect_tx(bar, WIN_BYTES);
    tma_load_2d(smem_addr(s_win + b * WIN_FLOATS), &img_map, ax, ay, bar);
  };

  Cand cur = load(0);
  vote(cur, 0);
  __syncthreads();
  int ax, ay;
  anchor(0, ax, ay);
  if (tid == 0) load_window(0, ax, ay);

  for (int c = 0; c < C; ++c) {
    const int b = c & 1;
    Cand nxt = cur;
    if (c + 1 < C) {
      nxt = load(c + 1);
      vote(nxt, b ^ 1);
    }
    // candidate c - 1 is done with buffer b ^ 1, and the votes for c + 1 are in
    __syncthreads();
    int nax = 0, nay = 0;
    if (c + 1 < C) {
      anchor(b ^ 1, nax, nay);
      if (tid == 0) load_window(b ^ 1, nax, nay);
    }
    if (c == 0) mbar_wait(bar_w, 0);
    mbar_wait(bar_win + 8 * b, (c >> 1) & 1);

    if (live) {
      const float* win = s_win + b * WIN_FLOATS;
      const float inv_d = 1.f / cur.d;
      // texel k through the candidate's plane into the neighbour view, op
      // for op as K1 (pm_score.cu); false where it leaves [1, w-2] x [1, h-2]
      auto warp_texel = [&](int k, float& px, float& py) {
        const float4 g = s_g[k];
        const float4 sg = s_sg[k];
        const float n_goff = __fmaf_rn(cur.nz, g.z, __fmaf_rn(cur.ny, g.y, cur.nx * g.x));
        const float scale = __fmaf_rn(n_goff, cur.ind, inv_d);
        const float sx = __fmaf_rn(hm0, scale, sx0 + sg.x);
        const float sy = __fmaf_rn(hm1, scale, sy0 + sg.y);
        const float sz = __fmaf_rn(hm2, scale, sz0 + sg.z);
        const bool zok = sz > 1e-8f;
        const float rz = 1.f / sz;
        const float izs = zok ? rz : 0.f;
        px = sx * izs;
        py = sy * izs;
        return zok && px >= 1.f && px <= x_max && py >= 1.f && py <= y_max;
      };
      // K1's texel loop, every sample read from the window. A footprint
      // outside it reads an arbitrary window element and clears all_in:
      // such a sum is used only where some texel left the view, which
      // scores th_robust whatever the samples, and is redone below
      // otherwise. No image read and no predicated gather stays in the loop.
      float num = 0.f, ssum = 0.f, ssq = 0.f;
      bool inb = true, all_in = true;
#pragma unroll 5
      for (int k = 0; k < T; ++k) {
        float px, py;
        inb = warp_texel(k, px, py) && inb;
        float val;
        if (NEAREST) {
          int xi, yi;
          pm::nearest_index(Hp, Wp, px, py, xi, yi);
          const unsigned lx = (unsigned)(xi - ax), ly = (unsigned)(yi - ay);
          const bool in = lx < (unsigned)V2_WIN_W && ly < (unsigned)V2_WIN_H;
          val = win[in ? ly * V2_WIN_W + lx : 0];
          all_in = all_in && in;
        } else {
          int xi, yi;
          float fx, fy;
          pm::bilinear_index(Hp, Wp, px, py, xi, yi, fx, fy);
          const unsigned lx = (unsigned)(xi - ax), ly = (unsigned)(yi - ay);
          const bool in = lx < (unsigned)(V2_WIN_W - 1) && ly < (unsigned)(V2_WIN_H - 1);
          const float* q = win + (in ? ly * V2_WIN_W + lx : 0);
          val = pm::blend<true>(q[0], q[1], q[V2_WIN_W], q[V2_WIN_W + 1], fx, fy);
          all_in = all_in && in;
        }
        const float wk = s_w[k * THREADS + tid];
        const float wtmk = s_wtm[k * THREADS + tid];
        num = __fmaf_rn(val, wtmk, num);
        ssum = __fmaf_rn(val, wk, ssum);
        ssq = __fmaf_rn(val * val, wk, ssq);
      }
      if (inb && !all_in) {
        // an in-bounds footprint outside the window: the same loop again,
        // every sample read from the image
        num = ssum = ssq = 0.f;
        for (int k = 0; k < T; ++k) {
          float px, py;
          warp_texel(k, px, py);
          float val;
          if (NEAREST) {
            int xi, yi;
            pm::nearest_index(Hp, Wp, px, py, xi, yi);
            val = __ldg(im + (yi * pitch + xi));
          } else {
            int xi, yi;
            float fx, fy;
            pm::bilinear_index(Hp, Wp, px, py, xi, yi, fx, fy);
            const float* q = im + (yi * pitch + xi);
            val = pm::blend<true>(__ldg(q), __ldg(q + 1), __ldg(q + pitch),
                                  __ldg(q + pitch + 1), fx, fy);
          }
          const float wk = s_w[k * THREADS + tid];
          const float wtmk = s_wtm[k * THREADS + tid];
          num = __fmaf_rn(val, wtmk, num);
          ssum = __fmaf_rn(val, wk, ssum);
          ssq = __fmaf_rn(val * val, wk, ssq);
        }
      }
      const int i = c * HW + p;
      score_out[i] = pm::zncc_score(num, ssum, ssq, sw, nsq0, inb, th_robust);
      if (in_window != nullptr) in_window[i] = all_in ? 1 : 0;
    }
    cur = nxt;
    ax = nax;
    ay = nay;
  }
}

// cuTensorMapEncodeTiled's signature (cuda.h)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, fetched through the runtime once.
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || f == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(f);
  }
  *fn = cached;
  return cudaSuccess;
}

// A float32 tensor map of the given rank (dims innermost first, byte
// strides of dims 1.., box in elements); 0, or minus the driver's error.
int encode(EncodeTiled fn, CUtensorMap* map, const float* base, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
                        const_cast<float*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

#define V2_PARAMS                                                                  \
  const CUtensorMap &img_map, const CUtensorMap &w_map, const CUtensorMap &wtm_map, \
      const float *img, int Hp, int Wp, int pitch, const float *size,             \
      const float *Hl, const float *Hm, const float *depth, const float *normal,   \
      const float *inv_nd, const float *X0, const float *goff, int T,              \
      const float *sum_w, const float *norm_sq0, float *score, uint8_t *in_window, \
      int C, int H, int W, float th_robust
#define V2_ARGS                                                                   \
  img_map, w_map, wtm_map, img, Hp, Wp, pitch, size, Hl, Hm, depth, normal,       \
      inv_nd, X0, goff, T, sum_w, norm_sq0, score, in_window, C, H, W, th_robust

template <bool NEAREST>
cudaError_t launch(V2_PARAMS, cudaStream_t s) {
  auto kern = pm_score_v2<NEAREST>;
  const size_t bytes = layout(T).bytes;
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
  const dim3 grid((W + V2_TILE_W - 1) / V2_TILE_W, (H + V2_TILE_H - 1) / V2_TILE_H);
  kern<<<grid, THREADS, bytes, s>>>(V2_ARGS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_v2_max_texels() { return V2_MAX_TEXELS; }

// Launch K1-v2 on `stream`, with the arguments and layouts of K1
// (pm_score_view with geom = 0), except that the image (Hp, Wp) and the
// weights w, wtm (T, H, W) are given with row pitches img_pitch and w_pitch
// (in floats, multiples of 4, 16-byte-aligned bases), as TMA needs.
// in_window, if not null, is a (C, H, W) uint8 output: 1 where all texels
// of the (candidate, pixel) were read from the staged window. Returns the
// CUDA error of the launch, or minus the driver's error where a tensor map
// could not be encoded; does not synchronise.
int pm_score_view_v2(const float* img, int Hp, int Wp, int img_pitch,
                     const float* size, const float* Hl, const float* Hm,
                     const float* depth, const float* normal, const float* inv_nd,
                     const float* X0, const float* goff, int T, const float* w,
                     const float* wtm, int w_pitch, const float* sum_w,
                     const float* norm_sq0, float* score, uint8_t* in_window,
                     int C, int H, int W, float th_robust, int nearest,
                     void* stream) {
  if (T < 1 || T > V2_MAX_TEXELS || C < 0 || Hp < 2 || Wp < 2 || img_pitch < Wp ||
      img_pitch % 4 != 0 || w_pitch < W || w_pitch % 4 != 0 ||
      (long long)C * H * W >= (1LL << 31) || (long long)Hp * img_pitch >= (1LL << 31) ||
      layout(T).bytes > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if ((long long)C * H * W == 0) return 0;
  EncodeTiled fn;
  const cudaError_t e = encoder(&fn);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap img_map, w_map, wtm_map;
  const cuuint64_t img_dims[2] = {(cuuint64_t)Wp, (cuuint64_t)Hp};
  const cuuint64_t img_strides[1] = {(cuuint64_t)img_pitch * sizeof(float)};
  const cuuint32_t img_box[2] = {V2_WIN_W, V2_WIN_H};
  const cuuint64_t w_dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)T};
  const cuuint64_t w_strides[2] = {(cuuint64_t)w_pitch * sizeof(float),
                                   (cuuint64_t)w_pitch * H * sizeof(float)};
  const cuuint32_t w_box[3] = {V2_TILE_W, V2_TILE_H, (cuuint32_t)T};
  int rc = encode(fn, &img_map, img, 2, img_dims, img_strides, img_box);
  if (rc == 0) rc = encode(fn, &w_map, w, 3, w_dims, w_strides, w_box);
  if (rc == 0) rc = encode(fn, &wtm_map, wtm, 3, w_dims, w_strides, w_box);
  if (rc != 0) return rc;
  const int pitch = img_pitch;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t le = nearest ? launch<true>(V2_ARGS, s) : launch<false>(V2_ARGS, s);
  return (int)le;
}

}  // extern "C"
