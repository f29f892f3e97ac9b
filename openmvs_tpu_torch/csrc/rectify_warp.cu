// rectify_warp: the bilinear perspective warp of SGM's pair rectification
// for Hopper (sm_90a), both images of a pair in one launch.
//
// Replaces no TPU kernel: the JAX package rectifies on the host with
// cv2.warpPerspective (openmvs_tpu/ops/sgm.py:269-270), and the port's host
// path with io/images.warp_perspective, OpenCV 5's x86 warp rebuilt bit for
// bit in NumPy. On the card that host warp left the device idle for a fifth
// of a second a pair, 72 pairs a dtu-sgm job; this kernel does the same
// work where the pair is matched, and repeats the host's arithmetic step
// for step, so its images equal warp_perspective's on every pixel:
//
//   - the inverse homography as io/images._invert3 forms it, rounded to
//     float32 on the host (9 floats an image, copied into the launch);
//   - destination pixel (x, y) samples the source at (X / w, Y / w), each
//     of X, Y, w the float32 form of its row (c0, c1, c2) of the inverse:
//     fma32(x, c0, y c1 + c2) in OpenCV's vector loop, x < W - W mod 16,
//     fma32(x, c0, y c1) + c2 in its scalar tail past it;
//   - fma32(a, b, c) as images._fma32 computes it: the float64 product
//     (exact for float32 inputs), plus c in float64, rounded to float32.
//     Two roundings, so not fmaf;
//   - IEEE float32 divisions; a non-finite coordinate, or one of 2**30 or
//     more in magnitude, is sent to -4 (outside the image);
//   - the floor, the fractions a and b, the four texels (0 outside the
//     image), two horizontal lerps v0 + a (v1 - v0) and a vertical one, each
//     an fma32.
//
// Every step is written as the intrinsic it must be (__fmul_rn, __fadd_rn,
// __dmul_rn, __dadd_rn, __fdiv_rn, __double2float_rn), so no contraction or
// fast division can move a bit whatever the flags.
//
// Bound on an H100: bytes. A pair at 800x600 reads two float32 sources
// (3.84 MB) and writes two float32 images (3.84 MB): 7.68 MB, 2.3 us at
// 3.35 TB/s. The arithmetic (12 float64 and about 20 float32 operations a
// pixel, 0.96 M pixels) is far below the float64 peak. Design: a thread per
// destination pixel, a block a 32x8 tile of one image (blockIdx.z picks the
// image), so a warp stores 128 contiguous bytes and the block's source
// texels, a near-identity footprint for a rectification, are reused in L1;
// sources are read through the read-only path (__ldg). The launch and the
// copies around it, not the kernel, dominate the step.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// into a shared library with a plain C interface, loaded through ctypes
// (ops/_build.py).

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr float LIMIT = 1073741824.0f;  // 2**30
constexpr float AWAY = -4.0f;           // where OpenCV sends a bad coordinate

// the float32 inverse homographies of the pair, row-major
struct Inverses {
  float a[9];
  float b[9];
};

static_assert(sizeof(Inverses) == 18 * sizeof(float), "Inverses: 18 float32, no padding");

// a * b + c as images._fma32: the float64 sum of the exact product and c,
// rounded to float32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// one row (c0, c1, c2) of the inverse at (x, y), in the vector loop's form or
// the scalar tail's
__device__ __forceinline__ float coord(float x, float y, float c0, float c1, float c2,
                                       bool tail) {
  return tail ? __fadd_rn(fma32(x, c0, __fmul_rn(y, c1)), c2)
              : fma32(x, c0, __fadd_rn(__fmul_rn(y, c1), c2));
}

__device__ __forceinline__ float texel(const float* __restrict__ src, int h, int w, int y,
                                       int x) {
  return (x >= 0 && x < w && y >= 0 && y < h) ? __ldg(src + (long long)y * w + x) : 0.0f;
}

__global__ void __launch_bounds__(BX * BY)
    rectify_warp_kernel(const float* __restrict__ src_a, int ha, int wa,
                        const float* __restrict__ src_b, int hb, int wb, Inverses inv,
                        float* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  const bool second = blockIdx.z != 0;
  const float* src = second ? src_b : src_a;
  const int h = second ? hb : ha;
  const int w = second ? wb : wa;
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = second ? inv.b[i] : inv.a[i];

  const float xf = (float)x, yf = (float)y;
  const bool tail = x >= W - W % 16;
  const float wz = coord(xf, yf, m[6], m[7], m[8], tail);
  float sx = __fdiv_rn(coord(xf, yf, m[0], m[1], m[2], tail), wz);
  float sy = __fdiv_rn(coord(xf, yf, m[3], m[4], m[5], tail), wz);
  if (!(isfinite(sx) && isfinite(sy) && fabsf(sx) < LIMIT && fabsf(sy) < LIMIT)) {
    sx = AWAY;
    sy = AWAY;
  }
  const float x0f = floorf(sx), y0f = floorf(sy);
  const float a = __fsub_rn(sx, x0f), b = __fsub_rn(sy, y0f);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float p00 = texel(src, h, w, y0, x0), p01 = texel(src, h, w, y0, x0 + 1);
  const float p10 = texel(src, h, w, y0 + 1, x0), p11 = texel(src, h, w, y0 + 1, x0 + 1);
  const float v0 = fma32(a, __fsub_rn(p01, p00), p00);
  const float v1 = fma32(a, __fsub_rn(p11, p10), p10);
  out[((long long)blockIdx.z * H + y) * W + x] = fma32(b, __fsub_rn(v1, v0), v0);
}

}  // namespace

extern "C" {

// Launch on `stream`: src_a (ha, wa) warped through the inverse
// homography inverses[0:9] into out[0] (H, W), src_b (hb, wb) through
// inverses[9:18] into out[1]; float32 throughout, the inverses in host
// memory (copied into the launch). Returns the CUDA error of the launch
// (0 = success); does not synchronise.
int rectify_warp_launch(const float* src_a, int ha, int wa, const float* src_b, int hb,
                        int wb, const float* inverses, float* out, int H, int W,
                        void* stream) {
  if (ha < 0 || wa < 0 || hb < 0 || wb < 0 || H < 0 || W < 0 ||
      (long long)ha * wa >= (1LL << 31) || (long long)hb * wb >= (1LL << 31) ||
      (long long)H * W >= (1LL << 30) || (H + BY - 1) / BY > 65535)
    return (int)cudaErrorInvalidValue;
  if ((long long)H * W == 0) return 0;
  Inverses inv;
  memcpy(&inv, inverses, sizeof(Inverses));
  const dim3 block(BX, BY);
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, 2);
  rectify_warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(src_a, ha, wa, src_b, hb, wb,
                                                                 inv, out, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
