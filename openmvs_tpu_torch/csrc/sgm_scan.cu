// sgm_scan: B directional dynamic-programming passes of semi-global
// matching in one launch, for Hopper (sm_90a).
//
// Replaces, in the JAX package, the lax.scan of each directional pass that
// the jitted aggregate8 (openmvs_tpu/ops/sgm.py:519) and aggregate (:171)
// run: _dp_pass's step (:152-164) and _dp_pass_diag's (:500-512). XLA runs
// each scan as one compiled loop; the port's plain version,
// _scan_passes_plain (openmvs_tpu_torch/ops/sgm.py), is a Python loop of
// about nine launches a row or column.
//
// What it computes: for xs (B, N, M, D) and p2s (B, N, M), out (B, N, M, D)
// with out[:, 0] = xs[:, 0] and, for t >= 1, with Lp the carry of step
// t - 1 moved `shift` columns along M (the column moved in at BIG):
//   min_lp = min_d Lp
//   best   = min(Lp, min_lp + P2)
//   best   = min(best, min(Lp[d - 1], Lp[d + 1]) + p1)   (BIG out of range)
//   L      = C + best
//   out    = L - min_lp, or with `diag` min(L - min(min_lp, BIG / 2), BIG)
// op for op as the plain version rounds it: float adds and fminf, which is
// what torch.minimum and torch.clamp run on the card for values that are
// not NaN, in the same argument order. The build's -fmad=false keeps every
// add an add.
//
// Lines are independent. With shift = 0 a line is one (b, m), walked over
// t. With shift = 1 a line is a diagonal m - t = const: step t at column m
// reads the carry of column m - 1 at step t - 1, and a diagonal that enters
// at column 0 at step t0 > 0 starts from a carry of BIG. There are M + N - 1
// diagonals per b.
//
// Design: one warp per line. For D <= REG_D (256), lane l holds the carry
// of d = 32 j + l for j < K = ceil(D / 32) in registers (K <= 8); lanes past
// D hold BIG, which is the out-of-range neighbour of d = D - 1. The minimum
// over d is a butterfly of shuffles (min is exact, so its order does not
// matter); d - 1 and d + 1 come from shuffles of the same register and,
// across a 32-column boundary, of the neighbouring one. No shared memory,
// no barrier. Loads of a step's costs and P2 are issued one step ahead, so
// the carry's dependency chain does not wait on memory. Loads and stores
// of a step are coalesced: lane l touches d = 32 j + l.
//
// Above REG_D the carry is the row the warp wrote at the previous step: it
// lies in `out`, and __syncwarp() makes each lane's stores visible to the
// others. A step takes two passes over d in chunks of 32 lanes, one for
// the minimum of the carry and one for the new row, which reads the carry
// at d - 1, d and d + 1 back from `out` (BIG outside [0, D)). The adds and
// minima are the register path's, so both paths give the same bits; D is
// bounded by device memory only.
//
// Bound on an H100: bytes. Each pass reads xs and p2s once and writes out
// once: for aggregate8 at 480x640 with D = 64 and 8 passes over 2 images,
// about 1.3 GB, 0.39 ms at 3.35 TB/s; its operations (about 12 a cell) are
// far below the fp32 rate. chip_smoke.py computes the bound from each run's
// shapes. A line's steps are sequential: with too few lines (a short axis
// and a small batch) the card is latency-bound instead.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// into a shared library with a plain C interface, loaded through ctypes
// (ops/_build.py).

#include <cuda_runtime.h>

// the most disparities whose carry a warp keeps in registers
#define REG_D 256

namespace {

constexpr int WARPS = 4;  // lines per block
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e9f;  // the plain version's _BIG, exact in float32

template <int K, bool DIAG>
__global__ void __launch_bounds__(WARPS * 32)
sgm_scan_kernel(const float* __restrict__ xs, const float* __restrict__ p2s,
                float* __restrict__ out, int N, int M, int D, float p1,
                int shift, long long n_lines) {
  const int lane = threadIdx.x & 31;
  const long long line = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (line >= n_lines) return;  // the whole warp leaves together
  const int per_b = shift ? M + N - 1 : M;
  const long long b = line / per_b;
  const int q = (int)(line - b * per_b);
  // the line's first cell (t0, m0): a diagonal q has m - t = q - (N - 1)
  int t = 0, m = q;
  if (shift) {
    t = N - 1 - q > 0 ? N - 1 - q : 0;
    m = q - (N - 1) + t;
  }
  // offsets of cell (t, m): xs and out at row * D, p2s at row
  auto row_of = [&](int tt, int mm) { return (b * N + tt) * M + mm; };

  float lp[K];
  if (t == 0) {
    const long long base = row_of(0, m) * D;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int d = 32 * j + lane;
      lp[j] = BIG;
      if (d < D) {
        lp[j] = xs[base + d];
        out[base + d] = lp[j];
      }
    }
    t = 1;
    m += shift;
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) lp[j] = BIG;
  }
  if (t >= N || m >= M) return;

  // this step's costs and P2, loaded one step ahead
  float cx[K];
  float p2 = p2s[row_of(t, m)];
  {
    const long long base = row_of(t, m) * D;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int d = 32 * j + lane;
      cx[j] = d < D ? xs[base + d] : 0.f;
    }
  }
  for (;;) {
    const long long base = row_of(t, m) * D;
    const int t_next = t + 1, m_next = m + shift;
    const bool more = t_next < N && m_next < M;
    float cn[K];
    float p2n = 0.f;
    if (more) {
      const long long nbase = row_of(t_next, m_next) * D;
      p2n = p2s[row_of(t_next, m_next)];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int d = 32 * j + lane;
        cn[j] = d < D ? xs[nbase + d] : 0.f;
      }
    }

    // min over the D carried values (lanes past D excluded)
    float mn = __int_as_float(0x7f800000);  // +inf
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (32 * j + lane < D) mn = fminf(mn, lp[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));

    // each register rotated by one lane down (from lane - 1) and up (from
    // lane + 1): the d - 1 and d + 1 neighbours within a 32-column group
    float from_lo[K], from_hi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      from_lo[j] = __shfl_sync(FULL, lp[j], (lane + 31) & 31);
      from_hi[j] = __shfl_sync(FULL, lp[j], (lane + 1) & 31);
    }
    const float a = mn + p2;
    const float mn_half = fminf(mn, BIG * 0.5f);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int d = 32 * j + lane;
      float lo = from_lo[j], hi = from_hi[j];
      if (lane == 0) lo = j == 0 ? BIG : from_lo[j > 0 ? j - 1 : 0];
      if (lane == 31) hi = j == K - 1 ? BIG : from_hi[j < K - 1 ? j + 1 : j];
      float best = fminf(lp[j], a);
      best = fminf(best, fminf(lo, hi) + p1);
      const float L = cx[j] + best;
      const float o = DIAG ? fminf(L - mn_half, BIG) : L - mn;
      if (d < D) out[base + d] = o;
      lp[j] = d < D ? o : BIG;
    }
    if (!more) break;
    t = t_next;
    m = m_next;
    p2 = p2n;
#pragma unroll
    for (int j = 0; j < K; ++j) cx[j] = cn[j];
  }
}

// D > REG_D: the carry read back from `out` (see the design note above).
template <bool DIAG>
__global__ void __launch_bounds__(WARPS * 32)
sgm_scan_wide_kernel(const float* __restrict__ xs, const float* __restrict__ p2s,
                     float* out, int N, int M, int D, float p1, int shift,
                     long long n_lines) {
  const int lane = threadIdx.x & 31;
  const long long line = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (line >= n_lines) return;  // the whole warp leaves together
  const int per_b = shift ? M + N - 1 : M;
  const long long b = line / per_b;
  const int q = (int)(line - b * per_b);
  int t = 0, m = q;
  if (shift) {
    t = N - 1 - q > 0 ? N - 1 - q : 0;
    m = q - (N - 1) + t;
  }
  auto row_of = [&](int tt, int mm) { return (b * N + tt) * M + mm; };

  // the previous step's row, or null while the carry is BIG everywhere (a
  // diagonal entering at column 0 after step 0)
  const float* carry = nullptr;
  if (t == 0) {
    const long long base = row_of(0, m) * D;
    for (int d = lane; d < D; d += 32) out[base + d] = xs[base + d];
    carry = out + base;
    t = 1;
    m += shift;
  }
  for (; t < N && m < M; ++t, m += shift) {
    __syncwarp();  // the carry row's stores, made by every lane, are visible
    const long long base = row_of(t, m) * D;
    const float p2 = p2s[row_of(t, m)];
    float mn = BIG;  // the minimum of a carry that is BIG everywhere
    if (carry) {
      mn = __int_as_float(0x7f800000);  // +inf
      for (int d = lane; d < D; d += 32) mn = fminf(mn, carry[d]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
    }
    const float a = mn + p2;
    const float mn_half = fminf(mn, BIG * 0.5f);
    for (int d = lane; d < D; d += 32) {
      const float lp = carry ? carry[d] : BIG;
      const float lo = carry && d > 0 ? carry[d - 1] : BIG;
      const float hi = carry && d < D - 1 ? carry[d + 1] : BIG;
      float best = fminf(lp, a);
      best = fminf(best, fminf(lo, hi) + p1);
      const float L = xs[base + d] + best;
      out[base + d] = DIAG ? fminf(L - mn_half, BIG) : L - mn;
    }
    carry = out + base;
  }
}

template <bool DIAG>
cudaError_t launch(int K, dim3 grid, cudaStream_t s, const float* xs,
                   const float* p2s, float* out, int N, int M, int D, float p1,
                   int shift, long long n_lines) {
#define SCAN_CASE(k)                                                        \
  case k:                                                                   \
    sgm_scan_kernel<k, DIAG><<<grid, WARPS * 32, 0, s>>>(                   \
        xs, p2s, out, N, M, D, p1, shift, n_lines);                         \
    break;
  switch (K) {
    SCAN_CASE(1)
    SCAN_CASE(2)
    SCAN_CASE(3)
    SCAN_CASE(4)
    SCAN_CASE(5)
    SCAN_CASE(6)
    SCAN_CASE(7)
    SCAN_CASE(8)
    default:
      sgm_scan_wide_kernel<DIAG><<<grid, WARPS * 32, 0, s>>>(
          xs, p2s, out, N, M, D, p1, shift, n_lines);
  }
#undef SCAN_CASE
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sgm_scan_reg_d() { return REG_D; }

// Launch the B passes on `stream`: out (B, N, M, D) from xs (B, N, M, D) and
// p2s (B, N, M), contiguous float32 on the card, with D >= 1, shift 0 or 1
// and diag 0 or 1. Returns the CUDA error of the launch
// (0 = success); does not synchronise.
int sgm_scan_launch(const float* xs, const float* p2s, float* out, int B,
                    int N, int M, int D, float p1, int shift, int diag,
                    void* stream) {
  if (B < 0 || N < 0 || M < 0 || D < 1 || (shift != 0 && shift != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * N * M == 0) return 0;
  const long long n_lines = (long long)B * (shift ? (long long)M + N - 1 : M);
  const long long blocks = (n_lines + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const int K = D <= REG_D ? (D + 31) / 32 : 0;  // 0: the wide kernel
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      diag ? launch<true>(K, grid, s, xs, p2s, out, N, M, D, p1, shift, n_lines)
           : launch<false>(K, grid, s, xs, p2s, out, N, M, D, p1, shift, n_lines);
  return (int)err;
}

}  // extern "C"
