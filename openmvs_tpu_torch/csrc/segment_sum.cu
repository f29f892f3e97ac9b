// segment_sum: ordered segment sums for Hopper (sm_90a), the scatter-adds
// of mesh refinement's iteration.
//
// Replaces, in the JAX package's jitted refinement iteration _device_iter
// (openmvs_tpu/refine.py:531), the scatter-adds by face and by vertex
// (.at[].add at :510, :516, :523 and :621), which XLA's CPU backend adds
// row by row in the order of the rows. The card's index_add_ races atomics
// (another rounding each run), and torch.segment_reduce leaves its order to
// the library; this kernel fixes the order: each segment summed from 0.0f,
// row after row, in a stable sort of the rows by segment.
//
// What it computes: out (n, K) with
//   out[s, k] = (((0 + src[order[r0], k]) + src[order[r0 + 1], k]) + ...)
// over r in [offsets[s], offsets[s + 1]), for src (R, K), a row order
// `order` (R,) and segment offsets (n + 1,) into it (int64). The wrapper
// (ops/segment.py) builds them with a stable sort and searchsorted, which
// read nothing back to the host, so the sum can be captured in a CUDA graph.
//
// Design: one thread per (segment, column), a sequential loop over the
// segment's rows; neighbouring threads take the columns of one segment and
// then the next segment, so a row's K values are read together. Simple and
// right first: a warp waits for its longest segment.
//
// Bound on an H100: bytes, each summed row of src and its entry of order,
// the offsets and out moved once. Rows past offsets[n] (refinement's pixels
// with no face) are not read and not counted. chip_smoke.py computes it
// from each run's offsets.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// into a shared library with a plain C interface, loaded through ctypes
// (ops/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const long long* __restrict__ order,
                   const long long* __restrict__ offsets,
                   const float* __restrict__ src, float* __restrict__ out,
                   long long n_out, int K) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const long long s = i / K;
  const int k = (int)(i - s * K);
  const long long r1 = offsets[s + 1];
  float acc = 0.0f;
  for (long long r = offsets[s]; r < r1; ++r) acc = acc + src[order[r] * K + k];
  out[i] = acc;
}

}  // namespace

extern "C" {

// Launch on `stream`: out (n, K) from order (R,) and offsets (n + 1,), int64,
// and src (R, K) float32, contiguous on the card. Returns the CUDA error of
// the launch (0 = success); does not synchronise.
int segment_sum_launch(const long long* order, const long long* offsets,
                       const float* src, float* out, long long n, int K,
                       void* stream) {
  if (n < 0 || K < 1) return (int)cudaErrorInvalidValue;
  const long long n_out = n * K;
  if (n_out == 0) return 0;
  const long long blocks = (n_out + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      order, offsets, src, out, n_out, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
