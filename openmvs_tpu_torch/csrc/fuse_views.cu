// fuse_views: the greedy claim-based fusion of depth maps into one point
// cloud for Hopper (sm_90a), each reference view a handful of launches.
//
// Replaces no TPU kernel: the JAX package fuses on the host in NumPy
// (openmvs_tpu/ops/fusion.py fuse_depth_maps; FuseDepthMaps,
// SceneDensify.cpp:1372-1646), as the port's host path does
// (openmvs_tpu_torch/ops/fusion.py). On the card that host loop left the
// device idle for about a third of a densify job; these kernels do the same
// work where the maps were estimated and filtered. They repeat the host's
// arithmetic op for op, so the cloud (points, colours, normals, each point's
// views and weights, in the host's order) equals the host's bit for bit:
//
//   - the views in the host's order (ops/fusion_kernel.py sorts them); a
//     reference view's candidates are its valid, unowned pixels, and a
//     candidate's index is its linear pixel index, so the host's scan
//     order is the order of the indices;
//   - a candidate unprojected, and projected into each neighbour, in
//     float64 as Camera.unproject and Camera.project_h do it: each 3x3
//     product the BLAS's chain over k, fused or not as the host's BLAS
//     rounds (the `fused` mode bit, ops/filter_kernel.blas_fuses), the
//     perspective divide, np.round's half to even (rint), the inside,
//     depth-agreement and free tests, the normals as normal @ R and their
//     dot in np.einsum's order of sums (the dot-order bits,
//     ops/fusion_kernel.sum_orders);
//   - a neighbour texel goes to the least agreeing candidate index (an
//     atomicMin into the neighbour's claim layer): np.unique's first
//     occurrence in scan order;
//   - each candidate's fusion weight (conf2weight: 1 - conf and the floor
//     in float32, the products and the reciprocal in float64), its point,
//     normal and colour accumulated in the host's order: its own term,
//     then each neighbour it won, in neighbour order;
//   - the min_views_fuse test; the conflicts (a free neighbour depth behind
//     the candidate on a texel no candidate claimed) of kept candidates
//     zeroed; ownership: the point index for kept candidates and the
//     texels they won, CONSUMED for dropped candidates;
//   - emission: float32 points (the sums times 1 / the weight), colours
//     clipped to [0, 255] and truncated to uint8, normals divided by
//     np.linalg.norm's root (the norm-order bits) or 1e-12, and each
//     point's (view id, float32 weight) members in order, at the point's
//     offset.
//
// Launches per reference view (a thread per reference pixel; blockIdx.y
// the neighbour in the claim): fuse_claim_kernel; fuse_count_kernel (a
// candidate's views, kept or not, and the block's sums); fuse_carry_kernel
// (one block: the blocks' offsets from the running totals of points and
// members, which stay on the card); fuse_keep_kernel (a block scan for each
// kept candidate's point index and member offset, ownership, conflicts);
// fuse_emit_kernel; then the claim layers are reset with a memset. The keep
// and emit kernels touch disjoint words: keep writes owners and zeroes
// unclaimed neighbour depths; emit reads the claimed texels' maps. A race
// in keep is harmless: a depth zeroed under a conflict test can only turn
// another thread's decision to zero that same depth.
//
// Bound on an H100: bytes and latency. A view of 800x600 with 8 neighbours
// reads its maps and, for each candidate and neighbour, a few scattered
// words of the neighbour's maps (depth, owner, claim; normal, confidence
// and colour for winners): about 100 MB a view from L2 at worst; the float64
// work (about 150 operations a candidate and neighbour, the projection
// recomputed in each of four kernels) is near 0.5 GFLOP a view, far below
// the float64 peak. Recomputing beats storing each (candidate, neighbour)
// texel (32 B written and read again).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// into a shared library with a plain C interface, loaded through ctypes
// (ops/_build.py). Every multiply-add below is written as the intrinsic it
// must be, so the flag only guards against contraction elsewhere.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CARRY_THREADS = 1024;
constexpr int MAX_NB = 12;          // _build.MAX_VIEWS: DenseOptions.max_views
constexpr int EMPTY = 0x7f7f7f7f;   // an unclaimed texel (every byte 0x7f)
constexpr int FREE = -1;            // an unowned pixel
constexpr int CONSUMED = -2;        // a dropped candidate's pixel
constexpr int CAM = 30;             // a view's K^-1, R, C, K: 30 float64
constexpr int META = 6;             // pixel offset, h, w, has_normal, has_color, id

// mode bits
constexpr int FUSED = 1;            // the BLAS's 3x3 chain fuses each step
constexpr int DOT_SHIFT = 1;        // 2 bits: np.einsum's order of a 3-term dot
constexpr int NORM_SHIFT = 3;       // 2 bits: np.linalg.norm's order of 3 squares
constexpr int EST_COLOR = 32;
constexpr int EST_NORMAL = 64;

// the maps of every view, flat in slot order (ops/fusion_kernel._upload)
struct Maps {
  float* depth;                  // zeroed where conflicts are invalidated
  const float* conf;             // ones where a view has none
  const float* normal;           // 3 a pixel, camera frame
  const unsigned char* colour;   // 3 a pixel
  int* owner;                    // FREE, CONSUMED or a point index
};

// one view of the launch: its cameras (device) and its place in the maps
struct View {
  const double* kinv;
  const double* r;
  const double* c;
  const double* k;
  long long off;
  int h, w;
  bool has_normal, has_color;
  unsigned id;
};

struct Tables {
  const double* cams;    // (views, CAM)
  const long long* meta; // (views, META)
  const int* sel;        // the reference's slot, then its neighbours'
  int n_nb;
  int hw;                // the reference's pixels
  int modes;
};

__device__ __forceinline__ View view(const Tables& t, int j) {
  const int s = __ldg(t.sel + j);
  const double* c = t.cams + (long long)s * CAM;
  const long long* m = t.meta + (long long)s * META;
  View v;
  v.kinv = c;
  v.r = c + 9;
  v.c = c + 18;
  v.k = c + 21;
  v.off = __ldg(m);
  v.h = (int)__ldg(m + 1);
  v.w = (int)__ldg(m + 2);
  v.has_normal = __ldg(m + 3) != 0;
  v.has_color = __ldg(m + 4) != 0;
  v.id = (unsigned)__ldg(m + 5);
  return v;
}

// one step of the BLAS's chain over k: acc + a * b, fused or rounded twice
__device__ __forceinline__ double madd(double a, double b, double acc, bool fused) {
  return fused ? __fma_rn(a, b, acc) : __dadd_rn(__dmul_rn(a, b), acc);
}

// (v @ M.T)[j] = sum_k v[k] M[j][k], k in order
__device__ __forceinline__ double row_t(const double* v, const double* m, int j, bool fused) {
  double acc = __dmul_rn(v[0], __ldg(m + j * 3));
  acc = madd(v[1], __ldg(m + j * 3 + 1), acc, fused);
  return madd(v[2], __ldg(m + j * 3 + 2), acc, fused);
}

// (v @ M)[j] = sum_k v[k] M[k][j], k in order
__device__ __forceinline__ double col(const double* v, const double* m, int j, bool fused) {
  double acc = __dmul_rn(v[0], __ldg(m + j));
  acc = madd(v[1], __ldg(m + 3 + j), acc, fused);
  return madd(v[2], __ldg(m + 6 + j), acc, fused);
}

// three terms summed in the order NumPy takes: 0 (a + b) + c, 1 a + (b + c),
// 2 (a + c) + b
__device__ __forceinline__ double sum3(double a, double b, double c, int order) {
  if (order == 1) return __dadd_rn(a, __dadd_rn(b, c));
  if (order == 2) return __dadd_rn(__dadd_rn(a, c), b);
  return __dadd_rn(__dadd_rn(a, b), c);
}

// np.einsum("ij,ij->i") of one row: the products rounded and summed in
// sum3's order, or (order 3) the third product fused into the first
__device__ __forceinline__ double dot3(const double* a, const double* b, int order) {
  if (order == 3)
    return __dadd_rn(__fma_rn(a[2], b[2], __dmul_rn(a[0], b[0])), __dmul_rn(a[1], b[1]));
  return sum3(__dmul_rn(a[0], b[0]), __dmul_rn(a[1], b[1]), __dmul_rn(a[2], b[2]), order);
}

// Camera.unproject of pixel (u, v) at depth d: [u, v, 1] @ K^-1.T, times d,
// @ R + C
__device__ __forceinline__ void unproject(const View& v, double u, double y, double d,
                                          bool fused, double* X) {
  const double uv1[3] = {u, y, 1.0};
  double cam[3];
  for (int j = 0; j < 3; ++j) cam[j] = __dmul_rn(row_t(uv1, v.kinv, j, fused), d);
  for (int j = 0; j < 3; ++j) X[j] = __dadd_rn(col(cam, v.r, j, fused), __ldg(v.c + j));
}

// np.round(p).astype(int64) clipped to [0, n - 1]: NaN and values past
// int64 cast to its least value, so to 0
__device__ __forceinline__ int clip_index(double r, int n) {
  if (!(r >= 0.0) || !(r < 9223372036854775808.0)) return 0;
  return r > (double)(n - 1) ? n - 1 : (int)r;
}

// a point projected into a view: Camera.project_h ((X - C) @ R.T @ K.T),
// the divide where z > 0 (else -1), rounded half to even
struct Hit {
  double z;
  int lin;  // the clipped texel's linear index
  int x, y; // the clipped texel
  bool inside;
};

__device__ __forceinline__ Hit project(const View& v, const double* X, bool fused) {
  double t[3], xc[3], p[3];
  for (int j = 0; j < 3; ++j) t[j] = __dsub_rn(X[j], __ldg(v.c + j));
  for (int j = 0; j < 3; ++j) xc[j] = row_t(t, v.r, j, fused);
  for (int j = 0; j < 3; ++j) p[j] = row_t(xc, v.k, j, fused);
  Hit h;
  h.z = p[2];
  const bool front = p[2] > 0.0;
  const double rx = rint(front ? __ddiv_rn(p[0], p[2]) : -1.0);
  const double ry = rint(front ? __ddiv_rn(p[1], p[2]) : -1.0);
  h.inside = front && rx >= 0.0 && rx < (double)v.w && ry >= 0.0 && ry < (double)v.h;
  h.x = clip_index(rx, v.w);
  h.y = clip_index(ry, v.h);
  h.lin = h.y * v.w + h.x;
  return h;
}

// a pixel's normal in the world frame: normal @ R, or -R[2] without normals
__device__ __forceinline__ void world_normal(const View& v, const Maps& m, int lin, bool fused,
                                             double* N) {
  if (v.has_normal) {
    const float* n = m.normal + (v.off + lin) * 3;
    const double a[3] = {(double)n[0], (double)n[1], (double)n[2]};
    for (int j = 0; j < 3; ++j) N[j] = col(a, v.r, j, fused);
  } else {
    for (int j = 0; j < 3; ++j) N[j] = -__ldg(v.r + 6 + j);
  }
}

// conf2weight: 1 / (max(1 - conf, floor) depth^2), 1 - conf and the floor
// in float32 (np.maximum keeps a NaN), 0 where the denominator is not > 0
__device__ __forceinline__ double weight(float conf, double d, float floor_) {
  float m = __fsub_rn(1.0f, conf);
  if (!(m >= floor_ || m != m)) m = floor_;
  const double den = __dmul_rn(__dmul_rn((double)m, d), d);
  return den > 0.0 ? __ddiv_rn(1.0, den) : 0.0;
}

// whether reference pixel p is a candidate (valid, unowned), with its
// world point
__device__ __forceinline__ bool candidate(const View& r, const Maps& m, int p, bool fused,
                                          double* X) {
  const float d = m.depth[r.off + p];
  if (!(d > 0.0f) || m.owner[r.off + p] != FREE) return false;
  const int y = p / r.w;
  unproject(r, (double)(p - y * r.w), (double)y, (double)d, fused, X);
  return true;
}

// inclusive scan of (a, b) over the block's threads (NW warps); ta, tb the
// block's totals. Every thread of the block calls it.
template <int NW>
__device__ __forceinline__ void block_scan(long long& a, long long& b, long long& ta,
                                           long long& tb) {
  __shared__ long long sa[NW], sb[NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const long long x = __shfl_up_sync(0xffffffffu, a, o);
    const long long y = __shfl_up_sync(0xffffffffu, b, o);
    if (lane >= o) {
      a += x;
      b += y;
    }
  }
  if (lane == 31) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  long long pa = 0, pb = 0;
  ta = 0;
  tb = 0;
  for (int k = 0; k < NW; ++k) {
    if (k < warp) {
      pa += sa[k];
      pb += sb[k];
    }
    ta += sa[k];
    tb += sb[k];
  }
  a += pa;
  b += pb;
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
fuse_claim_kernel(Maps m, Tables t, int* __restrict__ claims, long long stride, double thr,
                  double cos_err) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= t.hw) return;
  const bool fused = t.modes & FUSED;
  const View r = view(t, 0);
  double X[3];
  if (!candidate(r, m, p, fused, X)) return;
  const int j = blockIdx.y;
  const View nb = view(t, 1 + j);
  const Hit h = project(nb, X, fused);
  if (!h.inside) return;
  const long long q = nb.off + h.lin;
  const float db = m.depth[q];
  if (!(db > 0.0f) || m.owner[q] != FREE) return;
  if (!(fabs(__dsub_rn(h.z, (double)db)) < __dmul_rn(thr, h.z))) return;
  double nw[3], nn[3];
  world_normal(r, m, p, fused, nw);
  world_normal(nb, m, h.lin, fused, nn);
  if (!(dot3(nw, nn, (t.modes >> DOT_SHIFT) & 3) > cos_err)) return;
  atomicMin(claims + j * stride + h.lin, p);
}

__global__ void __launch_bounds__(THREADS)
fuse_count_kernel(Maps m, Tables t, const int* __restrict__ claims, long long stride,
                  int n_min, int* __restrict__ flags, int* __restrict__ block_sums) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool fused = t.modes & FUSED;
  int flag = 0;
  if (p < t.hw) {
    const View r = view(t, 0);
    double X[3];
    if (candidate(r, m, p, fused, X)) {
      int n = 1;
      for (int j = 0; j < t.n_nb; ++j) {
        const Hit h = project(view(t, 1 + j), X, fused);
        n += h.inside && claims[j * stride + h.lin] == p;
      }
      flag = n >= n_min ? n : 0;
    }
    flags[p] = flag;
  }
  long long a = flag > 0, b = flag, ta, tb;
  block_scan<WARPS>(a, b, ta, tb);
  if (threadIdx.x == 0) {
    block_sums[2 * blockIdx.x] = (int)ta;
    block_sums[2 * blockIdx.x + 1] = (int)tb;
  }
}

// one block: each block's first point index and member offset, from the
// running totals, which it then advances by the view's
__global__ void __launch_bounds__(CARRY_THREADS)
fuse_carry_kernel(const int* __restrict__ block_sums, int n_blocks, long long* __restrict__ totals,
                  long long* __restrict__ block_base) {
  __shared__ long long carry[2];
  if (threadIdx.x == 0) {
    carry[0] = totals[0];
    carry[1] = totals[1];
  }
  __syncthreads();
  for (int start = 0; start < n_blocks; start += CARRY_THREADS) {
    const int i = start + threadIdx.x;
    const long long a0 = i < n_blocks ? block_sums[2 * i] : 0;
    const long long b0 = i < n_blocks ? block_sums[2 * i + 1] : 0;
    long long a = a0, b = b0, ta, tb;
    block_scan<CARRY_THREADS / 32>(a, b, ta, tb);
    if (i < n_blocks) {
      block_base[2 * i] = carry[0] + a - a0;
      block_base[2 * i + 1] = carry[1] + b - b0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      carry[0] += ta;
      carry[1] += tb;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    totals[0] = carry[0];
    totals[1] = carry[1];
  }
}

__global__ void __launch_bounds__(THREADS)
fuse_keep_kernel(Maps m, Tables t, const int* __restrict__ claims, long long stride,
                 const int* __restrict__ flags, const long long* __restrict__ block_base,
                 int* __restrict__ pidx, int* __restrict__ moff) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool in = p < t.hw;
  const int flag = in ? flags[p] : 0;
  long long a = flag > 0, b = flag, ta, tb;
  block_scan<WARPS>(a, b, ta, tb);
  if (!in) return;
  const bool fused = t.modes & FUSED;
  const View r = view(t, 0);
  double X[3];
  if (!candidate(r, m, p, fused, X)) return;
  const bool keep = flag > 0;
  const int pt = (int)(block_base[2 * blockIdx.x] + a - keep);
  if (keep) {
    pidx[p] = pt;
    moff[p] = (int)(block_base[2 * blockIdx.x + 1] + b - flag);
  }
  m.owner[r.off + p] = keep ? pt : CONSUMED;
  for (int j = 0; j < t.n_nb; ++j) {
    const View nb = view(t, 1 + j);
    const Hit h = project(nb, X, fused);
    if (!h.inside) continue;
    const long long q = nb.off + h.lin;
    const int c = claims[j * stride + h.lin];
    if (c == p) {
      if (keep) m.owner[q] = pt;  // a texel this point won
      continue;
    }
    if (!keep || c != EMPTY) continue;  // merged texels are no conflict
    const float db = m.depth[q];
    if (db > 0.0f && m.owner[q] == FREE && h.z < (double)db) m.depth[q] = 0.0f;
  }
}

// the cloud's arrays, flat (ops/fusion_kernel._Job)
struct Out {
  float* points;            // 3 a point
  unsigned char* colours;   // 3 a point
  float* normals;           // 3 a point
  int* counts;              // members a point
  unsigned* views;          // a member's view id
  float* weights;           // a member's weight
};

__global__ void __launch_bounds__(THREADS)
fuse_emit_kernel(Maps m, Tables t, const int* __restrict__ claims, long long stride,
                 float floor_, const int* __restrict__ flags, const int* __restrict__ pidx,
                 const int* __restrict__ moff, Out o) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= t.hw) return;
  const int flag = flags[p];
  if (flag == 0) return;
  const bool fused = t.modes & FUSED;
  const bool est_color = t.modes & EST_COLOR;
  const View r = view(t, 0);
  const long long pt = pidx[p];
  const long long mo = moff[p];
  const double d = (double)m.depth[r.off + p];
  const double w = weight(m.conf[r.off + p], d, floor_);
  const int y = p / r.w;
  double X[3], N[3];
  unproject(r, (double)(p - y * r.w), (double)y, d, fused, X);
  world_normal(r, m, p, fused, N);
  double ax[3], an[3], ac[3] = {0.0, 0.0, 0.0}, aw = w;
  for (int k = 0; k < 3; ++k) {
    ax[k] = __dmul_rn(X[k], w);
    an[k] = __dmul_rn(N[k], w);
  }
  if (est_color && r.has_color)
    for (int k = 0; k < 3; ++k) ac[k] = __dmul_rn((double)m.colour[(r.off + p) * 3 + k], w);
  o.views[mo] = r.id;
  o.weights[mo] = __double2float_rn(w);
  int n = 1;
  for (int j = 0; j < t.n_nb; ++j) {
    const View nb = view(t, 1 + j);
    const Hit h = project(nb, X, fused);
    if (!h.inside || claims[j * stride + h.lin] != p) continue;
    const long long q = nb.off + h.lin;
    const double db = (double)m.depth[q];
    const double wb = weight(m.conf[q], db, floor_);
    double Xb[3], Nb[3];
    unproject(nb, (double)h.x, (double)h.y, db, fused, Xb);
    world_normal(nb, m, h.lin, fused, Nb);
    for (int k = 0; k < 3; ++k) {
      ax[k] = __dadd_rn(ax[k], __dmul_rn(Xb[k], wb));
      an[k] = __dadd_rn(an[k], __dmul_rn(Nb[k], wb));
    }
    aw = __dadd_rn(aw, wb);
    if (est_color && nb.has_color)
      for (int k = 0; k < 3; ++k)
        ac[k] = __dadd_rn(ac[k], __dmul_rn((double)m.colour[q * 3 + k], wb));
    o.views[mo + n] = nb.id;
    o.weights[mo + n] = __double2float_rn(wb);
    ++n;
  }
  o.counts[pt] = n;
  const double inv = __ddiv_rn(1.0, aw);
  for (int k = 0; k < 3; ++k) o.points[pt * 3 + k] = __double2float_rn(__dmul_rn(ax[k], inv));
  if (est_color) {
    for (int k = 0; k < 3; ++k) {
      double v = __dmul_rn(ac[k], inv);  // np.clip(v, 0, 255), NaN kept
      v = v < 0.0 ? 0.0 : v;
      v = v > 255.0 ? 255.0 : v;
      o.colours[pt * 3 + k] = (unsigned char)__double2uint_rz(v);
    }
  }
  if (t.modes & EST_NORMAL) {
    const double s = sqrt(sum3(__dmul_rn(an[0], an[0]), __dmul_rn(an[1], an[1]),
                               __dmul_rn(an[2], an[2]), (t.modes >> NORM_SHIFT) & 3));
    const double den = (s > 1e-12 || s != s) ? s : 1e-12;
    for (int k = 0; k < 3; ++k) o.normals[pt * 3 + k] = __double2float_rn(__ddiv_rn(an[k], den));
  }
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

Maps maps_of(const unsigned long long* p) {
  return Maps{(float*)p[0], (const float*)p[1], (const float*)p[2],
              (const unsigned char*)p[3], (int*)p[4]};
}

bool tables_ok(int n_nb, int hw, int modes) {
  return n_nb >= 0 && n_nb <= MAX_NB && hw >= 0 && modes >= 0 && modes < 128;
}

Tables tables_of(const double* cams, const long long* meta, const int* sel, int n_nb, int hw,
                 int modes) {
  return Tables{cams, meta, sel, n_nb, hw, modes};
}

}  // namespace

extern "C" {

// The limit on neighbours a reference view takes (DenseOptions.max_views).
int fuse_max_neighbours() { return MAX_NB; }

// Every launch below runs on `stream`, returns the CUDA error of its
// launches (0 = success) and does not synchronise. `maps` is a host array of
// 5 device pointers (Maps' order); `cams` (views, 30) float64 and `meta`
// (views, 6) int64 are the views' tables on the card; `sel` points at the
// card's row of the reference view: its slot, then its n_nb neighbours';
// `hw` is the reference's pixels; `claims` holds a layer of `stride` words
// per neighbour; `modes` the mode bits.

// Claim: each neighbour texel's least agreeing candidate index.
int fuse_claim_launch(const unsigned long long* maps, const double* cams, const long long* meta,
                      const int* sel, int n_nb, int hw, int* claims, long long stride,
                      double thr, double cos_err, int modes, void* stream) {
  if (!tables_ok(n_nb, hw, modes) || stride < 0) return (int)cudaErrorInvalidValue;
  if (hw == 0 || n_nb == 0) return 0;
  const dim3 grid(blocks_for(hw), n_nb);
  fuse_claim_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      maps_of(maps), tables_of(cams, meta, sel, n_nb, hw, modes), claims, stride, thr, cos_err);
  return (int)cudaGetLastError();
}

// Count: flags (hw) the views of each kept candidate, 0 elsewhere;
// block_sums (blocks_for(hw), 2) each block's kept candidates and members.
int fuse_count_launch(const unsigned long long* maps, const double* cams, const long long* meta,
                      const int* sel, int n_nb, int hw, const int* claims, long long stride,
                      int n_min, int modes, int* flags, int* block_sums, void* stream) {
  if (!tables_ok(n_nb, hw, modes) || stride < 0) return (int)cudaErrorInvalidValue;
  if (hw == 0) return 0;
  fuse_count_kernel<<<blocks_for(hw), THREADS, 0, (cudaStream_t)stream>>>(
      maps_of(maps), tables_of(cams, meta, sel, n_nb, hw, modes), claims, stride, n_min, flags,
      block_sums);
  return (int)cudaGetLastError();
}

// Keep: the blocks' offsets (block_base, (blocks, 2) int64 scratch) from
// and into `totals` (points, members; int64 on the card), then each kept
// candidate's point index (pidx) and member offset (moff), ownership and
// the invalidated conflicts.
int fuse_keep_launch(const unsigned long long* maps, const double* cams, const long long* meta,
                     const int* sel, int n_nb, int hw, const int* claims, long long stride,
                     int modes, const int* flags, const int* block_sums, long long* totals,
                     long long* block_base, int* pidx, int* moff, void* stream) {
  if (!tables_ok(n_nb, hw, modes) || stride < 0) return (int)cudaErrorInvalidValue;
  if (hw == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = blocks_for(hw);
  fuse_carry_kernel<<<1, CARRY_THREADS, 0, s>>>(block_sums, (int)blocks, totals, block_base);
  fuse_keep_kernel<<<blocks, THREADS, 0, s>>>(maps_of(maps),
                                             tables_of(cams, meta, sel, n_nb, hw, modes), claims,
                                             stride, flags, block_base, pidx, moff);
  return (int)cudaGetLastError();
}

// Emit: each kept candidate's point, colour, normal, member count and
// members; `out` a host array of 6 device pointers (Out's order).
int fuse_emit_launch(const unsigned long long* maps, const double* cams, const long long* meta,
                     const int* sel, int n_nb, int hw, const int* claims, long long stride,
                     float floor_, int modes, const int* flags, const int* pidx, const int* moff,
                     const unsigned long long* out, void* stream) {
  if (!tables_ok(n_nb, hw, modes) || stride < 0) return (int)cudaErrorInvalidValue;
  if (hw == 0) return 0;
  const Out o{(float*)out[0], (unsigned char*)out[1], (float*)out[2], (int*)out[3],
              (unsigned*)out[4], (float*)out[5]};
  fuse_emit_kernel<<<blocks_for(hw), THREADS, 0, (cudaStream_t)stream>>>(
      maps_of(maps), tables_of(cams, meta, sel, n_nb, hw, modes), claims, stride, floor_, flags,
      pidx, moff, o);
  return (int)cudaGetLastError();
}

// Clear: n claim words set to EMPTY.
int fuse_clear_launch(int* claims, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return (int)cudaMemsetAsync(claims, 0x7f, (size_t)n * sizeof(int), (cudaStream_t)stream);
}

}  // extern "C"
