// Kernels A1, A2 and A3: nearest-K occluders for each (channel, azimuth)-
// sorted beam, phase A of the dense snowfall assembly.
//
// Replaces, in lidar_snow_sim_tpu/ops/pallas_occluders.py:
//   A1 `_kernel` (with `_prep_side`, `_extract_step`): every beam of a chunk
//      of `blk` consecutive sorted beams against one bank slice
//      data_t[row, :, lo:lo+w_sl] plus the row's whole wide list;
//   A2 `_kernel_routed`: per chunk mode 0 (dead: sentinels), mode 1 (A1's
//      body) or mode 2 (each band_group of beams against its own band
//      data_t[row, :, gloa:gloa+band] plus wide[:wide_sl]);
//   A3 `_kernel_banded` (with `_prep_banded`): each band_group against two
//      bands, head-anchored A and tail-anchored B (B's columns already in A
//      dropped), plus wide[:wide_sl], and a per-beam coverage flag.
// All three keep the K nearest hits in the order of lax.top_k over the
// candidate list as the TPU kernel concatenates it: ascending range, ties to
// the lowest candidate column.
//
// Design. One CTA per chunk, one thread per beam. After the wrap-pad dedup
// every candidate list is a run of ascending bank columns, at most two
// intervals of it (A3: band A, then band B's columns past band A), then the
// wide columns. So the CTA stages the bank columns that any of its threads
// needs (A1: the slice; A2/A3: the union of the chunk's bands, all inside
// its slice) through one shared-memory tile of kTile columns, in ascending
// order, each column loaded once; a thread tests only the columns of its
// own intervals, which keeps the list order. Candidate property rows are
// x, y, r, dist, azimuth in [0, 2pi) and half-width. Each thread keeps a
// sorted top-K list in local memory; a hit is inserted only when its range
// is strictly below the current K-th, which reproduces "value, then lowest
// index". Hits are rare (a few per beam), so the insertion cost is small.
// The hit test and the insertion are one function (TopK::consider) that
// all three kernels share, so their arithmetic is identical.
//
// What bounds it on this card: the hit test, ~20 flops per (beam, column)
// pair. At the bench shapes (576 chunks x 128 beams) A1 tests 1408 columns
// per beam, A2's fast chunks 384 + 32 and A3 at most 2 x band + 32; each
// staged column is 24 bytes, read once per chunk. It is compute- and
// latency-bound, not bandwidth-bound.
//
// Exactness. Compiled with -fmad=false: the hit test (|px sin - py cos| < r,
// the half-plane sign) is a decision boundary, and the plain torch version
// rounds every product on its own. Empty top-K slots hold a1 = a2 = 0 and
// dist = 3e38 (the TPU kernel leaves a retired column's a1/a2 there; every
// consumer masks on dist < 1e37). Wrap-pad copies (a column at or past the
// row's narrow count from the list's start; in band B also the columns band
// A holds) and columns past the end of the bank row are never tested.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kBig = 3.0e38f;
constexpr int kFeat = 9;   // point-feature rows, see ops/occluders.py
constexpr int kProp = 8;   // bank property rows
constexpr int kSangRow = 6;  // bank row of the signed sort angle
constexpr int kTile = 1024;

typedef float Tile[6][kTile];

struct Beam {
  float d_orig, right, left, sin_r, cos_r, sin_l, cos_l;
  bool wrapped;
  __device__ explicit Beam(const float* f)
      : d_orig(f[0]), right(f[1]), left(f[2]), sin_r(f[3]), cos_r(f[4]),
        sin_l(f[5]), cos_l(f[6]), wrapped(f[7] > 0.5f) {}
};

template <int KMAX>
struct TopK {
  float d[KMAX], a1[KMAX], a2[KMAX];
  int n_kept = 0, n_hit = 0;

  // The exact hit test of one staged candidate column, then the insertion
  // of a hit among the K nearest so far.
  __device__ __forceinline__ void consider(const Beam& b, const Tile& tile,
                                           int j, int k_occ) {
    const float px = tile[0][j], py = tile[1][j], pr = tile[2][j];
    const float pdist = tile[3][j], pang = tile[4][j], halfw = tile[5][j];
    bool center_in = (b.right <= pang) && (pang <= b.left);
    center_in = center_in ||
                (b.wrapped && (b.right - kTwoPi <= pang) && (pang <= b.left));
    center_in = center_in ||
                (b.wrapped && (b.right <= pang) && (pang <= b.left + kTwoPi));
    const float dist_r = fabsf(px * b.sin_r - py * b.cos_r);
    const float dist_l = fabsf(px * b.sin_l - py * b.cos_l);
    const bool right_hit =
        (dist_r < pr) && (b.cos_r * px + b.sin_r * py > 0.f);
    const bool left_hit =
        (dist_l < pr) && (b.cos_l * px + b.sin_l * py > 0.f);
    const bool hit =
        (center_in || right_hit || left_hit) && (pdist < b.d_orig);
    if (!hit) return;
    ++n_hit;
    if (n_kept == k_occ && !(pdist < d[k_occ - 1])) return;
    float v1 = pang - halfw;
    if (v1 < 0.f) v1 = v1 + kTwoPi;
    float v2 = pang + halfw;
    if (v2 > kTwoPi) v2 = v2 - kTwoPi;
    if (right_hit) v1 = b.right;
    if (left_hit) v2 = b.left;
    int pos = n_kept < k_occ ? n_kept : k_occ - 1;
    while (pos > 0 && d[pos - 1] > pdist) {
      d[pos] = d[pos - 1];
      a1[pos] = a1[pos - 1];
      a2[pos] = a2[pos - 1];
      --pos;
    }
    d[pos] = pdist;
    a1[pos] = v1;
    a2[pos] = v2;
    if (n_kept < k_occ) ++n_kept;
  }

  __device__ void write(float* a12d, int* ovf, size_t n2, size_t col,
                        int k_occ) const {
    for (int k = 0; k < k_occ; ++k) {
      const bool kept = k < n_kept;
      a12d[(size_t)k * n2 + col] = kept ? a1[k] : 0.f;
      a12d[(size_t)(k_occ + k) * n2 + col] = kept ? a2[k] : 0.f;
      a12d[(size_t)(2 * k_occ + k) * n2 + col] = kept ? d[k] : kBig;
    }
    ovf[col] = n_hit > k_occ ? n_hit - k_occ : 0;
  }
};

__device__ void write_empty(float* a12d, int* ovf, size_t n2, size_t col,
                            int k_occ) {
  for (int k = 0; k < k_occ; ++k) {
    a12d[(size_t)k * n2 + col] = 0.f;
    a12d[(size_t)(k_occ + k) * n2 + col] = 0.f;
    a12d[(size_t)(2 * k_occ + k) * n2 + col] = kBig;
  }
  ovf[col] = 0;
}

// Test every thread's beam against the columns of its own intervals
// [s0, e0) and [s1, e1) (e0 <= s1; either may be empty), in ascending
// column order. The CTA stages the columns [c_lo, c_hi), which must hold
// every thread's intervals, through the shared tile once, so threads whose
// intervals overlap share the loads. Must be reached by every thread.
template <int KMAX>
__device__ void scan_range(Tile& tile, const float* src, size_t ld,
                           int c_lo, int c_hi, int s0, int e0, int s1,
                           int e1, const Beam& b, TopK<KMAX>& top,
                           int k_occ) {
  for (int t0 = c_lo; t0 < c_hi; t0 += kTile) {
    const int n_t = min(kTile, c_hi - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n_t; j += blockDim.x)
      for (int r = 0; r < 6; ++r) tile[r][j] = src[(size_t)r * ld + t0 + j];
    __syncthreads();
    for (int c = max(s0, t0); c < min(e0, t0 + n_t); ++c)
      top.consider(b, tile, c - t0, k_occ);
    for (int c = max(s1, t0); c < min(e1, t0 + n_t); ++c)
      top.consider(b, tile, c - t0, k_occ);
  }
}

// The smallest and largest of a chunk's n per-group band starts.
__device__ void start_range(const int* starts, int n, int& lo, int& hi) {
  lo = starts[0];
  hi = starts[0];
  for (int g = 1; g < n; ++g) {
    lo = min(lo, starts[g]);
    hi = max(hi, starts[g]);
  }
}

// A1's body: the slice [lo, lo + w_sl) of the row up to one wrap period
// (cnt columns) and the row's end, then its wc wide columns.
template <int KMAX>
__device__ void full_slice(Tile& tile, const Beam& b, const float* bank,
                           const float* wide, int lo, int w_sl, int k_ext,
                           int cnt, int wc, TopK<KMAX>& top, int k_occ) {
  const int hi = min(lo + w_sl, k_ext);
  scan_range(tile, bank, k_ext, lo, hi, lo, min(hi, lo + cnt), 0, 0, b, top,
             k_occ);
  scan_range(tile, wide, wc, 0, wc, 0, wc, 0, 0, b, top, k_occ);
}

template <int KMAX>
__global__ void a1_kernel(
    const float* __restrict__ feats, const int* __restrict__ w0b,
    const int* __restrict__ rows, const int* __restrict__ los,
    const int* __restrict__ has, const int* __restrict__ counts,
    const float* __restrict__ data_t, const float* __restrict__ wide_t,
    float* __restrict__ a12d, int* __restrict__ ovf,
    int n_chunks, int blk, int w_sl, int k_ext, int wc, int k_occ) {
  __shared__ Tile tile;
  const int chunk = blockIdx.x;
  const size_t n2 = (size_t)n_chunks * blk;
  const size_t col_out = (size_t)chunk * blk + threadIdx.x;
  if (has[chunk] == 0) {   // dead window: sentinels only (uniform per CTA)
    write_empty(a12d, ovf, n2, col_out, k_occ);
    return;
  }
  const int row = rows[chunk];
  const Beam b(feats + ((size_t)w0b[chunk] * blk + threadIdx.x) * kFeat);
  TopK<KMAX> top;
  full_slice(tile, b, data_t + (size_t)row * kProp * k_ext,
             wide_t + (size_t)row * kProp * wc, los[chunk], w_sl, k_ext,
             counts[row], wc, top, k_occ);
  top.write(a12d, ovf, n2, col_out, k_occ);
}

template <int KMAX>
__global__ void a2_kernel(
    const float* __restrict__ feats, const int* __restrict__ w0b,
    const int* __restrict__ rows, const int* __restrict__ los,
    const int* __restrict__ gloa, const int* __restrict__ mode,
    const int* __restrict__ counts, const float* __restrict__ data_t,
    const float* __restrict__ wide_t, float* __restrict__ a12d,
    int* __restrict__ ovf, int n_chunks, int blk, int w_sl, int k_ext,
    int wc, int k_occ, int band, int group, int wide_sl) {
  __shared__ Tile tile;
  const int chunk = blockIdx.x;
  const size_t n2 = (size_t)n_chunks * blk;
  const size_t col_out = (size_t)chunk * blk + threadIdx.x;
  const int m = mode[chunk];   // uniform per CTA
  if (m == 0) {
    write_empty(a12d, ovf, n2, col_out, k_occ);
    return;
  }
  const int row = rows[chunk];
  const int cnt = counts[row];
  const float* bank = data_t + (size_t)row * kProp * k_ext;
  const float* wide = wide_t + (size_t)row * kProp * wc;
  const Beam b(feats + ((size_t)w0b[chunk] * blk + threadIdx.x) * kFeat);
  TopK<KMAX> top;
  if (m == 1) {
    full_slice(tile, b, bank, wide, los[chunk], w_sl, k_ext, cnt, wc, top,
               k_occ);
  } else {
    const int* lo_g = gloa + (size_t)chunk * (blk / group);
    int c_lo, c_hi;
    start_range(lo_g, blk / group, c_lo, c_hi);
    const int s = lo_g[threadIdx.x / group];
    // the band, one copy per wrap period counted from its start
    scan_range(tile, bank, k_ext, c_lo, min(c_hi + band, k_ext), s,
               min(s + min(band, cnt), k_ext), 0, 0, b, top, k_occ);
    scan_range(tile, wide, wc, 0, wide_sl, 0, wide_sl, 0, 0, b, top, k_occ);
  }
  top.write(a12d, ovf, n2, col_out, k_occ);
}

template <int KMAX>
__global__ void a3_kernel(
    const float* __restrict__ feats, const int* __restrict__ w0b,
    const int* __restrict__ rows, const int* __restrict__ gloa,
    const int* __restrict__ glob, const int* __restrict__ counts,
    const float* __restrict__ data_t, const float* __restrict__ wide_t,
    float* __restrict__ a12d, int* __restrict__ ovf, int* __restrict__ unc,
    int n_chunks, int blk, int k_ext, int wc, int wide_sl, int k_occ,
    int band, int group, float delta) {
  __shared__ Tile tile;
  const int chunk = blockIdx.x;
  const size_t n2 = (size_t)n_chunks * blk;
  const size_t col_out = (size_t)chunk * blk + threadIdx.x;
  const int row = rows[chunk];
  const int cnt = counts[row];
  const float* bank = data_t + (size_t)row * kProp * k_ext;
  const float* f = feats + ((size_t)w0b[chunk] * blk + threadIdx.x) * kFeat;
  const Beam b(f);
  const int n_groups = blk / group;
  const int* lo_a = gloa + (size_t)chunk * n_groups;
  const int* lo_b = glob + (size_t)chunk * n_groups;
  int a_lo, a_hi, b_lo, b_hi;
  start_range(lo_a, n_groups, a_lo, a_hi);
  start_range(lo_b, n_groups, b_lo, b_hi);
  const int g = threadIdx.x / group;
  const int la = lo_a[g], lb = lo_b[g];
  // band A up to one wrap period from its start, then the columns of band B
  // past band A, up to the same period
  const int end = min(la + cnt, k_ext);
  TopK<KMAX> top;
  scan_range(tile, bank, k_ext, min(a_lo, b_lo),
             min(max(a_hi, b_hi) + band, k_ext), la, min(la + band, end),
             max(lb, la + band), min(lb + band, end), b, top, k_occ);
  scan_range(tile, wide_t + (size_t)row * kProp * wc, wc, 0, wide_sl, 0,
             wide_sl, 0, 0, b, top, k_occ);
  top.write(a12d, ovf, n2, col_out, k_occ);

  // coverage: the beam's sort-angle window [az - delta, az + delta] lies
  // inside band A, band B or (when they overlap or adjoin) their union
  const float* sang = bank + (size_t)kSangRow * k_ext;
  const float s_a0 = sang[min(la, k_ext - 1)];
  const float s_a1 = sang[min(la + band - 1, k_ext - 1)];
  const float s_b0 = sang[min(lb, k_ext - 1)];
  const float s_b1 = sang[min(lb + band - 1, k_ext - 1)];
  const float need_l = f[8] - delta;
  const float need_r = f[8] + delta;
  const bool in_a = (s_a0 <= need_l) && (need_r <= s_a1);
  const bool in_b = (s_b0 <= need_l) && (need_r <= s_b1);
  const bool in_j = (lb - la <= band) && (s_a0 <= need_l) && (need_r <= s_b1);
  const bool covered = (cnt <= band) || in_a || in_b || in_j;
  unc[col_out] = covered ? 0 : 1;
}

}  // namespace

// The per-thread top-K list is sized at compile time: K <= 32 ... 512.
#define DISPATCH_K(k_occ, ...)                                              \
  if ((k_occ) <= 32) { constexpr int KMAX = 32; __VA_ARGS__; }              \
  else if ((k_occ) <= 64) { constexpr int KMAX = 64; __VA_ARGS__; }         \
  else if ((k_occ) <= 128) { constexpr int KMAX = 128; __VA_ARGS__; }       \
  else if ((k_occ) <= 256) { constexpr int KMAX = 256; __VA_ARGS__; }       \
  else if ((k_occ) <= 512) { constexpr int KMAX = 512; __VA_ARGS__; }       \
  else return static_cast<int>(cudaErrorInvalidValue);

// Arrays (all contiguous): feats (n_pad, 9) f32; w0b, rows, los, has
// (n_chunks,) i32; counts (C,) i32; data_t (C, 8, k_ext) f32; wide_t
// (C, 8, wc) f32; outputs a12d (3K, n_chunks * blk) f32 holding
// [a1; a2; dist] and ovf (n_chunks, blk) i32. Returns cudaGetLastError().
extern "C" int occluders_a1(
    const float* feats, const int* w0b, const int* rows, const int* los,
    const int* has, const int* counts, const float* data_t,
    const float* wide_t, float* a12d, int* ovf, int n_chunks, int blk,
    int w_sl, int k_ext, int wc, int k_occ, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  DISPATCH_K(k_occ, a1_kernel<KMAX><<<n_chunks, blk, 0, s>>>(
      feats, w0b, rows, los, has, counts, data_t, wide_t, a12d, ovf,
      n_chunks, blk, w_sl, k_ext, wc, k_occ))
  return static_cast<int>(cudaGetLastError());
}

// As occluders_a1, with gloa (n_chunks * blk / group,) i32 band starts and
// mode (n_chunks,) i32 (0 dead, 1 full slice, 2 per-group band) in place of
// has. Needs blk % group == 0 and wide_sl <= wc.
extern "C" int occluders_a2(
    const float* feats, const int* w0b, const int* rows, const int* los,
    const int* gloa, const int* mode, const int* counts, const float* data_t,
    const float* wide_t, float* a12d, int* ovf, int n_chunks, int blk,
    int w_sl, int k_ext, int wc, int k_occ, int band, int group,
    int wide_sl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  if (group <= 0 || blk % group) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_K(k_occ, a2_kernel<KMAX><<<n_chunks, blk, 0, s>>>(
      feats, w0b, rows, los, gloa, mode, counts, data_t, wide_t, a12d, ovf,
      n_chunks, blk, w_sl, k_ext, wc, k_occ, band, group, wide_sl))
  return static_cast<int>(cudaGetLastError());
}

// Two bands per group: gloa, glob (n_chunks * blk / group,) i32 head- and
// tail-anchored band starts; outputs as occluders_a1 plus unc
// (n_chunks, blk) i32, 1 where a beam's window is not covered. Every chunk
// is computed (no dead gate, as in the TPU kernel).
extern "C" int occluders_a3(
    const float* feats, const int* w0b, const int* rows, const int* gloa,
    const int* glob, const int* counts, const float* data_t,
    const float* wide_t, float* a12d, int* ovf, int* unc, int n_chunks,
    int blk, int k_ext, int wc, int wide_sl, int k_occ, int band, int group,
    float delta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  if (group <= 0 || blk % group) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_K(k_occ, a3_kernel<KMAX><<<n_chunks, blk, 0, s>>>(
      feats, w0b, rows, gloa, glob, counts, data_t, wide_t, a12d, ovf, unc,
      n_chunks, blk, k_ext, wc, wide_sl, k_occ, band, group, delta))
  return static_cast<int>(cudaGetLastError());
}
