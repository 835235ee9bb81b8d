// Kernel A1: nearest-K occluders for each (channel, azimuth)-sorted beam.
//
// Replaces `_kernel` of lidar_snow_sim_tpu/ops/pallas_occluders.py (with its
// helpers `_prep_side` and `_extract_step`), phase A of the dense snowfall
// assembly. For each chunk of `blk` consecutive sorted beams it tests every
// beam against one bank slice data_t[row, :, lo:lo+w_sl] plus the row's wide
// list, and keeps the K nearest hits in the order of lax.top_k: ascending
// range, ties to the lowest candidate column.
//
// Design. One CTA per chunk, one thread per beam. The candidate property
// rows the test reads (x, y, r, dist, azimuth in [0, 2pi), half-width) are
// staged through shared memory in tiles of TILE columns, in ascending column
// order, so a slice of any width fits (the capacity healers widen it up to
// the whole bank row, ~19k columns at 2.5 mm/h). Each thread scans the
// columns in order and keeps a sorted top-K list in local memory; a hit is
// inserted only when its range is strictly below the current K-th, which
// reproduces "value, then lowest index". Hits are rare (a few per beam), so
// the insertion cost is small.
//
// What bounds it on this card: the hit test, ~20 flops per (beam, column)
// pair, about 104M pairs at the bench shapes (576 chunks x 128 beams x 1408
// columns); the slice reads are 24 bytes per column per chunk. It is
// compute- and latency-bound, not bandwidth-bound.
//
// Exactness. Compiled with -fmad=false: the hit test (|px sin - py cos| < r,
// the half-plane sign) is a decision boundary, and the plain torch version
// rounds every product on its own. Empty top-K slots hold a1 = a2 = 0 and
// dist = 3e38 (the TPU kernel leaves a retired column's a1/a2 there; every
// consumer masks on dist < 1e37). Slice columns at or beyond the row's
// narrow count are wrap-pad copies and never hit; so do columns past the
// end of the bank row, which the port allows when a slice is wider than the
// row.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kBig = 3.0e38f;
constexpr int kFeat = 9;   // point-feature rows, see ops/occluders.py
constexpr int kProp = 8;   // bank property rows
constexpr int kTile = 1024;

template <int KMAX>
__global__ void a1_kernel(
    const float* __restrict__ feats, const int* __restrict__ w0b,
    const int* __restrict__ rows, const int* __restrict__ los,
    const int* __restrict__ has, const int* __restrict__ counts,
    const float* __restrict__ data_t, const float* __restrict__ wide_t,
    float* __restrict__ a12d, int* __restrict__ ovf,
    int n_chunks, int blk, int w_sl, int k_ext, int wc, int k_occ) {
  __shared__ float tile[6][kTile];
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  const size_t n2 = (size_t)n_chunks * blk;
  const size_t col_out = (size_t)chunk * blk + t;

  if (has[chunk] == 0) {   // dead window: sentinels only (uniform per CTA)
    for (int k = 0; k < k_occ; ++k) {
      a12d[(size_t)k * n2 + col_out] = 0.f;
      a12d[(size_t)(k_occ + k) * n2 + col_out] = 0.f;
      a12d[(size_t)(2 * k_occ + k) * n2 + col_out] = kBig;
    }
    ovf[col_out] = 0;
    return;
  }

  const int row = rows[chunk];
  const int lo = los[chunk];
  const int cnt = counts[row];
  const float* f = feats + ((size_t)w0b[chunk] * blk + t) * kFeat;
  const float d_orig = f[0], right = f[1], left = f[2];
  const float sin_r = f[3], cos_r = f[4], sin_l = f[5], cos_l = f[6];
  const bool wrapped = f[7] > 0.5f;
  const float* bank = data_t + (size_t)row * kProp * k_ext;
  const float* wide = wide_t + (size_t)row * kProp * wc;

  float best_d[KMAX], best_a1[KMAX], best_a2[KMAX];
  int n_kept = 0, n_hit = 0;
  const int total = w_sl + wc;

  for (int t0 = 0; t0 < total; t0 += kTile) {
    const int n_t = min(kTile, total - t0);
    __syncthreads();
    for (int j = t; j < n_t; j += blockDim.x) {
      const int c = t0 + j;
      if (c < w_sl) {
        const int g = lo + c;
        const bool ok = g < k_ext && c < cnt;
        for (int r = 0; r < 6; ++r)
          tile[r][j] = ok ? bank[(size_t)r * k_ext + g] : 0.f;
        if (!ok) tile[3][j] = INFINITY;   // never nearer than the beam
      } else {
        const int w = c - w_sl;
        for (int r = 0; r < 6; ++r) tile[r][j] = wide[(size_t)r * wc + w];
      }
    }
    __syncthreads();
    for (int j = 0; j < n_t; ++j) {
      const float px = tile[0][j], py = tile[1][j], pr = tile[2][j];
      const float pdist = tile[3][j], pang = tile[4][j], halfw = tile[5][j];
      bool center_in = (right <= pang) && (pang <= left);
      center_in = center_in ||
                  (wrapped && (right - kTwoPi <= pang) && (pang <= left));
      center_in = center_in ||
                  (wrapped && (right <= pang) && (pang <= left + kTwoPi));
      const float dist_r = fabsf(px * sin_r - py * cos_r);
      const float dist_l = fabsf(px * sin_l - py * cos_l);
      const bool right_hit = (dist_r < pr) && (cos_r * px + sin_r * py > 0.f);
      const bool left_hit = (dist_l < pr) && (cos_l * px + sin_l * py > 0.f);
      const bool hit = (center_in || right_hit || left_hit) && (pdist < d_orig);
      if (!hit) continue;
      ++n_hit;
      if (n_kept == k_occ && !(pdist < best_d[k_occ - 1])) continue;
      float a1 = pang - halfw;
      if (a1 < 0.f) a1 = a1 + kTwoPi;
      float a2 = pang + halfw;
      if (a2 > kTwoPi) a2 = a2 - kTwoPi;
      if (right_hit) a1 = right;
      if (left_hit) a2 = left;
      int pos = n_kept < k_occ ? n_kept : k_occ - 1;
      while (pos > 0 && best_d[pos - 1] > pdist) {
        best_d[pos] = best_d[pos - 1];
        best_a1[pos] = best_a1[pos - 1];
        best_a2[pos] = best_a2[pos - 1];
        --pos;
      }
      best_d[pos] = pdist;
      best_a1[pos] = a1;
      best_a2[pos] = a2;
      if (n_kept < k_occ) ++n_kept;
    }
  }

  for (int k = 0; k < k_occ; ++k) {
    const bool kept = k < n_kept;
    a12d[(size_t)k * n2 + col_out] = kept ? best_a1[k] : 0.f;
    a12d[(size_t)(k_occ + k) * n2 + col_out] = kept ? best_a2[k] : 0.f;
    a12d[(size_t)(2 * k_occ + k) * n2 + col_out] = kept ? best_d[k] : kBig;
  }
  ovf[col_out] = n_hit > k_occ ? n_hit - k_occ : 0;
}

template <int KMAX>
void launch(const float* feats, const int* w0b, const int* rows,
            const int* los, const int* has, const int* counts,
            const float* data_t, const float* wide_t, float* a12d, int* ovf,
            int n_chunks, int blk, int w_sl, int k_ext, int wc, int k_occ,
            cudaStream_t stream) {
  a1_kernel<KMAX><<<n_chunks, blk, 0, stream>>>(
      feats, w0b, rows, los, has, counts, data_t, wide_t, a12d, ovf,
      n_chunks, blk, w_sl, k_ext, wc, k_occ);
}

}  // namespace

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
  if (k_occ <= 32)
    launch<32>(feats, w0b, rows, los, has, counts, data_t, wide_t, a12d, ovf,
               n_chunks, blk, w_sl, k_ext, wc, k_occ, s);
  else if (k_occ <= 64)
    launch<64>(feats, w0b, rows, los, has, counts, data_t, wide_t, a12d, ovf,
               n_chunks, blk, w_sl, k_ext, wc, k_occ, s);
  else if (k_occ <= 128)
    launch<128>(feats, w0b, rows, los, has, counts, data_t, wide_t, a12d,
                ovf, n_chunks, blk, w_sl, k_ext, wc, k_occ, s);
  else if (k_occ <= 256)
    launch<256>(feats, w0b, rows, los, has, counts, data_t, wide_t, a12d,
                ovf, n_chunks, blk, w_sl, k_ext, wc, k_occ, s);
  else if (k_occ <= 512)
    launch<512>(feats, w0b, rows, los, has, counts, data_t, wide_t, a12d,
                ovf, n_chunks, blk, w_sl, k_ext, wc, k_occ, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
