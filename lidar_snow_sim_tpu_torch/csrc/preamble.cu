// Kernels P1 and P2: the snowfall preamble of one scan, the ground plane
// and the noise floor at every point, one launch each.
//
// Replaces the plain torch composition of `models/snowfall._plane_and_noise`
// on CUDA tensors: P1 is `ops/fitting.ransac_plane` (the crop, the median
// and MAD of its z, the trials, the refit), P2 is `ops/laser.noise_floor_at`
// (the ground band, the incidence, `estimate_laser_parameters`' power fit
// and (50 x 2555) histogram rows, `masked_polyfit2` and `polyval2`). In the
// JAX package the same code (lidar_snow_sim_tpu/ops/fitting.py,
// ops/laser.py) is left to XLA's fusion: there is no Pallas kernel. As
// plain torch it was ~1,760 small launches and two host syncs a scan.
//
// What bounds it: neither bytes nor operations. The kernels read ~25 bytes
// a point (xyz, intensity, mask, range; the noise floor out), ~1.6 MB for
// a 65,536-row scan, 0.5 us at 3.35 TB/s. Each runs as a single CTA of
// 1,024 threads whose phases are separated by __syncthreads, so one SM
// does the work and the passes over the points are latency-bound. That is
// still a small part of a scan's device time, and none of its host time:
// neither kernel synchronizes the host or needs a value on it.
//
// P1, per phase:
//  1. the road crop, as ransac_plane states it, compacted in index order
//     into the scratch arrays (block-wide ballot scan over tiles of 1,024
//     rows); in order, crop point number floor(u) is the one that
//     searchsorted(cumsum(crop), u, right=True) picks;
//  2. the exact median and MAD of the crop's z: radix select on
//     order-preserving uint32 keys (four 8-bit passes, histograms in shared
//     memory) of ranks (n-1)/2 and n/2, then of |z - median| by the same
//     float32 subtraction. An order statistic does not depend on how it is
//     found, so both equal `masked_median_and_mad` bit for bit;
//  3. the trials, one thread each: three crop points, + 1e-12 on the
//     diagonal, `_solve3`'s cofactors in its order, the finiteness and
//     |det| > 1e-6 gate; then a warp a trial counts its inliers
//     (resid * resid < MAD) and the first trial of most inliers wins;
//  4. the refit over that trial's inliers (block sums in a fixed order),
//     `_solve2`, the normalisation, the `good` test and the flat-earth
//     fallback. Writes (w, h), the median, the MAD, the crop size, the
//     chosen trial and every trial's count to device memory.
//
// P2 reads (w, h) from device memory and, per phase:
//  1. per point: the height over the plane, the ground band, the incidence
//     (acosf of the clamped ratio), cosf of it, the normalized intensity
//     and the range, kept in scratch; sums for the power fit's means, the
//     polyfit's mean range and the largest normalized intensity;
//  2. the power fit's centred sums, the polyfit's variance, and the (50 x
//     2555) histogram counted with integer atomics in a scratch buffer that
//     phase 1 zeroed;
//  3. each row's least nonzero count and its lowest bin (a warp a row),
//     the reference's fill rule (an empty row, or a count >= the ground
//     points, takes bin 0), the bin edges, the row fit and its fallback to
//     the power fit with three usable rows or fewer;
//  4. the threshold times cos(incidence), the degree-2 fit's normal
//     equations in its centred basis, + 1e-9 on the diagonal, solved by LU
//     with partial pivoting; then the fitted floor at every point's range.
//
// Rounding. Built with -fmad=false, so every product is rounded on its
// own, as torch's elementwise kernels round it; every division is the
// correctly rounded `/` (ops/f32.div); comparisons and bin indices follow
// the plain version's operation order. Sums are per-thread runs over a
// fixed stride, then warp and block trees in a fixed order: the same input
// gives the same bits on every run. They run in another order than
// torch's reductions, so the sums, the refit's (w, h) and the fits differ
// from the plain version's by rounding; integer counts, the crop, the
// order statistics, the trials' counts and the histogram's bins are exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTrials = 1024;
constexpr int kRows = 50;              // distance rows, 10 m to 70 m
constexpr int kBins = 2555;            // intensity bins a row
constexpr int kHist = kRows * kBins;
constexpr int kRed = 8;                // floats a block sum carries
constexpr float kBig = 3.0e38f;        // ops/fitting._BIG
constexpr unsigned kFull = 0xffffffffu;

// ---- block-wide helpers (every thread of the CTA calls them) ----

__device__ __forceinline__ float warp_sum(float v) {
  // xor tree: a + b == b + a, so every lane ends with the same bits
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// Sums each v[k] over the CTA: a thread's own run, a warp's xor tree, then
// the 32 warp sums in warp order; every thread gets the totals.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  static_assert(K <= kRed, "block_sum carries at most kRed floats");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = red[k];
    for (int w = 1; w < kWarps; ++w) t += red[w * K + k];
    v[k] = t;
  }
  __syncthreads();
}

__device__ __forceinline__ int block_count(int c, int* ired) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  c = __reduce_add_sync(kFull, c);
  if (lane == 0) ired[warp] = c;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < kWarps; ++w) t += ired[w];
  __syncthreads();
  return t;
}

// torch's max: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, m));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < kWarps; ++w) t = nan_max(t, red[w]);
  __syncthreads();
  return t;
}

// torch's clamp_min / clamp: NaN passes through
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float clamp_pm1(float v) {
  return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}

// ---- P1 ----

// float -> uint32 key whose unsigned order is the floats' order
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The k-th smallest (0-based) of the keys key_of(i), i < n, k < n: four
// passes over 8-bit digits from the top, each a histogram of the keys that
// share the digits found so far.
template <class KeyOf>
__device__ uint32_t select_key(KeyOf key_of, int n, int k, int* hist,
                               int* bcast) {
  uint32_t prefix = 0, pmask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int j = threadIdx.x; j < 256; j += kThreads) hist[j] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const uint32_t key = key_of(i);
      if ((key & pmask) == prefix)
        atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l owns digits 8l .. 8l + 7; the first lane whose inclusive
      // count passes k owns the digit of rank k
      const int lane = threadIdx.x;
      int local[8], own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        local[j] = hist[lane * 8 + j];
        own += local[j];
      }
      int incl = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned hit = __ballot_sync(kFull, incl > k);
      if (lane == __ffs(hit) - 1) {
        int below = incl - own, d = 0;
        for (; d < 7; ++d) {
          if (below + local[d] > k) break;
          below += local[d];
        }
        bcast[0] = lane * 8 + d;
        bcast[1] = k - below;
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(bcast[0]) << shift;
    pmask |= 255u << shift;
    k = bcast[1];
    __syncthreads();
  }
  return prefix;
}

__device__ __forceinline__ bool in_crop(float x, float y, float z) {
  return (z < -1.55f) && (z > -1.86f - 0.01f * x) && (x > 10.0f) &&
         (x < 70.0f) && (y > -3.0f) && (y < 3.0f);
}

struct P1Shared {
  int hist[256];
  int bcast[2];
  int ired[kWarps];
  float red[kWarps * kRed];
  float coef[kMaxTrials][3];
  int ok[kMaxTrials];
  int count[kMaxTrials];
  int best;
};

__global__ void __launch_bounds__(kThreads, 1)
p1_kernel(const float* __restrict__ xyz, int rs, int cs,
          const unsigned char* __restrict__ mask,
          const float* __restrict__ draws, int trials, int n,
          float standard_height, float* cx, float* cy, float* cz,
          float* __restrict__ out, int* __restrict__ info) {
  __shared__ P1Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the crop, compacted in index order
  int nc = 0;
  for (int start = 0; start < n; start += kThreads) {
    const int i = start + tid;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    bool f = false;
    if (i < n && mask[i]) {
      const float* p = xyz + static_cast<size_t>(i) * rs;
      x = p[0];
      y = p[cs];
      z = p[2 * cs];
      f = in_crop(x, y, z);
    }
    const unsigned b = __ballot_sync(kFull, f);
    if (lane == 0) sh.ired[warp] = __popc(b);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = sh.ired[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (f) {
      const int pos = nc + before + __popc(b & ((1u << lane) - 1u));
      cx[pos] = x;
      cy[pos] = y;
      cz[pos] = z;
    }
    nc += total;
    __syncthreads();
  }

  // 2. median and MAD of the crop's z
  float m1, mad;
  if (nc == 0) {
    const float big = kBig;
    m1 = (big + big) * 0.5f;       // inf, as the plain version's
    mad = kBig;
  } else {
    const int lo = (nc - 1) / 2, hi = nc / 2;
    auto zkey = [&](int i) { return order_key(cz[i]); };
    const float a = key_value(select_key(zkey, nc, lo, sh.hist, sh.bcast));
    const float b = hi == lo
        ? a : key_value(select_key(zkey, nc, hi, sh.hist, sh.bcast));
    m1 = (a + b) * 0.5f;
    auto dkey = [&](int i) { return order_key(fabsf(cz[i] - m1)); };
    const float c = key_value(select_key(dkey, nc, lo, sh.hist, sh.bcast));
    const float d = hi == lo
        ? c : key_value(select_key(dkey, nc, hi, sh.hist, sh.bcast));
    mad = (c + d) * 0.5f;
  }
  const float thresh = mad;

  // 3. the trials: a thread each solves, a warp each counts
  const float nf = static_cast<float>(nc);
  for (int t = tid; t < trials; t += kThreads) {
    float e[3][3], bz[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float px, py, pz;
      if (nc > 0) {
        const float u = fminf(draws[3 * t + j] * nf, nf - 0.5f);
        const int k = static_cast<int>(u);
        px = cx[k];
        py = cy[k];
        pz = cz[k];
      } else {  // searchsorted(zeros, -0.5, right=True) = 0: row 0
        px = xyz[0];
        py = xyz[cs];
        pz = xyz[2 * cs];
      }
      e[j][0] = px + (j == 0 ? 1e-12f : 0.0f);
      e[j][1] = py + (j == 1 ? 1e-12f : 0.0f);
      e[j][2] = 1.0f + (j == 2 ? 1e-12f : 0.0f);
      bz[j] = pz;
    }
    const float c00 = e[1][1] * e[2][2] - e[1][2] * e[2][1];
    const float c01 = e[1][2] * e[2][0] - e[1][0] * e[2][2];
    const float c02 = e[1][0] * e[2][1] - e[1][1] * e[2][0];
    const float det = e[0][0] * c00 + e[0][1] * c01 + e[0][2] * c02;
    const float c10 = e[0][2] * e[2][1] - e[0][1] * e[2][2];
    const float c11 = e[0][0] * e[2][2] - e[0][2] * e[2][0];
    const float c12 = e[0][1] * e[2][0] - e[0][0] * e[2][1];
    const float c20 = e[0][1] * e[1][2] - e[0][2] * e[1][1];
    const float c21 = e[0][2] * e[1][0] - e[0][0] * e[1][2];
    const float c22 = e[0][0] * e[1][1] - e[0][1] * e[1][0];
    const float s0 = (c00 * bz[0] + c10 * bz[1] + c20 * bz[2]) / det;
    const float s1 = (c01 * bz[0] + c11 * bz[1] + c21 * bz[2]) / det;
    const float s2 = (c02 * bz[0] + c12 * bz[1] + c22 * bz[2]) / det;
    sh.coef[t][0] = s0;
    sh.coef[t][1] = s1;
    sh.coef[t][2] = s2;
    sh.ok[t] = isfinite(s0) && isfinite(s1) && isfinite(s2) &&
               fabsf(det) > 1e-6f;
  }
  __syncthreads();
  for (int t = warp; t < trials; t += kWarps) {
    int cnt = 0;
    if (sh.ok[t]) {
      const float a0 = sh.coef[t][0], a1 = sh.coef[t][1],
                  a2 = sh.coef[t][2];
      for (int i = lane; i < nc; i += 32) {
        const float r = cz[i] - (cx[i] * a0 + cy[i] * a1 + a2);
        cnt += r * r < thresh;
      }
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) sh.count[t] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    for (int t = 1; t < trials; ++t)
      if (sh.count[t] > sh.count[best]) best = t;
    sh.best = best;
  }
  __syncthreads();

  // 4. the refit over the chosen trial's inliers
  const int best = sh.best;
  const bool okb = sh.ok[best] != 0;
  const float a0 = sh.coef[best][0], a1 = sh.coef[best][1],
              a2 = sh.coef[best][2];
  float s[3] = {0.0f, 0.0f, 0.0f};
  int nin = 0;
  for (int i = tid; i < nc; i += kThreads) {
    const float x = cx[i], y = cy[i], z = cz[i];
    const float r = z - (x * a0 + y * a1 + a2);
    if (okb && r * r < thresh) {
      s[0] += x;
      s[1] += y;
      s[2] += z;
      ++nin;
    }
  }
  block_sum(s, sh.red);
  nin = block_count(nin, sh.ired);
  const float n_in = fmaxf(static_cast<float>(nin), 1.0f);
  const float mx = s[0] / n_in, my = s[1] / n_in, mz = s[2] / n_in;
  float q[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = tid; i < nc; i += kThreads) {
    const float x = cx[i], y = cy[i], z = cz[i];
    const float r = z - (x * a0 + y * a1 + a2);
    if (okb && r * r < thresh) {
      const float dx = x - mx, dy = y - my, dz = z - mz;
      q[0] += dx * dx;
      q[1] += dx * dy;
      q[2] += dy * dy;
      q[3] += dx * dz;
      q[4] += dy * dz;
    }
  }
  block_sum(q, sh.red);
  if (tid == 0) {
    const float g00 = q[0] + 1e-9f, g01 = q[1] + 0.0f, g10 = q[1] + 0.0f,
                g11 = q[2] + 1e-9f;
    const float det = g00 * g11 - g01 * g10;
    const float ab0 = (g11 * q[3] - g01 * q[4]) / det;
    const float ab1 = (g00 * q[4] - g10 * q[3]) / det;
    const float intercept = mz - ab0 * mx - ab1 * my;
    const float nrm = sqrtf(ab0 * ab0 + ab1 * ab1 + 1.0f);
    const float w0 = ab0 / nrm, w1 = ab1 / nrm, w2 = -1.0f / nrm;
    const bool good = nc > 3 && nin >= 3 && isfinite(w0) && isfinite(w1) &&
                      isfinite(w2) && isfinite(intercept);
    out[0] = good ? w0 : 0.0f;
    out[1] = good ? w1 : 0.0f;
    out[2] = good ? w2 : 1.0f;
    out[3] = good ? intercept : standard_height;
    out[4] = m1;
    out[5] = mad;
    info[0] = nc;
    info[1] = best;
  }
  for (int t = tid; t < trials; t += kThreads) info[2 + t] = sh.count[t];
}

// ---- P2 ----

// np.histogram2d's bin of v in [lo, hi] of nbins, the plain version's
// `_bin_index` on an in-range v: floor(((v - lo) / span) * nbins), hi in
// the last bin
__device__ __forceinline__ int bin_of(float v, float lo, float hi,
                                      float span, int nbins) {
  int idx = static_cast<int>(floorf(((v - lo) / span) *
                                    static_cast<float>(nbins)));
  if (v == hi) idx = nbins - 1;
  return min(max(idx, 0), nbins - 1);
}

struct P2Shared {
  int ired[kWarps];
  float red[kWarps * kRed];
  int ymin[kRows];
  float yedge[kRows];
  float pmin[2];
};

// x_y_z . w as torch's CUDA `xyz @ w` rounds it
__device__ __forceinline__ float dot3(float x, float y, float z, float w0,
                                      float w1, float w2) {
  return x * w0 + y * w1 + z * w2;
}

__global__ void __launch_bounds__(kThreads, 1)
p2_kernel(const float* __restrict__ xyz, int rs, int cs,
          const float* __restrict__ intensity, int int_stride,
          const unsigned char* __restrict__ mask,
          const float* __restrict__ dist, const float* __restrict__ wp,
          const float* __restrict__ hp, const float* __restrict__ x_centers,
          int n, float ground_delta, float noise_floor, float* d3s,
          float* nis, float* cincs, int* ground, int* hist,
          float* __restrict__ stats, float* __restrict__ noise_at) {
  __shared__ P2Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float w0 = wp[0], w1 = wp[1], w2 = wp[2], h = hp[0];
  const float nw = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);

  // 1. per point; the histogram zeroed
  for (int j = tid; j < kHist; j += kThreads) hist[j] = 0;
  int cnt = 0;
  float m[3] = {0.0f, 0.0f, 0.0f};   // range, normalized intensity, dist
  float ymax = -INFINITY;
  for (int i = tid; i < n; i += kThreads) {
    const float* p = xyz + static_cast<size_t>(i) * rs;
    const float x = p[0], y = p[cs], z = p[2 * cs];
    const float dot = dot3(x, y, z, w0, w1, w2);
    const float hog = dot + h;
    const bool g = mask[i] && hog < ground_delta && hog > -ground_delta;
    const float di = dist[i];
    const float ratio = clamp_pm1(dot / (clamp_lo(di, 1e-12f) * nw));
    const float ci = cosf(acosf(ratio));
    const float ni = intensity[static_cast<size_t>(i) * int_stride] / ci;
    const float d3 = sqrtf(x * x + y * y + z * z);
    d3s[i] = d3;
    nis[i] = ni;
    cincs[i] = ci;
    ground[i] = g;
    if (g) {
      ++cnt;
      m[0] += d3;
      m[1] += ni;
      m[2] += di;
      ymax = nan_max(ymax, ni);
    }
  }
  block_sum(m, sh.red);
  cnt = block_count(cnt, sh.ired);
  ymax = block_max(ymax, sh.red);
  const float ncl = static_cast<float>(max(cnt, 1));
  const float xm = m[0] / ncl, ym = m[1] / ncl, mu = m[2] / ncl;
  const float y_hi = fabsf(ymax);
  const float y_span = y_hi - 5.0f;

  // 2. centred sums and the histogram
  float c[3] = {0.0f, 0.0f, 0.0f};   // dx dx, dx dy, (dist - mu)^2
  for (int i = tid; i < n; i += kThreads) {
    if (!ground[i]) continue;
    const float d3 = d3s[i], ni = nis[i];
    const float dx = d3 - xm, dy = ni - ym, dv = dist[i] - mu;
    c[0] += dx * dx;
    c[1] += dx * dy;
    c[2] += dv * dv;
    if (d3 >= 10.0f && d3 <= 70.0f && ni >= 5.0f && ni <= y_hi) {
      const int xi = bin_of(d3, 10.0f, 70.0f, 60.0f, kRows);
      const int yi = bin_of(ni, 5.0f, y_hi, y_span, kBins);
      atomicAdd(&hist[xi * kBins + yi], 1);
    }
  }
  block_sum(c, sh.red);   // its barriers also end the histogram's atomics
  const float slope = c[1] / clamp_lo(c[0], 1e-30f);
  const float intercept = ym - slope * xm;
  const float sigma = sqrtf(clamp_lo(c[2] / ncl, 1e-12f));

  // 3. each row's least count and lowest bin, then the row fit
  for (int r = warp; r < kRows; r += kWarps) {
    unsigned long long key = ~0ull;   // (count << 32) | bin, least wins
    for (int b = lane; b < kBins; b += 32) {
      const int v = hist[r * kBins + b];
      const unsigned long long k =
          (static_cast<unsigned long long>(v) << 32) | b;
      if (v > 0 && k < key) key = k;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, key, o);
      key = other < key ? other : key;
    }
    if (lane == 0) {
      const bool empty = key == ~0ull;
      const int cmin = static_cast<int>(key >> 32);
      const int yb = (empty || cmin >= cnt)
          ? 0 : static_cast<int>(key & 0xffffffffull);
      sh.ymin[r] = yb;
      sh.yedge[r] = 5.0f + (static_cast<float>(yb) * y_span) /
                    static_cast<float>(kBins);
    }
  }
  __syncthreads();
  if (warp == 0) {
    float sx = 0.0f, sy = 0.0f;
    int rows = 0;
    for (int r = lane; r < kRows; r += 32) {
      if (sh.yedge[r] > 5.0f) {
        sx += x_centers[r];
        sy += sh.yedge[r];
        ++rows;
      }
    }
    sx = warp_sum(sx);
    sy = warp_sum(sy);
    rows = __reduce_add_sync(kFull, rows);
    const float nr = static_cast<float>(max(rows, 1));
    const float xmr = sx / nr, ymr = sy / nr;
    float sxx = 0.0f, sxy = 0.0f;
    for (int r = lane; r < kRows; r += 32) {
      if (sh.yedge[r] > 5.0f) {
        const float dx = x_centers[r] - xmr, dy = sh.yedge[r] - ymr;
        sxx += dx * dx;
        sxy += dx * dy;
      }
    }
    sxx = warp_sum(sxx);
    sxy = warp_sum(sxy);
    const float rs = sxy / clamp_lo(sxx, 1e-30f);
    const float ri = ymr - rs * xmr;
    if (lane == 0) {
      const bool use_rows = rows > 3;
      sh.pmin[0] = use_rows ? rs : slope;
      sh.pmin[1] = use_rows ? ri : intercept;
      stats[4] = rs;
      stats[5] = ri;
      stats[6] = static_cast<float>(rows);
    }
  }
  __syncthreads();
  const float pm1 = sh.pmin[0], pm2 = sh.pmin[1];

  // 4. the threshold's degree-2 fit over range, in the centred basis
  float f[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = tid; i < n; i += kThreads) {
    if (!ground[i]) continue;
    const float d3 = d3s[i];
    const float fl = 0.0f * d3 * d3 + pm1 * d3 + pm2;   // polyval2(p_min)
    const float thr = fl * noise_floor * cincs[i];
    const float u = (dist[i] - mu) / sigma, uu = u * u;
    f[0] += uu * uu;
    f[1] += uu * u;
    f[2] += uu;
    f[3] += u;
    f[4] += uu * thr;
    f[5] += u * thr;
    f[6] += thr;
  }
  block_sum(f, sh.red);
  // G + 1e-9 I, solved by LU with partial pivoting
  float A[3][3] = {{f[0] + 1e-9f, f[1] + 0.0f, f[2] + 0.0f},
                   {f[1] + 0.0f, f[2] + 1e-9f, f[3] + 0.0f},
                   {f[2] + 0.0f, f[3] + 0.0f,
                    static_cast<float>(cnt) + 1e-9f}};
  float rhs[3] = {f[4], f[5], f[6]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
    for (int i = k + 1; i < 3; ++i)
      if (fabsf(A[i][k]) > fabsf(A[p][k])) p = i;
    if (p != k) {
      for (int j = 0; j < 3; ++j) {
        const float t = A[k][j];
        A[k][j] = A[p][j];
        A[p][j] = t;
      }
      const float t = rhs[k];
      rhs[k] = rhs[p];
      rhs[p] = t;
    }
    for (int i = k + 1; i < 3; ++i) {
      const float l = A[i][k] / A[k][k];
      for (int j = k + 1; j < 3; ++j) A[i][j] = A[i][j] - l * A[k][j];
      rhs[i] = rhs[i] - l * rhs[k];
    }
  }
  const float cu_ = rhs[2] / A[2][2];
  const float bu = (rhs[1] - A[1][2] * cu_) / A[1][1];
  const float a = (rhs[0] - A[0][1] * bu - A[0][2] * cu_) / A[0][0];
  const float ss = sigma * sigma;
  const float p2 = a / ss;
  const float p1 = bu / sigma - 2.0f * a * mu / ss;
  const float p0 = a * mu * mu / ss - bu * mu / sigma + cu_;
  for (int i = tid; i < n; i += kThreads) {
    const float d = dist[i];
    noise_at[i] = p2 * d * d + p1 * d + p0;
  }
  if (tid == 0) {
    stats[0] = static_cast<float>(cnt);
    stats[1] = y_hi;
    stats[2] = slope;
    stats[3] = intercept;
    stats[7] = p2;
    stats[8] = p1;
    stats[9] = p0;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    stats[10 + r] = static_cast<float>(sh.ymin[r]);
    stats[10 + kRows + r] = sh.yedge[r];
  }
}

}  // namespace

// P1. xyz (n, 3) f32 at strides (rs, cs) floats, mask (n,) bool,
// draws (trials, 3) f32 in [0, 1), scratch (3 n) f32; out (6,) f32: w (3),
// h, the crop's median and MAD of z; info (2 + trials,) int32: the crop's
// size, the chosen trial, each trial's inlier count. 1 <= n, 1 <= trials
// <= 1024. Returns cudaGetLastError().
extern "C" int preamble_p1(const float* xyz, int rs, int cs,
                           const unsigned char* mask, const float* draws,
                           int trials, int n, float standard_height,
                           float* scratch, float* out, int* info,
                           void* stream) {
  if (n < 1 || trials < 1 || trials > kMaxTrials || rs < 0 || cs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p1_kernel<<<1, kThreads, 0, s>>>(xyz, rs, cs, mask, draws, trials, n,
                                   standard_height, scratch, scratch + n,
                                   scratch + 2 * n, out, info);
  return static_cast<int>(cudaGetLastError());
}

// P2. xyz as P1's, intensity (n,) f32 at stride `int_stride`, mask (n,)
// bool, dist (n,) f32, w (3,) f32 and h (1,) f32 on the device, x_centers
// (50,) f32; scratch (4 n + 50 * 2555) int32-sized words: range,
// normalized intensity, cos(incidence), the ground flag, the histogram;
// stats (110,) f32 (ground points, y_hi, the power fit, the row fit and
// its usable rows, the noise polynomial p2 p1 p0, each row's bin, each
// row's edge); noise_at (n,) f32. Returns cudaGetLastError().
extern "C" int preamble_p2(const float* xyz, int rs, int cs,
                           const float* intensity, int int_stride,
                           const unsigned char* mask, const float* dist,
                           const float* w, const float* h,
                           const float* x_centers, int n, float ground_delta,
                           float noise_floor, int* scratch, float* stats,
                           float* noise_at, void* stream) {
  if (n < 1 || rs < 0 || cs < 0 || int_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = reinterpret_cast<float*>(scratch);
  p2_kernel<<<1, kThreads, 0, s>>>(
      xyz, rs, cs, intensity, int_stride, mask, dist, w, h, x_centers, n,
      ground_delta, noise_floor, f, f + n, f + 2 * n, scratch + 3 * n,
      scratch + 4 * n, stats, noise_at);
  return static_cast<int>(cudaGetLastError());
}
