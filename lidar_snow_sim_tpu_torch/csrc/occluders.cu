// Kernels A1, A2, A3, A4a and A4b: nearest-K occluders for each (channel,
// azimuth)-sorted beam, phase A of the dense snowfall assembly.
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
//      dropped), plus wide[:wide_sl], and a per-beam coverage flag;
//   A4a `_kernel_t` (`pallas_transposed`) and A4b `_kernel_pair`
//      (`pallas_pair`): A1's function, every chunk computed (no has gate).
// All of them keep the K nearest hits in the order of lax.top_k over the
// candidate list as the TPU kernel concatenates it: ascending range, ties to
// the lowest candidate column.
//
// What bounds them on this card: instructions issued, not bytes. The hit
// test is ~20 flops per (beam, column) pair; at the bench shapes (576
// chunks x 128 beams) A1 tests 1408 columns per beam (~83 M tests on the
// live chunks), A2's fast chunks 384 + 32 and A3 at most 2 x band + 32,
// while each staged column is 24 bytes read once per chunk (~19.5 MB, most
// of it from L2). So the count of instructions per test, and how many
// warps each SM has in flight to hide their latency, set the time.
//
// A1 (redesigned for the H100). The first port gave one thread a beam and
// one CTA of 4 warps a chunk: a single wave of 576 CTAs, ~20% of them dead,
// ~3.5 warps per scheduler, and per test six scalar shared loads, the wrap
// shifts of the centre test recomputed, the loop bounds re-derived and a
// branch into the insertion. Now:
//   - a beam's list is split over kLanesA1 lanes (lane s tests candidates
//     s, s + kLanesA1, ...), each lane keeps its own top-K, and the lanes
//     merge (merge_write), which is exact for "value, then lowest index";
//     a CTA holds kBeamsA1 beams, so a chunk is blk / 64 CTAs and the grid
//     is many more, smaller items (balance across the 132 SMs, ~6 CTAs of
//     8 warps resident on each);
//   - the CTA stages its list as structures, {x, y, r, dist} in one float4
//     plus the angle: one LDS.128 and one LDS.32 a test; the half-width
//     only for a kept hit;
//   - the beam's centre-test bounds are worked out once (Beam), the loop is
//     unrolled with a branch-free test (& and |, the hit count in a
//     register), and the insertion is a rare path behind one compare
//     against the K-th kept range.
// The no-hit path of a test fell from 46 SASS instructions to 32.75
// (scripts/sass_loops.py), and the device time at the bench shapes to 0.44x
// the first port's on an H100 at 700 W (tools/kernel_times.py).
// A slice longer than the tile (a grown slice, up to the bank row) streams
// through it in column order, which keeps the tie order.
//
// A4a and A4b (redesigned for the H100) compute A1's function on every
// chunk and run A1's body: one device function, lane_split_chunks, with a
// compile-time switch for the has gate, so the three share their staging,
// their per-test code (33 SASS instructions a no-hit test) and their
// merge. Like A1 they are bound by the instructions issued a test and by
// how many warps each SM keeps in flight to hide the shared-memory and
// shuffle latencies, not by bytes; and, with ~1.5 waves of CTAs, by how
// evenly the last wave fills the SMs.
//   - A4a replaces `_kernel_t`, whose point on the TPU is a beam's
//     candidates across the lanes (sublanes there) and a reduction along
//     them a trip. Here a beam's list stays split, over kLanesA4a lanes,
//     merged by merge_write. The first port gave a warp one beam (32
//     lanes) and ran the per-test path A1 dropped (six scalar loads from a
//     row-major tile, a branch on every test, the hit count in memory).
//     The split (8 lanes, 64 beams a CTA) is the fastest of the variants
//     timed on the card (scripts/a4_sweep.py): fewer beams a CTA pay the
//     staging of the whole list for fewer beams, more lanes a beam more
//     shuffles a merge trip.
//   - A4b replaces `_kernel_pair`, which interleaves two chunks' extraction
//     loops for instruction-level parallelism on the TPU. Here a CTA still
//     owns chunks 2i and 2i + 1 (so the chunk count must be even), as two
//     groups of threads, each running the lane split (kLanesA4b lanes a
//     beam) on kBeamsA4b beams of its own chunk, so the pair costs no
//     occupancy: the CTA stages both lists, each in its own region of
//     dynamic shared memory (over 48 KB, after cudaFuncSetAttribute), and
//     each chunk keeps its own candidate indices for the merge. The first
//     port gave a CTA of 4 warps both chunks' 128 beams, one thread a beam
//     with both chains: 288 CTAs, ~9 warps an SM, too few to hide the
//     shared-memory latency.
//
// A2 and A3: one CTA per chunk, one thread per beam. After the wrap-pad
// dedup every candidate list is a run of ascending bank columns, at most
// two intervals of it (A3: band A, then band B's columns past band A),
// then the wide columns. So the CTA stages the bank columns that any of its
// threads needs (A2/A3: the union of the chunk's bands, all inside its
// slice) through one shared-memory tile of kTile columns, in ascending
// order, each column loaded once; a thread tests only the columns of its
// own intervals, which keeps the list order. Candidate property rows are
// x, y, r, dist, azimuth in [0, 2pi) and half-width. Each thread keeps a
// sorted top-K list in local memory; a hit is inserted only when its range
// is strictly below the current K-th, which reproduces "value, then lowest
// index". Hits are rare (a few per beam), so the insertion cost is small.
// Every kernel here calls one hit test (hit_test) and one interval
// function, so their arithmetic is identical.
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

// A beam's point features, with the centre test's bounds worked out once.
// The plain version tests the centre angle against [right, left] and, for a
// wrapped beam, against [right - 2pi, left] and [right, left + 2pi]. The
// first interval lies inside the third whenever the beam is wrapped, so the
// test is two intervals: [right, left] and an empty one (lo_b = +inf) for a
// beam that is not wrapped, the two shifted ones for a wrapped beam. The
// shifted bounds are the same single float operations, so the booleans are
// the plain version's.
struct Beam {
  float d_orig, right, left, sin_r, cos_r, sin_l, cos_l;
  float lo_a, hi_a, lo_b, hi_b;
  __device__ explicit Beam(const float* f)
      : d_orig(f[0]), right(f[1]), left(f[2]), sin_r(f[3]), cos_r(f[4]),
        sin_l(f[5]), cos_l(f[6]) {
    const bool wrapped = f[7] > 0.5f;
    lo_a = wrapped ? right - kTwoPi : right;
    hi_a = left;
    lo_b = wrapped ? right : INFINITY;
    hi_b = wrapped ? left + kTwoPi : -INFINITY;
    // keep the bounds in registers: left to itself, the compiler redoes
    // the wrap select and shift in every test
    asm("" : "+f"(lo_a), "+f"(lo_b), "+f"(hi_b));
  }
};

// The exact hit test of candidate (px, py, pr, pdist, pang) against beam b;
// on a hit, also whether it is a right or left edge hit. Every kernel of
// this file calls it, so their arithmetic is identical.
__device__ __forceinline__ bool hit_test(const Beam& b, float px, float py,
                                         float pr, float pdist, float pang,
                                         bool& right_hit, bool& left_hit) {
  // & and | rather than && and ||: every compare is cheap and has no side
  // effect, so a branch-free predicate beats the short-circuit branches
  const bool center_in = ((b.lo_a <= pang) & (pang <= b.hi_a)) |
                         ((b.lo_b <= pang) & (pang <= b.hi_b));
  const float dist_r = fabsf(px * b.sin_r - py * b.cos_r);
  const float dist_l = fabsf(px * b.sin_l - py * b.cos_l);
  right_hit = (dist_r < pr) & (b.cos_r * px + b.sin_r * py > 0.f);
  left_hit = (dist_l < pr) & (b.cos_l * px + b.sin_l * py > 0.f);
  return (center_in | right_hit | left_hit) & (pdist < b.d_orig);
}

// The occluded interval [v1, v2] of a hit.
__device__ __forceinline__ void interval(const Beam& b, float pang,
                                         float halfw, bool right_hit,
                                         bool left_hit, float& v1,
                                         float& v2) {
  v1 = pang - halfw;
  if (v1 < 0.f) v1 = v1 + kTwoPi;
  v2 = pang + halfw;
  if (v2 > kTwoPi) v2 = v2 - kTwoPi;
  if (right_hit) v1 = b.right;
  if (left_hit) v2 = b.left;
}

template <int KMAX>
struct TopK {
  float d[KMAX], a1[KMAX], a2[KMAX];
  int n_kept = 0, n_hit = 0;

  // The exact hit test of one staged candidate column, then the insertion
  // of a hit among the K nearest so far.
  __device__ __forceinline__ void consider(const Beam& b, const Tile& tile,
                                           int j, int k_occ) {
    const float pdist = tile[3][j], pang = tile[4][j];
    bool right_hit, left_hit;
    if (!hit_test(b, tile[0][j], tile[1][j], tile[2][j], pdist, pang,
                  right_hit, left_hit))
      return;
    ++n_hit;
    if (n_kept == k_occ && !(pdist < d[k_occ - 1])) return;
    float v1, v2;
    interval(b, pang, tile[5][j], right_hit, left_hit, v1, v2);
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

// A2's mode 1, A1's function with one thread a beam: the slice
// [lo, lo + w_sl) of the row up to one wrap period (cnt columns) and the
// row's end, then its wc wide columns.
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


// ---- A1, A4a and A4b: one lane-split body for A1's function

// One lane's sorted list of its K nearest hits (ascending range; a tie keeps
// the lower candidate index, which is also the lane's earlier test).
template <int KMAX>
struct LaneTopK {
  float d[KMAX], a1[KMAX], a2[KMAX];
  int col[KMAX];
  int n_kept = 0, n_hit = 0, head = 0;
  float kth = INFINITY;   // d[k_occ - 1] once the list is full

  // Whether a hit at range pdist enters the list (the K-th kept is nearer
  // or equal, and earlier, otherwise).
  __device__ __forceinline__ bool takes(float pdist, int k_occ) const {
    return n_kept < k_occ || pdist < kth;
  }

  __device__ void insert(float pdist, float v1, float v2, int c, int k_occ) {
    int pos = n_kept < k_occ ? n_kept : k_occ - 1;
    while (pos > 0 && d[pos - 1] > pdist) {
      d[pos] = d[pos - 1];
      a1[pos] = a1[pos - 1];
      a2[pos] = a2[pos - 1];
      col[pos] = col[pos - 1];
      --pos;
    }
    d[pos] = pdist;
    a1[pos] = v1;
    a2[pos] = v2;
    col[pos] = c;
    if (n_kept < k_occ) ++n_kept;
    if (n_kept == k_occ) kth = d[k_occ - 1];
  }
};

// Merge the lists of each group of G lanes (one beam; G a power of two up to
// 32, groups aligned in the warp) and write the beam's K slots and overflow.
// min(K, hits) trips each take the group minimum of (range, candidate
// index), lax.top_k's "value, then lowest index", and the winning lane pops
// its head. Every lane of the warp must call it; lanes of an inactive beam
// hold empty lists and write nothing. A beam without hits (a dead chunk of
// A1 among them) gets the empty-slot sentinels and overflow 0.
template <int G, int KMAX>
__device__ void merge_write(LaneTopK<KMAX>& top, float* a12d, int* ovf,
                            size_t n2, size_t col_out, int k_occ, int sub,
                            bool active) {
  int total = top.n_hit;
  for (int o = G / 2; o > 0; o >>= 1)
    total += __shfl_xor_sync(0xffffffffu, total, o);
  const int trips = min(k_occ, total);
  int trips_w = trips;   // the warp's largest: shuffles need every lane
  for (int o = 16; o >= G; o >>= 1)
    trips_w = max(trips_w, __shfl_xor_sync(0xffffffffu, trips_w, o));
  for (int k = 0; k < trips_w; ++k) {
    const bool has = top.head < top.n_kept;
    float bd = has ? top.d[top.head] : kBig;
    int bc = has ? top.col[top.head] : 0x7fffffff;
    for (int o = G / 2; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, o);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
      if (od < bd || (od == bd && oc < bc)) { bd = od; bc = oc; }
    }
    if (has && top.col[top.head] == bc) {   // the winner: one lane
      a12d[(size_t)k * n2 + col_out] = top.a1[top.head];
      a12d[(size_t)(k_occ + k) * n2 + col_out] = top.a2[top.head];
      a12d[(size_t)(2 * k_occ + k) * n2 + col_out] = bd;
      ++top.head;
    }
  }
  if (!active) return;
  for (int k = trips + sub; k < k_occ; k += G) {
    a12d[(size_t)k * n2 + col_out] = 0.f;
    a12d[(size_t)(k_occ + k) * n2 + col_out] = 0.f;
    a12d[(size_t)(2 * k_occ + k) * n2 + col_out] = kBig;
  }
  if (sub == 0) ovf[col_out] = total > k_occ ? total - k_occ : 0;
}

// A chunk's candidate list in A1's function: the slice [lo, lo + n_s) of its
// bank row (n_s: the slice up to one wrap period and the row's end), then
// the row's wc wide columns; n_tot = 0 for a chunk that is not computed.
struct ChunkList {
  const float* bank;   // property row 0 of the bank row, at column lo
  const float* wide;
  int n_s, n_tot, k_ext, wc;

  __device__ ChunkList(const int* rows, const int* los, const int* counts,
                       const float* data_t, const float* wide_t, int chunk,
                       bool computed, int w_sl, int k_ext_, int wc_)
      : k_ext(k_ext_), wc(wc_) {
    const int row = rows[chunk];
    const int lo = los[chunk];
    n_s = max(min(min(lo + w_sl, k_ext), lo + counts[row]) - lo, 0);
    n_tot = computed ? n_s + wc : 0;
    bank = data_t + (size_t)row * kProp * k_ext + lo;
    wide = wide_t + (size_t)row * kProp * wc;
  }

  // Stage list columns [c0, c0 + n_t) in column order, by the CTA's
  // threads: {x, y, r, dist} as one float4, the angle, the half-width.
  __device__ __forceinline__ void stage(int c0, int n_t, float4* xyrd,
                                        float* ang, float* halfw) const {
    for (int j = threadIdx.x; j < n_t; j += blockDim.x) {
      const int c = c0 + j;
      const float* src = c < n_s ? bank + c : wide + (c - n_s);
      const size_t ld = c < n_s ? k_ext : wc;
      xyrd[j] = make_float4(src[0], src[ld], src[2 * ld], src[3 * ld]);
      ang[j] = src[4 * ld];
      halfw[j] = src[5 * ld];
    }
  }
};

// A1's function on NL chunks per CTA (1, or 2 for A4b): thread group l,
// threads [l * NB * G, (l + 1) * NB * G), holds beams blockIdx.y * NB ...
// + NB - 1 of chunk chunk0 + l, G lanes a beam. The CTA stages every
// chunk's list, cap columns a pass, each in its own region of the dynamic
// shared memory (NL * cap * 24 bytes: NL * cap float4, then the angles,
// then the half-widths). Lane s of a beam tests its chunk's candidates s,
// s + G, ... with the branch-free hit test, the hit count in a register and
// the insertion behind one compare against the K-th kept range; then
// merge_write joins the lanes' lists in lax.top_k order, with each chunk's
// own candidate indices. kGated: a chunk with has == 0 is not computed and
// gets sentinels (A1); otherwise every chunk is computed (A4a, A4b). Every
// thread of the CTA must call it.
template <int KMAX, int G, int NB, int NL, bool kGated>
__device__ __forceinline__ void lane_split_chunks(
    const float* __restrict__ feats, const int* __restrict__ w0b,
    const int* __restrict__ rows, const int* __restrict__ los,
    const int* __restrict__ has, const int* __restrict__ counts,
    const float* __restrict__ data_t, const float* __restrict__ wide_t,
    float* __restrict__ a12d, int* __restrict__ ovf, int n_chunks, int blk,
    int w_sl, int k_ext, int wc, int k_occ, int cap, int chunk0) {
  extern __shared__ float4 xyrd[];   // NL * cap columns, then ang, halfw
  float* ang = reinterpret_cast<float*>(xyrd + NL * cap);
  float* halfw = ang + NL * cap;
  const int l_me = NL == 1 ? 0 : threadIdx.x / (NB * G);   // per warp
  const int sub = threadIdx.x % G;
  const int beam = blockIdx.y * NB + (threadIdx.x % (NB * G)) / G;
  const bool active = beam < blk;
  const int chunk = chunk0 + l_me;
  const size_t n2 = (size_t)n_chunks * blk;
  const ChunkList l0(rows, los, counts, data_t, wide_t, chunk0,
                     !kGated || has[chunk0] != 0, w_sl, k_ext, wc);
  const ChunkList l1 =
      NL == 1 ? l0
              : ChunkList(rows, los, counts, data_t, wide_t, chunk0 + 1,
                          !kGated || has[chunk0 + 1] != 0, w_sl, k_ext, wc);
  const int n_max = max(l0.n_tot, l1.n_tot);
  const int n_me = l_me ? l1.n_tot : l0.n_tot;
  const Beam b(feats + ((size_t)w0b[chunk] * blk + min(beam, blk - 1)) *
                           kFeat);
  const float4* my_xyrd = xyrd + l_me * cap;
  const float* my_ang = ang + l_me * cap;
  const float* my_halfw = halfw + l_me * cap;
  LaneTopK<KMAX> top;
  int n_hit = 0;   // a register; top's counters live with its lists
  for (int c0 = 0; c0 < n_max; c0 += cap) {
    if (c0 > 0) __syncthreads();   // the last pass's tests are done
    l0.stage(c0, min(cap, l0.n_tot - c0), xyrd, ang, halfw);
    if (NL == 2)
      l1.stage(c0, min(cap, l1.n_tot - c0), xyrd + cap, ang + cap,
               halfw + cap);
    __syncthreads();
    if (!active) continue;
    const int n_t = min(cap, n_me - c0);
#pragma unroll 4
    for (int j = sub; j < n_t; j += G) {
      const float4 q = my_xyrd[j];
      const float pang = my_ang[j];
      bool right_hit, left_hit;
      const bool hit =
          hit_test(b, q.x, q.y, q.z, q.w, pang, right_hit, left_hit);
      n_hit += hit ? 1 : 0;
      if (hit && top.takes(q.w, k_occ)) {   // rare: a kept hit
        float v1, v2;
        interval(b, pang, my_halfw[j], right_hit, left_hit, v1, v2);
        top.insert(q.w, v1, v2, c0 + j, k_occ);
      }
    }
  }
  top.n_hit = n_hit;
  merge_write<G>(top, a12d, ovf, n2, (size_t)chunk * blk + beam, k_occ, sub,
                 active);
}

// A1: 4 lanes a beam, 64 beams a CTA (a chunk spans blk / 64 CTAs), up to
// 2,048 staged columns a pass (48 KB), the has gate.
constexpr int kLanesA1 = 4;
constexpr int kBeamsA1 = 64;
constexpr int kTileA1 = 2048;
// A4a and A4b: every chunk; the splits are the fastest of the variants
// timed on the card (scripts/a4_sweep.py, PERF.md section 6). A4a: 8
// lanes a beam, 64 beams a CTA (512 threads). A4b: chunks 2i and 2i + 1
// in one CTA, each on 32 beams of 8 lanes (512 threads, two 1,408-column
// lists in 66 KB at the bench).
constexpr int kLanesA4a = 8;
constexpr int kBeamsA4a = 64;
constexpr int kTileA4a = 2048;
constexpr int kLanesA4b = 8;
constexpr int kBeamsA4b = 32;
constexpr int kTileA4b = 2048;

#define LANE_SPLIT_ARGS                                                    \
  const float* __restrict__ feats, const int* __restrict__ w0b,           \
      const int* __restrict__ rows, const int* __restrict__ los,          \
      const int* __restrict__ counts, const float* __restrict__ data_t,   \
      const float* __restrict__ wide_t, float* __restrict__ a12d,         \
      int* __restrict__ ovf, int n_chunks, int blk, int w_sl, int k_ext,  \
      int wc, int k_occ, int cap

template <int KMAX>
__global__ void __launch_bounds__(kLanesA1 * kBeamsA1)
    a1_kernel(const int* __restrict__ has, LANE_SPLIT_ARGS) {
  lane_split_chunks<KMAX, kLanesA1, kBeamsA1, 1, true>(
      feats, w0b, rows, los, has, counts, data_t, wide_t, a12d, ovf,
      n_chunks, blk, w_sl, k_ext, wc, k_occ, cap, blockIdx.x);
}

template <int KMAX>
__global__ void __launch_bounds__(kLanesA4a * kBeamsA4a)
    a4a_kernel(LANE_SPLIT_ARGS) {
  lane_split_chunks<KMAX, kLanesA4a, kBeamsA4a, 1, false>(
      feats, w0b, rows, los, nullptr, counts, data_t, wide_t, a12d, ovf,
      n_chunks, blk, w_sl, k_ext, wc, k_occ, cap, blockIdx.x);
}

template <int KMAX>
__global__ void __launch_bounds__(2 * kLanesA4b * kBeamsA4b)
    a4b_kernel(LANE_SPLIT_ARGS) {
  lane_split_chunks<KMAX, kLanesA4b, kBeamsA4b, 2, false>(
      feats, w0b, rows, los, nullptr, counts, data_t, wide_t, a12d, ovf,
      n_chunks, blk, w_sl, k_ext, wc, k_occ, cap, 2 * blockIdx.x);
}

#undef LANE_SPLIT_ARGS

// Launch a lane-split kernel (NL chunks a CTA, G lanes and NB beams a chunk)
// with its tile of min(w_sl + wc, tile) columns a chunk, raising the
// kernel's dynamic shared-memory limit past 48 KB where it needs more.
// Returns the first CUDA error.
template <int NL, int G, int NB, typename Kernel, typename... Args>
int launch_lane_split(Kernel kernel, int tile, int n_chunks, int blk,
                      int w_sl, int wc, cudaStream_t s, Args... args) {
  const int cap = max(1, min(w_sl + wc, tile));
  const int smem =
      NL * cap * static_cast<int>(sizeof(float4) + 2 * sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_chunks / NL, (blk + NB - 1) / NB);
  kernel<<<grid, NL * NB * G, smem, s>>>(args..., cap);
  return static_cast<int>(cudaGetLastError());
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
  DISPATCH_K(k_occ, return launch_lane_split<1, kLanesA1, kBeamsA1>(
      a1_kernel<KMAX>, kTileA1, n_chunks, blk, w_sl, wc, s, has, feats, w0b,
      rows, los, counts, data_t, wide_t, a12d, ovf, n_chunks, blk, w_sl,
      k_ext, wc, k_occ))
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

// A1's function on every chunk, each beam's candidates split over
// kLanesA4a lanes (kernel A4a). Arguments as occluders_a1 without has.
extern "C" int occluders_a4a(
    const float* feats, const int* w0b, const int* rows, const int* los,
    const int* counts, const float* data_t, const float* wide_t, float* a12d,
    int* ovf, int n_chunks, int blk, int w_sl, int k_ext, int wc, int k_occ,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  DISPATCH_K(k_occ, return launch_lane_split<1, kLanesA4a, kBeamsA4a>(
      a4a_kernel<KMAX>, kTileA4a, n_chunks, blk, w_sl, wc, s, feats, w0b,
      rows, los, counts, data_t, wide_t, a12d, ovf, n_chunks, blk, w_sl,
      k_ext, wc, k_occ))
}

// A1's function on every chunk, chunks 2i and 2i + 1 in one CTA (kernel
// A4b). Arguments as occluders_a4a; n_chunks must be even.
extern "C" int occluders_a4b(
    const float* feats, const int* w0b, const int* rows, const int* los,
    const int* counts, const float* data_t, const float* wide_t, float* a12d,
    int* ovf, int n_chunks, int blk, int w_sl, int k_ext, int wc, int k_occ,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  if (n_chunks % 2) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_K(k_occ, return launch_lane_split<2, kLanesA4b, kBeamsA4b>(
      a4b_kernel<KMAX>, kTileA4b, n_chunks, blk, w_sl, wc, s, feats, w0b,
      rows, los, counts, data_t, wide_t, a12d, ovf, n_chunks, blk, w_sl,
      k_ext, wc, k_occ))
}
