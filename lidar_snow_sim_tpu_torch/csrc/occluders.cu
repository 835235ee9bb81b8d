// Kernels A1, A2, A3, A4a and A4b: nearest-K occluders for each (channel,
// azimuth)-sorted beam, phase A of the dense snowfall assembly; kernel W1:
// the window assembly's occluders (see w1_kernel at the end).
//
// Replaces, in lidar_snow_sim_tpu/ops/pallas_occluders.py:
//   A1 `_kernel` (with `_prep_side`, `_extract_step`): every beam of a chunk
//      of `blk` consecutive sorted beams against one bank slice
//      data_t[row, :, lo:lo+w_sl] plus the row's whole wide list;
//   A2 `_kernel_routed`: per chunk mode 0 (dead: sentinels), mode 1 (A1's
//      function) or mode 2 (each band_group of beams against its own band
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
// live chunks), A2's mode-2 chunks 384 + 32 and A3 at most 2 x band + 32,
// while each staged column is 24 bytes read once per CTA (most of it from
// L2). So the count of instructions per test, how many warps each SM has
// in flight to hide their latency, and how evenly the CTAs fill the SMs set
// the time; for A2 and A3, whose CTAs test ~100 columns a lane against
// A1's 352, also each CTA's fixed costs (its hull, staging and merge).
//
// One body computes A1's function for all five. A CTA stages a candidate
// list in shared memory, column order kept (ChunkList): a bank range
// [c_lo, c_hi) of its chunk's row, then a prefix wide[:w_n] of the row's
// wide list, cap columns a pass (a longer list streams through in passes),
// as structures, {x, y, r, dist} in one float4 plus the angle: one LDS.128
// and one LDS.32 a test, the half-width only for a kept hit. A beam's
// candidates are split over G lanes (lane s tests s, s + G, ...); each lane
// tests with the branch-free hit_test, the hit count in a register and the
// insertion behind one compare against its K-th kept range (test_span),
// then merge_write joins the lanes' lists, exact for lax.top_k's "value,
// then lowest index" with the staged position as the index (it ascends
// along every beam's list). The first ports gave one thread a beam and one
// CTA of 4 warps a chunk, with six scalar shared loads, a branch on every
// test and the bounds re-derived every tile: 46 SASS instructions a no-hit
// test, against 31.75-33.25 now (scripts/sass_loops.py).
//   - A1, A4a, A4b and A2's mode 1 (lane_split_chunks): the list is the
//     chunk's slice [lo, lo + n_s) then wide[:wc], and every beam tests all
//     of it. A1 gates on has; A4b puts chunks 2i and 2i + 1 in one CTA, as
//     two groups of threads with their lists in separate regions of the
//     dynamic shared memory (the pair costs no occupancy), which is how it
//     replaces `_kernel_pair`'s interleaved chains; A4a replaces
//     `_kernel_t`'s beam across the sublanes by the lane split itself.
//   - A2's mode 2 and A3 (band_chunk): after the wrap-pad dedup a beam's
//     list is at most two runs of ascending bank columns (A2: its group's
//     band; A3: band A, then band B's columns past band A) and the wide
//     prefix. The CTA stages the hull of its own groups' runs, not the
//     chunk's, and each beam tests its runs only; with band_group >= the
//     beams of a warp their bounds are uniform across the warp. A2's mode
//     is uniform per chunk, so per CTA; its mode-1 chunks test ~3.4x a
//     mode-2 chunk's columns a beam, so they run on more lanes a beam over
//     more CTAs (a second grid row), which keeps them from setting the
//     kernel's length. A3 computes every chunk, as `_kernel_banded` does,
//     and writes each beam's coverage flag.
// The splits (lanes a beam, beams a CTA, columns a pass) are chosen on the
// card (scripts/phase_a_sweep.py, PERF.md section 6).
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

// A CTA's staged candidate list: bank columns [c_lo, c_lo + n_s) of its
// chunk's row, in column order, then the row's first w_n wide columns;
// n_tot = 0 for a chunk that is not computed.
struct ChunkList {
  const float* bank;   // property row 0 of the bank row, at column c_lo
  const float* wide;
  int n_s, n_tot, k_ext, wc;

  // A1's list of a chunk: the slice [lo, lo + w_sl) up to one wrap period
  // (counts[row] columns) and the row's end, then all wc wide columns.
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

  // Bank columns [c_lo, c_lo + n_s) of row `row`, then wide[:w_n].
  __device__ ChunkList(const float* data_t, const float* wide_t, int row,
                       int c_lo, int n_s_, int w_n, bool computed,
                       int k_ext_, int wc_)
      : bank(data_t + (size_t)row * kProp * k_ext_ + c_lo),
        wide(wide_t + (size_t)row * kProp * wc_), n_s(n_s_),
        n_tot(computed ? n_s_ + w_n : 0), k_ext(k_ext_), wc(wc_) {}

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

// Test the beam against staged columns j0, j0 + G, ... below j1 of the
// current pass (base: the pass's first staged position): the branch-free hit
// test, the hit count in a register, the insertion behind one compare
// against the K-th kept range.
template <int G, int KMAX>
__device__ __forceinline__ void test_span(
    const Beam& b, LaneTopK<KMAX>& top, int& n_hit, const float4* xyrd,
    const float* ang, const float* halfw, int j0, int j1, int base,
    int k_occ) {
#pragma unroll 4
  for (int j = j0; j < j1; j += G) {
    const float4 q = xyrd[j];
    const float pang = ang[j];
    bool right_hit, left_hit;
    const bool hit =
        hit_test(b, q.x, q.y, q.z, q.w, pang, right_hit, left_hit);
    n_hit += hit ? 1 : 0;
    if (hit && top.takes(q.w, k_occ)) {   // rare: a kept hit
      float v1, v2;
      interval(b, pang, halfw[j], right_hit, left_hit, v1, v2);
      top.insert(q.w, v1, v2, base + j, k_occ);
    }
  }
}

// A1's function on NL chunks per CTA (1, or 2 for A4b; A1, A4a, A4b and
// A2's mode-1 chunks): thread group l,
// threads [l * NB * G, (l + 1) * NB * G), holds beams blockIdx.y * NB ...
// + NB - 1 of chunk chunk0 + l, G lanes a beam. The CTA stages every
// chunk's list, cap columns a pass, each in its own region of the dynamic
// shared memory (NL * cap * 24 bytes: NL * cap float4, then the angles,
// then the half-widths). Lane s of a beam tests its chunk's candidates s,
// s + G, ... with the branch-free hit test, the hit count in a register and
// the insertion behind one compare against the K-th kept range; then
// merge_write joins the lanes' lists in lax.top_k order, with each chunk's
// own candidate indices. kGated: a chunk with has == 0 is not computed and
// gets sentinels (A1); otherwise every chunk is computed. Every thread of
// the CTA must call it. (A pass loop shared with band_chunk, its bounds
// per beam, cost A1, A4a and A4b 2.5-3.3% and spills: PERF.md section 6.)
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
    test_span<G>(b, top, n_hit, my_xyrd, my_ang, my_halfw, sub, n_t, c0,
                 k_occ);
  }
  top.n_hit = n_hit;
  merge_write<G>(top, a12d, ovf, n2, (size_t)chunk * blk + beam, k_occ, sub,
                 active);
}

// Group g's bank-column runs, one copy a wrap period (cnt columns). A2 (lb
// null): its band [s, min(s + min(band, cnt), k_ext)). A3: band A
// [la, min(la + band, end)), then band B's columns past band A,
// [max(lb, la + band), min(lb + band, end)), end = min(la + cnt, k_ext).
struct Bands {
  int lo0, hi0, lo1, hi1;
};

__device__ __forceinline__ Bands group_bands(const int* la, const int* lb,
                                             int g, int band, int cnt,
                                             int k_ext) {
  const int a = la[g];
  if (lb == nullptr) return {a, min(a + min(band, cnt), k_ext), 0, 0};
  const int end = min(a + cnt, k_ext);
  const int b = lb[g];
  return {a, min(a + band, end), max(b, a + band), min(b + band, end)};
}

// A2's mode 2 (gla = gloa, glb null) and A3 (gla = gloa, glb = glob) on
// chunk `chunk`: beams blockIdx.y * NB ... + NB - 1, G lanes a beam, with
// lane_split_chunks' staging, test loop, top-K and merge. The CTA stages
// the hull of its own groups' runs, then wide[:wide_sl], cap columns a
// pass; each beam tests its group's runs, then the wide prefix, in list
// order, their bounds clipped to the pass once a pass. The staged position
// is the candidate index: it ascends along every beam's list. computed =
// false (A2's mode 0): an empty list, so sentinels and overflow 0.
template <int KMAX, int G, int NB>
__device__ __forceinline__ void band_chunk(
    const int* __restrict__ gla, const int* __restrict__ glb, bool computed,
    int band, int group, int wide_sl, const float* __restrict__ feats,
    const int* __restrict__ w0b, const int* __restrict__ rows,
    const int* __restrict__ counts, const float* __restrict__ data_t,
    const float* __restrict__ wide_t, float* __restrict__ a12d,
    int* __restrict__ ovf, int n_chunks, int blk, int k_ext, int wc,
    int k_occ, int cap, int chunk) {
  const int beam0 = blockIdx.y * NB;
  const int beam = beam0 + threadIdx.x / G;
  const int row = rows[chunk];
  const int cnt = counts[row];
  const size_t g0 = (size_t)chunk * (blk / group);
  const int* la = gla + g0;
  const int* lb = glb == nullptr ? nullptr : glb + g0;
  int c_lo = k_ext, c_hi = 0;
  for (int g = beam0 / group; g <= (min(beam0 + NB, blk) - 1) / group; ++g) {
    const Bands r = group_bands(la, lb, g, band, cnt, k_ext);
    if (r.lo0 < r.hi0) { c_lo = min(c_lo, r.lo0); c_hi = max(c_hi, r.hi0); }
    if (r.lo1 < r.hi1) { c_lo = min(c_lo, r.lo1); c_hi = max(c_hi, r.hi1); }
  }
  const int n_s = max(c_hi - c_lo, 0);
  if (n_s == 0) c_lo = 0;
  const ChunkList l(data_t, wide_t, row, c_lo, n_s, wide_sl, computed,
                    k_ext, wc);
  const Bands r = group_bands(la, lb, min(beam, blk - 1) / group, band, cnt,
                              k_ext);
  const int lo[3] = {r.lo0 - c_lo, r.lo1 - c_lo, n_s};
  const int hi[3] = {r.hi0 - c_lo, r.hi1 - c_lo, n_s + wide_sl};
  const Beam b(feats + ((size_t)w0b[chunk] * blk + min(beam, blk - 1)) *
                           kFeat);
  extern __shared__ float4 xyrd[];   // cap columns, then ang, halfw
  float* ang = reinterpret_cast<float*>(xyrd + cap);
  float* halfw = ang + cap;
  const int sub = threadIdx.x % G;
  const bool active = beam < blk;
  LaneTopK<KMAX> top;
  int n_hit = 0;
  for (int c0 = 0; c0 < l.n_tot; c0 += cap) {
    if (c0 > 0) __syncthreads();   // the last pass's tests are done
    const int n_t = min(cap, l.n_tot - c0);
    l.stage(c0, n_t, xyrd, ang, halfw);
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int r = 0; r < 3; ++r)   // in list order: ascending positions
      test_span<G>(b, top, n_hit, xyrd, ang, halfw, max(lo[r] - c0, 0) + sub,
                   min(hi[r] - c0, n_t), c0, k_occ);
  }
  top.n_hit = n_hit;
  merge_write<G>(top, a12d, ovf, (size_t)n_chunks * blk,
                 (size_t)chunk * blk + beam, k_occ, sub, active);
}

// The splits: lanes a beam, beams a CTA, columns a pass (cap). A1: 4 x 64
// (a chunk spans blk / 64 CTAs), 2,048 columns (48 KB), the has gate.
// A4a, A4b, A2 and A3: the fastest of the variants timed on the card
// (scripts/phase_a_sweep.py, PERF.md section 6). A4a: 8 lanes a beam, 64
// beams a CTA (512 threads). A4b: chunks 2i and 2i + 1 in one CTA, each on
// 32 beams of 8 lanes (512 threads, two 1,408-column lists in 66 KB at the
// bench). A2: mode 2 on 4 lanes x 64 beams, mode 1 on the same 256
// threads as 32 lanes x 8 beams (a mode-1 chunk on 16 CTAs, not 2). A3:
// 4 x 64 with 1,024-column passes (24 KB).
constexpr int kLanesA1 = 4;
constexpr int kBeamsA1 = 64;
constexpr int kTileA1 = 2048;
constexpr int kLanesA4a = 8;
constexpr int kBeamsA4a = 64;
constexpr int kTileA4a = 2048;
constexpr int kLanesA4b = 8;
constexpr int kBeamsA4b = 32;
constexpr int kTileA4b = 2048;
constexpr int kLanesA2 = 4;
constexpr int kBeamsA2 = 64;
constexpr int kTileA2 = 2048;
constexpr int kLanesA2s = 32;
constexpr int kBeamsA2s = 8;
constexpr int kLanesA3 = 4;
constexpr int kBeamsA3 = 64;
constexpr int kTileA3 = 1024;
static_assert(kLanesA2 * kBeamsA2 == kLanesA2s * kBeamsA2s,
              "A2's two modes share the CTA's threads");

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

// A2: the mode is uniform per chunk, so per CTA. The grid has rows enough
// for the narrower of the two splits; a CTA past its mode's beams exits.
template <int KMAX>
__global__ void __launch_bounds__(kLanesA2 * kBeamsA2)
    a2_kernel(const int* __restrict__ gloa, const int* __restrict__ mode,
              int band, int group, int wide_sl, LANE_SPLIT_ARGS) {
  const int chunk = blockIdx.x;
  const int m = mode[chunk];
  if (m == 1) {
    if (blockIdx.y * kBeamsA2s < blk)
      lane_split_chunks<KMAX, kLanesA2s, kBeamsA2s, 1, false>(
          feats, w0b, rows, los, nullptr, counts, data_t, wide_t, a12d, ovf,
          n_chunks, blk, w_sl, k_ext, wc, k_occ, cap, chunk);
  } else if (blockIdx.y * kBeamsA2 < blk) {
    band_chunk<KMAX, kLanesA2, kBeamsA2>(
        gloa, nullptr, m == 2, band, group, wide_sl, feats, w0b, rows,
        counts, data_t, wide_t, a12d, ovf, n_chunks, blk, k_ext, wc, k_occ,
        cap, chunk);
  }
}

// A3: every chunk, then each beam's coverage flag (one lane a beam): its
// sort-angle window [az - delta, az + delta] lies inside band A, band B or
// (when they overlap or adjoin) their union.
template <int KMAX>
__global__ void __launch_bounds__(kLanesA3 * kBeamsA3)
    a3_kernel(const int* __restrict__ gloa, const int* __restrict__ glob,
              int* __restrict__ unc, int band, int group, int wide_sl,
              float delta, LANE_SPLIT_ARGS) {
  const int chunk = blockIdx.x;
  band_chunk<KMAX, kLanesA3, kBeamsA3>(
      gloa, glob, true, band, group, wide_sl, feats, w0b, rows, counts,
      data_t, wide_t, a12d, ovf, n_chunks, blk, k_ext, wc, k_occ, cap,
      chunk);
  const int beam = blockIdx.y * kBeamsA3 + threadIdx.x / kLanesA3;
  if (beam >= blk || threadIdx.x % kLanesA3 != 0) return;
  const int row = rows[chunk];
  const int cnt = counts[row];
  const size_t g = (size_t)chunk * (blk / group) + beam / group;
  const int la = gloa[g], lb = glob[g];
  const float* sang = data_t + ((size_t)row * kProp + kSangRow) * k_ext;
  const float s_a0 = sang[min(la, k_ext - 1)];
  const float s_a1 = sang[min(la + band - 1, k_ext - 1)];
  const float s_b0 = sang[min(lb, k_ext - 1)];
  const float s_b1 = sang[min(lb + band - 1, k_ext - 1)];
  const float az = feats[((size_t)w0b[chunk] * blk + beam) * kFeat + 8];
  const float need_l = az - delta;
  const float need_r = az + delta;
  const bool in_a = (s_a0 <= need_l) && (need_r <= s_a1);
  const bool in_b = (s_b0 <= need_l) && (need_r <= s_b1);
  const bool in_j = (lb - la <= band) && (s_a0 <= need_l) && (need_r <= s_b1);
  const bool covered = (cnt <= band) || in_a || in_b || in_j;
  unc[(size_t)chunk * blk + beam] = covered ? 0 : 1;
}

#undef LANE_SPLIT_ARGS

// Kernel W1: the window assembly's nearest-K occluders. It replaces no TPU
// kernel: the JAX package computes them in XLA inside its lax.map over
// point chunks (`_occluder_phase` on `chunk_fn`'s gathered candidates,
// lidar_snow_sim_tpu/models/snowfall.py:112-148, 352-373), and the port's
// plain version, ops/occluders.occluders_window_plain, gathers a (P, 384,
// 4) block a chunk. Each live point tests its own list: window_size bank
// columns lo, lo + 1, ... of its row (clamped to the row's last column;
// an entry whose sort angle lies outside the point's window [center -
// delta, center + delta] takes range 1e9, which fails the range test),
// then the row's n_wide wide columns; it keeps the K nearest hits in
// lax.top_k's order (range, then list position) and writes them as (n, K)
// rows with an empty slot's a1 = a2 = 0, dist = inf, valid = false, and
// the hits beyond K. A point that is not live (live[p] false; a null live
// means every point) gets the empty row and overflow 0 without a test.
//
// Its hit test is the plain version's, candidate_intervals
// (ops/geometry.py), not A1's hit_test: the half-plane test of an edge is
// cos(edge - pang) > 0 (A1 takes the sign of a dot product), and pang and
// the interval ends wrap(pang -+ asin(r / d)) come from per-column tables
// made once a bank with torch's own atan2 and asin (ops/occluders.
// window_angles, in models/snowfall.bank_to_torch), since a column's values
// do not depend on the point; the plain version reads the same tables.
// The sign of that cosine is decided without cosf (cos_positive), as
// exactly. The point's
// features (point_features: range, edges, their sin and cos, and feature
// 8, the centre azimuth) are the rows kernel W2 reads too; the window
// bounds are feature 8 -+ delta, one float operation each, as torch's.
//
// What bounds it: at the bench's 50,475 live points a point's window holds
// ~37 of its 256 columns and its row ~1 real wide particle of 128, and it
// writes 13 bytes a slot, ~42 MB at K = 64 for the live points (~13 us at
// 3.35 TB/s); its bound is the bytes (chip_smoke's window_occluder_bound),
// its time the instructions each point's warp issues (PERF.md). No tensor
// cores: there is no product to give them. The design:
//   - one warp a point, kWarpsW1 warps a CTA over kPointsW1 consecutive
//     points. The points are channel-sorted with the padding last, so a
//     CTA's points mostly share one bank row and their windows overlap; a
//     CTA of padding only writes empty rows.
//   - the CTA stages its points' features, rows, starts and live flags,
//     and the union of its live points' windows on the row of its first
//     live point ([min lo, max lo + window - 1], clamped to the row) in
//     shared memory with cp.async: the x, y, r, dist and sort-angle rows
//     of data_t and the pang, start, end rows of ang_t, and the row's
//     n_wide wide columns (x, y, r, dist of wide_t, the three rows of
//     wang_t). A point on another row (a CTA across a channel boundary),
//     or every point of a CTA whose span or wide list exceeds the staging
//     room (kSpanW1, kWideW1), reads the same values from global memory
//     with the same arithmetic (GlobalCols).
//   - work skipped exactly: a point's window columns ascend in sort angle
//     (checked on the staged span), so once a run of 32 starts past the
//     window's upper bound no later column is in the window, and an
//     out-of-window column (range 1e9) cannot hit a point nearer than
//     1e9; and a staged wide column past the last one nearer than the
//     CTA's farthest live point fails every range test (the bank's wide
//     lists are mostly padding at range 1e9).
//   - no top-K list a thread: a ballot appends the warp's hits (range,
//     list position, a1, a2) to its buffer of kHitsW1 in shared memory.
//     When a hit would not fit, the buffer is cut to its T smallest (rank
//     by counting; T = min(K - written, kHitsW1 / 2)), and from then on
//     only a hit below the T-th enters. At the end of the list the buffer
//     is ranked in lax.top_k's order and its first min(count, K) hits (T
//     after a cut) are written; a point with more hits than that takes
//     another pass over its list for the hits after the last one written,
//     until min(K, hits) are out. Live points have a handful of hits, so
//     one pass.
//   - row p's K slots (sentinels included) go out as contiguous stores,
//     32 slots a warp instruction, from the ranked buffer.
constexpr int kWarpsW1 = 8;       // warps a CTA
constexpr int kCtasW1 = 1;        // CTAs an SM asked of __launch_bounds__
constexpr int kPointsW1 = 32;     // consecutive points a CTA (<= 32)
constexpr int kSpanW1 = 1024;     // bank columns a CTA can stage
constexpr int kWideW1 = 128;      // wide columns a CTA can stage
constexpr int kHitsW1 = 64;       // a warp's hit buffer (a multiple of 32)
constexpr int kBankRowsW1 = 8;    // staged rows: x, y, r, dist, sort angle,
                                  // pang, start, end
constexpr int kWideRowsW1 = 7;    // x, y, r, dist, pang, start, end
constexpr unsigned kFullW1 = 0xffffffffu;
// a cut keeps at most kHitsW1 / 2 hits, and an iteration adds at most 32
static_assert(kPointsW1 <= 32 && kHitsW1 % 32 == 0 && kHitsW1 >= 64,
              "W1's shape");

// Whether cos(x) > 0, as torch.cos(x) > 0 decides it, for a float x with
// |x| < 5 pi / 2 (here x = edge - pang, both in [0, 2 pi]): a faithful
// cosine never has the wrong sign, and cos of a float is never 0, so the
// sign is the true cosine's, positive iff |x| < pi / 2 or |x| > 3 pi / 2;
// no float equals either bound, so for a float |x| that is |x| below the
// first float above pi / 2 (0x3fc90fdb) or above the last float below
// 3 pi / 2 (0x4096cbe3). chip_smoke.py holds this against torch.cos on
// every float with |x| <= 7 (trig_proof). It keeps cosf, whose
// large-argument reduction works in local memory, out of the kernel.
__device__ __forceinline__ bool cos_positive(float x) {
  const float a = fabsf(x);
  return a < __int_as_float(0x3fc90fdb) || a > __int_as_float(0x4096cbe3);
}

// The window assembly's hit test of candidate (px, py, pr, pang), its
// range already found below the point's d_orig: the centre inside the
// beam, or an edge ray within r of the centre on the centre's side.
__device__ __forceinline__ bool window_hit(const Beam& b, float px, float py,
                                           float pr, float pang,
                                           bool& right_hit, bool& left_hit) {
  const bool center_in = ((b.lo_a <= pang) & (pang <= b.hi_a)) |
                         ((b.lo_b <= pang) & (pang <= b.hi_b));
  right_hit = fabsf(px * b.sin_r - py * b.cos_r) < pr &&
              cos_positive(b.right - pang);
  left_hit = fabsf(px * b.sin_l - py * b.cos_l) < pr &&
             cos_positive(b.left - pang);
  return center_in | right_hit | left_hit;
}

// A candidate list's columns in global memory: property rows at stride ld
// (data_t's x, y, r, dist and sort angle, or wide_t's first four) and the
// angle rows [pang, start, end] at stride lda.
struct GlobalCols {
  const float* __restrict__ d;
  const float* __restrict__ a;
  int ld, lda;
  __device__ float x(int c) const { return d[c]; }
  __device__ float y(int c) const { return d[ld + c]; }
  __device__ float r(int c) const { return d[2 * ld + c]; }
  __device__ float dist(int c) const { return d[3 * ld + c]; }
  __device__ float sang(int c) const { return d[kSangRow * ld + c]; }
  __device__ float pang(int c) const { return a[c]; }
  __device__ float start(int c) const { return a[lda + c]; }
  __device__ float end(int c) const { return a[2 * lda + c]; }
};

// The same columns staged in shared memory from column c0 on, one row of
// S floats a property: x, y, r, dist, then the sort angle (bank only),
// then pang, start, end.
template <int S, bool kBank>
struct SharedCols {
  const float* s;
  int c0;
  static constexpr int kA = kBank ? 5 : 4;   // the first angle row
  __device__ float x(int c) const { return s[c - c0]; }
  __device__ float y(int c) const { return s[S + c - c0]; }
  __device__ float r(int c) const { return s[2 * S + c - c0]; }
  __device__ float dist(int c) const { return s[3 * S + c - c0]; }
  __device__ float sang(int c) const { return s[4 * S + c - c0]; }
  __device__ float pang(int c) const { return s[kA * S + c - c0]; }
  __device__ float start(int c) const { return s[(kA + 1) * S + c - c0]; }
  __device__ float end(int c) const { return s[(kA + 2) * S + c - c0]; }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Copy n columns from c0 on of R rows (row i at src[i], stride S in
// shared memory) with the CTA's threads; the caller waits and syncs.
template <int R>
__device__ __forceinline__ void stage_rows(float* s,
                                           const float* const (&src)[R],
                                           int S, int c0, int n) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    for (int c = threadIdx.x; c < n; c += blockDim.x)
      cp_async4(s + i * S + c, src[i] + c0 + c);
}

// lax.top_k's order on hits: nearer first, equal ranges by list position.
__device__ __forceinline__ bool key_less(float d, int j, float od, int oj) {
  return d < od || (d == od && j < oj);
}

// A warp's hit buffer in shared memory.
struct HitBuf {
  float* d;
  float* a1;
  float* a2;
  int* j;
};

// Rank the warp's `count` buffered hits in lax.top_k's order and move the
// first `keep` of them to positions 0 .. keep - 1, in order; returns the
// key (range, position) of the last one kept through od, oj. Every lane of
// the warp calls it, with count <= kHitsW1.
__device__ void rank_keep(const HitBuf& h, int count, int keep, int lane,
                          float& od, int& oj) {
  constexpr int U = kHitsW1 / 32;
  float d[U], a1[U], a2[U];
  int j[U], rank[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = lane + 32 * u;
    rank[u] = kHitsW1;
    if (i < count) {
      d[u] = h.d[i];
      j[u] = h.j[i];
      a1[u] = h.a1[i];
      a2[u] = h.a2[i];
      int r = 0;
      for (int t = 0; t < count; ++t) r += key_less(h.d[t], h.j[t], d[u], j[u]);
      rank[u] = r;
    }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (rank[u] < keep) {
      h.d[rank[u]] = d[u];
      h.j[rank[u]] = j[u];
      h.a1[rank[u]] = a1[u];
      h.a2[rank[u]] = a2[u];
    }
  }
  __syncwarp();
  od = h.d[keep - 1];
  oj = h.j[keep - 1];
}

// One pass's state of a point's selection (every value warp-uniform).
struct Selection {
  int count = 0;              // hits in the buffer
  int n_hit = 0;              // hits counted (first pass)
  bool first = true;          // the first pass counts every hit
  bool cut = false;           // the buffer was cut to its T smallest
  int take = 0;               // T
  float last_d = -INFINITY;   // the last hit written: later passes take
  int last_j = -1;            // only hits after it
  float thr_d = INFINITY;     // after a cut: only hits before the T-th
  int thr_j = 0x7fffffff;
};

// Offer one candidate a lane (hit h at key (d, j), interval [v1, v2]) to
// the warp's buffer. Every lane of the warp calls it.
__device__ __forceinline__ void offer(Selection& sel, const HitBuf& hb,
                                      bool h, float d, int j, float v1,
                                      float v2, int lane) {
  const unsigned hits = __ballot_sync(kFullW1, h);
  if (hits == 0u) return;
  if (sel.first) sel.n_hit += __popc(hits);
  bool e = h && key_less(sel.last_d, sel.last_j, d, j) &&
           key_less(d, j, sel.thr_d, sel.thr_j);
  unsigned bits = __ballot_sync(kFullW1, e);
  if (sel.count + __popc(bits) > kHitsW1) {
    rank_keep(hb, sel.count, sel.take, lane, sel.thr_d, sel.thr_j);
    sel.count = sel.take;
    sel.cut = true;
    e = e && key_less(d, j, sel.thr_d, sel.thr_j);
    bits = __ballot_sync(kFullW1, e);
  }
  if (e) {
    const int at = sel.count + __popc(bits & ((1u << lane) - 1u));
    hb.d[at] = d;
    hb.j[at] = j;
    hb.a1[at] = v1;
    hb.a2[at] = v2;
  }
  sel.count += __popc(bits);
  __syncwarp();
}

// One pass over a point's window columns (kWindow: clamped bank columns
// lo + j, with the sort-angle test; list positions j) or its wide columns
// (list positions j_base + j). With `ends` (a sorted bank row, and a point
// whose out-of-window columns, at range 1e9, fail the range test), the
// window pass stops at the first 32 columns whose first is past hi_ang:
// the columns ascend, so every later one is out of the window.
template <bool kWindow, typename Cols>
__device__ void scan_list(Selection& sel, const HitBuf& hb, const Cols& src,
                          const Beam& b, int n_list, int j_base, int lo,
                          int k_last, float lo_ang, float hi_ang, bool ends,
                          int lane) {
  for (int j0 = 0; j0 < n_list; j0 += 32) {
    if (kWindow && ends && src.sang(min(max(lo + j0, 0), k_last)) > hi_ang)
      break;
    const int j = j0 + lane;
    bool h = false, rh = false, lh = false;
    float d = 0.f;
    int c = 0;
    if (j < n_list) {
      c = kWindow ? min(max(lo + j, 0), k_last) : j;
      d = src.dist(c);
      if (kWindow) {
        const float sa = src.sang(c);
        if (!(sa >= lo_ang && sa <= hi_ang)) d = 1e9f;
      }
      if (d < b.d_orig)
        h = window_hit(b, src.x(c), src.y(c), src.r(c), src.pang(c), rh, lh);
    }
    const float v1 = h ? (rh ? b.right : src.start(c)) : 0.f;
    const float v2 = h ? (lh ? b.left : src.end(c)) : 0.f;
    offer(sel, hb, h, d, j_base + j, v1, v2, lane);
  }
}

// Row p's slots [from, K): the buffer's first m hits, then empty slots.
__device__ __forceinline__ void write_slots(const HitBuf& hb, int from, int m,
                                            int to, float* a1, float* a2,
                                            float* dist, bool* valid,
                                            size_t row, int lane) {
  for (int s = from + lane; s < to; s += 32) {
    const int i = s - from;
    const bool v = i < m;
    a1[row + s] = v ? hb.a1[i] : 0.f;
    a2[row + s] = v ? hb.a2[i] : 0.f;
    dist[row + s] = v ? hb.d[i] : INFINITY;
    valid[row + s] = v;
  }
}

// One live point: its passes over window and wide columns, its K slots
// and its overflow. Every lane of the warp calls it.
template <typename Bank, typename Wide>
__device__ void w1_point(const HitBuf& hb, const Bank& bank, const Wide& wide,
                         const Beam& b, float lo_ang, float hi_ang, int lo,
                         bool ends, int k_ext, int window, int n_wide,
                         int wide_tested, int k_occ, float* a1, float* a2,
                         float* dist, bool* valid, int* ovf, int p,
                         int lane) {
  const size_t row = (size_t)p * k_occ;
  Selection sel;
  int written = 0;
  while (true) {
    sel.count = 0;
    sel.cut = false;
    sel.take = min(k_occ - written, kHitsW1 / 2);
    sel.thr_d = INFINITY;
    sel.thr_j = 0x7fffffff;
    scan_list<true>(sel, hb, bank, b, window, 0, lo, k_ext - 1, lo_ang,
                    hi_ang, ends, lane);
    scan_list<false>(sel, hb, wide, b, wide_tested, window, 0, 0, 0.f, 0.f,
                     false, lane);
    const int want = min(k_occ, sel.n_hit);
    const int m = sel.cut ? sel.take : min(sel.count, k_occ - written);
    if (sel.count > 1) {
      rank_keep(hb, sel.count, m, lane, sel.last_d, sel.last_j);
    } else if (m == 1) {   // one hit: already in place
      sel.last_d = hb.d[0];
      sel.last_j = hb.j[0];
    }
    const bool done = written + m >= want;
    write_slots(hb, written, m, done ? k_occ : written + m, a1, a2, dist,
                valid, row, lane);
    written += m;
    sel.first = false;
    __syncwarp();
    if (done) break;
  }
  if (lane == 0) ovf[p] = sel.n_hit > k_occ ? sel.n_hit - k_occ : 0;
}

__global__ void __launch_bounds__(kWarpsW1 * 32, kCtasW1) w1_kernel(
    const float* __restrict__ feats, const int* __restrict__ rows,
    const int* __restrict__ los, const bool* __restrict__ live,
    const float* __restrict__ data_t, const float* __restrict__ wide_t,
    const float* __restrict__ ang_t, const float* __restrict__ wang_t,
    float* __restrict__ a1, float* __restrict__ a2, float* __restrict__ dist,
    bool* __restrict__ valid, int* __restrict__ ovf, int n, int k_ext, int wc,
    int n_wide, int window, int k_occ, float delta) {
  extern __shared__ float smem[];
  __shared__ int s_row, s_c0, s_c1, s_dmax, s_wide_end;
  __shared__ float s_feat[kPointsW1 * kFeat];
  __shared__ int s_rows[kPointsW1], s_los[kPointsW1], s_live[kPointsW1];
  float* s_bank = smem;
  float* s_wide = s_bank + kBankRowsW1 * kSpanW1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* hbase = s_wide + kWideRowsW1 * kWideW1 + warp * 4 * kHitsW1;
  const HitBuf hb{hbase, hbase + kHitsW1, hbase + 2 * kHitsW1,
                  reinterpret_cast<int*>(hbase + 3 * kHitsW1)};
  const int p0 = blockIdx.x * kPointsW1;
  const int np = min(kPointsW1, n - p0);

  // the CTA's points (features, rows, starts, live flags) in shared
  // memory; the staged row (the first live point's) and its span over the
  // CTA's live points on that row
  for (int i = threadIdx.x; i < np * kFeat; i += blockDim.x)
    cp_async4(s_feat + i, feats + (size_t)p0 * kFeat + i);
  if (warp == 0) {
    const int p = p0 + lane;
    const bool in = lane < np;
    const bool on = in && (live == nullptr || live[p]);
    const int r = in ? rows[p] : -1;
    const int l = in ? los[p] : 0;
    if (in) {
      s_rows[lane] = r;
      s_los[lane] = l;
      s_live[lane] = on;
    }
    const unsigned any = __ballot_sync(kFullW1, on);
    const int first = any ? __ffs(any) - 1 : 0;
    const int row = __shfl_sync(kFullW1, r, first);
    const bool mine = on && r == row;
    int c0 = 0x7fffffff, c1 = -1;
    if (mine) {
      c0 = min(max(l, 0), k_ext - 1);
      c1 = min(max(l + window - 1, 0), k_ext - 1);
    }
    for (int o = 16; o > 0; o >>= 1) {
      c0 = min(c0, __shfl_xor_sync(kFullW1, c0, o));
      c1 = max(c1, __shfl_xor_sync(kFullW1, c1, o));
    }
    if (lane == 0) {
      s_row = any ? row : -1;
      s_c0 = c0;
      s_c1 = c1;
      s_dmax = 0;       // +0.0: the farthest live point's range, as bits
      s_wide_end = 0;   // the staged wide columns a point tests
    }
  }
  __syncthreads();
  const int srow = s_row, c0 = s_c0, span = s_c1 - s_c0 + 1;
  const bool stage_bank = srow >= 0 && window > 0 && span <= kSpanW1;
  const bool stage_wide = srow >= 0 && n_wide > 0 && n_wide <= kWideW1;
  if (stage_bank) {
    const float* bank = data_t + (size_t)srow * kProp * k_ext;
    const float* ang = ang_t + (size_t)srow * 3 * k_ext;
    const float* src[kBankRowsW1] = {bank, bank + k_ext, bank + 2 * k_ext,
                                     bank + 3 * k_ext,
                                     bank + (size_t)kSangRow * k_ext, ang,
                                     ang + k_ext, ang + 2 * k_ext};
    stage_rows(s_bank, src, kSpanW1, c0, span);
  }
  if (stage_wide) {
    const float* w = wide_t + (size_t)srow * kProp * wc;
    const float* wa = wang_t + (size_t)srow * 3 * n_wide;
    const float* src[kWideRowsW1] = {w, w + wc, w + 2 * wc, w + 3 * wc, wa,
                                     wa + n_wide, wa + 2 * n_wide};
    stage_rows(s_wide, src, kWideW1, 0, n_wide);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // whether the staged sort angles ascend (a bank row's do; NaN does not),
  // and the range of the farthest live point on the staged row (ranges
  // are >= 0, so their bits order as ints; a NaN range hits nothing)
  bool unsorted = false;
  if (stage_bank) {
    const float* sang = s_bank + 4 * kSpanW1;
    for (int c = threadIdx.x; c + 1 < span; c += blockDim.x)
      unsorted = unsorted || !(sang[c] <= sang[c + 1]);
  }
  if (threadIdx.x < np && s_live[threadIdx.x] &&
      s_rows[threadIdx.x] == srow && s_feat[threadIdx.x * kFeat] > 0.f)
    atomicMax(&s_dmax, __float_as_int(s_feat[threadIdx.x * kFeat]));
  const bool sorted = !__syncthreads_or(unsorted);
  // a staged wide column past the last one nearer than that point fails
  // every staged point's range test: those columns are not tested
  if (stage_wide) {
    const float dmax = __int_as_float(s_dmax);
    for (int c = threadIdx.x; c < n_wide; c += blockDim.x)
      if (s_wide[3 * kWideW1 + c] < dmax) atomicMax(&s_wide_end, c + 1);
  }
  __syncthreads();
  const int wide_end = s_wide_end;

  for (int q = warp; q < np; q += kWarpsW1) {
    const int p = p0 + q;
    const size_t row_out = (size_t)p * k_occ;
    if (!s_live[q]) {
      write_slots(hb, 0, 0, k_occ, a1, a2, dist, valid, row_out, lane);
      if (lane == 0) ovf[p] = 0;
      continue;
    }
    const float* f = s_feat + q * kFeat;
    const Beam b(f);
    const float lo_ang = f[8] - delta;
    const float hi_ang = f[8] + delta;
    const int row = s_rows[q];
    const int lo = s_los[q];
    const GlobalCols gbank{data_t + (size_t)row * kProp * k_ext,
                           ang_t + (size_t)row * 3 * k_ext, k_ext, k_ext};
    const GlobalCols gwide{wide_t + (size_t)row * kProp * wc,
                           wang_t + (size_t)row * 3 * n_wide, wc, n_wide};
    const SharedCols<kSpanW1, true> sbank{s_bank, c0};
    const SharedCols<kWideW1, false> swide{s_wide, 0};
    const bool on_bank = stage_bank && row == srow;
    const bool on_wide = stage_wide && row == srow;
    // out-of-window columns (range 1e9) cannot hit this point
    const bool ends = on_bank && sorted && !(1e9f < b.d_orig);
    if (on_bank && on_wide)
      w1_point(hb, sbank, swide, b, lo_ang, hi_ang, lo, ends, k_ext, window,
               n_wide, wide_end, k_occ, a1, a2, dist, valid, ovf, p, lane);
    else if (on_bank)
      w1_point(hb, sbank, gwide, b, lo_ang, hi_ang, lo, ends, k_ext, window,
               n_wide, n_wide, k_occ, a1, a2, dist, valid, ovf, p, lane);
    else if (on_wide)
      w1_point(hb, gbank, swide, b, lo_ang, hi_ang, lo, false, k_ext, window,
               n_wide, wide_end, k_occ, a1, a2, dist, valid, ovf, p, lane);
    else
      w1_point(hb, gbank, gwide, b, lo_ang, hi_ang, lo, false, k_ext, window,
               n_wide, n_wide, k_occ, a1, a2, dist, valid, ovf, p, lane);
  }
}

// W1's dynamic shared memory: the staged bank and wide rows and the warps'
// hit buffers; and its static shared memory (the CTA's points and the
// staging bounds). Both fit the 48 KB default, so the launch needs no
// cudaFuncSetAttribute call (a host call on every launch).
constexpr int kSmemW1 =
    (kBankRowsW1 * kSpanW1 + kWideRowsW1 * kWideW1 + kWarpsW1 * 4 * kHitsW1) *
    static_cast<int>(sizeof(float));
constexpr int kStaticW1 = (kPointsW1 * (kFeat + 3) + 5) * 4;
static_assert(kSmemW1 + kStaticW1 <= 48 * 1024,
              "kernel W1 needs more than the 48 KB default of shared memory");

// Launch a lane-split kernel on grid (grid_x, grid_y) of `threads`, with
// nl staged lists of cap columns in its dynamic shared memory, raising the
// kernel's limit past 48 KB where it needs more; the kernel takes cap as its
// last argument. Returns the first CUDA error.
template <typename Kernel, typename... Args>
int launch_lane_split(Kernel kernel, int grid_x, int grid_y, int threads,
                      int nl, int cap, cudaStream_t s, Args... args) {
  cap = max(1, cap);
  const int smem =
      nl * cap * static_cast<int>(sizeof(float4) + 2 * sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(grid_x, grid_y), threads, smem, s>>>(args..., cap);
  return static_cast<int>(cudaGetLastError());
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

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
  DISPATCH_K(k_occ, return launch_lane_split(
      a1_kernel<KMAX>, n_chunks, cdiv(blk, kBeamsA1), kLanesA1 * kBeamsA1,
      1, min(w_sl + wc, kTileA1), s, has, feats, w0b, rows, los, counts,
      data_t, wide_t, a12d, ovf, n_chunks, blk, w_sl, k_ext, wc, k_occ))
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
  // mode 1's list (the slice and every wide column) is the longest
  DISPATCH_K(k_occ, return launch_lane_split(
      a2_kernel<KMAX>, n_chunks, cdiv(blk, min(kBeamsA2, kBeamsA2s)),
      kLanesA2 * kBeamsA2, 1, min(w_sl + wc, kTileA2), s, gloa, mode, band,
      group, wide_sl, feats, w0b, rows, los, counts, data_t, wide_t, a12d,
      ovf, n_chunks, blk, w_sl, k_ext, wc, k_occ))
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
  DISPATCH_K(k_occ, return launch_lane_split(
      a3_kernel<KMAX>, n_chunks, cdiv(blk, kBeamsA3), kLanesA3 * kBeamsA3,
      1, min(k_ext + wide_sl, kTileA3), s, gloa, glob, unc, band, group,
      wide_sl, delta, feats, w0b, rows, nullptr, counts, data_t, wide_t,
      a12d, ovf, n_chunks, blk, 0, k_ext, wc, k_occ))
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
  DISPATCH_K(k_occ, return launch_lane_split(
      a4a_kernel<KMAX>, n_chunks, cdiv(blk, kBeamsA4a),
      kLanesA4a * kBeamsA4a, 1, min(w_sl + wc, kTileA4a), s, feats, w0b,
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
  DISPATCH_K(k_occ, return launch_lane_split(
      a4b_kernel<KMAX>, n_chunks / 2, cdiv(blk, kBeamsA4b),
      2 * kLanesA4b * kBeamsA4b, 2, min(w_sl + wc, kTileA4b), s, feats, w0b,
      rows, los, counts, data_t, wide_t, a12d, ovf, n_chunks, blk, w_sl,
      k_ext, wc, k_occ))
}

// Kernel W1: feats (n, 9) f32 (point_features; feature 8 is the point's
// centre azimuth); rows, los (n,) i32; live (n,) bool or null (every
// point); data_t (C, 8, k_ext), wide_t (C, 8, wc) f32; ang_t (C, 3, k_ext)
// and wang_t (C, 3, n_wide) f32 rows [pang, start, end]; delta, the
// window's half-width; outputs a1, a2, dist (n, K) f32, valid (n, K) bool,
// ovf (n,) i32. Needs 1 <= K <= window + n_wide and n_wide <= wc. Returns
// cudaGetLastError().
extern "C" int occluders_w1(
    const float* feats, const int* rows, const int* los, const bool* live,
    const float* data_t, const float* wide_t, const float* ang_t,
    const float* wang_t, float* a1, float* a2, float* dist, bool* valid,
    int* ovf, int n, int k_ext, int wc, int n_wide, int window, int k_occ,
    float delta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (k_occ < 1 || k_occ > window + n_wide || n_wide > wc)
    return static_cast<int>(cudaErrorInvalidValue);
  w1_kernel<<<cdiv(n, kPointsW1), kWarpsW1 * 32, kSmemW1, s>>>(
      feats, rows, los, live, data_t, wide_t, ang_t, wang_t, a1, a2, dist,
      valid, ovf, n, k_ext, wc, n_wide, window, k_occ, delta);
  return static_cast<int>(cudaGetLastError());
}
