// Kernels C1 and C2: first-claim sweep and received-pulse peak per occluded
// beam; kernel W2: the window assembly's sweep, bump selection and pulse
// peak per point (see w2_kernel at the end).
//
// C1 replaces `_kernel` of lidar_snow_sim_tpu/ops/pallas_pulse.py (with its
// helpers `_side_state`, `_sweep_step`, `_sweep_init` and `_make_wave_fns`),
// C2 its `_kernel_pair`; phase C of the dense snowfall assembly. For each
// compacted beam both
//   1. run the first-claim angular sweep as an extract-min walk over the
//      2K+2 interval endpoints: each trip retires every copy of the minimum,
//      and the lowest-index (nearest) occluder covering the midpoint of
//      [prev, cur] claims its width;
//   2. turn the claimed shares into bump amplitudes
//      amp_scale * share * xsi(r) / r^2, the unclaimed remainder going to the
//      hard target;
//   3. sum the target bump and then occluder bumps 0, 1, 2, ... bin by bin
//      over the M-bin range grid, and take the peak and its first bin.
//
// Design. A group of G lanes carries one beam (C1: G = kLanesC1 = 16, two
// beams a warp; C2: G = kLanesC2, the two beams of a pair in one warp).
// The beam's state (endpoints, claimed widths, intervals, bumps) lives in
// its slice of shared memory, and a final group reduction takes the
// maximum of the wave and the lowest bin among equal values.
//
// The sweep (sweep_all, both kernels). The TPU kernel runs it as up to
// 2K + 2 dependent extract-min trips, each over all 2K + 2 endpoints. Here
// only the valid occluders' endpoints are kept (an invalid one's are copies
// of `left`, which is an endpoint already), the distinct ones are ranked
// by counting, every elementary interval finds its claimer at once, and
// each occluder sums its widths in interval order: the trips' operations in
// their order, so the same values, in a few short passes.
//
// What bounds C1 on this card. It does little arithmetic for its bytes, so
// its time is the latency of each beam's chain of dependent steps, and in
// one wave of CTAs the kernel lasts as long as its heaviest beams (the
// count-bucketed order puts the beams with 10-12 occluders together). A
// bump covers only the bins r * ipm <= bin <= (r + c_tau) * ipm, ~31 of
// the M = 1230 at the bench's ipm 10 and c_tau 3 m, yet the first port
// (one warp a beam, the TPU kernel's whole-grid loop) evaluated all M bins
// for the target and every bump up to the last active one: ~40x the
// waveform work the function needs, and most of its time. C1 now
//   - evaluates only the union of the walked windows (walk_list): the
//     target's and those of the bumps before the last active one with a
//     nonzero amplitude, in ascending order of range (the top-K order; the
//     target is the farthest), each less the window before it;
//   - sums at a bin only the windows that hold it, in today's order
//     (target, then bumps 0, 1, ...), with the target's and the current
//     window's parameters in registers: a term left out is an exact zero;
//     a bin outside the union is +0.0 in the full sum, so the peak is the
//     larger of the union's peak and +0.0 at the lowest bin outside it,
//     ties to the lower bin;
//   - computes amplitudes only for the bumps the walk reads;
//   - runs the sweep at once (above) with 16 lanes a beam, where the trip
//     loop left 26 of 32 lanes idle in each reduction step at K = 24.
//
// A beam whose amplitudes are all 0 has an all-zero wave: peak 0 at bin 0.
//
// The precondition of C1 and C2: in each beam the valid occluders' ranges
// rise with their slot, and none lies past the target's d_orig. Phase A's
// top-K order and its hit test (pdist < d_orig) give exactly that, and it
// makes the walked windows' bin bounds ascend, which the walk relies on.
// The plain version takes any order.
//
// C2 (the `pulse_pair` knob) is C1's body under the TPU kernel's pair map:
// beam j of pulse blocks 2i and 2i + 1 (blocks of blk beams) share a warp,
// each on its own group of kLanesC2 lanes, so its values are C1's, with
// C1's tie rules; it needs an even number of blocks. The TPU kernel pairs
// the blocks to run two independent sweep chains side by side; here every
// warp already runs two beams' chains, so the pair only chooses which two
// beams share a warp. That costs little: the count-bucketed compaction
// sorts beams by occluder count, so paired blocks have near-equal trip
// counts (pallas_pulse.py's `_kernel_pair` docstring), though less equal
// than neighbouring beams: on the bench scene 17% of pairs differ in
// occluder count against 0.07% of C1's neighbours, and C2 takes ~1.06x
// C1's device time on an H100 (PERF.md). The split (lanes a beam) was chosen on the card against 8
// and 4 lanes (two and four pairs a warp) and 32 lanes with the pair's
// two walks interleaved in one warp (scripts/phase_c_sweep.py; PERF.md).
// c2_kernel repeats c1_kernel's few lines of calls rather than sharing
// them, so that C1's code stays as it was.
//
// Exactness. Compiled with -fmad=false: the pulse sums are decision
// boundaries (the peak bin sets the label), and the plain torch version
// rounds every product on its own.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanesC1 = 16;          // lanes per beam in C1
constexpr int kLanesC2 = 16;          // lanes per beam in C2
static_assert(32 % (2 * kLanesC2) == 0, "a pair shares one warp");
constexpr int kSmemMax = 232448;      // a CTA's shared memory on the H100

// Reductions over the group of G lanes that holds a beam (G a power of two
// up to 32, groups aligned in the warp). Every lane of the warp takes part.
template <int G>
__device__ __forceinline__ int group_max_int(int v) {
  for (int o = G / 2; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The ballot bits of lane's group.
template <int G>
__device__ __forceinline__ unsigned group_bits(int lane) {
  return G == 32 ? kFull : ((1u << G) - 1u) << (lane & ~(G - 1));
}

// One beam's state in its slice of shared memory: 12K + 8 floats.
struct Side {
  float* score;     // 2 nv + 2 endpoints: right, left, then a1, a2 of each
                    // valid occluder
  float* claimed;   // K
  float* a1s;       // nv, the valid occluders' intervals in index order
  float* a2s;       // nv
  int* kidx;        // nv, their indices
  float* amp;       // K + 1 (target last)
  float* cb;        // K + 1
  float* sb;        // K + 1
  float* wlo;       // K + 1 window starts
  float* whi;       // K + 1 window ends
  // C1's walked windows, written over score, claimed and a1s once the
  // sweep is done: the bumps, then their bins [walk_lo, walk_hi]
  int* walk;        // K + 1
  int* walk_lo;     // K + 1
  int* walk_hi;     // K + 1
  int p;            // the beam
  float d_orig, left;
  float unclaimed = 0.f, remainder = 0.f;
  int nv = 0, last_active = 0, n_walk = 0;
  bool touched = false;

  __device__ Side(float* base, int K, int p_) : p(p_) {
    score = base;
    claimed = score + 2 * K + 2;
    a1s = claimed + K;
    a2s = a1s + K;
    kidx = reinterpret_cast<int*>(a2s + K);
    amp = a2s + 2 * K;
    cb = amp + K + 1;
    sb = cb + K + 1;
    wlo = sb + K + 1;
    whi = wlo + K + 1;
    walk = reinterpret_cast<int*>(score);
    walk_lo = walk + K + 1;
    walk_hi = walk_lo + K + 1;   // 3K + 3 ints within the 4K + 2 floats
  }
};

// Load the beam's intervals and endpoints, the valid occluders' only: an
// invalid occluder's endpoints are copies of `left` (the plain version's
// rule), which is an endpoint already, so the sweep's distinct values are
// the same without them.
template <int G>
__device__ void side_init(Side& s, const float* __restrict__ feats,
                          const float* __restrict__ a1g,
                          const float* __restrict__ a2g,
                          const float* __restrict__ validg, int cap, int K,
                          int lane) {
  const int gl = lane & (G - 1);
  const int p = s.p;
  s.d_orig = feats[p];
  const float right = feats[(size_t)cap + p];
  s.left = feats[2 * (size_t)cap + p];
  const bool wrapped = right > s.left;
  int nv = 0;
  for (int k0 = 0; k0 < K; k0 += G) {
    const int k = k0 + gl;
    bool v = false;
    float a1 = 0.f, a2 = 0.f;
    if (k < K) {
      const size_t at = (size_t)k * cap + p;
      a1 = a1g[at];
      a2 = a2g[at];
      v = validg[at] > 0.5f;
      if (wrapped && a1 > a2) a1 = a1 - kTwoPi;
      s.claimed[k] = 0.f;
    }
    const unsigned bits = __ballot_sync(kFull, v) & group_bits<G>(lane);
    if (v) {   // compacted in index order
      const int at = nv + __popc(bits & ((1u << lane) - 1u));
      s.a1s[at] = a1;
      s.a2s[at] = a2;
      s.kidx[at] = k;
      s.score[2 + 2 * at] = a1;
      s.score[3 + 2 * at] = a2;
    }
    nv += __popc(bits);
  }
  s.nv = nv;
  if (gl == 0) {
    s.score[0] = wrapped ? right - kTwoPi : right;
    s.score[1] = s.left;
  }
  __syncwarp();
}

// The first-claim sweep at once. The TPU kernel's trips take the
// distinct finite endpoints in ascending order e_0 < e_1 < ...; trip i > 0
// gives the interval [e_{i-1}, e_i] (width e_i - e_{i-1}, midpoint
// 0.5 (e_i + e_{i-1})) to the lowest valid occluder covering its midpoint
// (or to the target), and trip 0 adds a zero width. Here the endpoints are
// ranked by counting, every interval finds its claimer at once, and each
// occluder then sums its widths in interval order: the same operations in
// the same order, so the same values, with a critical path of a few
// passes instead of 2 nv + 3 dependent trips. Scratch: the sorted
// endpoints and the claimers in amp.. (free until amplitudes), the widths
// over score once it is read.
template <int G>
__device__ void sweep_all(Side& s, int K, int gl) {
  const int m_e = 2 * s.nv + 2;
  float* e = s.amp;
  int* flag = reinterpret_cast<int*>(s.amp + 2 * K + 2);
  int* wix = flag;
  float* wid = s.score;
  for (int j = gl; j < m_e; j += G) {   // the first copy of each value
    const float v = s.score[j];
    // a value the trips would not take as live (>= kBig / 2, or NaN)
    // adds nothing
    bool first = v < kBig / 2;
    for (int i = 0; i < j && first; ++i) first = s.score[i] != v;
    flag[j] = first ? 1 : 0;
  }
  __syncwarp();
  int n = 0;
  for (int i = 0; i < m_e; ++i) n += flag[i];
  for (int j = gl; j < m_e; j += G) {
    if (!flag[j]) continue;
    const float v = s.score[j];
    int rank = 0;
    for (int i = 0; i < m_e; ++i) rank += (flag[i] && s.score[i] < v) ? 1 : 0;
    e[rank] = v;
  }
  __syncwarp();
  for (int i = gl + 1; i < n; i += G) {
    const float cur = e[i], prev = e[i - 1];
    const float mid = 0.5f * (cur + prev);
    int w = K;
    for (int t = 0; t < s.nv; ++t)
      if (s.a1s[t] <= mid && mid <= s.a2s[t]) { w = s.kidx[t]; break; }
    wid[i] = cur - prev;
    wix[i] = w;
  }
  __syncwarp();
  for (int t = gl; t < s.nv; t += G) {
    const int k = s.kidx[t];
    float c = s.claimed[k];
    for (int i = 1; i < n; ++i)
      if (wix[i] == k) c = c + wid[i];
    s.claimed[k] = c;
  }
  float u = s.unclaimed;
  for (int i = 1; i < n; ++i)
    if (wix[i] == K) u = u + wid[i];
  s.unclaimed = u;
  __syncwarp();
}

// Shares -> amplitudes; window bounds in bins; touched and the last active
// bump. The bumps are filled for b < last_active and the target.
template <int G>
__device__ void amplitudes(Side& s, const float* __restrict__ feats,
                           const float* __restrict__ rrg,
                           const float* __restrict__ cos_b,
                           const float* __restrict__ sin_b, int cap, int K,
                           int lane, float beam_rad, float ipm, float c_tau,
                           float xsi_r1, float xsi_den) {
  const int p = s.p;
  const int gl = lane & (G - 1);
  const float amp_scale = feats[3 * (size_t)cap + p];
  s.remainder = fminf(fmaxf(s.unclaimed / beam_rad, 0.f), 1.f);
  int last_active = 0;
  bool touched = false;
  for (int b = gl; b < K; b += G) {
    const float c = s.claimed[b];
    touched = touched || c > 0.f;
    // a share is positive only for c > 0 (and then may still round to 0)
    if (c > 0.f && fminf(fmaxf(c / beam_rad, 0.f), 1.f) > 0.f)
      last_active = max(last_active, b + 1);
  }
  s.touched = (__ballot_sync(kFull, touched) & group_bits<G>(lane)) != 0u;
  s.last_active = group_max_int<G>(last_active);
  for (int b = gl; b <= K; b += G) {
    if (b < K && b >= s.last_active) continue;
    float r, share;
    if (b < K) {
      share = fminf(fmaxf(s.claimed[b] / beam_rad, 0.f), 1.f);
      r = rrg[(size_t)b * cap + p];
    } else {
      share = s.remainder;
      r = s.d_orig;
    }
    const float r_amp = fminf(fmaxf(r, 1e-6f), 1e6f);
    const float xsi = fminf(fmaxf((r_amp - xsi_r1) / xsi_den, 0.f), 1.f);
    s.amp[b] = amp_scale * share * xsi / (r_amp * r_amp);
    s.cb[b] = cos_b[(size_t)b * cap + p];
    s.sb[b] = sin_b[(size_t)b * cap + p];
    s.wlo[b] = r * ipm;
    s.whi[b] = (r + c_tau) * ipm;
  }
  __syncwarp();
}

// One bump's term at a bin, amp * pulse, the pulse
// 0.5 (1 - (cos_g cb + sin_g sb)) rounded step by step.
__device__ __forceinline__ float term(float amp, float cb, float sb, float cg,
                                      float sg) {
  return amp * (0.5f * (1.0f - (cg * cb + sg * sb)));
}

// The group's largest value and its lowest bin among equal values.
template <int G>
__device__ __forceinline__ void group_peak(float& best, int& best_i) {
  for (int o = G / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, best_i, o);
    if (ov > best || (ov == best && oi < best_i)) { best = ov; best_i = oi; }
  }
}

// The bins m in [0, M - 1] with wlo <= m <= whi, as [lo, hi] (empty when
// lo > hi): for an integer m, wlo <= m is ceil(wlo) <= m and m <= whi is
// m <= floor(whi).
__device__ __forceinline__ void window_bins(float wlo, float whi, int M,
                                            int& lo, int& hi) {
  if (!(wlo <= whi)) {   // also a NaN bound: the predicate never holds
    lo = M;
    hi = -1;
    return;
  }
  lo = (int)fminf(fmaxf(ceilf(wlo), 0.f), (float)M);
  hi = (int)fmaxf(fminf(floorf(whi), (float)(M - 1)), -1.f);
}

// The windows the walk takes, in its order: occluder bumps b <
// last_active of nonzero amplitude (a zero amplitude's terms are exact
// zeros) in index order, which is ascending range, then the target, the
// farthest; empty windows are left out. Every lane of the warp calls it.
template <int G>
__device__ void walk_list(Side& s, int K, int M, int lane) {
  const int gl = lane & (G - 1);
  int n = 0;
  for (int b0 = 0; b0 < K; b0 += G) {
    const int b = b0 + gl;
    int lo = M, hi = -1;
    if (b < s.last_active && s.amp[b] != 0.f)
      window_bins(s.wlo[b], s.whi[b], M, lo, hi);
    const bool walked = lo <= hi;
    const unsigned bits = __ballot_sync(kFull, walked) & group_bits<G>(lane);
    if (walked) {
      const int at = n + __popc(bits & ((1u << lane) - 1u));
      s.walk[at] = b;
      s.walk_lo[at] = lo;
      s.walk_hi[at] = hi;
    }
    n += __popc(bits);
  }
  int lo, hi;
  window_bins(s.wlo[K], s.whi[K], M, lo, hi);
  if (lo <= hi) {
    if (gl == 0) {
      s.walk[n] = K;
      s.walk_lo[n] = lo;
      s.walk_hi[n] = hi;
    }
    ++n;
  }
  s.n_walk = n;
  __syncwarp();   // the group's entries are read back below
}

// The lowest bin outside every walked window, or M if they cover all: a
// window holding the candidate moves it past its end (every bin below the
// candidate stays covered) until none holds it.
__device__ int lowest_uncovered(const Side& s, int M) {
  int u = 0;
  for (bool moved = true; moved && u < M;) {
    moved = false;
    for (int t = 0; t < s.n_walk; ++t) {
      if (s.walk_lo[t] <= u && u <= s.walk_hi[t]) {
        u = s.walk_hi[t] + 1;
        moved = true;
      }
    }
  }
  return u;
}

// The windowed waveform's peak and first bin (see the notes at the top):
// the G lanes of a group stride each walked window's bins less the
// previous window's, then reduce; +0.0 at the lowest uncovered bin joins
// when the union's peak is not above zero. Every lane of the warp calls it.
//
// The windows come sorted (the precondition, at the top), so a bin of
// window t's run lies past the end of every earlier window and is summed
// from registers: the target's term if the target holds it, window t's
// term, and the next windows' only from the bin where the next one starts.
template <int G>
__device__ void windowed_peak(const Side& s, int K, int M, int lane,
                              const float* __restrict__ cos_g,
                              const float* __restrict__ sin_g, float& best,
                              int& best_i) {
  const int gl = lane & (G - 1);
  const int n = s.n_walk;
  const bool tgt = n > 0 && s.walk[n - 1] == K;
  const int n_occ = tgt ? n - 1 : n;
  const int tlo = tgt ? s.walk_lo[n - 1] : M;
  const int thi = tgt ? s.walk_hi[n - 1] : -1;
  const float tamp = s.amp[K], tcb = s.cb[K], tsb = s.sb[K];
  best = -INFINITY;
  best_i = M;
  int plo = 0, phi = -1;   // the last window walked (none yet)
  for (int t = 0; t < n; ++t) {
    const int lo = s.walk_lo[t], hi = s.walk_hi[t];
    const int below = min(hi, plo - 1), above = max(lo, phi + 1);
    const bool occ = t < n_occ;
    const int b = occ ? s.walk[t] : K;
    const float amp = s.amp[b], cb = s.cb[b], sb = s.sb[b];
    const int next_lo = t + 1 < n_occ ? s.walk_lo[t + 1] : M;
    for (int m = lo + gl; m <= hi; m += G) {
      if (m > below && m < above) continue;   // the previous window's bins
      const float cg = cos_g[m], sg = sin_g[m];
      float w = (tlo <= m && m <= thi) ? term(tamp, tcb, tsb, cg, sg) : 0.f;
      if (occ) {
        w = w + term(amp, cb, sb, cg, sg);
        for (int u = t + 1; m >= next_lo && u < n_occ && s.walk_lo[u] <= m;
             ++u) {
          const int bu = s.walk[u];
          w = w + term(s.amp[bu], s.cb[bu], s.sb[bu], cg, sg);
        }
      }
      if (w > best || (w == best && m < best_i)) { best = w; best_i = m; }
    }
    plo = lo;
    phi = hi;
  }
  group_peak<G>(best, best_i);
  if (!(best > 0.f)) {
    const int u = lowest_uncovered(s, M);
    if (u < M && (0.f > best || (0.f == best && u < best_i))) {
      best = 0.f;
      best_i = u;
    }
  }
}

__device__ __forceinline__ void write_out(const Side& s, float best,
                                          int best_i, float* peak_out,
                                          int* idx_out,
                                          unsigned char* touched_out,
                                          float* rem_out) {
  peak_out[s.p] = best;
  idx_out[s.p] = best_i;
  touched_out[s.p] = s.touched ? 1 : 0;
  rem_out[s.p] = s.remainder;
}

// Kernel C1: kLanesC1 lanes a beam, the windowed waveform. A CTA holds
// blockDim.x / kLanesC1 beams; a slot past cap computes the last beam again
// and writes nothing (its lanes take part in the warp's shuffles).
__global__ void c1_kernel(
    const float* __restrict__ feats, const float* __restrict__ a1g,
    const float* __restrict__ a2g, const float* __restrict__ rrg,
    const float* __restrict__ validg, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ cos_g,
    const float* __restrict__ sin_g, float* __restrict__ peak_out,
    int* __restrict__ idx_out, unsigned char* __restrict__ touched_out,
    float* __restrict__ rem_out, int cap, int K, int M, int per_beam,
    float beam_rad, float ipm, float c_tau, float xsi_r1, float xsi_den) {
  constexpr int G = kLanesC1;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x / G;
  const int p = blockIdx.x * (blockDim.x / G) + slot;

  Side s(smem + (size_t)slot * per_beam, K, min(p, cap - 1));
  side_init<G>(s, feats, a1g, a2g, validg, cap, K, lane);
  sweep_all<G>(s, K, lane & (G - 1));
  amplitudes<G>(s, feats, rrg, cos_b, sin_b, cap, K, lane, beam_rad, ipm,
                c_tau, xsi_r1, xsi_den);
  walk_list<G>(s, K, M, lane);
  float best;
  int best_i;
  windowed_peak<G>(s, K, M, lane, cos_g, sin_g, best, best_i);
  if (p < cap && (lane & (G - 1)) == 0)
    write_out(s, best, best_i, peak_out, idx_out, touched_out, rem_out);
}

// Kernel C2: C1's body under the pair map. Beam slots 2j and 2j + 1 of a
// CTA (kLanesC2 lanes each, in one warp) carry pair q: beam q % blk of
// pulse blocks 2 (q / blk) and 2 (q / blk) + 1. Slots past the last pair
// compute it again and write nothing (their lanes take part in the warp's
// shuffles).
__global__ void c2_kernel(
    const float* __restrict__ feats, const float* __restrict__ a1g,
    const float* __restrict__ a2g, const float* __restrict__ rrg,
    const float* __restrict__ validg, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ cos_g,
    const float* __restrict__ sin_g, float* __restrict__ peak_out,
    int* __restrict__ idx_out, unsigned char* __restrict__ touched_out,
    float* __restrict__ rem_out, int cap, int K, int M, int per_beam,
    int blk, float beam_rad, float ipm, float c_tau, float xsi_r1,
    float xsi_den) {
  constexpr int G = kLanesC2;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x / G;
  const int pairs = cap / 2;
  const int q = blockIdx.x * (blockDim.x / (2 * G)) + slot / 2;
  const int qc = min(q, pairs - 1);
  const int p = (qc / blk) * 2 * blk + qc % blk + (slot & 1) * blk;

  Side s(smem + (size_t)slot * per_beam, K, p);
  side_init<G>(s, feats, a1g, a2g, validg, cap, K, lane);
  sweep_all<G>(s, K, lane & (G - 1));
  amplitudes<G>(s, feats, rrg, cos_b, sin_b, cap, K, lane, beam_rad, ipm,
                c_tau, xsi_r1, xsi_den);
  walk_list<G>(s, K, M, lane);
  float best;
  int best_i;
  windowed_peak<G>(s, K, M, lane, cos_g, sin_g, best, best_i);
  if (q < pairs && (lane & (G - 1)) == 0)
    write_out(s, best, best_i, peak_out, idx_out, touched_out, rem_out);
}

// Kernel W2: the window assembly's sweep, bump selection and pulse peak
// per point. It replaces no TPU kernel: the JAX package computes them in
// XLA inside its lax.map over point chunks (`_pulse_phase` up to the peak,
// lidar_snow_sim_tpu/models/snowfall.py:151-199), and the port's plain
// version, ops/pulse.window_pulse_plain, evaluates every bump over the
// whole M-bin grid, a (P, M) plane of ~10 operations a bump. For each
// point, from kernel W1's (n, K) rows:
//   1. the first-claim sweep: window_side_init loads the valid occluders
//      (C1's side_init, with W1's row layout and bool valid), then C1's
//      sweep_all, which sums each occluder's widths and the target's in
//      interval order, as ops/sweep.occlusion_sweep does;
//   2. the ratios clamp(claimed / beam_rad, 0, 1) and the max_bumps
//      largest nonzero ones in the order of a stable descending sort (ties
//      to the lower slot; a zero ratio has a zero amplitude, so the tail of
//      zeros adds nothing), with the nonzero ratios beyond max_bumps;
//   3. amplitudes 0.9 * max_int * ratio * xsi(r) / (r * r) of those bumps
//      and of the hard target with the remainder, in that order;
//   4. the waveform's peak and first bin, summed at each bin as the plain
//      version sums it: the selected bumps in their order, then the target
//      (an exact zero term, out of its window or of a zero amplitude,
//      leaves the sum as it is), over the union of the bumps' windows only
//      (C1's rule for the bins outside: +0.0, the lowest of them ties).
//      A NaN term (the target of a point at the origin: 0/0) makes the
//      peak NaN and the bin M, as torch's amax and the equality test do.
// The transcendentals (cos and sin of each slot's, the target's and the
// grid's pulse phase) come from the wrapper, computed by torch, as C1
// takes them. Design: C1's, kLanesW2 lanes a point and the point's state in
// its slice of shared memory. Unlike C1's, the selected bumps' windows are
// not in ascending order, so each bin sums every selected window that
// holds it (a check a window). What bounds it: little. It reads W1's valid
// flags (a byte a slot), the intervals of the few valid slots and the
// range, cos and sin of the selected bumps, and writes 13 bytes a point:
// a few MB at the bench's 65,536 points x K = 64, a few microseconds at
// 3.35 TB/s. Its time is each point's chain of dependent steps.
constexpr int kLanesW2 = 16;

// C1's side_init on W1's rows: (n, K) occluders, row p, with bool valid.
template <int G>
__device__ void window_side_init(Side& s, const float* __restrict__ feats,
                                 const float* __restrict__ a1g,
                                 const float* __restrict__ a2g,
                                 const bool* __restrict__ validg, int n,
                                 int K, int lane) {
  const int gl = lane & (G - 1);
  const int p = s.p;
  s.d_orig = feats[p];
  const float right = feats[(size_t)n + p];
  s.left = feats[2 * (size_t)n + p];
  const bool wrapped = right > s.left;
  int nv = 0;
  for (int k0 = 0; k0 < K; k0 += G) {
    const int k = k0 + gl;
    bool v = false;
    float a1 = 0.f, a2 = 0.f;
    if (k < K) {
      const size_t at = (size_t)p * K + k;
      a1 = a1g[at];
      a2 = a2g[at];
      v = validg[at];
      if (wrapped && a1 > a2) a1 = a1 - kTwoPi;
      s.claimed[k] = 0.f;
    }
    const unsigned bits = __ballot_sync(kFull, v) & group_bits<G>(lane);
    if (v) {   // compacted in index order
      const int at = nv + __popc(bits & ((1u << lane) - 1u));
      s.a1s[at] = a1;
      s.a2s[at] = a2;
      s.kidx[at] = k;
      s.score[2 + 2 * at] = a1;
      s.score[3 + 2 * at] = a2;
    }
    nv += __popc(bits);
  }
  s.nv = nv;
  if (gl == 0) {
    s.score[0] = wrapped ? right - kTwoPi : right;
    s.score[1] = s.left;
  }
  __syncwarp();
}

// Steps 2 and 3 after sweep_all: the selected bumps, then the target, as
// walk entries q = 0 .. n_sel (written over the Side's free arrays: the
// positive ratios' slots over kidx and their ratios over a1s, then each
// entry's amplitude, cos, sin in amp, cb, sb and its bins [lo, hi] over
// wlo, whi; an entry of zero amplitude gets an empty window). Returns the
// entry count n_sel + 1; sets touched, the remainder and bump_over.
template <int G>
__device__ int window_bumps(Side& s, const float* __restrict__ feats,
                            const float* __restrict__ dist,
                            const float* __restrict__ cos_b,
                            const float* __restrict__ sin_b,
                            const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t, int n, int K,
                            int M, int max_bumps, int lane, float beam_rad,
                            float ipm, float c_tau, float xsi_r1,
                            float xsi_den, int& bump_over) {
  const int gl = lane & (G - 1);
  const int p = s.p;
  int* pos_k = s.kidx;
  float* pos_r = s.a1s;
  int* lo = reinterpret_cast<int*>(s.wlo);
  int* hi = reinterpret_cast<int*>(s.whi);
  s.remainder = fminf(fmaxf(s.unclaimed / beam_rad, 0.f), 1.f);
  bool touched = false;
  int n_pos = 0;
  for (int k0 = 0; k0 < K; k0 += G) {
    const int k = k0 + gl;
    float r = 0.f;
    if (k < K) {
      const float c = s.claimed[k];
      touched = touched || c > 0.f;
      r = fminf(fmaxf(c / beam_rad, 0.f), 1.f);
    }
    const bool pos = r > 0.f;
    const unsigned bits = __ballot_sync(kFull, pos) & group_bits<G>(lane);
    if (pos) {
      const int at = n_pos + __popc(bits & ((1u << lane) - 1u));
      pos_k[at] = k;
      pos_r[at] = r;
    }
    n_pos += __popc(bits);
  }
  s.touched = (__ballot_sync(kFull, touched) & group_bits<G>(lane)) != 0u;
  bump_over = max(n_pos - max_bumps, 0);
  const int n_sel = min(n_pos, min(max_bumps, K));
  __syncwarp();
  const float amp_scale = feats[3 * (size_t)n + p];
  for (int i = gl; i <= n_pos; i += G) {
    int q;
    float r, ratio, cb, sb;
    if (i < n_pos) {   // rank in the stable descending order of the ratios
      ratio = pos_r[i];
      q = 0;
      for (int j = 0; j < n_pos; ++j)
        q += (pos_r[j] > ratio || (pos_r[j] == ratio && j < i)) ? 1 : 0;
      if (q >= n_sel) continue;
      const size_t at = (size_t)p * K + pos_k[i];
      r = dist[at];
      cb = cos_b[at];
      sb = sin_b[at];
    } else {           // the target, last
      q = n_sel;
      ratio = s.remainder;
      r = s.d_orig;
      cb = cos_t[p];
      sb = sin_t[p];
    }
    const float xsi = fminf(fmaxf((r - xsi_r1) / xsi_den, 0.f), 1.f);
    const float amp = amp_scale * ratio * xsi / (r * r);
    s.amp[q] = amp;
    s.cb[q] = cb;
    s.sb[q] = sb;
    lo[q] = M;
    hi[q] = -1;
    if (amp != 0.f) window_bins(r * ipm, (r + c_tau) * ipm, M, lo[q], hi[q]);
  }
  __syncwarp();
  return n_sel + 1;
}

// Step 4: the peak over the union of the n_walk entries' windows, each bin
// once (in the first window that holds it), summed over every entry that
// holds it in entry order; then +0.0 at the lowest bin outside the union
// where the union's peak is not above zero; NaN anywhere: (NaN, M). Every
// lane of the warp calls it.
template <int G>
__device__ void window_wave_peak(const Side& s, int n_walk, int M, int lane,
                                 const float* __restrict__ cos_g,
                                 const float* __restrict__ sin_g,
                                 float& best, int& best_i) {
  const int gl = lane & (G - 1);
  const int* lo = reinterpret_cast<const int*>(s.wlo);
  const int* hi = reinterpret_cast<const int*>(s.whi);
  best = -INFINITY;
  best_i = M;
  bool nan = false;
  for (int t = 0; t < n_walk; ++t) {
    for (int m = lo[t] + gl; m <= hi[t]; m += G) {
      bool seen = false;
      for (int u = 0; u < t && !seen; ++u) seen = lo[u] <= m && m <= hi[u];
      if (seen) continue;
      const float cg = cos_g[m], sg = sin_g[m];
      float w = 0.f;
      for (int u = 0; u < n_walk; ++u)
        if (lo[u] <= m && m <= hi[u])
          w = w + term(s.amp[u], s.cb[u], s.sb[u], cg, sg);
      if (w != w) {
        nan = true;
      } else if (w > best || (w == best && m < best_i)) {
        best = w;
        best_i = m;
      }
    }
  }
  group_peak<G>(best, best_i);
  if ((__ballot_sync(kFull, nan) & group_bits<G>(lane)) != 0u) {
    best = NAN;
    best_i = M;
    return;
  }
  if (!(best > 0.f)) {
    int u = 0;   // the lowest bin outside every window (lowest_uncovered)
    for (bool moved = true; moved && u < M;) {
      moved = false;
      for (int t = 0; t < n_walk; ++t) {
        if (lo[t] <= u && u <= hi[t]) {
          u = hi[t] + 1;
          moved = true;
        }
      }
    }
    if (u < M && (0.f > best || (0.f == best && u < best_i))) {
      best = 0.f;
      best_i = u;
    }
  }
}

// Kernel W2: kLanesW2 lanes a point. A slot past n computes the last point
// again and writes nothing (its lanes take part in the warp's shuffles).
__global__ void w2_kernel(
    const float* __restrict__ feats, const float* __restrict__ a1g,
    const float* __restrict__ a2g, const float* __restrict__ dist,
    const bool* __restrict__ validg, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const float* __restrict__ cos_g,
    const float* __restrict__ sin_g, float* __restrict__ peak_out,
    int* __restrict__ idx_out, bool* __restrict__ touched_out,
    int* __restrict__ bump_out, int n, int K, int M, int max_bumps,
    int per_beam, float beam_rad, float ipm, float c_tau, float xsi_r1,
    float xsi_den) {
  constexpr int G = kLanesW2;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x / G;
  const int p = blockIdx.x * (blockDim.x / G) + slot;

  Side s(smem + (size_t)slot * per_beam, K, min(p, n - 1));
  window_side_init<G>(s, feats, a1g, a2g, validg, n, K, lane);
  sweep_all<G>(s, K, lane & (G - 1));
  int bump_over;
  const int n_walk = window_bumps<G>(
      s, feats, dist, cos_b, sin_b, cos_t, sin_t, n, K, M, max_bumps, lane,
      beam_rad, ipm, c_tau, xsi_r1, xsi_den, bump_over);
  float best;
  int best_i;
  window_wave_peak<G>(s, n_walk, M, lane, cos_g, sin_g, best, best_i);
  if (p < n && (lane & (G - 1)) == 0) {
    peak_out[p] = best;
    idx_out[p] = best_i;
    touched_out[p] = s.touched;
    bump_out[p] = bump_over;
  }
}

// The launch shape of a kernel of `lanes` lanes a beam: up to 4 warps a
// CTA, as many as fit at 12 K + 8 floats of shared memory a beam (see
// Side), the kernel allowed its size above the default 48 KB. Sets warps
// and smem (bytes); returns the error, if any.
template <typename Kernel>
cudaError_t launch_shape(Kernel kernel, int K, int lanes, int& warps,
                         int& smem) {
  const int warp_bytes = (32 / lanes) * (12 * K + 8) * 4;
  warps = min(4, kSmemMax / warp_bytes);
  if (warps < 1) return cudaErrorInvalidValue;
  smem = warps * warp_bytes;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// Inputs (contiguous f32): feats (4, cap) rows [d_orig, right, left,
// 0.9 * max_intensity]; a1, a2, rr, valid (K, cap); cos_b, sin_b (K+1, cap);
// cos_g, sin_g (M,). Outputs (cap,): peak f32, idx i32, touched one byte
// 0/1 (torch.bool), remainder f32. Returns cudaGetLastError().
extern "C" int pulse_c1(
    const float* feats, const float* a1, const float* a2, const float* rr,
    const float* valid, const float* cos_b, const float* sin_b,
    const float* cos_g, const float* sin_g, float* peak, int* idx,
    unsigned char* touched, float* remainder, int cap, int K, int M,
    float beam_rad, float ipm, float c_tau, float xsi_r1, float xsi_den,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap == 0) return static_cast<int>(cudaGetLastError());
  int warps, smem;
  const cudaError_t e = launch_shape(c1_kernel, K, kLanesC1, warps, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int beams = warps * 32 / kLanesC1;
  const int blocks = (cap + beams - 1) / beams;
  c1_kernel<<<blocks, warps * 32, smem, s>>>(
      feats, a1, a2, rr, valid, cos_b, sin_b, cos_g, sin_g, peak, idx,
      touched, remainder, cap, K, M, 12 * K + 8, beam_rad, ipm, c_tau,
      xsi_r1, xsi_den);
  return static_cast<int>(cudaGetLastError());
}

// Kernel C2: arguments as pulse_c1, plus blk, the pulse-block width; cap must
// be a multiple of 2 * blk.
extern "C" int pulse_c2(
    const float* feats, const float* a1, const float* a2, const float* rr,
    const float* valid, const float* cos_b, const float* sin_b,
    const float* cos_g, const float* sin_g, float* peak, int* idx,
    unsigned char* touched, float* remainder, int cap, int K, int M, int blk,
    float beam_rad, float ipm, float c_tau, float xsi_r1, float xsi_den,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap == 0) return static_cast<int>(cudaGetLastError());
  if (blk <= 0 || cap % (2 * blk)) return static_cast<int>(cudaErrorInvalidValue);
  int warps, smem;
  const cudaError_t e = launch_shape(c2_kernel, K, kLanesC2, warps, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = warps * 32 / (2 * kLanesC2);   // a CTA's
  const int blocks = (cap / 2 + pairs - 1) / pairs;
  c2_kernel<<<blocks, warps * 32, smem, s>>>(
      feats, a1, a2, rr, valid, cos_b, sin_b, cos_g, sin_g, peak, idx,
      touched, remainder, cap, K, M, 12 * K + 8, blk, beam_rad, ipm, c_tau,
      xsi_r1, xsi_den);
  return static_cast<int>(cudaGetLastError());
}

// Kernel W2: feats (4, n) f32 rows [d_orig, right, left, 0.9 *
// max_intensity]; a1, a2, dist (n, K) f32 and valid (n, K) bool (kernel
// W1's rows); cos_b, sin_b (n, K) f32 of each slot's pulse phase, cos_t,
// sin_t (n,) of the target's, cos_g, sin_g (M,) of the grid's. Outputs
// (n,): peak f32, first peak bin i32, touched bool, bump overflow i32.
// Returns cudaGetLastError().
extern "C" int pulse_w2(
    const float* feats, const float* a1, const float* a2, const float* dist,
    const bool* valid, const float* cos_b, const float* sin_b,
    const float* cos_t, const float* sin_t, const float* cos_g,
    const float* sin_g, float* peak, int* idx, bool* touched, int* bump,
    int n, int K, int M, int max_bumps, float beam_rad, float ipm,
    float c_tau, float xsi_r1, float xsi_den, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int warps, smem;
  const cudaError_t e = launch_shape(w2_kernel, K, kLanesW2, warps, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int points = warps * 32 / kLanesW2;
  w2_kernel<<<(n + points - 1) / points, warps * 32, smem, s>>>(
      feats, a1, a2, dist, valid, cos_b, sin_b, cos_t, sin_t, cos_g, sin_g,
      peak, idx, touched, bump, n, K, M, max_bumps, 12 * K + 8, beam_rad,
      ipm, c_tau, xsi_r1, xsi_den);
  return static_cast<int>(cudaGetLastError());
}
