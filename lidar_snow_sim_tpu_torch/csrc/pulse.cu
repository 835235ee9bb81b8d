// Kernels C1 and C2: first-claim sweep and received-pulse peak per occluded
// beam.
//
// C1 replaces `_kernel` of lidar_snow_sim_tpu/ops/pallas_pulse.py (with its
// helpers `_side_state`, `_sweep_step`, `_sweep_init` and `_make_wave_fns`),
// C2 its `_kernel_pair`; phase C of the dense snowfall assembly. For each
// compacted beam both
//   1. runs the first-claim angular sweep as an extract-min walk over the
//      2K+2 interval endpoints: each trip retires every copy of the minimum,
//      and the lowest-index (nearest) occluder covering the midpoint of
//      [prev, cur] claims its width;
//   2. turns the claimed shares into bump amplitudes
//      amp_scale * share * xsi(r) / r^2, the unclaimed remainder going to the
//      hard target;
//   3. sums the target bump and then occluder bumps 0, 1, 2, ... bin by bin
//      over the M-bin range grid, and takes the peak and its first bin.
//
// Design. One warp per beam. The sweep state (endpoints, claimed widths,
// intervals) lives in the warp's slice of shared memory; each trip is two
// warp reductions (the minimum endpoint, the lowest covering occluder). The
// waveform strides the lanes over the M bins, so each lane sums its bins in
// the TPU kernel's bump order, and a final warp reduction takes the maximum
// and the lowest bin among equal values.
//
// Trip counts. The TPU kernel loops to block maxima (sweep trips
// min(2 * max_valid + 3, 2K + 2) and the block's last active bump). Here the
// bounds are per beam: the extra trips of a block only add exact zeros
// (the sweep has retired every endpoint, an inactive bump has amplitude 0),
// so the values are the same; at most the sign of a zero can differ.
//
// What bounds it on this card: the waveform, ~10 flops per (beam, bin,
// active bump), about 18k beams x 1230 bins x a few bumps at the bench
// shapes; the sweep is a short chain of warp reductions (latency-bound).
//
// A beam whose amplitudes are all 0 has an all-zero wave: peak 0 at bin 0.
//
// C2 (the `pulse_pair` knob). The TPU kernel interleaves two blocks' sweep
// and wave loops under shared trip counts, two independent chains for the
// scheduler. Here one warp carries one beam of each of two blocks: two sweep
// states (two sets of warp reductions per trip) and two wave accumulators
// per lane, stepped under the pair's larger trip counts. The extra trips add
// exact zeros, so C2's values are C1's; it keeps C1's tie rules. It needs an
// even number of blocks.
//
// Exactness. Compiled with -fmad=false: the pulse sums are decision
// boundaries (the peak bin sets the label), and the plain torch version
// rounds every product on its own.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One beam's state in its warp's slice of shared memory: 12K + 8 floats.
struct Side {
  float* score;     // 2K + 2 endpoints
  float* claimed;   // K
  float* a1s;       // K
  float* a2s;       // K
  float* vs;        // K, 0/1
  float* amp;       // K + 1 (target last)
  float* cb;        // K + 1
  float* sb;        // K + 1
  float* wlo;       // K + 1 window starts
  float* whi;       // K + 1 window ends
  int p;            // the beam
  float d_orig, left;
  float prev = 0.f, unclaimed = 0.f, remainder = 0.f;
  int nv = 0, last_active = 0;
  bool touched = false;

  __device__ Side(float* base, int K, int p_) : p(p_) {
    score = base;
    claimed = score + 2 * K + 2;
    a1s = claimed + K;
    a2s = a1s + K;
    vs = a2s + K;
    amp = vs + K;
    cb = amp + K + 1;
    sb = cb + K + 1;
    wlo = sb + K + 1;
    whi = wlo + K + 1;
  }
};

// Load the beam's intervals and endpoints; counts its valid occluders.
__device__ void side_init(Side& s, const float* __restrict__ feats,
                          const float* __restrict__ a1g,
                          const float* __restrict__ a2g,
                          const float* __restrict__ validg, int cap, int K,
                          int lane) {
  const int p = s.p;
  s.d_orig = feats[p];
  const float right = feats[(size_t)cap + p];
  s.left = feats[2 * (size_t)cap + p];
  const bool wrapped = right > s.left;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    bool v = false;
    if (k < K) {
      const size_t at = (size_t)k * cap + p;
      float a1 = a1g[at], a2 = a2g[at];
      v = validg[at] > 0.5f;
      if (wrapped && a1 > a2) a1 = a1 - kTwoPi;
      if (!v) { a1 = s.left; a2 = s.left; }
      s.a1s[k] = a1;
      s.a2s[k] = a2;
      s.vs[k] = v ? 1.f : 0.f;
      s.claimed[k] = 0.f;
      s.score[2 + k] = a1;
      s.score[2 + K + k] = a2;
    }
    s.nv += __popc(__ballot_sync(0xffffffffu, v));
  }
  if (lane == 0) {
    s.score[0] = wrapped ? right - kTwoPi : right;
    s.score[1] = s.left;
  }
  __syncwarp();
}

// One trip of the first-claim sweep; a trip past the distinct endpoints
// adds zeros.
__device__ __forceinline__ void sweep_step(Side& s, int it, int K, int lane) {
  const int m_e = 2 * K + 2;
  float local = kBig;
  for (int j = lane; j < m_e; j += 32) local = fminf(local, s.score[j]);
  const float cur = warp_min(local);
  const bool live = cur < kBig / 2;
  const float width = (it > 0 && live) ? cur - s.prev : 0.f;
  const float mid = 0.5f * (cur + s.prev);
  int w = K;
  for (int k = lane; k < K; k += 32)
    if (s.a1s[k] <= mid && mid <= s.a2s[k] && s.vs[k] > 0.5f) { w = k; break; }
  const int widx = warp_min_int(w);
  if (widx < K) {
    if (lane == 0) s.claimed[widx] = s.claimed[widx] + width;
  } else {
    s.unclaimed = s.unclaimed + width;
  }
  // each lane retires only the endpoints it read: no cross-lane hazard
  for (int j = lane; j < m_e; j += 32)
    if (s.score[j] == cur) s.score[j] = kBig;
  s.prev = live ? cur : s.prev;
  __syncwarp();
}

// Shares -> amplitudes; window bounds in bins; touched and the last active
// bump.
__device__ void amplitudes(Side& s, const float* __restrict__ feats,
                           const float* __restrict__ rrg,
                           const float* __restrict__ cos_b,
                           const float* __restrict__ sin_b, int cap, int K,
                           int lane, float beam_rad, float ipm, float c_tau,
                           float xsi_r1, float xsi_den) {
  const int p = s.p;
  const float amp_scale = feats[3 * (size_t)cap + p];
  s.remainder = fminf(fmaxf(s.unclaimed / beam_rad, 0.f), 1.f);
  int last_active = 0;
  bool touched = false;
  for (int b = lane; b <= K; b += 32) {
    float r, share;
    if (b < K) {
      const float c = s.claimed[b];
      touched = touched || c > 0.f;
      share = fminf(fmaxf(c / beam_rad, 0.f), 1.f);
      if (share > 0.f) last_active = max(last_active, b + 1);
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
  s.touched = __any_sync(0xffffffffu, touched);
  s.last_active = warp_max_int(last_active);
  __syncwarp();
}

// The waveform at one bin: target bump first, then occluder bumps
// 0 .. n_bumps - 1 in index order (an inactive bump adds an exact zero).
__device__ __forceinline__ float wave_at(const Side& s, int K, int n_bumps,
                                         float bin, float cg, float sg) {
  float w;
  {
    const float pulse = 0.5f * (1.0f - (cg * s.cb[K] + sg * s.sb[K]));
    w = (bin >= s.wlo[K] && bin <= s.whi[K]) ? s.amp[K] * pulse : 0.f;
  }
  for (int b = 0; b < n_bumps; ++b) {
    const float pulse = 0.5f * (1.0f - (cg * s.cb[b] + sg * s.sb[b]));
    w = w + ((bin >= s.wlo[b] && bin <= s.whi[b]) ? s.amp[b] * pulse : 0.f);
  }
  return w;
}

// The warp's largest value and its lowest bin among equal values.
__device__ __forceinline__ void warp_peak(float& best, int& best_i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ov > best || (ov == best && oi < best_i)) { best = ov; best_i = oi; }
  }
}

__device__ __forceinline__ void write_out(const Side& s, float best,
                                          int best_i, float* peak_out,
                                          int* idx_out, int* touched_out,
                                          float* rem_out) {
  peak_out[s.p] = best;
  idx_out[s.p] = best_i;
  touched_out[s.p] = s.touched ? 1 : 0;
  rem_out[s.p] = s.remainder;
}

__global__ void c1_kernel(
    const float* __restrict__ feats, const float* __restrict__ a1g,
    const float* __restrict__ a2g, const float* __restrict__ rrg,
    const float* __restrict__ validg, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ cos_g,
    const float* __restrict__ sin_g, float* __restrict__ peak_out,
    int* __restrict__ idx_out, int* __restrict__ touched_out,
    float* __restrict__ rem_out, int cap, int K, int M, int per_warp,
    float beam_rad, float ipm, float c_tau, float xsi_r1, float xsi_den) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= cap) return;   // whole warp leaves together

  Side s(smem + (size_t)warp * per_warp, K, p);
  side_init(s, feats, a1g, a2g, validg, cap, K, lane);
  const int trips = min(2 * s.nv + 3, 2 * K + 2);
  for (int it = 0; it < trips; ++it) sweep_step(s, it, K, lane);
  amplitudes(s, feats, rrg, cos_b, sin_b, cap, K, lane, beam_rad, ipm, c_tau,
             xsi_r1, xsi_den);

  float best = -INFINITY;
  int best_i = M;
  for (int m = lane; m < M; m += 32) {
    const float w = wave_at(s, K, s.last_active, (float)m, cos_g[m],
                            sin_g[m]);
    if (w > best) { best = w; best_i = m; }
  }
  warp_peak(best, best_i);
  if (lane == 0)
    write_out(s, best, best_i, peak_out, idx_out, touched_out, rem_out);
}

// Kernel C2: one warp carries beam j of pulse blocks 2i and 2i + 1 (blocks
// of blk beams): two sweep states and two waves, stepped together under the
// pair's shared trip counts (the larger sweep count and the larger last
// active bump, as the TPU kernel's pair). The extra trips add exact zeros,
// so each beam's values are C1's.
__global__ void c2_kernel(
    const float* __restrict__ feats, const float* __restrict__ a1g,
    const float* __restrict__ a2g, const float* __restrict__ rrg,
    const float* __restrict__ validg, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ cos_g,
    const float* __restrict__ sin_g, float* __restrict__ peak_out,
    int* __restrict__ idx_out, int* __restrict__ touched_out,
    float* __restrict__ rem_out, int cap, int K, int M, int per_warp,
    int blk, float beam_rad, float ipm, float c_tau, float xsi_r1,
    float xsi_den) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + warp;   // the warp's pair
  if (q >= cap / 2) return;   // whole warp leaves together
  const int p0 = (q / blk) * 2 * blk + q % blk;

  Side s0(smem + (size_t)warp * 2 * per_warp, K, p0);
  Side s1(smem + (size_t)warp * 2 * per_warp + per_warp, K, p0 + blk);
  side_init(s0, feats, a1g, a2g, validg, cap, K, lane);
  side_init(s1, feats, a1g, a2g, validg, cap, K, lane);
  const int trips = min(2 * max(s0.nv, s1.nv) + 3, 2 * K + 2);
  for (int it = 0; it < trips; ++it) {
    sweep_step(s0, it, K, lane);
    sweep_step(s1, it, K, lane);
  }
  amplitudes(s0, feats, rrg, cos_b, sin_b, cap, K, lane, beam_rad, ipm,
             c_tau, xsi_r1, xsi_den);
  amplitudes(s1, feats, rrg, cos_b, sin_b, cap, K, lane, beam_rad, ipm,
             c_tau, xsi_r1, xsi_den);

  const int n_bumps = max(s0.last_active, s1.last_active);
  float best0 = -INFINITY, best1 = -INFINITY;
  int best_i0 = M, best_i1 = M;
  for (int m = lane; m < M; m += 32) {
    const float bin = (float)m, cg = cos_g[m], sg = sin_g[m];
    const float w0 = wave_at(s0, K, n_bumps, bin, cg, sg);
    const float w1 = wave_at(s1, K, n_bumps, bin, cg, sg);
    if (w0 > best0) { best0 = w0; best_i0 = m; }
    if (w1 > best1) { best1 = w1; best_i1 = m; }
  }
  warp_peak(best0, best_i0);
  warp_peak(best1, best_i1);
  if (lane == 0) {
    write_out(s0, best0, best_i0, peak_out, idx_out, touched_out, rem_out);
    write_out(s1, best1, best_i1, peak_out, idx_out, touched_out, rem_out);
  }
}

}  // namespace

// Inputs (contiguous f32): feats (4, cap) rows [d_orig, right, left,
// 0.9 * max_intensity]; a1, a2, rr, valid (K, cap); cos_b, sin_b (K+1, cap);
// cos_g, sin_g (M,). Outputs (cap,): peak f32, idx i32, touched i32 0/1,
// remainder f32. Returns cudaGetLastError().
extern "C" int pulse_c1(
    const float* feats, const float* a1, const float* a2, const float* rr,
    const float* valid, const float* cos_b, const float* sin_b,
    const float* cos_g, const float* sin_g, float* peak, int* idx,
    int* touched, float* remainder, int cap, int K, int M, float beam_rad,
    float ipm, float c_tau, float xsi_r1, float xsi_den, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap == 0) return static_cast<int>(cudaGetLastError());
  const int per_warp = 12 * K + 8;   // floats, see the layout above
  const int per_warp_bytes = per_warp * 4;
  int warps = 48 * 1024 / per_warp_bytes;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (warps > 4) warps = 4;
  const int blocks = (cap + warps - 1) / warps;
  c1_kernel<<<blocks, warps * 32, warps * per_warp_bytes, s>>>(
      feats, a1, a2, rr, valid, cos_b, sin_b, cos_g, sin_g, peak, idx,
      touched, remainder, cap, K, M, per_warp, beam_rad, ipm, c_tau, xsi_r1,
      xsi_den);
  return static_cast<int>(cudaGetLastError());
}

// Kernel C2: arguments as pulse_c1, plus blk, the pulse-block width; cap must
// be a multiple of 2 * blk.
extern "C" int pulse_c2(
    const float* feats, const float* a1, const float* a2, const float* rr,
    const float* valid, const float* cos_b, const float* sin_b,
    const float* cos_g, const float* sin_g, float* peak, int* idx,
    int* touched, float* remainder, int cap, int K, int M, int blk,
    float beam_rad, float ipm, float c_tau, float xsi_r1, float xsi_den,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap == 0) return static_cast<int>(cudaGetLastError());
  if (blk <= 0 || cap % (2 * blk)) return static_cast<int>(cudaErrorInvalidValue);
  const int per_warp = 12 * K + 8;   // floats per beam, see Side
  const int per_warp_bytes = 2 * per_warp * 4;
  const int warps = max(1, min(4, 48 * 1024 / per_warp_bytes));
  const int smem = warps * per_warp_bytes;
  if (smem > 48 * 1024) {   // K near 512: one warp over 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        c2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int pairs = cap / 2;
  const int blocks = (pairs + warps - 1) / warps;
  c2_kernel<<<blocks, warps * 32, smem, s>>>(
      feats, a1, a2, rr, valid, cos_b, sin_b, cos_g, sin_g, peak, idx,
      touched, remainder, cap, K, M, per_warp, blk, beam_rad, ipm, c_tau,
      xsi_r1, xsi_den);
  return static_cast<int>(cudaGetLastError());
}
