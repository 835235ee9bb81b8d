// Kernel C1: first-claim sweep and received-pulse peak per occluded beam.
//
// Replaces `_kernel` of lidar_snow_sim_tpu/ops/pallas_pulse.py (with its
// helpers `_side_state`, `_sweep_step`, `_sweep_init` and `_make_wave_fns`),
// phase C of the dense snowfall assembly. For each compacted beam it
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

  float* score = smem + (size_t)warp * per_warp;   // 2K + 2 endpoints
  float* claimed = score + 2 * K + 2;              // K
  float* a1s = claimed + K;                        // K
  float* a2s = a1s + K;                            // K
  float* vs = a2s + K;                             // K, 0/1
  float* amp = vs + K;                             // K + 1 (target last)
  float* cb = amp + K + 1;                         // K + 1
  float* sb = cb + K + 1;                          // K + 1
  float* wlo = sb + K + 1;                         // K + 1 window starts
  float* whi = wlo + K + 1;                        // K + 1 window ends

  const float d_orig = feats[p];
  const float right = feats[(size_t)cap + p];
  const float left = feats[2 * (size_t)cap + p];
  const float amp_scale = feats[3 * (size_t)cap + p];
  const bool wrapped = right > left;

  int nv = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    bool v = false;
    if (k < K) {
      const size_t at = (size_t)k * cap + p;
      float a1 = a1g[at], a2 = a2g[at];
      v = validg[at] > 0.5f;
      if (wrapped && a1 > a2) a1 = a1 - kTwoPi;
      if (!v) { a1 = left; a2 = left; }
      a1s[k] = a1;
      a2s[k] = a2;
      vs[k] = v ? 1.f : 0.f;
      claimed[k] = 0.f;
      score[2 + k] = a1;
      score[2 + K + k] = a2;
    }
    nv += __popc(__ballot_sync(0xffffffffu, v));
  }
  if (lane == 0) {
    score[0] = wrapped ? right - kTwoPi : right;
    score[1] = left;
  }
  __syncwarp();

  // first-claim sweep; trips beyond the distinct endpoints add zeros
  const int m_e = 2 * K + 2;
  const int trips = min(2 * nv + 3, m_e);
  float prev = 0.f, unclaimed = 0.f;
  for (int it = 0; it < trips; ++it) {
    float local = kBig;
    for (int j = lane; j < m_e; j += 32) local = fminf(local, score[j]);
    const float cur = warp_min(local);
    const bool live = cur < kBig / 2;
    const float width = (it > 0 && live) ? cur - prev : 0.f;
    const float mid = 0.5f * (cur + prev);
    int w = K;
    for (int k = lane; k < K; k += 32)
      if (a1s[k] <= mid && mid <= a2s[k] && vs[k] > 0.5f) { w = k; break; }
    const int widx = warp_min_int(w);
    if (widx < K) {
      if (lane == 0) claimed[widx] = claimed[widx] + width;
    } else {
      unclaimed = unclaimed + width;
    }
    // each lane retires only the endpoints it read: no cross-lane hazard
    for (int j = lane; j < m_e; j += 32)
      if (score[j] == cur) score[j] = kBig;
    prev = live ? cur : prev;
    __syncwarp();
  }

  // shares -> amplitudes; window bounds in bins
  const float remainder = fminf(fmaxf(unclaimed / beam_rad, 0.f), 1.f);
  int last_active = 0;
  bool touched = false;
  for (int b = lane; b <= K; b += 32) {
    float r, share;
    if (b < K) {
      const float c = claimed[b];
      touched = touched || c > 0.f;
      share = fminf(fmaxf(c / beam_rad, 0.f), 1.f);
      if (share > 0.f) last_active = max(last_active, b + 1);
      r = rrg[(size_t)b * cap + p];
    } else {
      share = remainder;
      r = d_orig;
    }
    const float r_amp = fminf(fmaxf(r, 1e-6f), 1e6f);
    const float xsi = fminf(fmaxf((r_amp - xsi_r1) / xsi_den, 0.f), 1.f);
    amp[b] = amp_scale * share * xsi / (r_amp * r_amp);
    cb[b] = cos_b[(size_t)b * cap + p];
    sb[b] = sin_b[(size_t)b * cap + p];
    wlo[b] = r * ipm;
    whi[b] = (r + c_tau) * ipm;
  }
  touched = __any_sync(0xffffffffu, touched);
  last_active = warp_max_int(last_active);
  __syncwarp();

  // waveform: target bump first, then occluder bumps in index order
  float best = -INFINITY;
  int best_i = M;
  for (int m = lane; m < M; m += 32) {
    const float bin = (float)m;
    const float cg = cos_g[m], sg = sin_g[m];
    float w;
    {
      const float pulse = 0.5f * (1.0f - (cg * cb[K] + sg * sb[K]));
      w = (bin >= wlo[K] && bin <= whi[K]) ? amp[K] * pulse : 0.f;
    }
    for (int b = 0; b < last_active; ++b) {
      const float pulse = 0.5f * (1.0f - (cg * cb[b] + sg * sb[b]));
      w = w + ((bin >= wlo[b] && bin <= whi[b]) ? amp[b] * pulse : 0.f);
    }
    if (w > best) { best = w; best_i = m; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ov > best || (ov == best && oi < best_i)) { best = ov; best_i = oi; }
  }
  if (lane == 0) {
    peak_out[p] = best;
    idx_out[p] = best_i;
    touched_out[p] = touched ? 1 : 0;
    rem_out[p] = remainder;
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
