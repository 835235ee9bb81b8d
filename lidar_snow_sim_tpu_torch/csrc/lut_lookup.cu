// Kernel L1: piecewise-linear lookup in a small knot-pair table.
//
// Replaces `_lookup_kernel` of lidar_snow_sim_tpu/ops/lut_lookup.py (reached
// through `_lookup_flat` and `lut_lookup_pairs`), LISA's Mie backscatter
// lookup of every (point, droplet) candidate. For each position p:
//   cell = min(max((int)p, 0), g1 - 1),  f = p - cell,
//   out  = lo * (1 - f) + hi * f,        (lo, hi) = row `cell` of the table.
//
// The TPU kernel splits each f32 knot into four bf16 parts and contracts a
// one-hot with them on the MXU: both only serve the TPU's matrix unit and
// rebuild the f32 knots exactly, and its 128-cell cap is the one-hot's
// width. Here the (g1, 2) f32 table itself is staged into dynamic shared
// memory by every CTA, sized from g1 (up to 6144 rows, the 48 KB a CTA
// gets without opting in), and each thread walks the positions with a
// grid-stride loop, four at a time (float4 loads and stores) where the
// pointers allow it.
//
// What bounds it: bytes. 8 bytes of device memory per lookup (read p,
// write out) against a handful of flops; the table reads hit shared memory.
//
// Exactness. Compiled with -fmad=false, so lo * (1 - f) and hi * f are each
// rounded before the sum, as in the plain torch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCells = 6144;   // 48 KB of float2
constexpr int kThreads = 256;

__device__ __forceinline__ float lerp_cell(const float2* tab, int g1,
                                           float p) {
  int i = (int)p;
  i = min(max(i, 0), g1 - 1);
  const float f = p - (float)i;
  const float2 kn = tab[i];
  return kn.x * (1.0f - f) + kn.y * f;
}

__global__ void l1_kernel(const float* __restrict__ p,
                          const float* __restrict__ table,
                          float* __restrict__ out, long long n, int g1,
                          bool vec4) {
  extern __shared__ float2 tab[];   // g1 rows
  for (int j = threadIdx.x; j < g1; j += blockDim.x)
    tab[j] = make_float2(table[2 * j], table[2 * j + 1]);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec4) {
    const long long n4 = n / 4;
    const float4* p4 = reinterpret_cast<const float4*>(p);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long j = t; j < n4; j += stride) {
      const float4 v = p4[j];
      float4 r;
      r.x = lerp_cell(tab, g1, v.x);
      r.y = lerp_cell(tab, g1, v.y);
      r.z = lerp_cell(tab, g1, v.z);
      r.w = lerp_cell(tab, g1, v.w);
      o4[j] = r;
    }
    done = n4 * 4;
  }
  for (long long j = done + t; j < n; j += stride)
    out[j] = lerp_cell(tab, g1, p[j]);
}

}  // namespace

// p (n,) f32, table (g1, 2) f32 rows (lo, hi), out (n,) f32;
// 1 <= g1 <= 6144.
// Returns cudaGetLastError().
extern "C" int lut_lookup_l1(const float* p, const float* table, float* out,
                             long long n, int g1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g1 < 1 || g1 > kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const bool vec4 = (reinterpret_cast<uintptr_t>(p) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long items = vec4 ? (n + 3) / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  // enough CTAs to fill the card several times over; the loop strides on
  if (blocks > 132 * 16) blocks = 132 * 16;
  const size_t smem = sizeof(float2) * (size_t)g1;
  l1_kernel<<<(int)blocks, kThreads, smem, s>>>(p, table, out, n, g1, vec4);
  return static_cast<int>(cudaGetLastError());
}
