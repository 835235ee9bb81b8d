"""Kernel C2 at other splits, timed on one CUDA device beside C1.

    python -m scripts.phase_c_sweep [--rounds 2] [--variants I ...]

Run from the repository root. Each variant of VARIANTS is csrc/pulse.cu
with C2's lanes a beam (kLanesC2) set: 16 lanes a beam is one pair of
beams a warp, 8 two pairs, 4 four. The variant "interleaved" also gets
INTERLEAVED, a kernel and a C entry (pulse_c2i, pulse_c2's arguments)
that run each pair on a whole warp, 32 lanes a beam, with the two beams'
windowed walks interleaved: each lane steps a bin of both beams' current
windows an iteration, two independent chains as the TPU kernel's pair
has. A variant runs at pulse block 512 (chip_smoke's) unless it names
another `blk`: at blk 1 a pair is two neighbouring beams, C1's own map,
so C2 against C1 there is the cost of the code apart from the pairing.
All variants are compiled by nvcc with the package's flags into
_build/sweep/, all builds started together. On the bench scene of
chip_smoke.py (scripts/kernel_ab.bench_inputs, this tree's A1, then the
compaction) each variant's C2 must equal the plain version; then its
device_ms (tools/kernel_times.device_ms) is taken over the variants in
turns, forwards then backwards each round, with this tree's C1 in every
turn as the reference. Prints the card's name and power limit, how far
the occluder counts of C1's neighbouring beams differ, then one JSON line
a variant with the compiler's registers and spills and how far the counts
of its pairs' two beams differ.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lidar_snow_sim_tpu_torch import _kernels
from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line, device_ms
from scripts.kernel_ab import (
    C2_BLOCK,
    _c1_call,
    bench_inputs,
    outputs_equal,
    pulse_call,
)

VARIANTS = [{"lanes": 16}, {"lanes": 8}, {"lanes": 4},
            {"lanes": 16, "interleaved": True},
            {"lanes": 16, "blk": 1}, {"lanes": 16, "blk": 64}]

# C2 at 32 lanes a beam, the pair's two windowed walks interleaved. Walk is
# windowed_peak's loop state for one beam, stepped a bin at a time.
INTERLEAVED = r"""
namespace {

struct Walk {
  const Side* s;
  int n, n_occ, tlo, thi, t = 0, plo = 0, phi = -1, lo, hi, below = 0,
      above = 0, next_lo = 0, best_i;
  bool occ = false;
  float tamp, tcb, tsb, amp = 0.f, cb = 0.f, sb = 0.f, best = -INFINITY;

  __device__ Walk(const Side& s_, int K, int M) : s(&s_), lo(M), hi(-1) {
    n = s_.n_walk;
    const bool tgt = n > 0 && s_.walk[n - 1] == K;
    n_occ = tgt ? n - 1 : n;
    tlo = tgt ? s_.walk_lo[n - 1] : M;
    thi = tgt ? s_.walk_hi[n - 1] : -1;
    tamp = s_.amp[K];
    tcb = s_.cb[K];
    tsb = s_.sb[K];
    best_i = M;
  }
  // take window t_ (empty past the last)
  __device__ void window(int t_, int K, int M) {
    t = t_;
    if (t >= n) {
      lo = M;
      hi = -1;
      return;
    }
    lo = s->walk_lo[t];
    hi = s->walk_hi[t];
    below = min(hi, plo - 1);
    above = max(lo, phi + 1);
    occ = t < n_occ;
    const int b = occ ? s->walk[t] : K;
    amp = s->amp[b];
    cb = s->cb[b];
    sb = s->sb[b];
    next_lo = t + 1 < n_occ ? s->walk_lo[t + 1] : M;
  }
  __device__ void bin(int m, const float* __restrict__ cos_g,
                      const float* __restrict__ sin_g) {
    if (m > hi || (m > below && m < above)) return;
    const float cg = cos_g[m], sg = sin_g[m];
    float w = (tlo <= m && m <= thi) ? term(tamp, tcb, tsb, cg, sg) : 0.f;
    if (occ) {
      w = w + term(amp, cb, sb, cg, sg);
      for (int u = t + 1; m >= next_lo && u < n_occ && s->walk_lo[u] <= m;
           ++u) {
        const int bu = s->walk[u];
        w = w + term(s->amp[bu], s->cb[bu], s->sb[bu], cg, sg);
      }
    }
    if (w > best || (w == best && m < best_i)) { best = w; best_i = m; }
  }
  __device__ void next() {
    if (t < n) {
      plo = lo;
      phi = hi;
    }
  }
  __device__ void finish(int M) {
    group_peak<32>(best, best_i);
    if (!(best > 0.f)) {
      const int u = lowest_uncovered(*s, M);
      if (u < M && (0.f > best || (0.f == best && u < best_i))) {
        best = 0.f;
        best_i = u;
      }
    }
  }
};

__global__ void c2i_kernel(
    const float* __restrict__ feats, const float* __restrict__ a1g,
    const float* __restrict__ a2g, const float* __restrict__ rrg,
    const float* __restrict__ validg, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ cos_g,
    const float* __restrict__ sin_g, float* __restrict__ peak_out,
    int* __restrict__ idx_out, unsigned char* __restrict__ touched_out,
    float* __restrict__ rem_out, int cap, int K, int M, int per_beam,
    int blk, float beam_rad, float ipm, float c_tau, float xsi_r1,
    float xsi_den) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= cap / 2) return;   // the whole warp leaves together
  const int p0 = (q / blk) * 2 * blk + q % blk;
  Side s0(smem + (size_t)warp * 2 * per_beam, K, p0);
  Side s1(smem + ((size_t)warp * 2 + 1) * per_beam, K, p0 + blk);
  side_init<32>(s0, feats, a1g, a2g, validg, cap, K, lane);
  side_init<32>(s1, feats, a1g, a2g, validg, cap, K, lane);
  sweep_all<32>(s0, K, lane);
  sweep_all<32>(s1, K, lane);
  amplitudes<32>(s0, feats, rrg, cos_b, sin_b, cap, K, lane, beam_rad, ipm,
                 c_tau, xsi_r1, xsi_den);
  amplitudes<32>(s1, feats, rrg, cos_b, sin_b, cap, K, lane, beam_rad, ipm,
                 c_tau, xsi_r1, xsi_den);
  walk_list<32>(s0, K, M, lane);
  walk_list<32>(s1, K, M, lane);
  Walk w0(s0, K, M), w1(s1, K, M);
  const int n = max(w0.n, w1.n);
  for (int t = 0; t < n; ++t) {
    w0.window(t, K, M);
    w1.window(t, K, M);
    const int len = max(w0.hi - w0.lo, w1.hi - w1.lo);
    for (int i = lane; i <= len; i += 32) {
      w0.bin(w0.lo + i, cos_g, sin_g);
      w1.bin(w1.lo + i, cos_g, sin_g);
    }
    w0.next();
    w1.next();
  }
  w0.finish(M);
  w1.finish(M);
  if (lane == 0) {
    write_out(s0, w0.best, w0.best_i, peak_out, idx_out, touched_out,
              rem_out);
    write_out(s1, w1.best, w1.best_i, peak_out, idx_out, touched_out,
              rem_out);
  }
}

}  // namespace

extern "C" int pulse_c2i(
    const float* feats, const float* a1, const float* a2, const float* rr,
    const float* valid, const float* cos_b, const float* sin_b,
    const float* cos_g, const float* sin_g, float* peak, int* idx,
    unsigned char* touched, float* remainder, int cap, int K, int M, int blk,
    float beam_rad, float ipm, float c_tau, float xsi_r1, float xsi_den,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap == 0) return static_cast<int>(cudaGetLastError());
  if (blk <= 0 || cap % (2 * blk)) return static_cast<int>(cudaErrorInvalidValue);
  int warps, smem;   // two beams a warp, as at 16 lanes a beam
  const cudaError_t e = launch_shape(c2i_kernel, K, 16, warps, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (cap / 2 + warps - 1) / warps;
  c2i_kernel<<<blocks, warps * 32, smem, s>>>(
      feats, a1, a2, rr, valid, cos_b, sin_b, cos_g, sin_g, peak, idx,
      touched, remainder, cap, K, M, 12 * K + 8, blk, beam_rad, ipm, c_tau,
      xsi_r1, xsi_den);
  return static_cast<int>(cudaGetLastError());
}
"""


def variant_source(variant: dict) -> str:
    """csrc/pulse.cu with kLanesC2 set, and INTERLEAVED appended for an
    interleaved variant."""
    src = (_kernels.CSRC / "pulse.cu").read_text()
    src, n = re.subn(r"constexpr int kLanesC2 = \d+;",
                     f"constexpr int kLanesC2 = {variant['lanes']};", src)
    if n != 1:
        raise RuntimeError("kLanesC2 not found once")
    return src + INTERLEAVED if variant.get("interleaved") else src


def entry(variant: dict) -> tuple[str, str]:
    """(the variant's C entry, its kernel's name)."""
    if variant.get("interleaved"):
        return "pulse_c2i", "c2i_kernel"
    return "pulse_c2", "c2_kernel"


def build_variant(i: int, variant: dict):
    """(loaded library, the compiler's register and spill lines for the
    variant's C2 kernel) of variant i."""
    out_dir = _kernels.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"pulse_v{i}.cu"
    so = out_dir / f"libpulse_v{i}.so"
    cu.write_text(variant_source(variant))
    proc = subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {i}:\n{proc.stderr}")
    fn, kernel = entry(variant)
    report, current = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            current = m.group(1)
        if current and kernel in current and ("registers" in line
                                              or "spill" in line):
            report.append(line.strip())
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _kernels.SIGNATURES["pulse"].items():
        f = getattr(lib, name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    f = getattr(lib, fn)
    f.argtypes = _kernels.SIGNATURES["pulse"]["pulse_c2"]
    f.restype = ctypes.c_int
    return lib, report


def pair_spread(valid, blk: int) -> dict:
    """How far the valid occluder counts of the beams that share a warp
    differ: C2's pairs (beam j of blocks 2i and 2i + 1) and C1's
    neighbours (beams 2j and 2j + 1)."""
    nv = (valid > 0.5).sum(dim=0).cpu().numpy()
    paired = nv.reshape(-1, 2, blk)
    out = {}
    for name, a, b in (("C2 pairs", paired[:, 0], paired[:, 1]),
                       ("C1 neighbours", nv[0::2], nv[1::2])):
        d = np.abs(a.astype(int) - b.astype(int)).ravel()
        out[name] = {"mean_abs_diff": float(d.mean()),
                     "share_differing": float((d > 0).mean()),
                     "max_abs_diff": int(d.max())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", type=int, nargs="+",
                    default=list(range(len(VARIANTS))))
    args = ap.parse_args(argv)
    variants = [VARIANTS[i] for i in args.variants]

    import torch

    if not torch.cuda.is_available():
        print("phase_c_sweep: no CUDA device", file=sys.stderr)
        return 1
    from lidar_snow_sim_tpu_torch.models.snowfall import compact_occluded
    from lidar_snow_sim_tpu_torch.ops.occluders import find_occluders
    from lidar_snow_sim_tpu_torch.ops.pulse import pulse_plain

    print(card_line(), flush=True)
    with ThreadPoolExecutor(len(variants) + 1) as pool:
        this = pool.submit(_kernels.load, "pulse")
        builds = [pool.submit(build_variant, i, v)
                  for i, v in zip(args.variants, variants)]
        this, builds = this.result(), [f.result() for f in builds]

    bench = bench_inputs(torch.device("cuda"))
    a12d, ovf = find_occluders(*bench.lay.occluder_args,
                               **bench.lay.occluder_kw)
    comp = compact_occluded(bench.lay, a12d, ovf, bench.calib, bench.cfg)
    pargs, pkw = comp.pulse_args, comp.pulse_kw
    want = pulse_plain(*pargs, **pkw)
    print(json.dumps({"cap": comp.cap, "C1 neighbours": pair_spread(
        pargs[4], C2_BLOCK)["C1 neighbours"]}), flush=True)
    c1 = _c1_call(this, pargs, pkw)

    calls, rec = [], []
    for v, variant, (lib, report) in zip(args.variants, variants, builds):
        fn_name, kernel = entry(variant)
        blk = variant.get("blk", C2_BLOCK)
        fn = pulse_call(lib, fn_name, pargs, pkw, 1, (blk,))
        got = fn()
        torch.cuda.synchronize()
        if not outputs_equal("C2", got, want, 0):
            print(f"phase_c_sweep: variant {v} differs from the plain "
                  "version", file=sys.stderr)
            return 1
        calls.append((fn, kernel))
        rec.append({"variant": v, **variant, "compiler": report,
                    "pairs": pair_spread(pargs[4], blk)["C2 pairs"],
                    "C2_device_ms": [], "C1_device_ms": []})

    for r in range(args.rounds):
        order = range(len(variants)) if r % 2 == 0 else \
            reversed(range(len(variants)))
        for i in order:
            rec[i]["C1_device_ms"].append(device_ms(c1, "c1_kernel")[0])
            rec[i]["C2_device_ms"].append(device_ms(*calls[i])[0])
    for r in rec:
        for name in ("C1", "C2"):
            r[f"{name}_median_ms"] = float(np.median(r[f"{name}_device_ms"]))
        r["C2_over_C1"] = r["C2_median_ms"] / r["C1_median_ms"]
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
