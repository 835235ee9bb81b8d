"""Kernels A2, A3, A4a and A4b at other lane, beam and tile splits, timed
on one CUDA device.

    python -m scripts.phase_a_sweep [--rounds 2] [--variants I ...]

Run from the repository root. Each variant of VARIANTS is
csrc/occluders.cu with the split constants it names set (CONSTS: A4a's
kLanesA4a, kBeamsA4a, kTileA4a; A4b's likewise; A2's kLanesA2, kBeamsA2,
kTileA2 and its mode-1 split kLanesA2s, kBeamsA2s; A3's kLanesA3,
kBeamsA3, kTileA3; for A2 and A3 also the CTAs an SM their
__launch_bounds__ asks for), compiled by nvcc with the package's flags into
_build/sweep/, all builds started together. For each variant and each
kernel it names (K <= 32, as at the bench) it reports the compiler's
registers and spills, the SASS instructions a test on the no-hit path of
each of the kernel's hit-test loops (scripts/sass_loops.py), and checks
that the kernel equals its plain version on the bench scene of
chip_smoke.py (scripts/kernel_ab.bench_inputs: A4a and A4b on A1's
layout, A2 on the routed one, A3 on the banded one). A2 is also run with
its mode-1 chunks set to mode 0 in a copy of its arguments ("A2 no mode
1"), which shows whether those chunks set the kernel's length. Then it
times each kernel's device_ms (tools/kernel_times.device_ms) over the
variants in turns, forwards then backwards each round, with this tree's
A1 in every turn as the reference. Prints the card's name and power
limit, then one JSON line a variant.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lidar_snow_sim_tpu_torch import _kernels
from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line, device_ms
from scripts import sass_loops
from scripts.kernel_ab import (
    _a1_call,
    banded_call,
    bench_inputs,
    outputs_equal,
    routed_call,
    ungated_call,
)

# the split constants of each kernel, in the order a variant gives them;
# CtasA2 / CtasA3 are the CTAs an SM that the kernel's __launch_bounds__
# asks for (0: none asked, as the source has it)
CONSTS = {
    "A4a": ("LanesA4a", "BeamsA4a", "TileA4a"),
    "A4b": ("LanesA4b", "BeamsA4b", "TileA4b"),
    "A2": ("LanesA2", "BeamsA2", "TileA2", "LanesA2s", "BeamsA2s",
           "CtasA2"),
    "A3": ("LanesA3", "BeamsA3", "TileA3", "CtasA3"),
}
LAUNCH_BOUNDS = {"CtasA2": "kLanesA2 * kBeamsA2",
                 "CtasA3": "kLanesA3 * kBeamsA3"}
# --variants picks some by index. 0-10: A4a with A4b splits; 11-28: A2
# (lanes, beams, tile; mode 1's lanes, beams; CTAs an SM) with A3 (lanes,
# beams, tile; CTAs an SM)
VARIANTS = [
    {"A4a": a, "A4b": b} for a, b in [
        ((4, 64, 2048), (4, 64, 2048)),
        ((8, 32, 2048), (4, 32, 2048)),
        ((8, 16, 2048), (8, 32, 2048)),
        ((16, 16, 2048), (8, 16, 2048)),
        ((32, 8, 2048), (4, 64, 1024)),
        ((4, 32, 2048), (16, 16, 2048)),
        ((8, 32, 1024), (4, 32, 1024)),
        ((4, 64, 1024), (8, 16, 1024)),
        ((4, 128, 2048), (16, 32, 2048)),
        ((8, 64, 2048), (8, 64, 2048)),
        ((16, 32, 2048), (4, 128, 2048)),
    ]
] + [
    {"A2": (*a, 0), "A3": (*b, 0)} for a, b in [
        ((4, 64, 2048, 4, 64), (4, 64, 2048)),
        ((4, 64, 2048, 8, 32), (4, 64, 1024)),
        ((4, 64, 2048, 16, 16), (8, 32, 2048)),
        ((4, 64, 2048, 32, 8), (8, 32, 1024)),
        ((8, 32, 2048, 16, 16), (4, 32, 1024)),
        ((8, 32, 2048, 32, 8), (8, 64, 2048)),
        ((4, 32, 2048, 16, 8), (4, 128, 1024)),
        ((8, 64, 2048, 16, 32), (16, 16, 1024)),
        ((4, 64, 1024, 16, 16), (2, 128, 1024)),
    ]
] + [
    # 20-28: the best of 11-19 again and their neighbours, asking
    # __launch_bounds__ for 1, 5, 6 or 8 CTAs an SM (6: at most 40
    # registers, 8: 32)
    {"A2": a, "A3": b} for a, b in [
        ((4, 64, 2048, 32, 8, 6), (4, 64, 1024, 6)),
        ((4, 64, 2048, 32, 8, 1), (4, 64, 1024, 8)),
        ((4, 64, 1024, 32, 8, 1), (4, 64, 512, 1)),
        ((4, 64, 2048, 16, 16, 6), (4, 64, 1024, 1)),
        ((4, 64, 1024, 16, 16, 1), (4, 64, 768, 1)),
        ((4, 64, 2048, 32, 8, 5), (2, 128, 1024, 6)),
        ((4, 64, 1024, 32, 8, 6), (4, 32, 1024, 8)),
        ((4, 64, 2048, 8, 32, 1), (4, 64, 1024, 1)),
        ((4, 64, 2048, 32, 8, 1), (8, 32, 1024, 1)),
    ]
]


def variant_source(variant: dict) -> str:
    """csrc/occluders.cu with each constant `variant` names set."""
    src = (_kernels.CSRC / "occluders.cu").read_text()
    for kernel, vals in variant.items():
        for name, v in zip(CONSTS[kernel], vals, strict=True):
            if name in LAUNCH_BOUNDS:
                if v:
                    old = f"__launch_bounds__({LAUNCH_BOUNDS[name]})"
                    src, n = re.subn(re.escape(old), old[:-1] + f", {v})",
                                     src)
                    if n != 1:
                        raise RuntimeError(f"{old} not found once")
                continue
            src, n = re.subn(rf"constexpr int k{name} = \d+;",
                             f"constexpr int k{name} = {v};", src)
            if n != 1:
                raise RuntimeError(f"k{name} not found once")
    return src


def build_variant(i: int, variant: dict):
    """(loaded library, its path, {kernel: compiler report lines}) of
    variant i."""
    import ctypes

    out_dir = _kernels.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"occluders_v{i}.cu"
    so = out_dir / f"liboccluders_v{i}.so"
    cu.write_text(variant_source(variant))
    proc = subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {i}:\n{proc.stderr}")
    report, entry = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            entry = m.group(1)
        for name in variant:
            if entry and f"{_kernel(name)}ILi32E" in entry and (
                    "registers" in line or "spill" in line):
                report.setdefault(name, []).append(line.strip())
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _kernels.SIGNATURES["occluders"].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib, so, report


def _kernel(name: str) -> str:
    return f"{name.lower()}_kernel"


def sass_per_test(so, names) -> dict:
    """{kernel: [SASS instructions a test on the no-hit path of each of its
    hit-test loops (8 FMUL a test), ascending]}."""
    listing = subprocess.run([sass_loops.cuobjdump(), "-sass", str(so)],
                             capture_output=True, text=True,
                             check=True).stdout
    out = {}
    for fname, instrs in sass_loops.functions(listing).items():
        for name in names:
            if f"{_kernel(name)}ILi32E" not in fname:
                continue
            out[name] = sorted(
                lp["fast_path"] / (lp["fast_path_fmul"] / 8)
                for lp in sass_loops.loops(instrs)
                if lp["fast_path_fmul"] >= 8)
    return out


def kernel_cases(bench):
    """{kernel: (its C entry's fn factory, arguments, keywords, plain
    version's output)} on the bench scene."""
    from lidar_snow_sim_tpu_torch.ops.occluders import (
        occluders_banded_plain,
        occluders_routed_plain,
        occluders_ungated_plain,
    )

    feats, w0b, rows, los, _, counts, data_t, wide_t = bench.lay.occluder_args
    args_u = (feats, w0b, rows, los, counts, data_t, wide_t)
    kw = bench.lay.occluder_kw
    r_args, r_kw = bench.routed.occluder_args, bench.routed.occluder_kw
    no_m1 = list(r_args)
    no_m1[5] = r_args[5].masked_fill(r_args[5] == 1, 0)
    b_args, b_kw = bench.banded.occluder_args, bench.banded.occluder_kw
    ungated = occluders_ungated_plain(*args_u, **kw)

    def ug(entry):
        return lambda lib, a, k: ungated_call(lib, entry, a, k)

    return {
        "A4a": (ug("occluders_a4a"), args_u, kw, ungated),
        "A4b": (ug("occluders_a4b"), args_u, kw, ungated),
        "A2": (routed_call, r_args, r_kw,
               occluders_routed_plain(*r_args, **r_kw)),
        "A2 no mode 1": (routed_call, tuple(no_m1), r_kw,
                         occluders_routed_plain(*no_m1, **r_kw)),
        "A3": (banded_call, b_args, b_kw,
               occluders_banded_plain(*b_args, **b_kw)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", type=int, nargs="+",
                    default=list(range(len(VARIANTS))))
    args = ap.parse_args(argv)
    variants = [VARIANTS[i] for i in args.variants]

    import torch

    if not torch.cuda.is_available():
        print("phase_a_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    with ThreadPoolExecutor(len(variants) + 1) as pool:
        this = pool.submit(_kernels.load, "occluders")
        builds = [pool.submit(build_variant, i, v)
                  for i, v in zip(args.variants, variants)]
        this, builds = this.result(), [f.result() for f in builds]

    bench = bench_inputs(torch.device("cuda"))
    cases = kernel_cases(bench)
    a1 = _a1_call(this, bench.lay.occluder_args, bench.lay.occluder_kw)

    calls, rec = [], []
    for v, variant, (lib, so, report) in zip(args.variants, variants,
                                             builds):
        sass = sass_per_test(so, variant)
        names = [n for n in cases if n.split()[0] in variant]
        calls.append({})
        rec.append({"variant": v, "A1_device_ms": []})
        for name in names:
            factory, a, kw, want = cases[name]
            fn = factory(lib, a, kw)
            got = fn()
            torch.cuda.synchronize()
            if not outputs_equal(name, got, want, kw["k_occ"]):
                print(f"phase_a_sweep: variant {v} {name} differs from its "
                      "plain version", file=sys.stderr)
                return 1
            kernel = name.split()[0]
            calls[-1][name] = (fn, _kernel(kernel))
            rec[-1][name] = dict(
                zip(CONSTS[kernel], variant[kernel]),
                compiler=report.get(kernel, []),
                sass_per_test=sass.get(kernel), device_ms=[])

    for r in range(args.rounds):
        order = range(len(variants)) if r % 2 == 0 else \
            reversed(range(len(variants)))
        for i in order:
            rec[i]["A1_device_ms"].append(device_ms(a1, "a1_kernel")[0])
            for name, (fn, kern) in calls[i].items():
                rec[i][name]["device_ms"].append(device_ms(fn, kern)[0])
    for r, c in zip(rec, calls):
        for name in c:
            r[name]["median_ms"] = float(np.median(r[name]["device_ms"]))
        r["A1_median_ms"] = float(np.median(r["A1_device_ms"]))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
