"""Kernels A4a and A4b at other lane, beam and tile splits, timed on one
CUDA device.

    python -m scripts.a4_sweep [--rounds 2] [--variants I ...]

Run from the repository root. Each variant of VARIANTS is
csrc/occluders.cu with A4a's constants (kLanesA4a, kBeamsA4a, kTileA4a)
and A4b's (kLanesA4b, kBeamsA4b, kTileA4b) set as it names, compiled by
nvcc with the package's flags into _build/sweep/, all builds started
together. For each variant and kernel (K <= 32, as at the bench) it
reports the compiler's registers and spills, the hit-test loop's SASS
instructions a test on its no-hit path (scripts/sass_loops.py), and
checks that the kernel equals occluders_ungated_plain on the bench scene
of chip_smoke.py (scripts/kernel_ab.bench_inputs). Then it times each
kernel's device_ms (tools/kernel_times.device_ms) over the variants in
turns, forwards then backwards each round, with this tree's A1 in every
turn as the reference. Prints the card's name and power limit, then one
JSON line a variant.
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
    bench_inputs,
    phase_a_equal,
    ungated_call,
)

# (lanes a beam, beams a CTA and chunk, tile columns) of A4a and of A4b;
# --variants picks some by index
VARIANTS = [
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
KERNELS = {"A4a": ("occluders_a4a", "a4a_kernel"),
           "A4b": ("occluders_a4b", "a4b_kernel")}


def variant_source(a4a, a4b) -> str:
    src = (_kernels.CSRC / "occluders.cu").read_text()
    for kernel, vals in (("A4a", a4a), ("A4b", a4b)):
        for what, v in zip(("Lanes", "Beams", "Tile"), vals):
            src, n = re.subn(rf"constexpr int k{what}{kernel} = \d+;",
                             f"constexpr int k{what}{kernel} = {v};", src)
            if n != 1:
                raise RuntimeError(f"k{what}{kernel} not found once")
    return src


def build_variant(i: int, a4a, a4b):
    """(loaded library, {kernel: compiler report lines}) of variant i."""
    import ctypes

    out_dir = _kernels.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"occluders_v{i}.cu"
    so = out_dir / f"liboccluders_v{i}.so"
    cu.write_text(variant_source(a4a, a4b))
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
        for name, (_, kern) in KERNELS.items():
            if entry and f"{kern}ILi32E" in entry and (
                    "registers" in line or "spill" in line):
                report.setdefault(name, []).append(line.strip())
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _kernels.SIGNATURES["occluders"].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib, so, report


def sass_per_test(so) -> dict:
    """{kernel: SASS instructions a test on the no-hit path of its hit-test
    loop (the loop with the most products; 8 FMUL a test)}."""
    listing = subprocess.run([sass_loops.cuobjdump(), "-sass", str(so)],
                             capture_output=True, text=True,
                             check=True).stdout
    out = {}
    for fname, instrs in sass_loops.functions(listing).items():
        for name, (_, kern) in KERNELS.items():
            if f"{kern}ILi32E" not in fname:
                continue
            lp = max(sass_loops.loops(instrs),
                     key=lambda lp: lp["fast_path_fmul"], default=None)
            if lp and lp["fast_path_fmul"]:
                out[name] = lp["fast_path"] / (lp["fast_path_fmul"] / 8)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", type=int, nargs="+",
                    default=list(range(len(VARIANTS))))
    args = ap.parse_args(argv)
    variants = [VARIANTS[i] for i in args.variants]

    import torch

    from lidar_snow_sim_tpu_torch.ops.occluders import occluders_ungated_plain

    if not torch.cuda.is_available():
        print("a4_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    with ThreadPoolExecutor(len(variants) + 1) as pool:
        this = pool.submit(_kernels.load, "occluders")
        builds = [pool.submit(build_variant, i, *v)
                  for i, v in zip(args.variants, variants)]
        this, builds = this.result(), [f.result() for f in builds]

    lay, _, _, _ = bench_inputs(torch.device("cuda"))
    kw = lay.occluder_kw
    feats, w0b, rows, los, _, counts, data_t, wide_t = lay.occluder_args
    args_u = (feats, w0b, rows, los, counts, data_t, wide_t)
    want = occluders_ungated_plain(*args_u, **kw)
    a1 = _a1_call(this, lay.occluder_args, kw)

    calls, rec = [], []
    for i, (v, (a4a, a4b), (lib, so, report)) in enumerate(
            zip(args.variants, variants, builds)):
        sass = sass_per_test(so)
        calls.append({})
        rec.append({"variant": v})
        for name, (entry, kern) in KERNELS.items():
            fn = ungated_call(lib, entry, args_u, kw)
            got = fn()
            torch.cuda.synchronize()
            if not phase_a_equal(got, want, kw["k_occ"]):
                print(f"a4_sweep: variant {v} {name} differs from its plain "
                      "version", file=sys.stderr)
                return 1
            lanes, beams, tile = a4a if name == "A4a" else a4b
            calls[i][name] = (fn, kern)
            rec[i][name] = dict(
                lanes=lanes, beams=beams, tile=tile,
                threads=lanes * beams * (2 if name == "A4b" else 1),
                compiler=report.get(name, []), sass_per_test=sass.get(name),
                device_ms=[])
        rec[i]["A1_device_ms"] = []

    for r in range(args.rounds):
        order = range(len(variants)) if r % 2 == 0 else \
            reversed(range(len(variants)))
        for i in order:
            rec[i]["A1_device_ms"].append(device_ms(a1, "a1_kernel")[0])
            for name, (fn, kern) in calls[i].items():
                rec[i][name]["device_ms"].append(device_ms(fn, kern)[0])
    for r in rec:
        for name in KERNELS:
            r[name]["median_ms"] = float(np.median(r[name]["device_ms"]))
        r["A1_median_ms"] = float(np.median(r["A1_device_ms"]))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
