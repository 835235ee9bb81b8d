"""The steps of kernels W1 and W2's redesign, and their splits, timed on
one CUDA device.

    python -m scripts.window_sweep [--other DIR] [--rounds 2]
        [--variants I ...]

Run from the repository root, on chip_smoke.py phase 12's inspect config
on the channel-sorted bench scan (scripts/kernel_ab.window_bench). Rows:
  - with --other DIR (a checkout whose W1 and W2 take no live mask: the
    parent of their redesign), that checkout's W1 and W2 on every row,
    and on the live rows only (called with n = the live count: the
    padding, sorted last, left out), which is what the live gate alone
    buys on the earlier kernels;
  - this tree's W1 and W2 without a live mask (every padding row
    computed) and with it;
  - each variant of VARIANTS: csrc/occluders.cu and csrc/pulse.cu with the
    constants it names set (W1: kPointsW1, kWarpsW1, kSpanW1, kWideW1,
    kHitsW1, kCtasW1, the CTAs an SM its __launch_bounds__ asks; W2:
    kLanesW2), compiled by nvcc with the package's flags into
    _build/sweep/, all builds started together; kSpanW1 = kWideW1 = 0 is
    W1 reading the bank from global memory (no staging). A variant whose
    W1 needs more than the 48 KB default of shared memory fails W1's
    static_assert and is reported as skipped.
Each row is checked against the plain versions on the live rows (the
other checkout's W2 on its own W1's rows; a row that differs is reported
and still timed), then every row's device_ms
(tools/kernel_times.device_ms) is taken in turns, forwards then backwards
each round. Prints the card's name and power limit, then one JSON line a
row, with the compiler's register and spill report of each variant's
kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from lidar_snow_sim_tpu_torch import _kernels
from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line, device_ms
from scripts.kernel_ab import (
    build_other,
    live_api,
    live_rows_equal,
    w1_call,
    w2_call,
    window_bench,
)

FILES = {"PointsW1": "occluders", "WarpsW1": "occluders",
         "SpanW1": "occluders", "WideW1": "occluders",
         "HitsW1": "occluders", "CtasW1": "occluders", "LanesW2": "pulse"}
# --variants picks some by index
VARIANTS = [
    {"SpanW1": 0, "WideW1": 0},                 # W1 without staging
    {"PointsW1": 16, "WarpsW1": 4},
    {"PointsW1": 32, "WarpsW1": 4},
    {"PointsW1": 16, "WarpsW1": 8},
    {"PointsW1": 32, "WarpsW1": 16},
    {"HitsW1": 128},
    {"CtasW1": 3},
    {"CtasW1": 4},
    {"LanesW2": 8},
    {"LanesW2": 4},
    {"LanesW2": 32},
]


def variant_source(name: str, variant: dict) -> str:
    """csrc/<name>.cu with each of its constants that `variant` names set."""
    src = (_kernels.CSRC / f"{name}.cu").read_text()
    for const, v in variant.items():
        if FILES[const] != name:
            continue
        src, n = re.subn(rf"constexpr int k{const} = \d+;",
                         f"constexpr int k{const} = {v};", src)
        if n != 1:
            raise RuntimeError(f"k{const} not found once in {name}.cu")
    return src


SMEM_ASSERT = "needs more than the 48 KB default of shared memory"


def build_variant(i: int, name: str, variant: dict):
    """(loaded library, compiler report lines of its W1/W2 kernels) of
    csrc/<name>.cu in variant i; None where W1's static_assert refuses the
    variant's shared memory."""
    out_dir = _kernels.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}_w{i}.cu"
    so = out_dir / f"lib{name}_w{i}.so"
    cu.write_text(variant_source(name, variant))
    proc = subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0 and SMEM_ASSERT in proc.stderr:
        return None
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {i}:\n{proc.stderr}")
    report, entry = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            entry = m.group(1)
        if entry and re.search(r"w[12]_kernel", entry) and (
                "registers" in line or "spill" in line):
            report.append(line.strip())
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _kernels.SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib, report


def first_differences(got, want, mask) -> dict:
    """For each output that differs on the rows of `mask`: the count of
    differing entries and the first, as (count, index, got, want)."""
    import torch

    out = {}
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a[mask[:a.shape[0]]], b[mask[:b.shape[0]]]
        bad = (a != b) & ~(a.isnan() & b.isnan()) if a.is_floating_point() \
            else a != b
        if bad.any():
            at = tuple(torch.nonzero(bad)[0].tolist())
            out[i] = (int(bad.sum()), at, a[at].item(), b[at].item())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", type=int, nargs="*",
                    default=list(range(len(VARIANTS))))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("window_sweep: no CUDA device", file=sys.stderr)
        return 1
    from lidar_snow_sim_tpu_torch.ops.occluders import occluders_window_plain
    from lidar_snow_sim_tpu_torch.ops.pulse import window_pulse_plain
    from lidar_snow_sim_tpu_torch.models import snowfall as ts

    print(card_line(), flush=True)
    with ThreadPoolExecutor(2 * len(args.variants) + 4) as pool:
        this = {n: pool.submit(_kernels.load, n) for n in FILES.values()}
        other = ({n: pool.submit(build_other, args.other.resolve(), n)
                  for n in set(FILES.values())} if args.other else {})
        builds = {(i, n): pool.submit(build_variant, i, n, VARIANTS[i])
                  for i in args.variants for n in set(FILES.values())
                  if any(FILES[c] == n for c in VARIANTS[i])}
        this = {n: f.result() for n, f in this.items()}
        other = {n: f.result() for n, f in other.items()}
        builds = {k: f.result() for k, f in builds.items()}

    dev = torch.device("cuda")
    inp, bank_t, cfg = window_bench(dev)
    mask = inp.mask
    n_live = int(mask.sum())
    args_p, kw_p = ts.window_occluder_call(inp, bank_t, cfg)
    want1 = occluders_window_plain(*args_p, **kw_p)
    pargs, pkw = ts.window_pulse_call(inp, [t.contiguous() for t in want1],
                                      cfg)
    want2 = window_pulse_plain(*pargs, **pkw)

    rows = []   # (label, constants, w1 fn, w2 fn, report)

    def add(label, libs, api, live=True, n=None, consts=None, report=None):
        w1 = w1_call(libs["occluders"], api, inp, bank_t, cfg, live, n)
        occ = [t.clone() for t in w1()]
        w2 = w2_call(libs["pulse"], api, inp, occ, cfg, live, n)
        equal = {}
        for fn, want, k in ((w1, want1, "W1"), (w2, want2, "W2")):
            got = fn()
            torch.cuda.synchronize()
            equal[k] = live_rows_equal(got, want, mask)
            if not equal[k]:
                print(f"window_sweep: {label} {k} differs from its plain "
                      f"version on the live rows: "
                      f"{first_differences(got, want, mask)}", flush=True)
        rows.append((label, consts or {}, w1, w2, report or [], equal))

    if other:
        api = live_api(args.other.resolve())
        add("other, every row", other, api, live=False)
        add("other, the live rows (n = live)", other, api, live=False,
            n=n_live)
    add("this, no live mask", this, True, live=False)
    add("this", this, True)
    for i in args.variants:
        if any(builds[k] is None for k in builds if k[0] == i):
            print(json.dumps({"row": f"variant {i}", "constants":
                              VARIANTS[i], "skipped": f"W1 {SMEM_ASSERT}"}),
                  flush=True)
            continue
        libs = dict(this)
        report = []
        for n in set(FILES.values()):
            if (i, n) in builds:
                libs[n], rep = builds[(i, n)]
                report += rep
        add(f"variant {i}", libs, True, consts=VARIANTS[i], report=report)

    times = [{"W1": [], "W2": []} for _ in rows]
    for r in range(args.rounds):
        order = range(len(rows)) if r % 2 == 0 else \
            reversed(range(len(rows)))
        for i in order:
            times[i]["W1"].append(device_ms(rows[i][2], "w1_kernel")[0])
            times[i]["W2"].append(device_ms(rows[i][3], "w2_kernel")[0])
    for (label, consts, _, _, report, equal), t in zip(rows, times):
        print(json.dumps({
            "row": label, "constants": consts, "equal_to_plain": equal,
            "live_points": n_live,
            "points": int(mask.shape[0]),
            "W1_device_ms": t["W1"], "W1_median_ms": float(np.median(t["W1"])),
            "W2_device_ms": t["W2"], "W2_median_ms": float(np.median(t["W2"])),
            "compiler": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
