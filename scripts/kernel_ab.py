"""An A/B of kernels A1 (single and folded over 16 frames), A2, A3, A4a,
A4b, C1 and C2 against another checkout's, on one CUDA device.

    python -m scripts.kernel_ab --other DIR [--rounds 2]

Run from the repository root. DIR is the root of another checkout of the
repository (a `git archive` of the parent commit, say). Its
csrc/occluders.cu and csrc/pulse.cu are compiled here by nvcc with this
tree's flags into DIR's own build directory and loaded with this tree's
C signatures, so both versions' kernels run through their C entry points
on the same inputs: the phase-A and phase-C inputs of chip_smoke.py's
bench scene (A4a and A4b on A1's layout without its has gate, as
chip_smoke's phase 7 runs them; A2 on its routed layout, route_band 384
and band_group 16, and A3 on its banded one, band_width 256 and
band_group 8, as chip_smoke's phase 3), the A1 chunks of 16 frames of
it folded into one launch, and C1 and C2 (pulse block 512, as chip_smoke's
phase 7) on its compacted beams. Each version's phase C writes touched in
its own width (an int32 before it became one byte a beam; touched_bytes)
into a buffer of that width.
Kernels W1 and W2 (the window assembly's) run on chip_smoke.py phase 12's
inspect config (window_size 256, wide_capacity 128, max_occluders 64,
max_bumps 32) on the channel-sorted bench scan, each version's W2 on its
own W1's rows; a checkout whose W1 and W2 take no live mask (before
pulse_trig_table existed in its pulse.cu) is called through those
kernels' earlier C signatures (W1_W2_BEFORE_LIVE) with the arrays they
took (window bounds, the (4, n) feature rows, torch's cos and sin
tables), and computes every row; the two are compared on the live rows.
Their outputs must be equal (touched as 0/1); then each kernel's device_ms
(`tools/kernel_times.device_ms`) in turns, other, this, this, other per
round. Prints one JSON line after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np

from lidar_snow_sim_tpu_torch import _kernels
from lidar_snow_sim_tpu_torch.tools.kernel_times import (
    bank_sets,
    bench_batch,
    bench_config,
    card_line,
    device_ms,
)

NAMES = ("occluders", "pulse")
C2_BLOCK = 512   # C2's pulse block on the bench scene (chip_smoke phase 7)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C signatures of kernels W1 and W2 before they took a live mask: W1
# took the window bounds (n, 2) in place of live and no delta; W2 the
# (4, n) rows [d_orig, right, left, 0.9 max_int] and torch's cos and sin
# of each slot's, the target's and the grid's phase
W1_W2_BEFORE_LIVE = {
    "occluders_w1": [_P] * 13 + [_I] * 6 + [_P],
    "pulse_w2": [_P] * 15 + [_I] * 4 + [_F] * 5 + [_P],
}
WINDOW_INSPECT = dict(window_size=256, wide_capacity=128, max_occluders=64,
                      max_bumps=32, point_chunk=2048)


def live_api(root: Path) -> bool:
    """Whether <root>'s kernels W1 and W2 take a live mask."""
    return "pulse_trig_table" in (
        root / "lidar_snow_sim_tpu_torch" / "csrc" / "pulse.cu").read_text()


def build_other(root: Path, name: str) -> ctypes.CDLL:
    """Compile <root>'s csrc/<name>.cu into its _build/ with this tree's
    nvcc flags; load it with this tree's signatures for it (W1's and W2's
    earlier ones where its kernels take no live mask)."""
    pkg = root / "lidar_snow_sim_tpu_torch"
    out = pkg / "_build" / f"lib{name}_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-o", str(out),
         str(pkg / "csrc" / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {root}'s {name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    before = {} if live_api(root) else W1_W2_BEFORE_LIVE
    for fn, argtypes in _kernels.SIGNATURES[name].items():
        f = getattr(lib, fn, None)
        if f is None:   # an entry point newer than the other checkout
            continue
        f.argtypes = before.get(fn, argtypes)
        f.restype = ctypes.c_int
    return lib


def window_bench(dev):
    """(WindowInputs, bank tensors, config) of chip_smoke.py phase 12's
    inspect config on the channel-sorted bench scan, the RANSAC plane
    fitted on its padded points."""
    import torch

    from lidar_snow_sim_tpu_torch import (
        SnowfallConfig,
        build_bank,
        load_hdl64_calib,
        pad_cloud,
        synthetic_scan,
    )
    from lidar_snow_sim_tpu_torch.models import snowfall as ts
    from lidar_snow_sim_tpu_torch.ops.fitting import (
        ransac_draws,
        ransac_plane,
    )

    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=870, seed=0, calib=calib)
    srt = np.ascontiguousarray(pc[np.argsort(pc[:, 4], kind="stable")])
    cap = 1 << int(np.ceil(np.log2(len(srt))))
    cfg = SnowfallConfig(max_points=cap, **WINDOW_INSPECT)
    sets = bank_sets(_kernels.BUILD_DIR / "banks")[0]
    bank_t = ts.bank_to_torch(build_bank(
        sets, window_size=cfg.window_size, wide_threshold=cfg.wide_threshold,
        wide_capacity=cfg.wide_capacity), dev)
    padded = pad_cloud(srt, cap)
    points = torch.as_tensor(padded.points, device=dev)
    mask = torch.as_tensor(padded.mask, device=dev)
    plane = ransac_plane(points[:, :3], mask,
                         ransac_draws(0, cfg.ransac_trials).to(dev))
    inp = ts.window_inputs(
        points, mask, bank_t, ts.calib_to_torch(calib, dev),
        torch.as_tensor(np.random.default_rng(0).permutation(64),
                        device=dev), None, cfg, plane=plane)
    return inp, bank_t, cfg


def w1_call(lib, with_live: bool, inp, bank_t, cfg, live: bool = True,
            n: int | None = None):
    """fn() launching `lib`'s occluders_w1 on the first n points of `inp`
    (all by default) into fixed outputs: with the C signature that takes a
    live mask (`live`: the scan's mask, else null) where `with_live`, else
    with W1_W2_BEFORE_LIVE's."""
    import torch

    from lidar_snow_sim_tpu_torch.models.snowfall import window_delta
    from lidar_snow_sim_tpu_torch.ops.occluders import w1_inputs

    n = inp.xyz.shape[0] if n is None else n
    k = cfg.max_occluders
    delta = window_delta(cfg)
    feats = inp.feats[:n].contiguous()
    ins = w1_inputs(feats, inp.bank_row[:n], inp.lo[:n], bank_t.data_t,
                    bank_t.wide_t, bank_t.ang_t, bank_t.wang_t,
                    live=inp.mask[:n] if live else None)
    if not with_live:
        bounds = torch.stack([feats[:, 8] - delta, feats[:, 8] + delta],
                             dim=1)
        ins = (*ins[:3], bounds, *ins[4:])
    dev = feats.device
    outs = (*(torch.empty((n, k), device=dev) for _ in range(3)),
            torch.empty((n, k), dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    ptrs = [None if t is None else t.data_ptr() for t in (*ins, *outs)]
    extra = (delta,) if with_live else ()
    dims = (n, bank_t.data_t.shape[2], bank_t.wide_t.shape[2],
            bank_t.wang_t.shape[2], cfg.window_size, k)

    def run():
        _kernels.check(lib.occluders_w1(
            *ptrs, *dims, *extra, torch.cuda.current_stream().cuda_stream),
            "occluders_w1")
        return outs
    run.inputs = ins   # the arrays behind ptrs live as long as run
    return run


def w2_call(lib, with_live: bool, inp, occ, cfg, live: bool = True,
            n: int | None = None):
    """fn() launching `lib`'s pulse_w2 on the first n points of `inp` with
    their W1 rows `occ` into fixed outputs, as w1_call calls W1."""
    import torch

    from lidar_snow_sim_tpu_torch.config import SPEED_OF_LIGHT
    from lidar_snow_sim_tpu_torch.ops.pulse import pulse_phase, w2_inputs

    n = inp.xyz.shape[0] if n is None else n
    occ = [t[:n] for t in occ[:4]]
    ins = w2_inputs(inp.feats[:n], inp.max_int[:n], *occ, inp.range_grid,
                    tau_h=cfg.tau_h, live=inp.mask[:n] if live else None)
    phase = pulse_phase(cfg.tau_h)
    if not with_live:
        f = inp.feats[:n]
        beta, beta_t = phase * occ[2], phase * f[:, 0]
        ins = (torch.stack([f[:, 0], f[:, 1], f[:, 2],
                            0.9 * inp.max_int[:n]]), *occ,
               torch.cos(beta), torch.sin(beta), torch.cos(beta_t),
               torch.sin(beta_t), *ins[-2:])
    dev = occ[0].device
    outs = (torch.empty(n, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    ptrs = [None if t is None else t.data_ptr() for t in (*ins, *outs)]
    scalars = (cfg.beam_divergence_rad, float(cfg.intervals_per_meter),
               SPEED_OF_LIGHT * cfg.tau_h, 0.9, 1.0 - 0.9)
    extra = (phase,) if with_live else ()
    m_bins = inp.range_grid.shape[0]

    def run():
        _kernels.check(lib.pulse_w2(
            *ptrs, n, cfg.max_occluders, m_bins, cfg.max_bumps, *scalars,
            *extra, torch.cuda.current_stream().cuda_stream), "pulse_w2")
        return outs
    run.inputs = ins   # the arrays behind ptrs live as long as run
    return run


def live_rows_equal(got, want, mask) -> bool:
    """Whether two W1 or W2 outputs agree on the rows of `mask` (a peak
    NaN where the other is)."""
    import torch

    def same(a, b):
        a, b = a[mask[:a.shape[0]]], b[mask[:b.shape[0]]]
        return torch.equal(a, b) or (a.is_floating_point() and torch.equal(
            a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(),
                                                  b.nan_to_num()))
    return all(same(a, b) for a, b in zip(got, want))


class BenchInputs(NamedTuple):
    lay: object       # A1's phase-A layout of one scan
    folded: tuple     # the folded phase-A arguments of 16 frames of it
    calib: tuple      # the calibration tensors
    cfg: object       # the config
    routed: object    # A2's layout: route_band 384, band_group 16
    banded: object    # A3's layout: band_width 256, band_group 8


def bench_inputs(dev) -> BenchInputs:
    """chip_smoke.py's bench scene on `dev`: the phase-A layouts of one scan
    (A1's, the routed and the banded config's), the folded phase-A
    arguments of 16 frames of it (bench_batch), the calibration tensors and
    the config."""
    import torch

    from lidar_snow_sim_tpu_torch import (
        build_bank,
        load_hdl64_calib,
        pad_cloud,
        synthetic_scan,
    )
    from lidar_snow_sim_tpu_torch.models.snowfall import (
        bank_to_torch,
        calib_to_torch,
        dense_layout,
    )
    from lidar_snow_sim_tpu_torch.ops.fitting import ransac_draws
    from lidar_snow_sim_tpu_torch.ops.occluders import fold_args
    from lidar_snow_sim_tpu_torch.parallel.batched import frame_draws

    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=870, seed=0, calib=calib)
    sets = bank_sets(_kernels.BUILD_DIR / "banks")[0]
    cfg = bench_config()
    bank_t = bank_to_torch(build_bank(sets, window_size=cfg.window_size,
                                      wide_threshold=cfg.wide_threshold,
                                      wide_capacity=cfg.wide_capacity), dev)
    padded = pad_cloud(pc, cfg.max_points)
    points = torch.as_tensor(padded.points, device=dev)
    mask = torch.as_tensor(padded.mask, device=dev)
    order = torch.as_tensor(np.random.default_rng(0).permutation(64),
                            device=dev)
    draws = ransac_draws(0, cfg.ransac_trials).to(dev)

    def lay_of(c):
        return dense_layout(points, mask, bank_t, order, draws, c)

    lay = lay_of(cfg)
    orders, seeds = bench_batch()
    frames = [dense_layout(points, mask, bank_t,
                           torch.as_tensor(o, device=dev),
                           frame_draws(s, cfg, None)[0].to(dev), cfg)
              for o, s in zip(orders, seeds)]
    folded = fold_args([f.occluder_args for f in frames],
                       lay.occluder_kw["blk"])[0]
    routed = lay_of(dataclasses.replace(cfg, route_band=384, band_group=16))
    banded = lay_of(dataclasses.replace(cfg, band_width=256, band_group=8))
    if (routed.kernel, banded.kernel) != ("A2", "A3"):
        raise RuntimeError(f"the bench scene laid out {routed.kernel} and "
                           f"{banded.kernel}, not A2 and A3")
    return BenchInputs(lay, folded, calib_to_torch(calib, dev), cfg, routed,
                       banded)


def _a1_call(lib, args, kw):
    """fn() launching `lib`'s occluders_a1 on `args` into fixed outputs."""
    import torch

    feats, w0b, rows, los, has, counts, data_t, wide_t = args
    n_chunks, blk, k = rows.shape[0], kw["blk"], kw["k_occ"]
    a12d = torch.empty((3 * k, n_chunks * blk), device=feats.device)
    ovf = torch.empty((n_chunks, blk), dtype=torch.int32, device=feats.device)
    ptrs = [t.data_ptr() for t in (*args, a12d, ovf)]

    def run():
        _kernels.check(lib.occluders_a1(
            *ptrs, n_chunks, blk, kw["w_sl"], data_t.shape[2],
            wide_t.shape[2], k,
            torch.cuda.current_stream().cuda_stream), "occluders_a1")
        return a12d, ovf
    return run


def ungated_call(lib, entry: str, args, kw):
    """fn() launching `lib`'s `entry` (occluders_a4a or occluders_a4b) on
    A1's arguments `args` without has, into fixed outputs."""
    import torch

    feats, w0b, rows, los, counts, data_t, wide_t = args
    n_chunks, blk, k = rows.shape[0], kw["blk"], kw["k_occ"]
    a12d = torch.empty((3 * k, n_chunks * blk), device=feats.device)
    ovf = torch.empty((n_chunks, blk), dtype=torch.int32, device=feats.device)
    ptrs = [t.data_ptr() for t in (*args, a12d, ovf)]

    def run():
        _kernels.check(getattr(lib, entry)(
            *ptrs, n_chunks, blk, kw["w_sl"], data_t.shape[2],
            wide_t.shape[2], k,
            torch.cuda.current_stream().cuda_stream), entry)
        return a12d, ovf
    return run


def routed_call(lib, args, kw):
    """fn() launching `lib`'s occluders_a2 on A2's arguments `args` into
    fixed outputs."""
    import torch

    feats, w0b, rows, los, gloa, mode, counts, data_t, wide_t = args
    n_chunks, blk, k = rows.shape[0], kw["blk"], kw["k_occ"]
    a12d = torch.empty((3 * k, n_chunks * blk), device=feats.device)
    ovf = torch.empty((n_chunks, blk), dtype=torch.int32, device=feats.device)
    ptrs = [t.data_ptr() for t in (*args, a12d, ovf)]

    def run():
        _kernels.check(lib.occluders_a2(
            *ptrs, n_chunks, blk, kw["w_sl"], data_t.shape[2],
            wide_t.shape[2], k, kw["band"], kw["group"], kw["wide_sl"],
            torch.cuda.current_stream().cuda_stream), "occluders_a2")
        return a12d, ovf
    return run


def banded_call(lib, args, kw):
    """fn() launching `lib`'s occluders_a3 on A3's arguments `args` into
    fixed outputs."""
    import torch

    feats, w0b, rows, gloa, glob, counts, data_t, wide_t = args
    n_chunks, blk, k = rows.shape[0], kw["blk"], kw["k_occ"]
    a12d = torch.empty((3 * k, n_chunks * blk), device=feats.device)
    ovf = torch.empty((n_chunks, blk), dtype=torch.int32, device=feats.device)
    unc = torch.empty((n_chunks, blk), dtype=torch.int32, device=feats.device)
    ptrs = [t.data_ptr() for t in (*args, a12d, ovf, unc)]

    def run():
        _kernels.check(lib.occluders_a3(
            *ptrs, n_chunks, blk, data_t.shape[2], wide_t.shape[2],
            kw["wide_sl"], k, kw["band"], kw["group"], kw["delta"],
            torch.cuda.current_stream().cuda_stream), "occluders_a3")
        return a12d, ovf, unc
    return run


def phase_a_equal(got, want, k: int) -> bool:
    """Whether two phase-A outputs (a12d, ovf) agree as chip_smoke holds
    them: ovf and the dist plane equal, a1/a2 where dist < 1e37."""
    import torch

    live = torch.cat([want[0][2 * k:] < 1e37] * 2)
    return (torch.equal(got[1], want[1])
            and torch.equal(got[0][2 * k:], want[0][2 * k:])
            and torch.equal(got[0][:2 * k][live], want[0][:2 * k][live]))


def outputs_equal(name: str, got, want, k: int) -> bool:
    """Whether two outputs of kernel `name` agree: A1 (folded too), A4a
    and A4b as phase_a_equal; A2, A3 (both write a1 = a2 = 0 in empty
    slots) in full; C1 and C2 in full, touched as 0/1 whatever its
    width."""
    import torch

    if name.startswith(("A1", "A4")):
        return phase_a_equal(got, want, k)
    if name.startswith("C"):
        got, want = list(got), list(want)
        got[2], want[2] = got[2].to(torch.int32), want[2].to(torch.int32)
    return all(torch.equal(a, b) for a, b in zip(got, want))


def touched_bytes(root: Path) -> int:
    """The bytes a beam's touched flag takes in <root>'s phase C: 4 where
    its csrc/pulse.cu entries take `int* touched`, else 1 (torch.bool)."""
    src = (root / "lidar_snow_sim_tpu_torch" / "csrc" / "pulse.cu"
           ).read_text()
    return 4 if re.search(r"\bint\s*\*\s*touched\b", src) else 1


def pulse_call(lib, entry: str, args, kw, width: int, extra=()):
    """fn() launching `lib`'s `entry` (pulse_c1, or pulse_c2 with `extra`
    (blk,)) on `args` into fixed outputs, touched `width` bytes a beam."""
    import torch

    k, cap = args[1].shape
    dev = args[0].device
    outs = (torch.empty(cap, device=dev),
            torch.empty(cap, dtype=torch.int32, device=dev),
            torch.empty(cap, dtype=torch.int32 if width == 4 else torch.bool,
                        device=dev),
            torch.empty(cap, device=dev))
    ptrs = [t.data_ptr() for t in (*args, *outs)]

    def run():
        _kernels.check(getattr(lib, entry)(
            *ptrs, cap, k, args[7].shape[0], *extra, kw["beam_rad"],
            kw["ipm"], kw["c_tau"], kw["xsi_r1"], kw["xsi_r2"] - kw["xsi_r1"],
            torch.cuda.current_stream().cuda_stream), entry)
        return outs
    return run


def _c1_call(lib, args, kw, width: int = 1):
    """fn() launching `lib`'s pulse_c1 (pulse_call)."""
    return pulse_call(lib, "pulse_c1", args, kw, width)


def _c2_call(lib, args, kw, width: int = 1, blk: int = C2_BLOCK):
    """fn() launching `lib`'s pulse_c2 at pulse block `blk` (pulse_call)."""
    return pulse_call(lib, "pulse_c2", args, kw, width, (blk,))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from lidar_snow_sim_tpu_torch.models.snowfall import compact_occluded

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    root = args.other.resolve()
    widths = {"this": touched_bytes(_kernels.CSRC.parents[1]),
              "other": touched_bytes(root)}
    with ThreadPoolExecutor(2 * len(NAMES)) as pool:
        this = {n: pool.submit(_kernels.load, n) for n in NAMES}
        other = {n: pool.submit(build_other, root, n) for n in NAMES}
        libs = {"this": {n: f.result() for n, f in this.items()},
                "other": {n: f.result() for n, f in other.items()}}

    lay, folded, calib_t, cfg, routed, banded = bench_inputs(dev)
    kw = lay.occluder_kw

    feats, w0b, rows, los, _, counts, data_t, wide_t = lay.occluder_args
    args_u = (feats, w0b, rows, los, counts, data_t, wide_t)
    calls = {}
    for ver, lib in libs.items():
        a12d, ovf = _a1_call(lib["occluders"], lay.occluder_args, kw)()
        comp = compact_occluded(lay, a12d.clone(), ovf.clone(), calib_t,
                                cfg)
        calls[ver] = {
            "A1": (_a1_call(lib["occluders"], lay.occluder_args, kw),
                   "a1_kernel"),
            "A1 folded 16 frames": (_a1_call(lib["occluders"], folded, kw),
                                    "a1_kernel"),
            "A4a": (ungated_call(lib["occluders"], "occluders_a4a", args_u,
                                 kw), "a4a_kernel"),
            "A4b": (ungated_call(lib["occluders"], "occluders_a4b", args_u,
                                 kw), "a4b_kernel"),
            "A2": (routed_call(lib["occluders"], routed.occluder_args,
                               routed.occluder_kw), "a2_kernel"),
            "A3": (banded_call(lib["occluders"], banded.occluder_args,
                               banded.occluder_kw), "a3_kernel"),
            "C1": (_c1_call(lib["pulse"], comp.pulse_args, comp.pulse_kw,
                            widths[ver]), "c1_kernel"),
            "C2": (_c2_call(lib["pulse"], comp.pulse_args, comp.pulse_kw,
                            widths[ver]), "c2_kernel"),
        }
    inp, bank_wt, wcfg = window_bench(dev)
    for ver, lib in libs.items():
        api = live_api(root) if ver == "other" else True
        w1 = w1_call(lib["occluders"], api, inp, bank_wt, wcfg)
        occ = [t.clone() for t in w1()]
        calls[ver]["W1"] = (w1, "w1_kernel")
        calls[ver]["W2"] = (w2_call(lib["pulse"], api, inp, occ, wcfg),
                            "w2_kernel")
    for name in calls["this"]:
        got = [t.clone() for t in calls["this"][name][0]()]
        want = calls["other"][name][0]()
        torch.cuda.synchronize()
        if name in ("W1", "W2"):
            if not live_rows_equal(got, want, inp.mask):
                print(f"kernel_ab: {name} differs between the two versions "
                      "on the live rows", file=sys.stderr)
                return 1
            continue
        if not outputs_equal(name, got, want, kw["k_occ"]):
            print(f"kernel_ab: {name} differs between the two versions",
                  file=sys.stderr)
            return 1

    times = {name: {"this": [], "other": []} for name in calls["this"]}
    for _ in range(args.rounds):
        for ver in ("other", "this", "this", "other"):
            for name, (fn, kernel) in calls[ver].items():
                times[name][ver].append(device_ms(fn, kernel)[0])
    out = {}
    for name, t in times.items():
        this_ms, other_ms = (float(np.median(t[v])) for v in ("this",
                                                             "other"))
        out[name] = {"this_device_ms": t["this"],
                     "other_device_ms": t["other"],
                     "ratio_of_medians": this_ms / other_ms}
    print(json.dumps({"ab": out, "other": str(args.other),
                      "equal_outputs": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
