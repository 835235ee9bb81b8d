"""The window assembly's scan time and the experiment tool's datagen rate
on the card, in one or more checkouts of the port.

    python scripts/window_ab.py --trees PARENT . . PARENT \
        [--frames 32] [--out window_ab.json]

Each tree given runs in a process of its own with that tree first on
sys.path, in the order given (so PARENT . . PARENT interleaves a parent
checkout, unpacked with `git archive`, with this one), and measures:

- scan: one window-assembly scan, `models/snowfall.snowfall_augment` on
  card tensors, at the JAX inspect CLI's config (window_size 256,
  wide_capacity 128, max_occluders 64, max_bumps 32, point_chunk 2,048) on
  chip_smoke.py's bench scan (synthetic_scan 870 azimuths, seed 0; stable-
  sorted by channel, max_points 65,536) and bank (`tools/kernel_times.
  bank_sets`): the median of --reps CUDA-event times after 2 warm-ups, with
  RANSAC on the card as a scan runs it; and kernel W1's wrapper call
  (`ops/occluders.find_occluders_window`) where the tree has it. The bank's
  tensors are made once, outside the timing, as a user's augmenter makes
  them.
- datagen: the experiment tool's `snowify` at its defaults (batch 4,
  max_points 16,384) on its corpus (`build_corpus`, --frames scenes): the
  offline driver's steady scans/s (the batches that built no kernel and
  reran no growth) and the assembly of the config that `snowify` built.

Both record the port's launch counters over the run. Prints one JSON line
a run, then a summary line with the card's name and power limit
(nvidia-smi), and writes them to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

COUNTED = {"ops.occluders": ("find_occluders", "find_occluders_window"),
           "ops.pulse": ("pulse_peaks", "window_pulse_peaks")}
INSPECT = dict(window_size=256, wide_capacity=128, max_occluders=64,
               max_bumps=32, point_chunk=2048)


def _time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


class Counters:
    """The tree's launch counters that exist, zeroed and read."""

    def __init__(self):
        import importlib

        self.fns = {}
        for m, names in COUNTED.items():
            mod = importlib.import_module(f"lidar_snow_sim_tpu_torch.{m}")
            self.fns.update({n: getattr(mod, n) for n in names
                             if hasattr(mod, n)})

    def zero(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self) -> dict:
        return {n: fn.launches for n, fn in self.fns.items()}


def scan(counters: Counters, reps: int) -> dict:
    """The window scan at the inspect CLI's config on the bench scan."""
    import torch

    from lidar_snow_sim_tpu_torch import (
        SnowfallConfig,
        build_bank,
        load_hdl64_calib,
        pad_cloud,
        synthetic_scan,
    )
    from lidar_snow_sim_tpu_torch._kernels import BUILD_DIR
    from lidar_snow_sim_tpu_torch.models import snowfall as ts
    from lidar_snow_sim_tpu_torch.ops import occluders as occ_ops
    from lidar_snow_sim_tpu_torch.ops.fitting import ransac_draws
    from lidar_snow_sim_tpu_torch.tools.kernel_times import bank_sets

    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=870, seed=0, calib=calib)
    pc = np.ascontiguousarray(pc[np.argsort(pc[:, 4], kind="stable")])
    cfg = SnowfallConfig(max_points=1 << 16, **INSPECT)
    bank = build_bank(bank_sets(BUILD_DIR / "banks")[0],
                      window_size=cfg.window_size,
                      wide_threshold=cfg.wide_threshold,
                      wide_capacity=cfg.wide_capacity)
    padded = pad_cloud(pc, cfg.max_points)
    dev = torch.device("cuda")
    bank_t = ts.bank_to_torch(bank, dev)
    args = (torch.as_tensor(padded.points, device=dev),
            torch.as_tensor(padded.mask, device=dev), bank_t,
            ts.calib_to_torch(calib, dev),
            torch.as_tensor(np.random.default_rng(0).permutation(64),
                            device=dev),
            ransac_draws(0, cfg.ransac_trials).to(dev), cfg)
    ts.snowfall_augment(*args)
    torch.cuda.synchronize()
    counters.zero()
    ts.snowfall_augment(*args)
    torch.cuda.synchronize()
    out = {"points": len(pc), "launches": counters.read(),
           "ms": _time_ms(lambda: ts.snowfall_augment(*args), reps),
           "w1_call_ms": None}
    if hasattr(occ_ops, "find_occluders_window"):
        inp = ts.window_inputs(*args)
        w_args, w_kw = ts.window_occluder_call(inp, bank_t, cfg)
        out["w1_call_ms"] = _time_ms(
            lambda: occ_ops.find_occluders_window(*w_args, **w_kw), 20)
    return out


def datagen(counters: Counters, frames: int) -> dict:
    """The experiment tool's snowify on its corpus."""
    import torch

    from lidar_snow_sim_tpu_torch.calib import load_hdl64_calib
    from lidar_snow_sim_tpu_torch.parallel import datagen as dg
    from lidar_snow_sim_tpu_torch.tools import experiment

    seen = {}
    run = dg.run_snowfall_datagen

    def recorded(*args, **kw):
        seen["cfg"] = args[5]
        seen["stats"] = run(*args, **kw)
        return seen["stats"]

    dg.run_snowfall_datagen = recorded
    calib = load_hdl64_calib()
    with tempfile.TemporaryDirectory() as work:
        scans, _, stems = experiment.build_corpus(
            Path(work) / "clear", frames, 0, calib)
        counters.zero()
        t0 = time.perf_counter()
        experiment.snowify(scans, stems, Path(work) / "snow", calib,
                           device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = seen["stats"]
    return {"assembly": seen["cfg"].assembly, "frames": stats.frames_done,
            "steady_scans_per_sec": stats.steady_scans_per_sec(),
            "steady_median_scans_per_sec":
                stats.steady_median_scans_per_sec(),
            "steady_batches": sum(not b["compiles"] for b in stats.batches),
            "wall_s": wall, "attenuated": int(stats.attenuated),
            "removed": int(stats.removed), "launches": counters.read()}


def one_tree(tree: str, frames: int, reps: int) -> dict:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import lidar_snow_sim_tpu_torch as port

    if not port.__file__.startswith(str(root)):
        raise RuntimeError(f"imported {port.__file__}, not {tree}'s")
    counters = Counters()
    return {"tree": tree, "scan": scan(counters, reps),
            "datagen": datagen(counters, frames)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one_tree(args.one, args.frames, args.reps)))
        return 0
    runs = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", tree, "--frames",
             str(args.frames), "--reps", str(args.reps)],
            capture_output=True, text=True, env=dict(os.environ))
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {"card": card_line()}
    for key, get in (("scan_ms", lambda r: r["scan"]["ms"]),
                     ("w1_call_ms", lambda r: r["scan"]["w1_call_ms"]),
                     ("datagen_steady_scans_per_sec",
                      lambda r: r["datagen"]["steady_scans_per_sec"])):
        summary[key] = {}
        for r in runs:
            summary[key].setdefault(r["tree"], []).append(get(r))
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs,
                                              "summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
