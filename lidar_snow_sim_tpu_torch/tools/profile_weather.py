"""Where the weather baselines' time goes on the card: torch.profiler over
the bench scan, one JSON line per case.

    python -m lidar_snow_sim_tpu_torch.tools.profile_weather [--reps 5]

Cases: kernel L1 and its plain version (20 calls each, on the 65,536 x 64
positions of LISA's (48, 16) Qback lookup), then one scan each through
`LISA.augment_compact` (rain 10 mm/h), `FogAugmenter` (alpha 0.06),
`StfFogAugmenter` (beta 0.046) and `dynamic_radius_outlier_filter`
(windowed). Each case runs 3 times to warm up, then `--reps` times under
the profiler; its line holds the host wall time and the summed device
time per rep, their ratio (the device's busy share; the profiler adds
host time, so it reads low), the device ops per rep and the top device
items. Last, L1 and its plain version timed with CUDA events around 200
back-to-back calls, which hides the host's enqueue time behind the queue.
Needs one CUDA device; the first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict


def profile_case(fn, reps: int, top: int = 6, trace_dir=None) -> dict:
    """fn() 3 times to warm up, then `reps` times under torch.profiler:
    host wall and summed device time per rep, their ratio, device ops per
    rep and the `top` device items [name, ms per rep, calls per rep]:
    the card's kernels, copies and memsets, not the spans' ranges
    (`utils/profiling.span`) that the profiler also puts on the card's
    timeline. With `trace_dir` the session is `utils/profiling.
    device_trace`, which also writes its Chrome trace there."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_snow_sim_tpu_torch.utils.profiling import device_trace

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    session = (device_trace(trace_dir) if trace_dir else
               profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]))
    with session as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
    device_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "wall_ms_per_rep": wall_us / reps / 1e3,
        "device_ms_per_rep": device_us / reps / 1e3,
        "busy_share": device_us / wall_us,
        "device_ops_per_rep": sum(count.values()) / reps,
        "top": [[name[:60], us / reps / 1e3, count[name] / reps]
                for name, us in ranked[:top]],
        "ops": {name: [us / reps / 1e3, count[name] / reps]
                for name, us in ranked},
    }


def back_to_back_ms(fn, calls: int = 200) -> float:
    """CUDA-event ms per call over `calls` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n-azimuth", type=int, default=870)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_weather: no CUDA device", file=sys.stderr)
        return 1
    from lidar_snow_sim_tpu_torch import (
        load_hdl64_calib,
        pad_cloud,
        synthetic_scan,
    )
    from lidar_snow_sim_tpu_torch.models import dror
    from lidar_snow_sim_tpu_torch.models import lisa as tlisa
    from lidar_snow_sim_tpu_torch.models.fog import (
        FogAugmenter,
        FogParameterSet,
    )
    from lidar_snow_sim_tpu_torch.models.stf_fog import StfFogAugmenter
    from lidar_snow_sim_tpu_torch.ops.lut_lookup import (
        lut_lookup_pairs,
        lut_lookup_plain,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pc = synthetic_scan(n_azimuth=args.n_azimuth, seed=0,
                        calib=load_hdl64_calib())

    # L1's positions: LISA's candidate diameters on the log grid
    lisa = tlisa.LISA(max_droplets=48, tail_droplets=16, device=dev)
    cfg = lisa.core_config()
    pc_n = pc.copy()
    pc_n[:, 3] /= 255.0
    padded = pad_cloud(pc_n, 65536)
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = tlisa.lisa_tables_to_torch(lisa._dsd_tables(10.0), dev)
    drops = tlisa.lisa_droplets(
        torch.as_tensor(padded.points, device=dev),
        tlisa.lisa_draws(65536, 48, 16, gen),
        torch.tensor(lisa.droplet_density(10.0), dtype=torch.float32,
                     device=dev),
        tables, cfg)
    p, pairs = tlisa.log_pos(drops.d_mm, cfg), tables.qb_pairs

    fog = FogAugmenter(FogParameterSet(alpha=0.06), seed=0, device=dev)
    stf = StfFogAugmenter(beta=0.046, seed=0, device=dev)
    cases = {
        "L1 x20": lambda: [lut_lookup_pairs(p, pairs) for _ in range(20)],
        "L1 plain x20": lambda: [lut_lookup_plain(p, pairs)
                                 for _ in range(20)],
        "lisa scan": lambda: lisa.augment_compact(pc, 10.0, fixed_seed=True,
                                                  seed=0),
        "fog scan": lambda: fog(pc),
        "stf_fog scan": lambda: stf(pc),
        "dror scan": lambda: dror.dynamic_radius_outlier_filter(pc,
                                                                device=dev),
    }
    for name, fn in cases.items():
        res = profile_case(fn, args.reps)
        del res["ops"]
        print(json.dumps({"case": name, "points": len(pc), **res}),
              flush=True)
    print(json.dumps({
        "case": "L1 back to back", "positions": list(p.shape),
        "cells": int(pairs.shape[0]),
        "ms_per_call": back_to_back_ms(lambda: lut_lookup_pairs(p, pairs)),
        "plain_ms_per_call": back_to_back_ms(
            lambda: lut_lookup_plain(p, pairs)),
        "equal": bool(torch.equal(lut_lookup_pairs(p, pairs),
                                  lut_lookup_plain(p, pairs))),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
