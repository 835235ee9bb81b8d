"""Same-process interleaved A/B harness (counterpart of
`lidar_snow_sim_tpu/tools/ab.py`): the way to compare two configurations
on one card (BASELINE.md's methodology).

- every arm is measured in the SAME process, on one card;
- reps are INTERLEAVED round-robin across arms, so a slow window taxes
  every arm and not one;
- the per-step time is the SLOPE between a short and a long chain of
  steps run back to back, ended by `torch.cuda.synchronize()`, so the
  constants of a chain (its first launch, the final synchronize) cancel;
  the MEDIAN of the reps is taken at each chain length;
- an arm with a nonzero capacity-overflow count did less work than a
  valid run, and fails the comparison.

The JAX tool's `full_leaf_dep` folds every output of a step into the
chain's carry so that XLA cannot eliminate or hoist unconsumed work.
Eager torch launches every operation it is given, whether or not its
result is read, so the port has no counterpart: a chain here is the step
called n times.

Usage (model first, then variant specs):

    python -m lidar_snow_sim_tpu_torch.tools.ab snow base route256
    python -m lidar_snow_sim_tpu_torch.tools.ab dror windowed full
    python -m lidar_snow_sim_tpu_torch.tools.ab lisa base 'k16=max_droplets:16'
    python -m lidar_snow_sim_tpu_torch.tools.ab detect base batch8

Variant syntax: a bare `name` picks a predefined variant of the model; a
`name=field:value[,field:value...]` defines an override on the fly (fields
are config fields of the model's arm builder; the special field `batch`
sets the frame batch). Values parse as int, then float, then str. The
arms run on the bench scene (`tools/kernel_times.bench_config`,
`bank_sets`), on `--device` (default cuda; without a card it raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch


class Arm(NamedTuple):
    """One A/B arm: `run(n_chain) -> (wall seconds, overflow count)`."""

    run: Callable[[int], tuple[float, int]]
    batch: int


PREDEFINED = {
    "snow": {
        "base": {},
        "batch4": {"batch": 4},
        "batch8": {"batch": 8},
        "batch16": {"batch": 16},
        "batch24": {"batch": 24},
        "batch32": {"batch": 32},
        "k16": {"max_occluders": 16},
        "route256": {"route_band": 256},
    },
    "dror": {
        # the windowed search at its bench parameters and the exact
        # full-N search
        "windowed": {"window": 2048, "margin": 1024, "block": 128},
        "full": {"window": 0, "block": 1024},
        "w4096": {"window": 4096, "margin": 1024, "block": 128},
    },
    "lisa": {
        "base": {},
        "k16": {"max_droplets": 16, "tail_droplets": 4},
        "k64": {"max_droplets": 64, "tail_droplets": 16},
    },
    "detect": {
        "base": {},
        "batch1": {"batch": 1},
        "batch8": {"batch": 8},
        "batch16": {"batch": 16},
        "f32": {"compute_dtype": "float32"},
    },
}


def _parse_value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def parse_variants(model: str, specs: list[str]) -> dict[str, dict]:
    """Variant specs -> {name: override dict}. See module docstring."""
    out = {}
    for spec in specs:
        if "=" in spec:
            name, fields = spec.split("=", 1)
            ov = {}
            for fv in fields.split(","):
                f, v = fv.split(":")
                ov[f] = _parse_value(v)
            out[name] = ov
        else:
            out[spec] = dict(PREDEFINED[model][spec])
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_runner(step, batch: int, device):
    """Wrap a per-step function into a chain runner.

    `step()` runs one step on `device` and returns its overflow count (a
    0-dim tensor or an int). Returns `run(n) -> (seconds, total
    overflow)`: the step called n times back to back, the overflow
    counts summed on the device and read once, after a synchronize.
    `batch` is carried for the caller (`Arm`).
    """
    del batch

    def run(n: int):
        _sync(device)
        t0 = time.perf_counter()
        total = 0
        for _ in range(n):
            total = total + step()
        _sync(device)
        seconds = time.perf_counter() - t0
        return seconds, int(total)

    return run


def interleaved_ab(
    arms: dict[str, Arm],
    short: int = 2,
    long_: int = 12,
    reps: int = 5,
    verbose: bool = True,
) -> dict[str, dict]:
    """Run the interleaved median-slope comparison over `arms`.

    Returns {name: {step_ms, scans_per_sec, spread_ms, overflow}}. Raises
    ValueError if any arm overflows (less work done => invalid comparison).
    """
    def say(msg):
        if verbose:
            print(msg, flush=True)

    # warm-up pass (kernel builds, allocator), also the overflow gate
    for name, arm in arms.items():
        t1, _ = arm.run(short)
        t2, ovf = arm.run(long_)
        say(f"warm-up {name}: short {t1:.1f}s long {t2:.1f}s ovf={ovf}")
        if ovf:
            raise ValueError(
                f"arm '{name}' overflowed ({ovf}): it did less work than "
                "a valid run — fix capacities before comparing"
            )

    res = {n: {"s": [], "l": []} for n in arms}
    for r in range(reps):
        for name, arm in arms.items():
            ts, _ = arm.run(short)
            tl, ovf = arm.run(long_)
            res[name]["s"].append(ts)
            res[name]["l"].append(tl)
            say(f"rep {r} {name}: short {ts:.3f}s long {tl:.3f}s ovf={ovf}")

    out = {}
    for name, arm in arms.items():
        s = sorted(res[name]["s"])[reps // 2]
        l = sorted(res[name]["l"])[reps // 2]
        dt = (l - s) / (long_ - short)
        spread = (max(res[name]["l"]) - min(res[name]["l"])) / (long_ - short)
        out[name] = dict(
            step_ms=dt * 1e3,
            scans_per_sec=arm.batch / dt if dt > 0 else float("inf"),
            spread_ms=spread * 1e3,
            overflow=0,
        )
        say(
            f"{name}: step {dt * 1e3:.2f} ms  {arm.batch / dt:.1f} scans/s  "
            f"(long-chain spread {spread * 1e3:.2f} ms/step)"
        )
    return out


# ---- arm builders (the bench scene) ---------------------------------------


def _bench_cloud():
    """The bench scan and its padded form at bench_config's capacity."""
    from lidar_snow_sim_tpu_torch import (
        load_hdl64_calib,
        pad_cloud,
        synthetic_scan,
    )
    from lidar_snow_sim_tpu_torch.tools.kernel_times import bench_config

    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=870, seed=0, calib=calib)
    return calib, pc, pad_cloud(pc, bench_config().max_points)


def _frames(padded, batch: int, device):
    points = torch.as_tensor(padded.points, device=device)
    mask = torch.as_tensor(padded.mask, device=device)
    return (points.expand(batch, *points.shape).contiguous(),
            mask.expand(batch, *mask.shape).contiguous())


def build_snow_arms(variants: dict[str, dict],
                    device="cuda") -> dict[str, Arm]:
    """`batched_step` (default 16 frames of the bench scan, each with its
    own channel order and RANSAC draws) on `bench_config` with the JAX
    tool's phase-A knobs (band_group 16, chunk_group 8, pulse_block 512),
    the bench bank; a variant's fields override the config's."""
    from lidar_snow_sim_tpu_torch import build_bank
    from lidar_snow_sim_tpu_torch._kernels import BUILD_DIR
    from lidar_snow_sim_tpu_torch.models.snowfall import (
        OVERFLOW_COUNTERS,
        bank_to_torch,
        calib_to_torch,
    )
    from lidar_snow_sim_tpu_torch.ops.fitting import ransac_draws
    from lidar_snow_sim_tpu_torch.parallel.batched import batched_step
    from lidar_snow_sim_tpu_torch.tools.kernel_times import (
        bank_sets,
        bench_config,
    )

    calib, _pc, padded = _bench_cloud()
    base = dataclasses.replace(bench_config(), band_group=16, chunk_group=8,
                               pulse_block=512)
    sets, _rr, _occ = bank_sets(BUILD_DIR / "banks")
    bank = bank_to_torch(build_bank(
        sets, window_size=base.window_size,
        wide_threshold=base.wide_threshold,
        wide_capacity=base.wide_capacity), device)
    calib_t = calib_to_torch(calib, device)

    arms = {}
    for name, ov in variants.items():
        ov = dict(ov)
        batch = ov.pop("batch", 16)
        cfg = dataclasses.replace(base, **ov)
        points, mask = _frames(padded, batch, device)
        orders = torch.as_tensor(np.stack(
            [np.random.default_rng(i).permutation(64) for i in range(batch)]),
            device=device)
        draws = (torch.stack([ransac_draws(i, cfg.ransac_trials)
                              for i in range(batch)]).to(device), None)

        def step(points=points, mask=mask, orders=orders, draws=draws,
                 cfg=cfg):
            snow, _ = batched_step(points, mask, bank, calib_t, orders,
                                   draws, cfg)
            return sum(getattr(snow, c).sum() for c in OVERFLOW_COUNTERS)

        arms[name] = Arm(make_runner(step, batch, device), batch)
    return arms


def build_dror_arms(variants: dict[str, dict],
                    device="cuda") -> dict[str, Arm]:
    """DROR on the bench scan frame by frame (default 8 frames): the
    azimuth-windowed search, or the full-N one where window is 0."""
    import math

    from lidar_snow_sim_tpu_torch.models.dror import (
        dror_full,
        dror_windowed,
    )

    _calib, _pc, padded = _bench_cloud()
    arms = {}
    for name, ov in variants.items():
        ov = dict(ov)
        batch = ov.pop("batch", 8)
        window = ov.pop("window", 2048)
        margin = ov.pop("margin", 1024)
        block = ov.pop("block", 128 if window else 1024)
        alpha = float(ov.pop("alpha", 0.45))
        beta = float(ov.pop("beta", 3.0))
        k_min = int(ov.pop("k_min", 3))
        sr_min = float(ov.pop("sr_min", 0.04))
        if ov:
            raise ValueError(f"unknown dror fields: {sorted(ov)}")
        points, mask = _frames(padded, batch, device)
        coef = float(np.float32(beta) * np.float32(math.radians(alpha)))

        def step(points=points, mask=mask, window=window, margin=margin,
                 block=block, coef=coef, k_min=k_min, sr_min=sr_min):
            ovf = 0
            for p, m in zip(points, mask):
                if window:
                    _keep, o = dror_windowed(p[:, :3], m, coef, k_min,
                                             sr_min, block=block,
                                             window=window, margin=margin)
                    ovf = ovf + o
                else:   # the full search tiles itself: block unused
                    dror_full(p[:, :3], m, coef, k_min, sr_min)
            return ovf

        arms[name] = Arm(make_runner(step, batch, device), batch)
    return arms


def build_lisa_arms(variants: dict[str, dict],
                    device="cuda") -> dict[str, Arm]:
    """LISA's core (rain, Rr 10 mm/h by default; kernel L1 for the Qback
    lookup) on the bench scan frame by frame (default 8 frames), each
    frame with its own seeded draws; fields other than batch and Rr go to
    the LISA constructor, over the bench's (48, 16) droplets
    (bench.py:473; the JAX tool's base takes LISA's defaults, (32, 8),
    whose droplet_overflow is nonzero on the bench scan, an invalid arm
    by its own gate)."""
    from lidar_snow_sim_tpu_torch.models import lisa as tlisa

    _calib, _pc, padded = _bench_cloud()
    arms = {}
    for name, ov in variants.items():
        ov = dict(ov)
        batch = ov.pop("batch", 8)
        rr = float(ov.pop("Rr", 10.0))
        lisa = tlisa.LISA(**{"max_droplets": 48, "tail_droplets": 16,
                             **ov}, device=device)
        tables = tlisa.lisa_tables_to_torch(lisa._dsd_tables(rr), device)
        alpha = torch.tensor(lisa.alpha(rr), dtype=torch.float32,
                             device=device)
        density = torch.tensor(lisa.droplet_density(rr),
                               dtype=torch.float32, device=device)
        core = lisa.core_config()
        points, mask = _frames(padded, batch, device)
        points[..., 3] /= 255.0
        n = points.shape[1]
        draws = [tlisa.lisa_draws(
            n, lisa.max_droplets, lisa.tail_droplets,
            torch.Generator(device=device).manual_seed(i))
            for i in range(batch)]

        def step(points=points, mask=mask, draws=draws, tables=tables,
                 alpha=alpha, density=density, core=core):
            return sum(tlisa.lisa_augment_core(p, m, d, alpha, density,
                                               tables, core).droplet_overflow
                       for p, m, d in zip(points, mask, draws))

        arms[name] = Arm(make_runner(step, batch, device), batch)
    return arms


def build_detect_arms(variants: dict[str, dict],
                      device="cuda") -> dict[str, Arm]:
    """PointPillars `detect` at full width (nms_pre_max 1,024, bfloat16 by
    default) on the bench scan frame by frame (default 4 frames), seeded
    random weights with the class logits scaled to background level (so
    the candidates are as sparse as on real scenes); a variant's fields
    override the config's."""
    from lidar_snow_sim_tpu_torch.models import pointpillars as tpp

    _calib, _pc, padded = _bench_cloud()
    arms = {}
    for name, ov in variants.items():
        ov = dict(ov)
        batch = ov.pop("batch", 4)
        cfg = dataclasses.replace(tpp.PointPillarsConfig(), nms_pre_max=1024,
                                  compute_dtype="bfloat16")
        cfg = dataclasses.replace(cfg, **ov)
        params = tpp.init_params(cfg, torch.Generator().manual_seed(0))
        params["dense_head.conv_cls.weight"] = (
            params["dense_head.conv_cls.weight"] * 0.01)
        net = tpp.PointPillars(cfg, params, device=device)
        pts4 = np.asarray(padded.points)[:, :4].copy()
        pts4[:, 3] /= 255.0
        points = torch.as_tensor(pts4, device=device)
        mask = torch.as_tensor(padded.mask, device=device)

        def step(net=net, points=points, mask=mask, batch=batch):
            ovf = 0
            for _ in range(batch):
                out = tpp.detect(points, mask, net, device=device)
                ovf = ovf + (out.nms_pre_overflow + out.prefix_overflow
                             + out.topk_block_miss)
            return ovf

        arms[name] = Arm(make_runner(step, batch, device), batch)
    return arms


BUILDERS = {
    "snow": build_snow_arms,
    "dror": build_dror_arms,
    "lisa": build_lisa_arms,
    "detect": build_detect_arms,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", choices=sorted(BUILDERS))
    ap.add_argument("specs", nargs="+", help="variant specs (see module doc)")
    ap.add_argument("--short", type=int, default=2)
    ap.add_argument("--long", dest="long_", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)

    from lidar_snow_sim_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line

        where = card_line()
    else:
        where = "cpu"
    print(f"device: {where}", flush=True)
    variants = parse_variants(args.model, args.specs)
    arms = BUILDERS[args.model](variants, device)
    out = interleaved_ab(arms, short=args.short, long_=args.long_,
                         reps=args.reps)
    print(json.dumps({"model": args.model, "device": where, "arms": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
