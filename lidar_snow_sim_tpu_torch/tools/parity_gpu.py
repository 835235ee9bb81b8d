"""Run the exact-or-boundary device/oracle parity harness on the card and
write a report (counterpart of `lidar_snow_sim_tpu/tools/parity_tpu.py`).

The CPU harness (tests/test_snowfall_parity.py) is exact; the card's float32
(its own transcendentals, reduction orders) can shift decision boundaries
the CPU never sees. This tool runs the JAX tool's scene through the window
assembly (kernels W1 and W2), the dense assembly (kernels A1 and C1) and
the span-routed dense assembly (kernel A2 in both of its modes, then C1) on
the device, classifies every mismatch against the port's NumPy oracle with
its margin machinery (`oracle/parity.py`), and writes the counts and each
variant's kernel launches with the card's name and power limit
(nvidia-smi) and the torch version.

Usage:  python -m lidar_snow_sim_tpu_torch.tools.parity_gpu [out.json]
        [--device cuda|cpu]

The device defaults to cuda and raises without a card; the CPU must be asked
for. Exits 1 unless every variant has 0 unexplained mismatches, a mismatch
rate under 0.002 and no overflow, and, on the card, launched its kernels
(`KERNELS`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def build_scene():
    """The parity scene of tests/test_snowfall_parity.py (same seeds as the
    JAX tool's): the channel-sorted scan, 64 sets of 250 particles, their
    bank, the channel order and the config."""
    from lidar_snow_sim_tpu_torch.calib import load_hdl64_calib
    from lidar_snow_sim_tpu_torch.config import SnowfallConfig
    from lidar_snow_sim_tpu_torch.sampling.banks import build_bank
    from lidar_snow_sim_tpu_torch.utils.synthetic import synthetic_scan

    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=100, seed=1, calib=calib)
    pc = pc[np.argsort(pc[:, 4], kind="stable")]

    rng = np.random.default_rng(11)
    sets = []
    for _ in range(64):
        ang = rng.uniform(0, 2 * np.pi, 250)
        d = np.sqrt(rng.uniform(0.01, 1, 250)) * 60
        r = rng.uniform(0.005, 0.05, 250)
        sets.append(np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))

    cfg = SnowfallConfig(
        max_points=1 << int(np.ceil(np.log2(len(pc)))),
        window_size=256,
        wide_capacity=64,
        max_occluders=48,
        max_bumps=24,
        point_chunk=256,
    )
    bank = build_bank(
        sets,
        window_size=cfg.window_size,
        wide_threshold=cfg.wide_threshold,
        wide_capacity=cfg.wide_capacity,
    )
    order = np.random.default_rng(3).permutation(64)
    return calib, pc, sets, bank, order, cfg


# the kernels each variant launches on the card
KERNELS = {"window": ("W1", "W2"), "dense_pallas": ("A1", "C1"),
           "dense_pallas_routed": ("A2", "C1")}


def variants(cfg):
    """The JAX tool's three variants (parity_tpu.py:98-116) on the port's
    config: window; dense (A1, C1); dense span-routed with route_band 128
    under a 384 slice, so both fast-banded (mode 2) and full-slice (mode 1)
    groups run on A2."""
    dense = dict(assembly="dense", channel_capacity=128, block_points=32,
                 slice_width=384, chunk_group=8, use_pallas=True)
    return {
        "window": cfg,
        "dense_pallas": dataclasses.replace(cfg, **dense),
        "dense_pallas_routed": dataclasses.replace(
            cfg, **dense, route_band=128, band_group=8),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="PARITY_GPU.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)

    import torch

    from lidar_snow_sim_tpu_torch.device import resolve_device
    from lidar_snow_sim_tpu_torch.models.snowfall import (
        OVERFLOW_COUNTERS,
        bank_to_torch,
        calib_to_torch,
        snowfall_augment,
    )
    from lidar_snow_sim_tpu_torch.ops.fitting import ransac_draws
    from lidar_snow_sim_tpu_torch.ops.occluders import (
        find_occluders,
        find_occluders_routed,
        find_occluders_window,
    )
    from lidar_snow_sim_tpu_torch.ops.pulse import (
        pulse_peaks,
        window_pulse_peaks,
    )
    from lidar_snow_sim_tpu_torch.oracle.parity import classify_parity
    from lidar_snow_sim_tpu_torch.oracle.snowfall import (
        augment as augment_oracle,
    )
    from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line
    from lidar_snow_sim_tpu_torch.utils.pointcloud import pad_cloud

    dev = resolve_device(args.device)
    beam_div_deg = float(np.degrees(3e-3))
    w = np.array([0.005, -0.003, -1.0])
    plane = (w / np.linalg.norm(w), -1.55)

    calib, pc, sets, bank, order, cfg = build_scene()
    stats_o, _ = augment_oracle(
        pc.astype(np.float64), sets, calib, order, beam_div_deg,
        plane=plane, device_semantics=True,
    )

    padded = pad_cloud(pc, cfg.max_points)
    inputs = (
        torch.as_tensor(padded.points, device=dev),
        torch.as_tensor(padded.mask, device=dev),
        bank_to_torch(bank, dev),
        calib_to_torch(calib, dev),
        torch.as_tensor(order, dtype=torch.int64, device=dev),
        # unused: the plane is given, so no RANSAC runs
        ransac_draws(0, cfg.ransac_trials).to(dev),
    )
    plane_t = (torch.as_tensor(plane[0], dtype=torch.float32, device=dev),
               torch.tensor(plane[1], dtype=torch.float32, device=dev))
    n = len(pc)
    counted = {"A1": find_occluders, "A2": find_occluders_routed,
               "C1": pulse_peaks, "W1": find_occluders_window,
               "W2": window_pulse_peaks}

    report = {
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "card": card_line() if dev.type == "cuda" else None,
        "torch": torch.__version__,
        "points": n,
        "oracle_stats": dict(
            num_attenuated=int(stats_o[0]), num_removed=int(stats_o[1]),
            avg_intensity_diff=int(stats_o[2]),
        ),
        "assemblies": {},
    }
    for name, vcfg in variants(cfg).items():
        before = {k: fn.launches for k, fn in counted.items()}
        res = snowfall_augment(*inputs, vcfg, plane=plane_t)
        planes = res.planes.cpu().numpy()
        launches = {k: fn.launches - before[k] for k, fn in counted.items()}
        overflows = {c.removesuffix("_overflow"): int(getattr(res, c))
                     for c in OVERFLOW_COUNTERS}
        cls = classify_parity(
            pc, planes.T[:n], sets, calib, order, beam_div_deg,
        )
        report["assemblies"][name] = dict(
            overflows=overflows,
            device_stats=dict(
                num_attenuated=int(res.num_attenuated),
                num_removed=int(res.num_removed),
                avg_intensity_diff=int(res.avg_intensity_diff),
            ),
            total=cls["total"],
            num_mismatches=len(cls["mismatches"]),
            num_unexplained=len(cls["unexplained"]),
            mismatch_rate=round(cls["mismatch_rate"], 6),
            boundary_examples=cls["mismatches"][:5],
            unexplained_examples=cls["unexplained"][:5],
            launches=launches,
        )
        print(
            f"{name}: {len(cls['mismatches'])}/{cls['total']} boundary-tied,"
            f" {len(cls['unexplained'])} unexplained, overflows={overflows},"
            f" launches={launches}"
        )

    ok = all(
        a["num_unexplained"] == 0 and a["mismatch_rate"] < 0.002
        and not any(a["overflows"].values())
        and (dev.type != "cuda"
             or all(a["launches"][k] >= 1 for k in KERNELS[name]))
        for name, a in report["assemblies"].items()
    )
    report["ok"] = bool(ok)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"parity_gpu {'ok' if ok else 'FAILED'} on {report['device']} "
          f"({report['card']}) -> {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
