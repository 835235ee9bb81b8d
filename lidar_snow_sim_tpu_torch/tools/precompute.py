"""Offline snowfall-dataset generation CLI (counterpart of
`lidar_snow_sim_tpu/tools/precompute.py`; reference script
`tools/snowfall/precompute.py:47-106`).

Walks an STF split and, for each mode and (snowfall rate, terminal
velocity) combo, camera-FOV-filters each scan, runs the snowfall
augmentation (and wet ground with --wet), and writes STF-format .bin files
to

    {out_root}/snowfall_simulation/{mode}/{lidar_name}_rainrate_{int(rr)}/{id}.bin

with skip-if-exists resume. Same flags as the JAX CLI without --mesh, plus
--device and the phase-A layout (--route-band, --band-width, --band-group;
SnowfallConfig's fields of those names). Run:
python -m lidar_snow_sim_tpu_torch.tools.precompute --help
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from lidar_snow_sim_tpu.config import SnowfallConfig, WetGroundConfig
from lidar_snow_sim_tpu.tools.precompute import (
    SNOWFALL_RATES,
    TERMINAL_VELOCITIES,
    reference_sample_order,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split", required=True, help="STF split .txt")
    ap.add_argument(
        "--lidar-dir", required=True,
        help="directory of {id}.bin scans (e.g. lidar_hdl64_strongest)",
    )
    ap.add_argument(
        "--bank-dir", required=True,
        help="directory of {mode}_{rate}_{occ}_{line}.npy particle files",
    )
    ap.add_argument("--out-root", default=None,
                    help="default: parent of --lidar-dir")
    ap.add_argument("--modes", nargs="+", default=("gunn", "sekhon"))
    ap.add_argument("--rates", type=float, nargs="+", default=SNOWFALL_RATES)
    ap.add_argument(
        "--velocities", type=float, nargs="+", default=TERMINAL_VELOCITIES
    )
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-points", type=int, default=1 << 16)
    ap.add_argument("--window-size", type=int, default=256)
    ap.add_argument("--no-fov-filter", action="store_true")
    ap.add_argument("--camera-calib", default=None,
                    help="KITTI-format calib txt (default: built-in DENSE rig)")
    ap.add_argument("--shard", default="0/1",
                    help="i/n: process every n-th frame starting at i")
    ap.add_argument("--wet", action="store_true",
                    help="chain wet-ground reflectance after snowfall "
                         "(the viewer's snow+wet mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda when available)")
    ap.add_argument("--route-band", type=int, default=0,
                    help="span-routed phase A (kernel A2) band width; 0: off")
    ap.add_argument("--band-width", type=int, default=0,
                    help="dual-banded phase A (kernel A3) band width; 0: off")
    ap.add_argument("--band-group", type=int, default=8,
                    help="beams per band of --route-band/--band-width")
    args = ap.parse_args(argv)

    from lidar_snow_sim_tpu.calib import load_hdl64_calib
    from lidar_snow_sim_tpu.sampling.banks import load_bank_files
    from lidar_snow_sim_tpu.sampling.distributions import (
        compute_occupancy,
        snowfall_rate_to_rainfall_rate,
    )
    from lidar_snow_sim_tpu.utils.pointcloud import load_velodyne_bin
    from lidar_snow_sim_tpu_torch.camera import (
        CameraCalibration,
        camera_fov_mask,
    )
    from lidar_snow_sim_tpu_torch.parallel.datagen import (
        run_snowfall_datagen,
    )

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    lidar_dir = Path(args.lidar_dir)
    out_root = Path(args.out_root) if args.out_root else lidar_dir.parent
    shard_i, shard_n = (int(x) for x in args.shard.split("/"))
    ids = reference_sample_order(args.split)[shard_i::shard_n]
    print(f"{len(ids)} frames (shard {args.shard}) on {device}")

    calib = load_hdl64_calib()
    cam = (CameraCalibration.from_file(args.camera_calib)
           if args.camera_calib else None)
    fov = None if args.no_fov_filter else (
        lambda xyz: camera_fov_mask(xyz, cam).numpy()
    )
    pch = max(args.max_points // 64, 256)
    cfg = SnowfallConfig(
        max_points=args.max_points, window_size=args.window_size,
        wide_capacity=128, max_occluders=32, max_bumps=32, point_chunk=2048,
        assembly="dense",   # capacities self-tune on overflow
        channel_capacity=pch,
        block_points=max(min(128, pch // 8), 32),
        slice_width=1536,
        route_band=args.route_band, band_width=args.band_width,
        band_group=args.band_group,
    )
    wet_cfg = WetGroundConfig(replace=False) if args.wet else None

    def load_fn(sid):
        return load_velodyne_bin(lidar_dir / f"{sid}.bin")

    combos = [
        (snowfall_rate_to_rainfall_rate(s, v), compute_occupancy(s, v))
        for s, v in zip(args.rates, args.velocities)
    ]
    all_stats = {}
    for mode in args.modes:
        for rr, occ in combos:
            bank = load_bank_files(
                args.bank_dir, f"{mode}_{rr}_{occ}",
                window_size=cfg.window_size,
                wide_threshold=cfg.wide_threshold,
                wide_capacity=cfg.wide_capacity,
            )
            out_dir = (
                out_root / "snowfall_simulation" / mode
                / f"{lidar_dir.name}_rainrate_{int(rr)}"
            )
            stats = run_snowfall_datagen(
                ids, load_fn, out_dir, bank, calib, cfg,
                batch=args.batch, seed=args.seed, fov_filter=fov,
                overwrite=args.overwrite, wet_cfg=wet_cfg, device=device,
            )
            all_stats[f"{mode}_rainrate_{int(rr)}"] = stats.as_dict()
            print(f"{mode} rr={rr:.2f}: {json.dumps(stats.as_dict())}",
                  flush=True)
    print(json.dumps(all_stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
