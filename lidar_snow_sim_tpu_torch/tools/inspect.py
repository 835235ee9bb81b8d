"""Headless scan inspector on PyTorch (counterpart of
`lidar_snow_sim_tpu/tools/inspect.py`).

The reference Qt viewer's `show_pointcloud` order without the GUI: DROR
mask -> camera-FOV filter -> min/max distance and height masks -> one
augmentation (snow | wet | snow+wet | lisa | fog | stf_fog) -> stat labels;
prints the stats as JSON (the JAX CLI's keys) and optionally writes a BEV
PNG. Same flags as the JAX CLI, plus --device (default cuda; without a
card it raises, and the CPU must be asked for with --device cpu). Example:

  python -m lidar_snow_sim_tpu_torch.tools.inspect scan.bin --augment lisa \
      --dror --fov --device cuda
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.device import resolve_device

MIN_DIST = 3.0  # the viewer's hard minimum distance (pointcloud_viewer.py)

# augmenters cached per parameter key, so a repeated in-process call reuses
# loaded banks and baked tables (the viewer keeps them in its window)
_AUGMENTER_CACHE: dict = {}


def _cached(key, factory):
    if key not in _AUGMENTER_CACHE:
        _AUGMENTER_CACHE[key] = factory()
    return _AUGMENTER_CACHE[key]


def add_pipeline_args(ap):
    """The JAX CLI's scan, mask and augmentation arguments
    (`lidar_snow_sim_tpu/tools/inspect.py`), plus --device."""
    ap.add_argument("scan", help=".bin scan (N x 5 float32)")
    ap.add_argument(
        "--augment",
        choices=("none", "snow", "wet", "snow+wet", "lisa", "fog", "stf_fog"),
        default="none",
    )
    ap.add_argument("--bank-dir", default=None)
    ap.add_argument("--rate", type=float, default=0.5, help="snowfall mm/h")
    ap.add_argument("--velocity", type=float, default=2.0, help="terminal m/s")
    ap.add_argument("--mode", default="gunn", choices=("gunn", "sekhon"))
    ap.add_argument("--rain-rate", type=float, default=10.0, help="LISA mm/h")
    ap.add_argument("--fog-alpha", type=float, default=0.02,
                    help="attenuation coefficient for --augment fog "
                         "(the viewer's 'our fog' alpha slider, "
                         "pointcloud_viewer.py:2939-2956)")
    ap.add_argument("--beta", type=float, default=0.046,
                    help="STF-fog scattering coefficient for --augment "
                         "stf_fog (a PHYSICALLY DIFFERENT knob from "
                         "--fog-alpha: the viewer drives BetaRadomization "
                         "with its own beta, pointcloud_viewer.py:2958-2975)")
    ap.add_argument("--dror", action="store_true", help="apply DROR de-snowing")
    ap.add_argument("--fov", action="store_true", help="camera-FOV filter")
    ap.add_argument("--max-dist", type=float, default=None)
    ap.add_argument("--min-height", type=float, default=None)
    ap.add_argument("--labels", default=None,
                    help="KITTI-format GT/prediction label file to overlay")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    return ap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_pipeline_args(ap)
    ap.add_argument("--bev", default=None, help="write a BEV PNG here")
    ap.add_argument("--bev-color", default="label",
                    choices=("depth", "intensity", "label", "channel",
                             "height"))
    ap.add_argument("--image", default=None,
                    help="synchronized camera image (default: the DENSE "
                         "cam_stereo_left_lut sibling); stacked under the "
                         "BEV PNG")
    args = ap.parse_args(argv)
    pc, report, boxes = run_pipeline(args, ap)

    if args.bev:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from PIL import Image

        from lidar_snow_sim_tpu_torch.utils.boxes import draw_boxes_bev
        from lidar_snow_sim_tpu_torch.utils.datasets import find_camera_image
        from lidar_snow_sim_tpu_torch.utils.render import bev_image

        img = bev_image(pc, color=args.bev_color)
        if boxes:
            draw_boxes_bev(img, boxes)
        cam_path = args.image or find_camera_image(args.scan)
        if cam_path:
            # the camera frame resized to the BEV width, stacked below
            cam = Image.open(cam_path).convert("RGB")
            w = img.shape[1]
            cam = cam.resize((w, max(1, int(cam.height * w / cam.width))))
            img = np.concatenate([img, np.asarray(cam, np.uint8)], axis=0)
            report["camera_image"] = str(Path(cam_path).resolve())
        plt.imsave(args.bev, img)
        report["bev"] = str(Path(args.bev).resolve())

    print(json.dumps(report, indent=2))
    return 0


def run_pipeline(args, ap):
    """DROR -> FOV -> masks -> augmentation -> stats on `args.device`.
    Returns (pc (N, 5), report dict, boxes list)."""
    from lidar_snow_sim_tpu_torch.utils.pointcloud import load_velodyne_bin
    from lidar_snow_sim_tpu_torch.utils.render import (
        augmentation_stat_labels,
        cloud_log_string,
    )

    device = resolve_device(args.device)
    pc = load_velodyne_bin(args.scan)
    report = {"file": str(args.scan), "loaded": len(pc)}

    # ---- viewer mask order: DROR -> FOV -> distance/height ----
    if args.dror:
        from lidar_snow_sim_tpu_torch.models.dror import (
            dror_snow_stats,
            dynamic_radius_outlier_filter,
        )

        num_snow, level = dror_snow_stats(pc, device=device)
        keep = dynamic_radius_outlier_filter(pc, device=device)
        report["dror"] = {
            "removed": int((~keep).sum()),
            "cube_snow_points": num_snow,
            "severity": level,
        }
        pc = pc[keep]
    if args.fov:
        from lidar_snow_sim_tpu_torch.camera import camera_fov_mask

        m = camera_fov_mask(
            torch.as_tensor(pc[:, :3], device=device)).cpu().numpy()
        report["fov_removed"] = int((~m).sum())
        pc = pc[m]
    dist = np.linalg.norm(pc[:, :3], axis=1)
    m = dist >= MIN_DIST
    if args.max_dist is not None:
        m &= dist <= args.max_dist
    if args.min_height is not None:
        m &= pc[:, 2] >= args.min_height
    pc = pc[m]
    n_before = len(pc)
    report["after_masks"] = n_before

    # ---- augmentation (mutually exclusive, viewer ordering) ----
    aug = args.augment
    if aug in ("snow", "snow+wet"):
        from lidar_snow_sim_tpu_torch.calib import load_hdl64_calib
        from lidar_snow_sim_tpu_torch.config import SnowfallConfig
        from lidar_snow_sim_tpu_torch.sampling.banks import load_bank_files
        from lidar_snow_sim_tpu_torch.sampling.distributions import (
            compute_occupancy,
            snowfall_rate_to_rainfall_rate,
        )
        from lidar_snow_sim_tpu_torch.models.snowfall import SnowfallAugmenter

        if not args.bank_dir:
            ap.error("--augment snow requires --bank-dir")
        rr = snowfall_rate_to_rainfall_rate(args.rate, args.velocity)
        occ = compute_occupancy(args.rate, args.velocity)
        prefix = f"{args.mode}_{rr}_{occ}"   # the viewer's live prefix
        cap = 1 << int(np.ceil(np.log2(max(len(pc), 2))))
        # the JAX CLI's config: the window assembly (kernels W1 and W2 on
        # the card), rows back stable-sorted by channel
        cfg = SnowfallConfig(
            max_points=cap, window_size=256, wide_capacity=128,
            max_occluders=64, max_bumps=32, point_chunk=2048,
        )

        def make_snow():
            bank = load_bank_files(
                args.bank_dir, prefix, window_size=cfg.window_size,
                wide_threshold=cfg.wide_threshold,
                wide_capacity=cfg.wide_capacity,
            )
            return SnowfallAugmenter(
                bank=bank, calib=load_hdl64_calib(), cfg=cfg, seed=args.seed,
                device=device,
            )

        stats, pc = _cached(
            ("snow", str(args.bank_dir), prefix, cap, args.seed, device),
            make_snow,
        )(pc)
        report["snow"] = {
            "num_attenuated": stats[0],
            "num_removed": stats[1],
            "avg_intensity_diff": stats[2],
            "particle_file_prefix": prefix,
        }
    if aug in ("wet", "snow+wet"):
        from lidar_snow_sim_tpu_torch.models.wet_ground import (
            WetGroundAugmenter,
        )

        pc = _cached(
            ("wet", args.seed, device),
            lambda: WetGroundAugmenter(seed=args.seed, device=device),
        )(pc)
        report["wet"] = {"points": len(pc)}
    if aug == "lisa":
        from lidar_snow_sim_tpu_torch.models.lisa import LISA

        pc, stats = _cached(
            ("lisa", device), lambda: LISA(device=device)
        ).augment_compact(pc, args.rain_rate, fixed_seed=True, seed=args.seed)
        report["lisa"] = stats
    if aug == "fog":
        from lidar_snow_sim_tpu_torch.models.fog import (
            FogAugmenter,
            FogParameterSet,
        )

        pc, stats = _cached(
            ("fog", args.fog_alpha, args.seed, device),
            lambda: FogAugmenter(FogParameterSet(alpha=args.fog_alpha),
                                 seed=args.seed, device=device),
        )(pc)
        report["fog"] = stats
    if aug == "stf_fog":
        from lidar_snow_sim_tpu_torch.models.stf_fog import StfFogAugmenter

        pc, stats = _cached(
            ("stf_fog", args.beta, args.seed, device),
            lambda: StfFogAugmenter(beta=args.beta, seed=args.seed,
                                    device=device),
        )(pc)
        report["stf_fog"] = stats

    if aug != "none":
        report["labels"] = augmentation_stat_labels(pc, n_before)
    report["log"] = cloud_log_string(pc)

    boxes = []
    if args.labels:
        from lidar_snow_sim_tpu_torch.utils.boxes import (
            points_in_boxes,
            read_label_file,
        )

        boxes = read_label_file(args.labels)
        in_box = points_in_boxes(pc, boxes)
        report["boxes"] = [
            {
                "identity": b.identity,
                "distance": round(b.distance, 2),
                "points_inside": int((in_box == i).sum()),
            }
            for i, b in enumerate(boxes)
        ]

    return pc, report, boxes


if __name__ == "__main__":
    sys.exit(main())
