"""Headless detector inference on PyTorch (counterpart of
`lidar_snow_sim_tpu/tools/infer.py`): the viewer's `run_inference` without
Qt.

The reference's live inference (`pointcloud_viewer.py:2388-2498`) takes
the displayed (optionally augmented) cloud plus temporal neighbour scans,
stacks them, runs the detector of an experiment directory (the last
``*.yaml`` and ``*.pth`` in listing order) and renders the (K, 9) array
``[box7 | label | score]`` (`:2428-2436`); here it is written to disk
and/or drawn on a BEV PNG. The cloud comes from the port's
`tools/inspect.run_pipeline`, so the masks and augmentations are the
inspect CLI's. Weights: ``--params`` (an ``.npz`` of either package),
``--experiment`` (its ``params_tpu.npz``, else its ``.pth`` read
directly), or ``--random-params`` for a smoke test. Same flags as the JAX
CLI, plus --device (default cuda; without a card it raises, and the CPU
must be asked for with --device cpu). Example:

  python -m lidar_snow_sim_tpu_torch.tools.infer scan.bin --random-params \
      --augment snow --bank-dir banks --predictions preds.txt --bev out.png
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.tools.inspect import (
    add_pipeline_args,
    run_pipeline,
)


def load_engine(args, device="cuda"):
    """(cfg, PointPillars on `device`) from --experiment / --config /
    --params / --random-params."""
    from lidar_snow_sim_tpu_torch.models.pointpillars import (
        PointPillars,
        PointPillarsConfig,
        config_from_openpcdet_yaml,
        init_params,
    )
    from lidar_snow_sim_tpu_torch.tools.convert_checkpoint import (
        find_experiment_files,
        load_checkpoint,
        load_params,
    )

    yaml_path = args.config
    params_path = args.params
    pth_path = None
    if args.experiment:
        y, p = find_experiment_files(args.experiment)
        yaml_path = yaml_path or y
        pth_path = p
        npz = Path(args.experiment) / "params_tpu.npz"
        if params_path is None and npz.exists():
            params_path = npz

    cfg = (config_from_openpcdet_yaml(yaml_path) if yaml_path
           else PointPillarsConfig())
    if args.max_pillars:
        cfg = dataclasses.replace(cfg, max_pillars=args.max_pillars)

    if params_path is not None:
        params = load_params(params_path)
    elif pth_path is not None:
        params = load_checkpoint(pth_path, cfg)
    elif args.random_params:
        params = init_params(cfg, torch.Generator().manual_seed(args.seed))
        print("WARNING: using RANDOM weights (--random-params); "
              "predictions are smoke-test output only", file=sys.stderr)
    else:
        raise SystemExit(
            "no weights: pass --experiment with a .pth/params_tpu.npz, "
            "--params, or --random-params for a smoke test"
        )
    return cfg, PointPillars(cfg, params, device=device)


def prediction_boxes(arr, class_names) -> list:
    """(K, 9) predictions [box7 | 1-based label | score] -> Box3D list
    (identity "Unknown" for a label outside `class_names`)."""
    from lidar_snow_sim_tpu_torch.utils.boxes import Box3D

    return [
        Box3D(
            x=float(r[0]), y=float(r[1]), z=float(r[2]),
            length=float(r[3]), width=float(r[4]), height=float(r[5]),
            yaw=float(r[6]),
            identity=(
                class_names[int(r[7]) - 1]
                if 0 < int(r[7]) <= len(class_names) else "Unknown"
            ),
            score=float(r[8]),
        )
        for r in arr
    ]


def class_counts(arr, class_names) -> dict:
    """Predictions per class name of a (K, 9) array (labels 1-based; a
    label outside `class_names` is left out)."""
    return {
        class_names[int(c) - 1]: int((arr[:, 7] == c).sum())
        for c in np.unique(arr[:, 7]).astype(int)
        if 0 < c <= len(class_names)
    }


def predictions_to_label_lines(arr, class_names) -> list:
    """(K, 9) predictions -> KITTI-style label lines (the convention
    `utils/boxes.py` parses back: z at box bottom, score last)."""
    lines = []
    for row in arr:
        x, y, z, dx, dy, dz, yaw, label, score = row
        name = (
            class_names[int(label) - 1]
            if 0 < int(label) <= len(class_names) else "Unknown"
        )
        lines.append(
            f"{name} 0 0 0 0 0 0 0 "
            f"{dz:.4f} {dy:.4f} {dx:.4f} {x:.4f} {y:.4f} {z - dz / 2:.4f} "
            f"{yaw:.4f} {score:.4f}"
        )
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_pipeline_args(ap)
    ap.add_argument("--experiment", default=None,
                    help="OpenPCDet experiment dir (.yaml + .pth / npz)")
    ap.add_argument("--config", default=None, help="explicit config yaml")
    ap.add_argument("--params", default=None, help="explicit params .npz")
    ap.add_argument("--random-params", action="store_true",
                    help="random weights (pipeline smoke test)")
    ap.add_argument("--temporal", nargs="*", default=[],
                    help="neighbor-frame .bin scans stacked into the input "
                         "(the viewer's temporal_pcs)")
    ap.add_argument("--exclude-current", action="store_true",
                    help="viewer's 'zero' checkbox OFF: only temporal scans")
    ap.add_argument("--intensity-scale", type=float, default=1.0 / 255.0,
                    help="intensity prescale before the detector (DENSE "
                         ".bin stores 0-255; pcdet models train on 0-1)")
    ap.add_argument("--max-pillars", type=int, default=0,
                    help="override pillar capacity")
    ap.add_argument("--predictions", default=None,
                    help="write predictions here (.npy = (K, 9) array, "
                         "anything else = KITTI label lines)")
    ap.add_argument("--bev", default=None, help="BEV PNG with pred boxes")
    args = ap.parse_args(argv)

    from lidar_snow_sim_tpu_torch.models.pointpillars import (
        detect,
        predictions_array,
    )
    from lidar_snow_sim_tpu_torch.utils.pointcloud import load_velodyne_bin

    device = resolve_device(args.device)
    # the viewer runs inference on the DISPLAYED cloud, augmentations and
    # masks included (run_inference uses self.current_pc, :2405-2414)
    pc, report, _ = run_pipeline(args, ap)

    list_of_pcs = [] if args.exclude_current else [pc]
    list_of_pcs += [load_velodyne_bin(t) for t in args.temporal]
    if not list_of_pcs:
        print("There are no points to process.", file=sys.stderr)  # :2412
        return 1
    points = np.vstack([p[:, :4] for p in list_of_pcs]).astype(np.float32)
    points[:, 3] *= args.intensity_scale

    cfg, net = load_engine(args, device)
    preds = detect(points, None, net, device=device)
    arr = predictions_array(preds)

    report["inference"] = {
        "input_points": len(points),
        "num_predictions": len(arr),
        "points_dropped": int(preds.points_dropped),
        "pillars_dropped": int(preds.pillars_dropped),
        "nms_pre_overflow": int(preds.nms_pre_overflow),
        # the JAX package's nms_pre_overflow is the sum of the two
        "topk_block_miss": int(preds.topk_block_miss),
        "classes": class_counts(arr, cfg.class_names),
    }

    if args.predictions:
        if args.predictions.endswith(".npy"):
            np.save(args.predictions, arr)
        else:
            Path(args.predictions).write_text(
                "\n".join(predictions_to_label_lines(arr, cfg.class_names))
                + "\n"
            )
        report["inference"]["saved"] = str(Path(args.predictions).resolve())

    if args.bev:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from lidar_snow_sim_tpu_torch.utils.boxes import draw_boxes_bev
        from lidar_snow_sim_tpu_torch.utils.render import bev_image

        img = bev_image(pc, color="label")
        draw_boxes_bev(img, prediction_boxes(arr, cfg.class_names))
        plt.imsave(args.bev, img)
        report["inference"]["bev"] = str(Path(args.bev).resolve())

    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
