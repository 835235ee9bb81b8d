"""Score detection results with the KITTI-protocol AP evaluator, on
PyTorch (counterpart of `lidar_snow_sim_tpu/tools/evaluate.py`).

Headless equivalent of the scoring step behind the reference's experiment
tables (the CVPR'22 paper evaluates `experiments.zip` checkpoints on the
STF snow splits with OpenPCDet's vendored `kitti_object_eval_python`;
`lib/OpenPCDet` is an empty submodule dir in the snapshot — protocol
semantics live in `utils/eval_ap.py`). Consumes prediction label files as
written by `tools/infer.py --predictions` and ground-truth label files in
either the same LiDAR-frame KITTI layout or the DENSE devkit layout
(`pointcloud_viewer.py:3083-3120` camera-frame labels + TF-tree calib).

Same flags as the JAX CLI, plus --device for the IoU matrices (default
cuda; without a card it raises, and the CPU must be asked for with
--device cpu).

    python -m lidar_snow_sim_tpu_torch.tools.evaluate \
        --predictions preds_dir/ --labels gt_dir/ \
        --classes Car,Pedestrian,Cyclist --metrics 3d,bev --out table.json

    # DENSE ground truth (camera-frame labels need the TF tree):
    python -m lidar_snow_sim_tpu_torch.tools.evaluate \
        --predictions preds/ --labels gt_labels_cmore/ --format dense \
        --dataset-root dense_root/ --camera-calib calib_cam_stereo_left.json \
        --tf-tree calib_tf_tree_full.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.utils import eval_ap


def _gt_from_kitti_lidar(path: Path) -> dict:
    """GT frame from a LiDAR-frame KITTI-layout label file (the layout
    `tools/infer.py` writes and `utils.boxes.parse_kitti_label_line`
    reads: z at box bottom; truncation/occlusion/bbox columns kept here
    for the difficulty buckets)."""
    boxes, names, trunc, occ, bh = [], [], [], [], []
    if path.exists():
        for line in path.read_text().splitlines():
            tok = line.split()
            if len(tok) < 15:
                continue
            try:
                vals = [float(v) for v in tok[1:15]]
            except ValueError:
                continue
            h, w, length = vals[7], vals[8], vals[9]
            x, y, z, yaw = vals[10], vals[11], vals[12], vals[13]
            names.append(tok[0])
            boxes.append([x, y, z + h / 2, length, w, h, yaw])
            trunc.append(vals[0])
            occ.append(vals[1])
            bh.append(vals[6] - vals[4])
    bh_arr = np.asarray(bh, float)
    # files without 2D boxes (e.g. infer.py output reused as GT) leave the
    # bbox columns zero — a 0px "height" would mark every box ignored, so
    # the height gate is disabled instead (documented eval_ap delta)
    has_bbox = bool(len(bh_arr)) and bool(np.any(bh_arr > 0))
    return eval_ap.gt_frame(
        np.asarray(boxes, float).reshape(-1, 7), names,
        truncated=trunc, occluded=occ,
        bbox_height=bh_arr if has_bbox else None,
    )


def _gt_from_dense(path: Path, camera_to_velodyne) -> dict:
    from lidar_snow_sim_tpu_torch.utils.stf_labels import read_label

    anns = read_label(
        str(path)[: -len(".txt")] if str(path).endswith(".txt") else str(path),
        camera_to_velodyne=camera_to_velodyne,
    )
    frame = eval_ap.gt_frame_from_annotations(anns)
    if frame["bbox_height"] is not None and not np.any(
        frame["bbox_height"] > 0
    ):
        frame["bbox_height"] = None
    return frame


def _det_from_file(path: Path) -> dict:
    from lidar_snow_sim_tpu_torch.utils.boxes import read_label_file

    return eval_ap.det_frame_from_boxes(read_label_file(path, classes=None))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--predictions", required=True,
                    help="prediction label file or directory of them")
    ap.add_argument("--labels", required=True,
                    help="ground-truth label file or directory")
    ap.add_argument("--format", choices=("kitti", "dense"), default="kitti",
                    help="ground-truth layout (predictions are always the "
                         "infer.py KITTI-LiDAR layout)")
    ap.add_argument("--classes", default="Car,Pedestrian,Cyclist")
    ap.add_argument("--metrics", default="3d,bev")
    ap.add_argument("--recall", choices=("R40", "R11"), default="R40")
    ap.add_argument("--iou", default=None,
                    help="per-class IoU thresholds, e.g. Car=0.7,Cyclist=0.5")
    ap.add_argument("--dataset-root", default=None,
                    help="(dense) root containing the calib JSONs")
    ap.add_argument("--camera-calib", default="calib_cam_stereo_left.json")
    ap.add_argument("--tf-tree", default="calib_tf_tree_full.json")
    ap.add_argument("--out", default=None, help="write the JSON table here")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the IoU matrices (default cuda; "
                         "--device cpu for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    pred_path = Path(args.predictions)
    label_path = Path(args.labels)
    if pred_path.is_dir():
        pred_files = sorted(pred_path.glob("*.txt"))
        if not pred_files:
            raise SystemExit(f"no .txt prediction files in {pred_path}")
        gt_files = [label_path / f.name for f in pred_files]
        missing = [g.name for g in gt_files if not g.exists()]
        if missing:
            # scoring a prediction file against a silently-empty GT frame
            # would turn every detection in it into a false positive
            raise SystemExit(
                f"{len(missing)} prediction file(s) have no same-named "
                f"ground-truth label in {label_path} (first: {missing[0]}); "
                "check the file naming between --predictions and --labels"
            )
    else:
        pred_files = [pred_path]
        gt_files = [label_path]

    cam_to_velo = None
    if args.format == "dense":
        if not args.dataset_root:
            # without the calib JSONs every dense annotation's lidar pose
            # defaults to (0, 0, 0) and the whole table reads ~0 AP
            raise SystemExit(
                "--format dense requires --dataset-root (the directory "
                "holding the camera/tf-tree calib JSONs) to place GT boxes "
                "in the lidar frame"
            )
        from lidar_snow_sim_tpu_torch.utils.stf_labels import load_calib_data

        cam_to_velo = load_calib_data(
            args.dataset_root, args.camera_calib, args.tf_tree
        )[1]

    gts, dets = [], []
    for gt_f, pr_f in zip(gt_files, pred_files):
        dets.append(_det_from_file(pr_f))
        if args.format == "dense":
            gts.append(_gt_from_dense(gt_f, cam_to_velo))
        else:
            gts.append(_gt_from_kitti_lidar(gt_f))

    iou_thresholds = None
    if args.iou:
        iou_thresholds = {
            k: float(v)
            for k, v in (kv.split("=") for kv in args.iou.split(","))
        }

    table = eval_ap.evaluate(
        gts, dets,
        classes=tuple(args.classes.split(",")),
        metrics=tuple(args.metrics.split(",")),
        iou_thresholds=iou_thresholds,
        recall_mode=args.recall,
        device=device,
    )
    report = {
        "frames": len(pred_files),
        "recall_mode": args.recall,
        "gt_boxes": int(sum(len(g["names"]) for g in gts)),
        "det_boxes": int(sum(len(d["names"]) for d in dets)),
        "ap": table,
    }
    text = json.dumps(report, indent=2, allow_nan=True)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
