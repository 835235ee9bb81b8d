"""The paper's experiment loop in miniature, recorded as one JSON artifact,
on PyTorch (counterpart of `lidar_snow_sim_tpu/tools/experiment.py`).

The CVPR'22 reference work trains OpenPCDet detectors on snow-augmented
DENSE scans and evaluates KITTI-protocol AP on snow splits (README.md:3,
arXiv 2203.15118; data produced by `tools/snowfall/precompute.py:47-106`,
checkpoints consumed by `pointcloud_viewer.py:2478-2494`). This tool runs
that exact experiment shape end-to-end on synthetic labeled scenes with
every piece of this framework:

  1. build a labeled corpus (synthetic HDL-64 scenes + KITTI label files),
  2. snow-augment copies of it with the offline datagen driver
     (`parallel/datagen.py`, a real reference-grid (rate, velocity) combo),
  3. arm A — train from scratch on clear scans, evaluate R40 AP on the
     clear eval split: AP(init) vs AP(trained) must strictly improve,
  4. arm B — evaluate the clear-trained model on the SNOW eval split, then
     fine-tune on the snow-augmented train split (warm start) and
     re-evaluate: the paper's robustness experiment in miniature.

Writes one JSON artifact with every number, under the JAX tool's keys
("platform" is the torch device type). Every stage runs on --device
(default cuda; without a card it raises, and the CPU must be asked for
with --device cpu): the datagen's kernels W1 and W2 (the window assembly,
as the JAX tool's), training, detection and the AP's IoU matrices.
Example:

  python -m lidar_snow_sim_tpu_torch.tools.experiment --out EXPERIMENT.json \
      --work work_dir/ --steps 300 --finetune-steps 150
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lidar_snow_sim_tpu_torch._kernels import BUILD_DIR

TINY_YAML = """
CLASS_NAMES: [Car]
DATA_CONFIG:
    POINT_CLOUD_RANGE: [0.0, -8.0, -3.0, 16.0, 8.0, 1.0]
    DATA_PROCESSOR:
        - NAME: transform_points_to_voxels
          VOXEL_SIZE: [0.5, 0.5, 4.0]
          MAX_POINTS_PER_VOXEL: 16
          MAX_NUMBER_OF_VOXELS: {train: 1024, test: 1024}
MODEL:
    VFE:
        NUM_FILTERS: [32]
    BACKBONE_2D:
        LAYER_NUMS: [2, 2, 2]
        LAYER_STRIDES: [2, 2, 2]
        NUM_FILTERS: [32, 64, 128]
        UPSAMPLE_STRIDES: [1, 2, 4]
        NUM_UPSAMPLE_FILTERS: [32, 32, 32]
    DENSE_HEAD:
        ANCHOR_GENERATOR_CONFIG:
            - class_name: Car
              anchor_sizes: [[3.9, 1.6, 1.56]]
              anchor_rotations: [0, 1.57]
              anchor_bottom_heights: [-1.78]
              matched_threshold: 0.6
              unmatched_threshold: 0.45
POST_PROCESSING:
    SCORE_THRESH: 0.1
    NMS_CONFIG:
        NMS_THRESH: 0.1
        NMS_PRE_MAXSIZE: 512
        NMS_POST_MAXSIZE: 32
"""

SNOWFALL_RATE = 2.5        # mm/h — a reference datagen grid combo
TERMINAL_VELOCITY = 1.6    # m/s    (precompute.py:20-21)
DISTRIBUTION = "gunn"       # the particle sets of `get_bank`


def build_corpus(out_dir: Path, n_frames: int, seed: int, calib,
                 n_cars=3, n_azimuth=220):
    """Synthetic labeled scenes: an HDL-64 ray-cast base scan plus car-box
    point clusters, with KITTI-LiDAR label files (z at box bottom)."""
    from lidar_snow_sim_tpu_torch.utils.synthetic import synthetic_scan

    scans = out_dir / "scans"
    labels = out_dir / "labels"
    scans.mkdir(parents=True, exist_ok=True)
    labels.mkdir(parents=True, exist_ok=True)
    stems = []
    for f in range(n_frames):
        rng = np.random.default_rng([seed, f])
        pc = synthetic_scan(n_azimuth=n_azimuth, seed=seed * 1000 + f,
                            calib=calib, n_boxes=4)
        rows = []
        for _c in range(n_cars):
            cx = rng.uniform(4.0, 14.0)
            cy = rng.uniform(-5.0, 5.0)
            yaw = rng.uniform(-np.pi, np.pi)
            l, w, h = 3.9, 1.6, 1.56
            zc = -1.75 + h / 2
            k = rng.integers(50, 90)
            local = rng.uniform(-0.45, 0.45, (k, 3)) * [l, w, h]
            cth, sth = np.cos(yaw), np.sin(yaw)
            pts = np.column_stack([
                cx + local[:, 0] * cth - local[:, 1] * sth,
                cy + local[:, 0] * sth + local[:, 1] * cth,
                zc + local[:, 2],
                rng.uniform(40, 220, k),
                rng.integers(0, 64, k).astype(np.float64),
            ]).astype(np.float32)
            pc = np.concatenate([pc, pts])
            rows.append(
                f"Car 0 0 0 0 0 50 50 {h} {w} {l} "
                f"{cx:.4f} {cy:.4f} {zc - h / 2:.4f} {yaw:.4f}"
            )
        stem = f"{f:06d}"
        pc.astype(np.float32).tofile(scans / f"{stem}.bin")
        (labels / f"{stem}.txt").write_text("\n".join(rows) + "\n")
        stems.append(stem)
    return scans, labels, stems


def get_bank(cfg, cache_dir: Path):
    """Particle bank for the chosen grid combo: the bench's 64 gunn sets
    (`tools/kernel_times.bank_sets`, seed 42), cached in `cache_dir`."""
    from lidar_snow_sim_tpu_torch.sampling.banks import build_bank
    from lidar_snow_sim_tpu_torch.tools.kernel_times import bank_sets

    sets = bank_sets(cache_dir, SNOWFALL_RATE, TERMINAL_VELOCITY, seed=42)[0]
    return build_bank(
        sets, window_size=cfg.window_size, wide_threshold=cfg.wide_threshold,
        wide_capacity=cfg.wide_capacity,
    )


def snowify(scans: Path, stems, out_dir: Path, calib, batch=4,
            max_points=16384, device="cuda"):
    """Snow-augment every scan with the offline datagen driver on `device`
    (resume semantics, counted capacities; `parallel/datagen.py`)."""
    from lidar_snow_sim_tpu_torch.config import SnowfallConfig
    from lidar_snow_sim_tpu_torch.parallel.datagen import run_snowfall_datagen
    from lidar_snow_sim_tpu_torch.utils.pointcloud import load_velodyne_bin

    cfg = SnowfallConfig(
        max_points=max_points, window_size=128, wide_capacity=16,
        max_occluders=24, max_bumps=16, point_chunk=2048,
        channel_capacity=max(max_points // 32, 128),
    )
    bank = get_bank(cfg, BUILD_DIR / "banks")
    stats = run_snowfall_datagen(
        stems,
        lambda sid: load_velodyne_bin(scans / f"{sid}.bin", columns=5),
        out_dir, bank, calib, cfg,
        batch=batch, seed=0, shuffle_channels=False, device=device,
    )
    return {
        "frames": stats.frames_done + stats.frames_skipped,
        "attenuated": int(stats.attenuated),
        "removed": int(stats.removed),
        "points_in": int(stats.points_in),
        "points_out": int(stats.points_out),
    }


def train(scans: Path, labels: Path, out: Path, steps: int, yaml_path: Path,
          seed=0, init_params=None, batch=4, max_points=16384,
          augment=False, gt_sampling="", device="cuda"):
    """One tools/train.py invocation (the OpenPCDet train.py stand-in)."""
    from lidar_snow_sim_tpu_torch.tools import train as train_cli

    argv = [
        "--scans", str(scans), "--labels", str(labels),
        "--steps", str(steps), "--batch", str(batch),
        "--max-points", str(max_points), "--max-gt", "16",
        "--config", str(yaml_path), "--out", str(out),
        "--dtype", "float32", "--log-every", "50",
        "--save-every", "100000", "--seed", str(seed),
        "--device", str(device),
    ]
    if init_params:
        argv += ["--init-params", str(init_params)]
    if augment:
        argv += ["--augment"]
    if gt_sampling:
        argv += ["--gt-sampling", gt_sampling]
    if train_cli.main(argv) != 0:
        raise RuntimeError(f"training into {out} failed")
    return out / "params_tpu.npz"


def evaluate_params(params, scans: Path, labels: Path, stems, cfg,
                    max_points=16384, intensity_scale=1.0 / 255.0,
                    device="cuda"):
    """Detect on every eval scan, score with the KITTI-protocol R40 AP."""
    from lidar_snow_sim_tpu_torch.models import pointpillars as pp
    from lidar_snow_sim_tpu_torch.utils import eval_ap
    from lidar_snow_sim_tpu_torch.utils.boxes import read_label_file
    from lidar_snow_sim_tpu_torch.utils.pointcloud import load_velodyne_bin

    net = pp.PointPillars(cfg, params, device=device)
    gt_frames, det_frames = [], []
    for sid in stems:
        pc = load_velodyne_bin(scans / f"{sid}.bin", columns=5)[:, :4]
        pc = pc.astype(np.float32)
        pc[:, 3] *= intensity_scale
        n = len(pc)
        if n > max_points:
            sel = np.random.default_rng(0).choice(n, max_points, False)
            pc, n = pc[sel], max_points
        buf = np.zeros((max_points, 4), np.float32)
        buf[:n] = pc
        preds = pp.detect(buf, np.arange(max_points) < n, net, device=device)
        arr = pp.predictions_array(preds)
        det_frames.append(eval_ap.det_frame(
            arr[:, :7],
            [cfg.class_names[int(c) - 1] for c in arr[:, 7]],
            arr[:, 8],
        ))
        boxes = read_label_file(labels / f"{sid}.txt", classes=None)
        gt_frames.append(eval_ap.gt_frame(
            np.array([[b.x, b.y, b.z, b.length, b.width, b.height, b.yaw]
                      for b in boxes], float).reshape(-1, 7),
            [b.identity for b in boxes],
        ))
    table = eval_ap.evaluate(
        gt_frames, det_frames, classes=cfg.class_names,
        metrics=("bev", "3d"), difficulties=(1,), device=device,
    )
    return {
        cls: {m: float(v["moderate"]) for m, v in per_cls.items()}
        for cls, per_cls in table.items()
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="JSON artifact path")
    ap.add_argument("--work", required=True, help="working directory")
    ap.add_argument("--train-frames", type=int, default=16)
    ap.add_argument("--eval-frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--finetune-steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-azimuth", type=int, default=220,
                    help="scene azimuth resolution (scan size knob)")
    ap.add_argument("--max-points", type=int, default=16384)
    ap.add_argument("--augment", action="store_true",
                    help="world augmentations during both trainings")
    ap.add_argument("--gt-sampling", default="",
                    help="gt-sampling SAMPLE_GROUPS for both trainings, "
                         "e.g. 'Car:8'")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every stage (default cuda; "
                         "--device cpu for the CPU)")
    args = ap.parse_args(argv)

    from lidar_snow_sim_tpu_torch.calib import load_hdl64_calib
    from lidar_snow_sim_tpu_torch.models.pointpillars import (
        config_from_openpcdet_yaml,
        init_params,
    )

    from lidar_snow_sim_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    # training's deterministic mode needs it before the first cuBLAS call,
    # which the datagen may make (tools/train.deterministic)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.time()
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    yaml_path = work / "tiny_car.yaml"
    yaml_path.write_text(TINY_YAML)
    cfg = config_from_openpcdet_yaml(yaml_path)
    calib = load_hdl64_calib()

    print("== corpus ==", file=sys.stderr)
    tr_scans, tr_labels, tr_stems = build_corpus(
        work / "clear_train", args.train_frames, args.seed, calib,
        n_azimuth=args.n_azimuth,
    )
    ev_scans, ev_labels, ev_stems = build_corpus(
        work / "clear_eval", args.eval_frames, args.seed + 777, calib,
        n_azimuth=args.n_azimuth,
    )

    print("== snowify (datagen driver) ==", file=sys.stderr)
    snow_tr = work / "snow_train"
    snow_ev = work / "snow_eval"
    dg_train = snowify(tr_scans, tr_stems, snow_tr, calib, args.batch,
                       max_points=args.max_points, device=device)
    dg_eval = snowify(ev_scans, ev_stems, snow_ev, calib, args.batch,
                      max_points=args.max_points, device=device)

    print("== arm A: init vs trained (clear) ==", file=sys.stderr)
    ip = work / "init_params.npz"
    p0 = {k: v.numpy() for k, v in init_params(
        cfg, torch.Generator().manual_seed(args.seed)).items()}
    np.savez(ip, **p0)
    ap_init = evaluate_params(
        p0, ev_scans, ev_labels, ev_stems, cfg, max_points=args.max_points,
        device=device,
    )
    clear_params = train(
        tr_scans, tr_labels, work / "ckpt_clear", args.steps, yaml_path,
        seed=args.seed, batch=args.batch, augment=args.augment,
        gt_sampling=args.gt_sampling, max_points=args.max_points,
        device=device,
    )
    from lidar_snow_sim_tpu_torch.tools.convert_checkpoint import load_params

    pc_ = load_params(clear_params)
    ap_trained = evaluate_params(pc_, ev_scans, ev_labels, ev_stems, cfg,
                                 max_points=args.max_points, device=device)

    print("== arm B: clear-trained vs snow-finetuned (snow eval) ==",
          file=sys.stderr)
    ap_clear_on_snow = evaluate_params(
        pc_, snow_ev, ev_labels, ev_stems, cfg, max_points=args.max_points,
        device=device,
    )
    snow_ckpt = train(
        snow_tr, tr_labels, work / "ckpt_snow", args.finetune_steps,
        yaml_path, seed=args.seed + 1, init_params=clear_params,
        batch=args.batch, augment=args.augment,
        gt_sampling=args.gt_sampling, max_points=args.max_points,
        device=device,
    )
    ps_ = load_params(snow_ckpt)
    ap_snow_on_snow = evaluate_params(
        ps_, snow_ev, ev_labels, ev_stems, cfg, max_points=args.max_points,
        device=device,
    )
    ap_snow_on_clear = evaluate_params(
        ps_, ev_scans, ev_labels, ev_stems, cfg, max_points=args.max_points,
        device=device,
    )

    headline = lambda t: t["Car"]["3d"]  # noqa: E731
    artifact = {
        "what": "paper experiment shape in miniature: train -> infer -> "
                "KITTI R40 AP, clear and snow arms "
                "(arXiv 2203.15118 tables; reference precompute.py:47-106 "
                "feeding OpenPCDet training)",
        "config": {
            "detector_yaml": "tiny single-class PointPillars (see tool)",
            "train_frames": args.train_frames,
            "eval_frames": args.eval_frames,
            "steps": args.steps,
            "finetune_steps": args.finetune_steps,
            "batch": args.batch,
            "seed": args.seed,
            "world_augment": bool(args.augment),
            "gt_sampling": args.gt_sampling,
            "snow": {
                "snowfall_rate_mm_h": SNOWFALL_RATE,
                "terminal_velocity_m_s": TERMINAL_VELOCITY,
                "distribution": DISTRIBUTION,
            },
        },
        "datagen": {"train": dg_train, "eval": dg_eval},
        "ap_R40_moderate": {
            "init_on_clear": ap_init,
            "clear_trained_on_clear": ap_trained,
            "clear_trained_on_snow": ap_clear_on_snow,
            "snow_finetuned_on_snow": ap_snow_on_snow,
            "snow_finetuned_on_clear": ap_snow_on_clear,
        },
        "assertions": {
            "trained_strictly_beats_init":
                headline(ap_trained) > headline(ap_init),
            "snow_degrades_clear_model":
                headline(ap_clear_on_snow) < headline(ap_trained),
            "finetune_improves_on_snow":
                headline(ap_snow_on_snow) > headline(ap_clear_on_snow),
        },
        "wall_seconds": round(time.time() - t0, 1),
        "platform": device.type,
    }
    Path(args.out).write_text(json.dumps(artifact, indent=1))
    print(json.dumps(artifact["ap_R40_moderate"], indent=1))
    print(json.dumps(artifact["assertions"]))
    if not artifact["assertions"]["trained_strictly_beats_init"]:
        print("FAIL: training did not improve AP over init", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
