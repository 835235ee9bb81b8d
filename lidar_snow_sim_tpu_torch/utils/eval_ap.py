"""KITTI-protocol average precision for 3D detection results (counterpart
of `lidar_snow_sim_tpu/utils/eval_ap.py`: its numpy protocol, copied, with
the pairwise IoU matrices from the port's `ops/rotated_iou`).

The reference's experiments (CVPR'22 paper tables; `experiments.zip`
checkpoints) are scored with OpenPCDet's vendored KITTI evaluator
(`kitti_object_eval_python/eval.py` in `lib/OpenPCDet` — an empty
submodule dir in the snapshot). This module reproduces that protocol so
detectors run through `tools/infer.py` / `models/pointpillars.py` can be
scored on the snow splits without OpenPCDet:

- difficulty buckets (easy/moderate/hard) from 2D bbox height, occlusion
  and truncation with the official thresholds;
- the neighbour-class ignore rules (Van counts as ignored-Car,
  Person_sitting as ignored-Pedestrian) and DontCare handling;
- the two-pass greedy matcher of ``compute_statistics_jit`` (max-score
  assignment when collecting thresholds, max-overlap when counting fp);
- score thresholds at 41 recall sample points (``get_thresholds``) and
  the R40 / R11 interpolated AP readouts.

Deltas vs the official evaluator, each deliberate and documented:

- metrics are ``"3d"`` and ``"bev"`` (rotated IoU via `ops.rotated_iou`,
  the same code the NMS uses); the image-plane ``bbox`` metric and AOS
  need 2D detections, which this LiDAR-only pipeline never produces.
- detections carry no 2D bbox, so the det-side MIN_HEIGHT ignore and the
  DontCare-area fp subtraction (both defined on image-plane boxes) do
  not apply; GT-side difficulty uses the label's 2D bbox when present
  and treats the height test as passing when absent.

Everything here is host-side NumPy except the pairwise IoU matrices,
computed once per frame pair on `device` (default the card; raises where
there is none) at the frame's exact (n_gt, n_det) shape.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.ops import rotated_iou as riou

# Official KITTI difficulty thresholds (eval.py clean_data):
#   difficulty 0/1/2 = easy/moderate/hard
MIN_HEIGHT = (40.0, 25.0, 25.0)          # min 2D bbox height [px]
MAX_OCCLUSION = (0, 1, 2)                # max occlusion state
MAX_TRUNCATION = (0.15, 0.30, 0.50)      # max truncation fraction
DIFFICULTY_NAMES = ("easy", "moderate", "hard")

# eval.py: Van is "similar" to Car, Person_sitting to Pedestrian — they
# never count as fp and never as fn.
SIMILAR_CLASSES = {
    "Car": ("Van",),
    "Pedestrian": ("Person_sitting",),
}

# OpenPCDet KITTI defaults (eval.py overlap_0_7 row for 3d/bev)
DEFAULT_IOU_THRESH = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}

_N_SAMPLE_PTS = 41


def _np(x, dtype=np.float64):
    return np.asarray(x, dtype=dtype)


def gt_frame(boxes7, names, truncated=None, occluded=None, bbox_height=None):
    """Build one ground-truth frame record.

    boxes7: (N, 7) LiDAR-frame [x y z dx dy dz heading]; names: N class
    strings; truncated/occluded/bbox_height: optional per-box difficulty
    inputs (absent → the corresponding test passes, see module deltas).
    """
    boxes7 = _np(boxes7).reshape(-1, 7)
    n = len(boxes7)
    return {
        "boxes": boxes7,
        "names": list(names),
        "truncated": _np(truncated if truncated is not None else np.zeros(n)),
        "occluded": _np(occluded if occluded is not None else np.zeros(n)),
        "bbox_height": (
            _np(bbox_height) if bbox_height is not None else None
        ),
    }


def det_frame(boxes7, names, scores):
    """Build one detection frame record (same box layout as gt_frame)."""
    boxes7 = _np(boxes7).reshape(-1, 7)
    return {
        "boxes": boxes7,
        "names": list(names),
        "scores": _np(scores).reshape(-1),
    }


def gt_frame_from_annotations(anns: Iterable[Mapping]) -> dict:
    """GT frame from `utils.stf_labels.read_label` dicts (LiDAR frame,
    z recentred to the box middle like `dense_boxes`)."""
    anns = list(anns)
    boxes, names, trunc, occ, bh = [], [], [], [], []
    for a in anns:
        boxes.append([
            a["posx_lidar"], a["posy_lidar"],
            a["posz_lidar"] + a["height"] / 2,
            a["length"], a["width"], a["height"], a["rotz"],
        ])
        names.append(a["identity"])
        trunc.append(a.get("truncated", 0.0))
        occ.append(a.get("occlusion", 0))
        x1, y1, x2, y2 = a.get("bbox", (0.0, 0.0, 0.0, 1e6))
        bh.append(y2 - y1)
    return gt_frame(
        np.array(boxes, np.float64).reshape(-1, 7), names,
        truncated=trunc, occluded=occ, bbox_height=bh,
    )


def det_frame_from_predictions(pred_array, class_names: Sequence[str]):
    """Det frame from `models.pointpillars.predictions_array` output
    ((K, 9) [box7 | label | score]; labels are 1-based like pcdet)."""
    pred_array = _np(pred_array).reshape(-1, 9)
    labels = pred_array[:, 7].astype(int)
    names = [
        class_names[l - 1] if 1 <= l <= len(class_names) else "Unknown"
        for l in labels
    ]
    return det_frame(pred_array[:, :7], names, pred_array[:, 8])


def _boxes7_from_box3d(boxes) -> np.ndarray:
    return np.array(
        [[b.x, b.y, b.z, b.length, b.width, b.height, b.yaw] for b in boxes],
        np.float64,
    ).reshape(-1, 7)


def gt_frame_from_boxes(boxes) -> dict:
    """GT frame from `utils.boxes.Box3D` objects (no difficulty inputs —
    every box passes the height/occlusion/truncation tests)."""
    return gt_frame(_boxes7_from_box3d(boxes), [b.identity for b in boxes])


def det_frame_from_boxes(boxes) -> dict:
    """Det frame from `utils.boxes.Box3D` objects (e.g. a prediction file
    written by `tools/infer.py` read back via `utils.boxes.read_label_file`)."""
    return det_frame(
        _boxes7_from_box3d(boxes),
        [b.identity for b in boxes],
        [b.score for b in boxes],
    )


def _clean_frame(gt, dt, current_class: str, difficulty: int):
    """eval.py clean_data: per-box ignore states for one frame.

    Returns (ignored_gt, ignored_det, num_valid_gt). Codes: 0 = counted,
    1 = ignored (no fn / no fp on match), -1 = foreign class (invisible
    to matching entirely).
    """
    similar = SIMILAR_CLASSES.get(current_class, ())
    n_gt = len(gt["names"])
    ignored_gt = np.full(n_gt, -1, np.int64)
    num_valid = 0
    for i, name in enumerate(gt["names"]):
        if name == current_class:
            valid_class = 1
        elif name in similar:
            valid_class = 0
        else:
            continue  # stays -1 (DontCare included: no 2D dets → no dc fp)
        height_ok = (
            gt["bbox_height"] is None
            or gt["bbox_height"][i] >= MIN_HEIGHT[difficulty]
        )
        ignore = (
            not height_ok
            or gt["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt["truncated"][i] > MAX_TRUNCATION[difficulty]
        )
        if valid_class == 1 and not ignore:
            ignored_gt[i] = 0
            num_valid += 1
        else:
            ignored_gt[i] = 1
    ignored_det = np.array(
        [0 if n == current_class else -1 for n in dt["names"]], np.int64
    )
    return ignored_gt, ignored_det, num_valid


def _pair_overlaps(gt_boxes: np.ndarray, dt_boxes: np.ndarray,
                   metric: str, device="cuda") -> np.ndarray:
    """(n_gt, n_dt) rotated overlap matrix on the chosen metric, computed
    in float32 on `device`."""
    n, m = len(gt_boxes), len(dt_boxes)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float64)
    if metric not in ("3d", "bev"):
        raise ValueError(f"metric must be '3d' or 'bev', got {metric!r}")
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(gt_boxes)[:, :7], dtype=torch.float32,
                        device=dev)
    b = torch.as_tensor(np.asarray(dt_boxes)[:, :7], dtype=torch.float32,
                        device=dev)
    fn = riou.boxes_iou3d if metric == "3d" else riou.boxes_iou_bev
    return fn(a, b).cpu().numpy().astype(np.float64)


def _frame_statistics_ref(overlaps, dt_scores, ignored_gt, ignored_det,
                          min_overlap, thresh, compute_fp):
    """Literal transcription of eval.py compute_statistics_jit (the
    per-det inner loop written out) — kept as the oracle the vectorized
    `_frame_statistics` is property-tested against."""
    n_gt, n_dt = overlaps.shape
    assigned = np.zeros(n_dt, bool)
    ignored_threshold = (
        (dt_scores < thresh) if compute_fp else np.zeros(n_dt, bool)
    )
    tp = fp = fn = 0
    tp_scores = []
    for i in range(n_gt):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = -np.inf
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(n_dt):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[i, j]
            score = dt_scores[j]
            if not compute_fp:
                if overlap > min_overlap and score > valid_detection:
                    det_idx = j
                    valid_detection = score
            elif (
                overlap > min_overlap
                and (overlap > max_overlap or assigned_ignored_det)
                and ignored_det[j] == 0
            ):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1.0
                assigned_ignored_det = False
            elif (
                overlap > min_overlap
                and valid_detection == -np.inf
                and ignored_det[j] == 1
            ):
                det_idx = j
                valid_detection = 1.0
                assigned_ignored_det = True
        if valid_detection == -np.inf and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != -np.inf and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned[det_idx] = True
        elif valid_detection != -np.inf:
            tp += 1
            tp_scores.append(dt_scores[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(n_dt):
            if not (
                assigned[j]
                or ignored_det[j] == -1
                or ignored_det[j] == 1
                or ignored_threshold[j]
            ):
                fp += 1
    return tp, fp, fn, tp_scores


def _frame_statistics(overlaps, dt_scores, ignored_gt, ignored_det,
                      min_overlap, thresh, compute_fp):
    """eval.py compute_statistics_jit for one frame.

    overlaps: (n_gt, n_dt). Returns (tp, fp, fn, tp_scores).

    Two-pass greedy semantics: when collecting thresholds
    (compute_fp=False) each counted gt takes the HIGHEST-SCORING
    overlapping det; when counting errors (compute_fp=True) it takes the
    LARGEST-OVERLAP non-ignored det (preferring any non-ignored det over
    an ignored one), and unassigned non-ignored dets above the score
    threshold become fp.

    The gt loop is order-dependent (earlier gts claim dets), but the
    per-det inner loop of the official evaluator reduces to first-argmax
    selections over candidate masks — vectorized here so a full val-split
    eval (1.8k frames x 41 thresholds) is numpy row ops instead of
    O(n_gt x n_dt) Python iterations per frame per threshold. Equality
    with the literal loop (`_frame_statistics_ref`) is property-tested.
    """
    n_gt, n_dt = overlaps.shape
    assigned = np.zeros(n_dt, bool)
    ignored_threshold = (
        (dt_scores < thresh) if compute_fp else np.zeros(n_dt, bool)
    )
    base_cand = (ignored_det != -1) & ~ignored_threshold
    tp = fp = fn = 0
    tp_scores = []
    neg_inf = -np.inf
    for i in range(n_gt):
        if ignored_gt[i] == -1:
            continue
        cand = base_cand & ~assigned & (overlaps[i] > min_overlap)
        det_idx = -1
        if not compute_fp:
            # highest-scoring candidate; the loop's strict `>` keeps the
            # FIRST occurrence of the max, which argmax also returns
            if cand.any():
                masked = np.where(cand, dt_scores, neg_inf)
                det_idx = int(np.argmax(masked))
            matched = det_idx >= 0
        else:
            cand0 = cand & (ignored_det == 0)
            if cand0.any():
                det_idx = int(np.argmax(np.where(cand0, overlaps[i],
                                                 neg_inf)))
            else:
                cand1 = cand & (ignored_det == 1)
                if cand1.any():
                    det_idx = int(np.argmax(cand1))   # first ignored det
            matched = det_idx >= 0
        if not matched and ignored_gt[i] == 0:
            fn += 1
        elif matched and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif matched:
            tp += 1
            tp_scores.append(dt_scores[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        fp = int(np.sum(~assigned & (ignored_det == 0)
                        & ~ignored_threshold))
    return tp, fp, fn, tp_scores


def _get_thresholds(scores: np.ndarray, num_gt: int) -> np.ndarray:
    """eval.py get_thresholds: score thresholds at ~41 recall points."""
    scores = np.sort(scores)[::-1]
    out = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) and (
            i < len(scores) - 1
        ):
            continue
        out.append(score)
        current_recall += 1.0 / (_N_SAMPLE_PTS - 1.0)
    return np.array(out, np.float64)


def average_precision(
    gt_frames: Sequence[Mapping],
    det_frames: Sequence[Mapping],
    current_class: str,
    *,
    difficulty: int = 1,
    metric: str = "3d",
    min_overlap: float | None = None,
    recall_mode: str = "R40",
    device="cuda",
    _overlaps: Sequence[np.ndarray] | None = None,
) -> float:
    """Class AP over a frame set (official KITTI interpolation).

    recall_mode "R40" (OpenPCDet's reported metric: mean precision at 40
    equally-spaced recall positions, skipping recall 0) or "R11" (the
    legacy 11-point metric: every 4th of the 41 sample points). The IoU
    matrices run on `device` unless `_overlaps` gives them.
    """
    if len(gt_frames) != len(det_frames):
        raise ValueError("gt/det frame lists differ in length")
    if min_overlap is None:
        min_overlap = DEFAULT_IOU_THRESH.get(current_class, 0.5)

    cleaned = [
        _clean_frame(gt, dt, current_class, difficulty)
        for gt, dt in zip(gt_frames, det_frames)
    ]
    overlaps = (
        list(_overlaps)
        if _overlaps is not None
        else [
            _pair_overlaps(gt["boxes"], dt["boxes"], metric, device)
            for gt, dt in zip(gt_frames, det_frames)
        ]
    )
    total_valid_gt = sum(c[2] for c in cleaned)
    if total_valid_gt == 0:
        return float("nan")

    all_tp_scores = []
    for (ig, idet, _), ov, dt in zip(cleaned, overlaps, det_frames):
        _, _, _, s = _frame_statistics(
            ov, dt["scores"], ig, idet, min_overlap, 0.0, compute_fp=False
        )
        all_tp_scores.extend(s)
    thresholds = _get_thresholds(np.array(all_tp_scores), total_valid_gt)
    if len(thresholds) == 0:
        return 0.0
    # the official sampler never exceeds 41 thresholds; keep the invariant
    # explicit so the position-indexed precision array below cannot overflow
    thresholds = thresholds[:_N_SAMPLE_PTS]

    precision = np.zeros(_N_SAMPLE_PTS)
    for t, thresh in enumerate(thresholds):
        tp = fp = fn = 0
        for (ig, idet, _), ov, dt in zip(cleaned, overlaps, det_frames):
            tpi, fpi, fni, _ = _frame_statistics(
                ov, dt["scores"], ig, idet, min_overlap, thresh,
                compute_fp=True,
            )
            tp += tpi
            fp += fpi
            fn += fni
        precision[t] = tp / max(tp + fp, 1)
    # right-max interpolation (eval.py:~760)
    for t in range(_N_SAMPLE_PTS):
        precision[t] = precision[t:].max()

    if recall_mode == "R40":
        return float(precision[1:].sum() / 40.0)
    if recall_mode == "R11":
        return float(precision[::4].mean())
    raise ValueError(f"recall_mode must be 'R40' or 'R11', got {recall_mode!r}")


def evaluate(
    gt_frames: Sequence[Mapping],
    det_frames: Sequence[Mapping],
    classes: Sequence[str] = ("Car", "Pedestrian", "Cyclist"),
    *,
    metrics: Sequence[str] = ("3d", "bev"),
    difficulties: Sequence[int] = (0, 1, 2),
    iou_thresholds: Mapping[str, float] | None = None,
    recall_mode: str = "R40",
    device="cuda",
) -> dict:
    """Full eval table: {class: {metric: {difficulty_name: AP}}}.

    IoU matrices are computed once per (frame, metric) on `device` and
    shared across difficulties (difficulty only changes the ignore sets).
    """
    table: dict = {}
    for metric in metrics:
        overlaps = [
            _pair_overlaps(gt["boxes"], dt["boxes"], metric, device)
            for gt, dt in zip(gt_frames, det_frames)
        ]
        for cls in classes:
            thresh = (iou_thresholds or {}).get(
                cls, DEFAULT_IOU_THRESH.get(cls, 0.5)
            )
            for diff in difficulties:
                ap = average_precision(
                    gt_frames, det_frames, cls,
                    difficulty=diff, metric=metric, min_overlap=thresh,
                    recall_mode=recall_mode, _overlaps=overlaps,
                )
                table.setdefault(cls, {}).setdefault(metric, {})[
                    DIFFICULTY_NAMES[diff]
                ] = ap
    return table
