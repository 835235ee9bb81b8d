"""chip_smoke.py's card-against-CPU gate for detector predictions
(`_flips`), on crafted predictions on the CPU.

A prediction that one run kept and the other did not is a flip. The gate
excuses a flip only where a decision about that prediction lies within
1e-5 of its threshold, or where it follows from such a flip (suppression
passed on); a decision at a boundary elsewhere excuses nothing. The
predictions are compared as matched sets, so one flip does not shift the
later rows, and matched rows must keep their order.
"""

import runpy
from pathlib import Path

import pytest
import torch

from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
from lidar_snow_sim_tpu_torch.ops.rotated_iou import boxes_iou_bev

torch.set_num_threads(1)

SMOKE = runpy.run_path(str(Path(__file__).parents[1] / "chip_smoke.py"),
                       run_name="chip_smoke_gate")
CFG = tpp.PointPillarsConfig()
T = CFG.score_thresh

# (x, y, z, dx, dy, dz, heading): A and C overlap a little, B overlaps A
# a lot, D and E stand apart
BOX = {
    "A": (10.0, 0.0, -1.0, 3.9, 1.6, 1.5, 0.0),
    "B": (10.4, 0.1, -1.0, 3.9, 1.6, 1.5, 0.1),
    "C": (13.2, 1.0, -1.0, 3.9, 1.6, 1.5, 0.3),
    "D": (30.0, 10.0, -1.0, 3.9, 1.6, 1.5, 0.0),
    "E": (50.0, -10.0, -1.0, 0.8, 0.6, 1.7, 0.0),
}


def _preds(names, scores):
    return tpp.Predictions(
        boxes=torch.tensor([BOX[n] for n in names], dtype=torch.float32),
        scores=torch.tensor(scores, dtype=torch.float32),
        labels=torch.ones(len(names), dtype=torch.int32),
        count=torch.tensor(len(names), dtype=torch.int32))


def _iou(a, b):
    bev = torch.tensor([BOX[a], BOX[b]])[:, [0, 1, 3, 4, 6]]
    return float(boxes_iou_bev(bev, bev)[0, 1])


@pytest.mark.parametrize("case,want", [
    # the same predictions: nothing to excuse
    ("equal", (0, 0, 0)),
    # the card loses D (score 0.5, far from every threshold) while another
    # anchor's score sits 1e-6 above score_thresh: that decision is not
    # D's, so the flip stands
    ("unrelated_boundary", (1, 0, 1)),
    # the card loses E, whose own score is 5e-6 above score_thresh
    ("own_score", (1, 1, 0)),
    # the card keeps A, which the CPU suppressed by C at an IoU exactly at
    # nms_thresh; the card then suppresses B, which the CPU kept
    ("iou_and_cascade", (2, 1, 0)),
    # both runs keep the same boxes in a different order
    ("out_of_order", (0, 0, 1)),
])
def test_flip_gate(case, want):
    cfg, scores = CFG, torch.full((100,), 0.01)
    cpu = _preds("CD", [0.9, 0.5])
    card = cpu
    if case == "unrelated_boundary":
        scores[7] = T + 1e-6
        card = _preds("C", [0.9])
    elif case == "own_score":
        cpu = _preds("CDE", [0.9, 0.5, T + 5e-6])
        card = _preds("CD", [0.9, 0.5])
    elif case == "iou_and_cascade":
        cfg = tpp.PointPillarsConfig(nms_thresh=_iou("A", "C"))
        assert 0.01 < cfg.nms_thresh < _iou("B", "C") - 0.01
        assert _iou("A", "B") > 0.5
        cpu = _preds("CBD", [0.9, 0.7, 0.5])
        card = _preds("CAD", [0.9, 0.8, 0.5])
    elif case == "out_of_order":
        card = _preds("DC", [0.5, 0.9])
    assert SMOKE["_flips"](card, cpu, scores, cfg) == want
