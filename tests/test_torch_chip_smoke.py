"""chip_smoke.py's card-against-CPU gates, on crafted inputs on the CPU:
phase 9's for detector predictions (`_flips`), phase 10's for assigned
labels (`_near_assignment`, `_label_flips`) and gradients (`_rel_err`);
phase 8's rule for truncated CUPTI records (tools/kernel_times.settle,
merge_times) on made-up records; phase 13's gates on made-up parity reports
(`_parity_gate`), phase 14's combos (`_grid_combos`) and its card-against-
CPU rule for one frame (`_card_cpu_parity`) on made-up results; phase 15's
launch-per-shard and stats gates (`_shard_launch_gate`, `_stats_gate`) and
phase 16's gates on made-up tool reports (`_ab_gate`, `_profile_gate`,
`_datagen_bench_gate`).

A prediction that one run kept and the other did not is a flip. The gate
excuses a flip only where a decision about that prediction lies within
1e-5 of its threshold, or where it follows from such a flip (suppression
passed on); a decision at a boundary elsewhere excuses nothing. The
predictions are compared as matched sets, so one flip does not shift the
later rows, and matched rows must keep their order.
"""

import dataclasses
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


# ---------------------------------------------------------------------------
# phase 10's gates: label flips at an assignment boundary, the gradient
# tolerance

SMALL = tpp.PointPillarsConfig(
    class_names=("Car", "Pedestrian"),
    point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
    voxel_size=(0.5, 0.5, 4.0),
    anchor_sizes=((3.9, 1.6, 1.56), (0.8, 0.6, 1.73)),
    anchor_bottom_heights=(-1.78, -0.6),
    anchor_match_thresholds=(0.6, 0.5),
    anchor_unmatch_thresholds=(0.45, 0.35))
ANCH = torch.as_tensor(tpp.generate_anchors(SMALL)).reshape(-1, 7)


def _gt(*rows):
    gt = torch.zeros(8, 8)
    for i, r in enumerate(rows):
        gt[i] = torch.tensor(r)
    return gt


# a car gt shifted off car anchor 400 by 0.28 of its length: anchor 400
# lies in the ignore band, the gt's best anchor stands alone
SHIFTED = (float(ANCH[400, 0]) + 0.28 * 3.9, *ANCH[400, 1:].tolist(), 1.0)


@pytest.mark.parametrize("case,want", [
    # the same labels: nothing to excuse
    ("equal", (0, 0)),
    # anchor 400 flips where no threshold is near its IoU
    ("far", (1, 1)),
    # ... and where the matched threshold sits 5e-6 above its IoU
    ("match", (1, 0)),
    # ... the unmatched threshold 5e-6 below it
    ("unmatch", (1, 0)),
    # the gt's best anchor flips: it stands alone (no tie), so it stands
    ("lone_best", (1, 1)),
    # a gt whose best IoU two anchors share: both flip, both are excused
    ("tie", (2, 0)),
    # a gt whose best is 0 (outside every same-class anchor): whether it
    # force-matches at all is a boundary, so its anchors' flips are excused
    ("best_zero", (1, 0)),
])
def test_label_flip_gate(case, want):
    from lidar_snow_sim_tpu_torch.models.detector_train import assign_targets

    cfg, gt = SMALL, _gt(SHIFTED)
    iou = boxes_iou_bev(ANCH, gt[:1, :7])[:, 0]
    a = 400
    if case == "match":
        cfg = dataclasses.replace(cfg, anchor_match_thresholds=(
            float(iou[a]) + 5e-6, 0.5))
    elif case == "unmatch":
        cfg = dataclasses.replace(cfg, anchor_unmatch_thresholds=(
            float(iou[a]) - 5e-6, 0.35))
    elif case == "lone_best":
        a = int(torch.argmax(iou))
    elif case == "tie":
        # a car box centred between two anchors of one row, at rotation 0:
        # equal IoU with both by symmetry
        x0, x1 = float(ANCH[400, 0]), float(ANCH[404, 0])
        gt = _gt(((x0 + x1) / 2, *ANCH[400, 1:].tolist(), 1.0))
        iou = boxes_iou_bev(ANCH, gt[:1, :7])[:, 0]
        top = torch.nonzero(iou == iou.max()).flatten()
        assert len(top) == 2
    elif case == "best_zero":
        gt = _gt((60.0, 40.0, -1.0, 3.9, 1.6, 1.56, 0.0, 1.0))
        a = 0
    want_labels = assign_targets(ANCH, gt, cfg)[0]
    got = want_labels.clone()
    if case == "tie":
        got[top] = 1 - got[top]
    elif case != "equal":
        got[a] = 1 - got[a]
    near = SMOKE["_near_assignment"](ANCH, gt, cfg, tol=1e-5)
    assert SMOKE["_label_flips"](got, want_labels, near) == want


def test_gradient_tolerance():
    rel = SMOKE["_rel_err"]
    g = torch.tensor([[0.5, -2.0], [1e-3, 0.0]], dtype=torch.float64)
    assert rel(g, g) == 0.0
    # relative to the largest |value| (2.0), not elementwise
    assert rel(g + 0.5e-3 * 2.0, g) == pytest.approx(0.5e-3)
    assert rel(g * (1 + 2e-3), g) == pytest.approx(2e-3)
    assert rel(g.float(), g) < 1e-7
    assert rel(torch.zeros(3), torch.zeros(3)) == 0.0
    assert rel(torch.full((3,), 1e-4), torch.zeros(3)) == pytest.approx(1e-4)


def test_gradient_gate():
    """A gradient passes within 1e-3 of its largest value, or within twice
    the CPU's own change under tiny weight perturbations where that change
    is larger; anything else fails."""
    gate = SMOKE["_grad_gate"]
    err = {"head": 5e-4, "bn_bias": 0.04, "conv": 0.04, "wrong": 0.5}
    noise = {"head": 1e-6, "bn_bias": 0.03, "conv": 0.01, "wrong": 0.02}
    assert gate(err, noise) == ["conv", "wrong"]
    assert gate({"a": 1e-3}, {"a": 0.0}) == []
    assert gate({"a": 2e-3}, {"a": 1e-3}) == []
    assert gate({"a": 2.1e-3}, {"a": 1e-3}) == ["a"]


def _takes(*pairs):
    """A take() that returns the records (device_ms, covered_ms) in turn,
    and the list of calls made."""
    made = []

    def take():
        dev, cov = pairs[len(made)]
        made.append(1)
        return {"device_ms": dev, "covered_ms": cov,
                "profiler_records": [10, 10]}
    return take, made


@pytest.mark.parametrize("pairs,want", [
    # the table's ratios (1.03-1.28): taken once, kept
    (((0.0141, 0.0145),), dict(device_ms=0.0141)),
    (((0.0200, 0.0400),), dict(device_ms=0.0200)),        # exactly 2: kept
    # a short record, then a fair one: retaken, the second kept
    (((0.0268, 0.0583), (0.0560, 0.0590)),
     dict(device_ms=0.0560, covered_ms=0.0590, retaken=True)),
    # short twice: truncated, no device_ms
    (((0.0268, 0.0583), (0.0250, 0.0580)),
     dict(device_ms=None, device_ms_short=0.0250, covered_ms=0.0580,
          retaken=True, device_ms_truncated=True)),
])
def test_truncated_records_are_retaken_then_marked(pairs, want):
    from lidar_snow_sim_tpu_torch.tools.kernel_times import settle

    take, made = _takes(*pairs)
    got = settle(take)
    assert len(made) == len(pairs)
    assert {k: got[k] for k in want} == want
    assert ("device_ms_truncated" in got) == ("device_ms_truncated" in want)


def test_merge_times_holds_a_truncated_record_to_covered_ms():
    """A truncated record merges with device_ms None, and its covered_ms
    (not the short reading) is held to the bound."""
    merge = SMOKE["merge_times"]
    times = {"device_ms": None, "device_ms_short": 0.001, "covered_ms": 0.05,
             "device_ms_truncated": True, "retaken": True}
    entry = {"name": "A3", "bound_ms": 0.03, "_times": dict(times)}
    merge([entry])
    assert entry["device_ms"] is None and entry["device_ms_truncated"]
    with pytest.raises(SystemExit):
        merge([{"name": "A3", "bound_ms": 0.06, "_times": dict(times)}])
    with pytest.raises(SystemExit):   # a plain record below its bound
        merge([{"name": "L1", "bound_ms": 0.02, "_times": {
            "device_ms": 0.01, "covered_ms": 0.03}}])


def _report(**change):
    """A made-up tools/parity_gpu report that passes every gate, with the
    variants' fields in `change` replaced (variant -> {field: value})."""
    zero = dict(window=0, occluder=0, bump=0, channel=0, compact=0)
    variants = {name: dict(overflows=dict(zero), num_mismatches=1,
                           num_unexplained=0, mismatch_rate=0.000175)
                for name in SMOKE["PARITY_VARIANTS"]}
    for name, fields in change.items():
        variants[name].update(fields)
    return dict(ok=True, oracle_stats=dict(SMOKE["PARITY_STATS"]),
                assemblies=variants)


LAUNCHED = dict(A1=1, A2=1, C1=2, W1=1, W2=1)


@pytest.mark.parametrize("report,launches,want", [
    (_report(), LAUNCHED, []),
    (dict(_report(), ok=False), LAUNCHED, ["not ok"]),
    (dict(_report(), oracle_stats=dict(num_attenuated=29, num_removed=846,
                                       avg_intensity_diff=194)),
     LAUNCHED, ["oracle_stats"]),
    (_report(window=dict(overflows=dict(window=1, occluder=0, bump=0,
                                        channel=0, compact=0))),
     LAUNCHED, ["window: overflows"]),
    (_report(dense_pallas=dict(num_unexplained=1)), LAUNCHED,
     ["dense_pallas: 1 unexplained"]),
    (_report(dense_pallas_routed=dict(mismatch_rate=0.002)), LAUNCHED,
     ["dense_pallas_routed: 0 unexplained, mismatch rate 0.002"]),
    (_report(), dict(LAUNCHED, A2=0), ["A2 never launched"]),
    (_report(), dict(LAUNCHED, W2=0), ["W2 never launched"]),
    (_report(), dict(A1=1), ["A2 never launched", "C1 never launched",
                             "W1 never launched", "W2 never launched"]),
    ({k: v for k, v in _report().items() if k != "assemblies"}, LAUNCHED,
     ["variants []"]),
])
def test_parity_gate(report, launches, want):
    bad = SMOKE["_parity_gate"](report, launches)
    assert len(bad) == len(want)
    for got, w in zip(bad, want):
        assert w in got


def test_grid_combos_are_the_reference_grids_choice():
    """gunn's five precompute pairs and sekhon's lightest rainfall rate
    (tests/test_reference_grid.py:54-59): 6 combos, 384 bank files."""
    from lidar_snow_sim_tpu_torch.parallel.datagen import iter_reference_grid
    from lidar_snow_sim_tpu_torch.sampling.distributions import (
        snowfall_rate_to_rainfall_rate as rainfall,
    )

    combos = SMOKE["_grid_combos"]()
    assert combos == [("gunn", 0.5, 2.0), ("gunn", 1.0, 1.6),
                      ("gunn", 2.0, 2.0), ("gunn", 2.5, 1.6),
                      ("gunn", 1.5, 0.6), ("sekhon", 0.5, 2.0)]
    grid = list(iter_reference_grid())
    lightest = min(rr for _, rr, _ in grid)
    assert [(m, rainfall(s, v)) for m, s, v in combos] == \
        [(m, rr) for m, rr, _ in grid
         if m == "gunn" or rr == lightest]


def _result(labels, keep, xyz=None, **counters):
    from lidar_snow_sim_tpu_torch.models.snowfall import (
        OVERFLOW_COUNTERS,
        SnowfallResult,
    )

    n = len(labels)
    planes = torch.zeros(5, n)
    if xyz is not None:
        planes[:3] = torch.as_tensor(xyz, dtype=torch.float32)
    planes[3] = 10.0
    planes[4] = torch.as_tensor(labels, dtype=torch.float32)
    vals = {c: torch.tensor(counters.get(c, 0)) for c in OVERFLOW_COUNTERS}
    z = torch.tensor(0)
    return SnowfallResult(planes=planes, keep=torch.as_tensor(keep),
                          num_attenuated=z, num_removed=z,
                          avg_intensity_diff=z, **vals)


def test_card_cpu_parity_rule():
    """Equal results pass; one flip in 1,000 points passes (the parity
    contract's 0.2%), counted; two in 1,000 fail, as do unequal counters
    and an xyz error over 1e-4 off the flipped points."""
    n = 1000
    labels = [0] * n
    keep = [True] * n
    ok = _result(labels, keep)
    assert SMOKE["_card_cpu_parity"]("t", ok, ok, n) == (0, 0.0)
    one = _result([1] + labels[1:], keep)
    assert SMOKE["_card_cpu_parity"]("t", one, ok, n) == (1, 0.0)
    with pytest.raises(SystemExit):
        SMOKE["_card_cpu_parity"]("t", _result([1, 2] + labels[2:], keep),
                                  ok, n)
    with pytest.raises(SystemExit):
        SMOKE["_card_cpu_parity"](
            "t", _result(labels, keep, compact_overflow=1), ok, n)
    xyz = torch.zeros(3, n)
    xyz[0, 5] = 2e-4
    with pytest.raises(SystemExit):
        SMOKE["_card_cpu_parity"]("t", _result(labels, keep, xyz), ok, n)
    xyz[0, 5] = 5e-5
    assert SMOKE["_card_cpu_parity"]("t", _result(labels, keep, xyz), ok,
                                     n)[1] == pytest.approx(5e-5)


@pytest.mark.parametrize("calls,want", [
    # two shards of 2 frames each, A1 and C1 once a frame on each
    ({"A1": {1: 2, 2: 2}, "C1": {1: 2, 2: 2}}, 0),
    # one shard launched everything: the frames were not sharded
    ({"A1": {1: 4}, "C1": {1: 4}}, 2),
    # a shard launched no C1 (a fallback ran its phase C)
    ({"A1": {1: 2, 2: 2}, "C1": {1: 2}}, 1),
    # a frame launched twice (a rerun)
    ({"A1": {1: 3, 2: 2}, "C1": {1: 2, 2: 2}}, 1),
])
def test_shard_launch_gate(calls, want):
    assert len(SMOKE["_shard_launch_gate"](calls, 2, 4)) == want


FIELDS = ("frames_done", "points_in")


@pytest.mark.parametrize("merged,want", [
    ([{"frames_done": 3, "points_in": 3 * 2**24 + 3, "wall_s": 0.0},
      {"frames_done": 3, "points_in": 3 * 2**24 + 3, "wall_s": 1.0}], 0),
    # a float32 sum: the count rounded
    ([{"frames_done": 3, "points_in": 3 * 2**24 + 4, "wall_s": 0.0},
      {"frames_done": 3, "points_in": 3 * 2**24 + 4, "wall_s": 1.0}], 2),
    # the wall time summed or maxed, not kept
    ([{"frames_done": 3, "points_in": 3 * 2**24 + 3, "wall_s": 1.0},
      {"frames_done": 3, "points_in": 3 * 2**24 + 3, "wall_s": 1.0}], 1),
])
def test_stats_gate(merged, want):
    local = {"frames_done": 1, "points_in": 2**24 + 1, "wall_s": 0.0}
    locals_ = [SMOKE["_stats_local"](local, r) for r in range(2)]
    assert locals_[1] == {"frames_done": 2, "points_in": 2 * (2**24 + 1),
                          "wall_s": 1.0}
    assert len(SMOKE["_stats_gate"](merged, locals_, FIELDS)) == want


ARM = {"step_ms": 12.5, "scans_per_sec": 80.0, "spread_ms": 1.0,
       "overflow": 0}


@pytest.mark.parametrize("report,want", [
    ({"base": ARM, "route256": ARM}, 0),
    ({"base": ARM}, 1),                                  # an arm missing
    ({"base": ARM, "route256": dict(ARM, step_ms=-0.1)}, 1),
    ({"base": dict(ARM, overflow=3), "route256": ARM}, 1),
    ({"base": {"step_ms": 1.0}, "route256": ARM}, 1),    # keys missing
])
def test_ab_gate(report, want):
    assert len(SMOKE["_ab_gate"](report, ("base", "route256"))) == want


def test_profile_gate():
    text = ("port kernels:\n   0.1345 ms x1.0    void a1_kernel<32>(...)\n"
            "   0.0280 ms x1.0    c1_kernel(...)\n")
    assert SMOKE["_profile_gate"](text) == []
    assert SMOKE["_profile_gate"](text.replace("c1_kernel", "x")) == [
        "c1_kernel"]


def test_datagen_bench_gate():
    report = dict.fromkeys(SMOKE["DATAGEN_BENCH_KEYS"], 1.0)
    report.update(frames=8)
    assert SMOKE["_datagen_bench_gate"](report, 8) == []
    assert len(SMOKE["_datagen_bench_gate"](dict(report, frames=6), 8)) == 1
    del report["tunnel"]
    assert SMOKE["_datagen_bench_gate"](report, 8) == ["missing tunnel"]
    report.update(tunnel={}, device_resident_scans_per_sec=None)
    assert len(SMOKE["_datagen_bench_gate"](report, 8)) == 1
