"""The comparison that decides a run's `correct`.

Each sampled frame's output rows, as the timed path handed them back, are
lined up with the frame's input rows and held row by row against the
plain reference (`port_bench/reference`), worked out here from the same
inputs:

- `row_mismatch_share`: the share of the sampled frames' input rows
  that both the program and the reference keep and on which they differ:
  the label, the intensity by more than 1, or a coordinate by more than
  0.05 m (the port's parity rule, `oracle/parity.classify_parity`); an
  output row that lines up with no input row counts as one more. The
  snowfall itself: occluders, pulse, decision tail, compaction.
- `keep_mismatch_share`: the share of the sampled frames' input rows that
  one side keeps and the other removes, where the program's decision is
  that of none of the reference's noise floors (the float64 floor and
  those of the histogram's decisions on a rounding's edge,
  `reference/fitting.noise_floors`). The plane and the noise floor.
- `stats_gap`: over the sampled frames, the largest relative gap of a
  stat the program reports (num_attenuated, num_removed,
  avg_intensity_diff) from the reference's, each against
  max(|reference|, 1), under the one of those noise floors that gives
  the frame the smallest gap.

Each number is held against the cell's limit (`port_bench/cells/`).
The reference's channels are spread over a pool of processes (numpy
only, no device).
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

from port_bench.reference import (
    bfloat16,
    frame_floor,
    frame_result,
)
from port_bench.reference.oracle import snow_channels

NUMBERS = ("row_mismatch_share", "keep_mismatch_share", "stats_gap")
XYZ_TOL = 0.05     # m
INT_TOL = 1.0      # intensity counts
_GROUP = 4         # channels a reference task
_ROUNDING = {None: None, "bfloat16": bfloat16}


LOOKAHEAD = 4096   # input rows an output row is looked for among


def align(inp, out):
    """Line up the output rows `out` (M, 5: x, y, z, intensity, label),
    an ordered subset of the input rows `inp` (N, >= 3) in the same order,
    with the rows they came from: (match (N,) the output row of each input
    row or -1, unmatched: output rows that line up with none). A row
    labelled 2 was moved along its line of sight (to the far side of the
    sensor where the pulse peaks before the origin, as the reference
    moves it): it lines up with the input row on its line; any other row
    keeps its input's coordinates bit for bit."""
    inp_xyz = np.asarray(inp[:, :3], np.float32).tolist()
    out_xyz = np.asarray(out[:, :3], np.float32).tolist()
    labels = np.asarray(out[:, 4]).tolist()
    match = np.full(len(inp_xyz), -1, np.int64)
    i, unmatched = 0, 0
    for j, (o, lab) in enumerate(zip(out_xyz, labels)):
        for k in range(i, min(i + LOOKAHEAD, len(inp_xyz))):
            p = inp_xyz[k]
            if lab != 2:
                hit = o == p
            else:
                cx = o[1] * p[2] - o[2] * p[1]
                cy = o[2] * p[0] - o[0] * p[2]
                cz = o[0] * p[1] - o[1] * p[0]
                nn = ((o[0] ** 2 + o[1] ** 2 + o[2] ** 2)
                      * (p[0] ** 2 + p[1] ** 2 + p[2] ** 2))
                hit = cx * cx + cy * cy + cz * cz <= 1e-10 * nn
            if hit:
                match[k] = j
                i = k + 1
                break
        else:
            unmatched += 1
    return match, unmatched


def frame_numbers(frame_scan, out_rows, out_stats, ref, row_order: str):
    """(rows compared, mismatched rows, keep mismatches, stats gap, {kind:
    rows}) of one
    frame: its output rows `out_rows` in the order `row_order` ("scan":
    the scan's own, "channel": stable-sorted by channel) and its stats
    against the reference result `ref` (`reference.frame_result`). The
    kinds: "keep" (kept by one side only), "label", "intensity", "xyz"
    (of rows both keep), "unmatched" (output rows of no input row), and
    the stats' own gaps."""
    perm = ref["perm"]
    idx = perm if row_order == "channel" else np.arange(len(frame_scan))
    match, unmatched = align(frame_scan[idx], out_rows)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    k = inv[idx]                      # reference row of each input row
    r_keep, r_rows = ref["keep"][k], ref["rows"][k]
    kept = match >= 0
    got = out_rows[np.where(kept, match, 0)]
    both = kept & r_keep
    kinds = {"keep": (ref["keeps"][:, k] != kept).all(axis=0),
             "label": both & (got[:, 4] != r_rows[:, 4]),
             "intensity": both & (np.abs(got[:, 3] - r_rows[:, 3]) > INT_TOL),
             "xyz": both & (np.abs(got[:, :3] - r_rows[:, :3]).max(axis=1)
                            > XYZ_TOL)}
    bad = kinds["label"] | kinds["intensity"] | kinds["xyz"]
    gap = min(stats_gap(out_stats, st) for st in ref["stats_all"])
    detail = {n: int(v.sum()) for n, v in kinds.items()}
    detail.update(unmatched=unmatched, stats=list(out_stats),
                  ref_stats=list(ref["stats"]))
    return (len(frame_scan), int(bad.sum()) + unmatched,
            int(kinds["keep"].sum()), gap, detail)


def stats_gap(got, want) -> float:
    """The largest relative gap of the stats `got` from `want`."""
    return max(abs(float(p) - float(r)) / max(abs(float(r)), 1.0)
               for p, r in zip(got, want))


def _snow_task(args):
    pc, sets, calib, order, beam_div, rounding, channels = args
    ds, rows = snow_channels(pc, sets, calib, order, beam_div,
                             _ROUNDING[rounding], channels)
    return channels, ds, rows


def reference_results(jobs, particle_sets, calib, *, beam_divergence_deg,
                      noise_floor, fit_on_sorted, rounding=None,
                      workers: int | None = None):
    """The reference result (`reference.frame_result`) of each job (scan,
    order, draws), its channels spread over `workers` processes (default:
    the usable cores but one). `rounding`: None, or "bfloat16" for the
    control."""
    rnd = _ROUNDING[rounding]
    floors, tasks = [], []
    for scan, order, draws in jobs:
        perm, pc, thr = frame_floor(scan, draws, noise_floor=noise_floor,
                                    fit_on_sorted=fit_on_sorted, rnd=rnd)
        floors.append((perm, pc, thr))
        for c0 in range(0, calib.num_lasers, _GROUP):
            channels = np.arange(c0, min(c0 + _GROUP, calib.num_lasers))
            m = np.isin(pc[:, 4], channels)
            sets = {int(order[c]): particle_sets[int(order[c])]
                    for c in channels}
            tasks.append((len(floors) - 1, (pc[m], sets, calib, order,
                                            beam_divergence_deg, rounding,
                                            channels)))
    workers = workers or max(len(os.sched_getaffinity(0)) - 1, 1)
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            parts = pool.map(_snow_task, [t for _, t in tasks], chunksize=1)
    else:
        parts = [_snow_task(t) for _, t in tasks]
    by_frame = [[] for _ in jobs]
    for (f, _), part in zip(tasks, parts):
        by_frame[f].append(part)
    return [frame_result(*floors[f], by_frame[f]) for f in range(len(jobs))]


def judge(samples, refs, limits: dict, row_order: str) -> dict:
    """The numbers of the sampled frames (each {"scan", "rows", "stats"})
    against their reference results, each beside its limit:
    {"numbers": {name: [value, limit]}, "correct": bool, "rows": ...}."""
    rows = bad = keep = 0
    gap = 0.0
    details = []
    for s, ref in zip(samples, refs):
        n, b, k, g, d = frame_numbers(s["scan"], s["rows"], s["stats"], ref,
                                      row_order)
        rows, bad, keep, gap = rows + n, bad + b, keep + k, max(gap, g)
        details.append(d)
    values = {"row_mismatch_share": bad / rows if rows else 1.0,
              "keep_mismatch_share": keep / rows if rows else 1.0,
              "stats_gap": gap}
    numbers = {k: [values[k], limits[k]] for k in NUMBERS}
    return {"numbers": numbers, "rows": rows, "mismatched_rows": bad + keep,
            "frames": len(samples), "details": details,
            "correct": bool(samples) and all(v <= lim for v, lim
                                             in numbers.values())}
