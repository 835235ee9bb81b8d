"""The control of the comparison: the plain reference put in the program's
place and computed a precision lower than the configuration states
(float32): in bfloat16, its geometry (points, particles, beam angles,
ranges, noise floor) rounded to 8 significant bits. The control's rows
are held against the float64 reference by the numbers the comparison
uses (`port_bench/compare.py`), row by row; a sound limit reads it as not
correct.

    python3 -m port_bench.control --workload NAME --seeds 1 2 3 [--frames 6]

prints one JSON line a seed with the control's numbers and the cell's
limits. It needs no card: the reference is NumPy.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from port_bench import compare, inputs, spec as specs


def control_numbers(refs, ctrls) -> dict:
    """The comparison's numbers of the control results `ctrls` against
    the reference results `refs`, rows by index (both channel-sorted)."""
    rows = bad = keep = 0
    gap = 0.0
    for r, c in zip(refs, ctrls):
        both = r["keep"] & c["keep"]
        bad += int((both & (
            (r["rows"][:, 4] != c["rows"][:, 4])
            | (np.abs(r["rows"][:, 3] - c["rows"][:, 3]) > compare.INT_TOL)
            | (np.abs(r["rows"][:, :3] - c["rows"][:, :3]).max(axis=1)
               > compare.XYZ_TOL))).sum())
        keep += int((r["keeps"] != c["keep"]).all(axis=0).sum())
        rows += len(both)
        gap = max(gap, min(compare.stats_gap(c["stats"], st)
                           for st in r["stats_all"]))
    return {"row_mismatch_share": bad / rows,
            "keep_mismatch_share": keep / rows, "stats_gap": gap}


def run_control(seed: int, config: dict, traffic: dict, frames: int,
                workers=None) -> dict:
    """The control's numbers on `frames` frames of the pool of `seed`."""
    calib = inputs.load_calib()
    sets = inputs.particle_sets(config["bank"])
    pool = inputs.frame_pool(seed, config["scan"], calib)
    snow = config["snowfall"]
    jobs = [(fr.scan, fr.order,
             inputs.ransac_draws(inputs.draws_seed(traffic, seed, fr),
                                 snow["ransac_trials"]))
            for fr in pool[:frames]]
    kw = dict(beam_divergence_deg=snow["beam_divergence_deg"],
              noise_floor=snow["noise_floor"],
              fit_on_sorted=snow["assembly"] == "window", workers=workers)
    refs = compare.reference_results(jobs, sets, calib, **kw)
    ctrls = compare.reference_results(jobs, sets, calib, rounding="bfloat16",
                                      **kw)
    return control_numbers(refs, ctrls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames a seed (default: the cell's sample)")
    args = ap.parse_args(argv)
    spec = specs.load_spec()
    wl = specs.workload(spec, args.workload)
    config = specs.config(spec, wl["config"])
    traffic = specs.traffic(wl["traffic"])
    cell = specs.cell(wl["name"])
    frames = args.frames or int(cell["sample_frames"])
    for seed in args.seeds:
        numbers = run_control(seed, config, traffic, frames)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "frames": frames, "control": numbers,
                          "limits": cell["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
