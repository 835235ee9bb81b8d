"""Particle-bank generation CLI (counterpart of
`lidar_snow_sim_tpu/tools/gen_banks.py`).

Mirrors the reference's sampling batch script
(`tools/snowfall/sampling.py:338-413`): the grid of
{snowfall rates} x {terminal velocities} x {gunn, sekhon} x 64 channel lines,
sorted by descending occupancy, with skip-if-exists resume and the reference's
file naming `{dist}_{rate}_{ratio}_{line}.npy`, line i seeded `seed + i`.

The sampler is the port's build of the native C++ spatial-hash dart thrower
(`native.py`, native/snow_sampler.cpp); for the same arguments its files
equal the JAX tool's byte for byte. Where the native library cannot be
built, a file is sampled by the NumPy `dart_throwing_fast` instead, as the
JAX tool does; those files differ from native ones of the same seed, so the
tool says so at the first one, and its summary line names the sampler that
wrote the files and counts the fallback files. Work is fanned out over host
processes (spawn context). Run:
python -m lidar_snow_sim_tpu_torch.tools.gen_banks --out-dir banks
"""

from __future__ import annotations

import argparse
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from lidar_snow_sim_tpu_torch.sampling.distributions import (
    compute_occupancy,
    diameter_rate_parameter,
    snowfall_rate_to_rainfall_rate,
)

# the reference grid (sampling.py:392-398): 5 rates x 10 velocities
SNOWFALL_RATES = (0.5, 1.0, 1.5, 2.0, 2.5)
TERMINAL_VELOCITIES = (0.2, 0.4, 0.6, 0.8, 1.0, 1.2, 1.4, 1.6, 1.8, 2.0)


def _sample_one(task):
    """(status, path, particles, seconds, sampler) of one bank file;
    sampler is "native", "numpy" (the fallback) or None for a skip."""
    (out_dir, dist, rate, occupancy, line, r0, seed, plot) = task
    out = Path(out_dir) / f"{dist}_{rate}_{occupancy}_{line}.npy"
    if out.exists():
        return ("skip", str(out), 0, 0.0, None)
    t0 = time.time()
    lam = diameter_rate_parameter(dist, float(rate))
    try:
        from lidar_snow_sim_tpu_torch.native import native_dart_throw

        samples = native_dart_throw(float(occupancy), lam, r0, seed=seed)
        sampler = "native"
    except Exception:   # noqa: BLE001 - the JAX tool's fallback, reported
        from lidar_snow_sim_tpu_torch.sampling import dart_throwing_fast

        rng = np.random.default_rng(seed)
        samples = dart_throwing_fast(
            float(occupancy), float(rate), r0, rng, dist
        )
        sampler = "numpy"
    np.save(out, samples)
    if plot and line < 3:  # reference plots low lines only (sampling.py:356)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from lidar_snow_sim_tpu_torch.utils.render import particle_field_image

        plt.imsave(out.with_suffix(".png"), particle_field_image(samples, r0))
    return ("done", str(out), len(samples), time.time() - t0, sampler)


def build_tasks(out_dir, rates, velocities, modes, lines, r0, seed,
                plot=False):
    combos = []
    for s in rates:
        for v in velocities:
            rr = snowfall_rate_to_rainfall_rate(s, v)
            occ = compute_occupancy(s, v)
            combos.append((rr, occ))
    # descending occupancy, the reference's scheduling order (sampling.py:400)
    combos.sort(key=lambda c: -c[1])
    tasks = []
    for dist in modes:
        for rr, occ in combos:
            for line in lines:
                tasks.append(
                    (out_dir, dist, rr, occ, line, r0, seed + line, plot)
                )
    return tasks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--rates", type=float, nargs="+", default=SNOWFALL_RATES)
    ap.add_argument(
        "--velocities", type=float, nargs="+", default=TERMINAL_VELOCITIES
    )
    ap.add_argument(
        "--modes", nargs="+", default=("gunn", "sekhon"),
        choices=("gunn", "sekhon"),
    )
    ap.add_argument("--lines", type=int, default=64, help="channel lines 1..N")
    ap.add_argument("--r0", type=float, default=80.0, help="domain radius [m]")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument(
        "--plot", action="store_true",
        help="also write a {name}.png raster of each sampled field "
             "(reference sampling.py saves debug SVGs for low lines)",
    )
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tasks = build_tasks(
        str(out_dir), args.rates, args.velocities, args.modes,
        range(1, args.lines + 1), args.r0, args.seed, plot=args.plot,
    )
    print(f"{len(tasks)} bank files over {args.workers} workers")
    t0 = time.time()
    done = skipped = particles = fallback = 0
    # spawn, not fork: the caller may already hold torch's threads (the
    # reference viewer forces spawn for the same reason, viewer:9-11)
    with ProcessPoolExecutor(
        max_workers=args.workers,
        mp_context=multiprocessing.get_context("spawn"),
    ) as ex:
        for status, path, n, dt, sampler in ex.map(_sample_one, tasks,
                                                    chunksize=4):
            if status == "skip":
                skipped += 1
                continue
            done += 1
            particles += n
            if sampler != "native":
                fallback += 1
                if fallback == 1:
                    print(f"  the native sampler failed on {path}: such "
                          "files are sampled by numpy's dart_throwing_fast "
                          "and differ from native ones of the same seed",
                          flush=True)
            if done % 64 == 0:
                print(
                    f"  {done} done / {skipped} skipped "
                    f"({time.time() - t0:.0f}s)", flush=True
                )
    sampler = ("native" if not fallback else
               "numpy" if fallback == done else "native and numpy")
    print(
        f"finished: {done} sampled ({particles:,} particles) by the "
        f"{sampler} sampler, {fallback} numpy-fallback files, "
        f"{skipped} skipped, {time.time() - t0:.1f}s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
