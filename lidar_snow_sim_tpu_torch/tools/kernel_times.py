"""Kernels' own device time on the card, and the bench scene they are
timed on.

`kernel_times(fn, kernel)` times the device kernels whose name holds
`kernel`, one launched by each call of fn, two independent ways, each
call behind a write that empties the L2 cache:

- `device_ms`: the kernel's own duration as torch.profiler (CUPTI)
  records it, the median over `reps` calls after warm-up. Unlike a
  CUDA-event pair around one call, it leaves out the host's enqueue (the
  wrapper's checks, allocations and the ctypes call). CUPTI now and then
  keeps no record of some launches of a session, so sessions run until
  `reps` records are in; the records kept and the calls made are
  reported beside the time.
- `covered_ms`: CUDA events around one call, enqueued while the device
  still runs a sleep kernel, so they time the call's device work back to
  back (a wrapper's other kernels included) and not the host's enqueue.
  It reads at least `device_ms`; for a wrapper that launches its kernel
  alone the two differ by the events' own few microseconds, unless the
  profiler's dropped records were not a fair sample.

chip_smoke.py reads every kernel's times through it, on its bench scene:
`bench_config`, `bank_sets` and `bench_batch`.
"""

from __future__ import annotations

import subprocess
import zlib
from pathlib import Path

import numpy as np

FLUSH_BYTES = 128 * 2**20    # over the H100's 50 MB of L2
SLEEP_CYCLES = 4_000_000     # ~2 ms at the H100's clock, longer than an
                             # enqueue; doubled for a call that outlasts it


def _flush():
    import torch

    return torch.empty(FLUSH_BYTES // 4, device="cuda")


def device_ms(fn, kernel: str, reps: int = 10, warmup: int = 2,
              sessions: int = 10):
    """(median device duration in ms of the kernel named `kernel` over at
    least `reps` launches, records kept, calls made), from torch.profiler's
    CUPTI records of calls of fn (each launches it once), each call behind
    a write of FLUSH_BYTES. Sessions of `reps` calls run until `reps`
    records are in, at most `sessions` of them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = _flush()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, calls = [], 0
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        calls += reps
        times += [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                  if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(times) >= reps:
            return float(np.median(times)), len(times), calls
    raise RuntimeError(f"the profiler kept {len(times)} records of {kernel} "
                       f"in {sessions} sessions of {reps} calls")


def covered_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time (ms) of the device work of one call of fn,
    each call behind a write of FLUSH_BYTES. The call and its events are
    enqueued while a sleep kernel still runs (an event recorded after the
    sleep has not completed when the host is done), so the device runs the
    call's kernels back to back between the events; a call whose enqueue
    outlasts the sleep is run again with a sleep twice as long."""
    import torch

    flush = _flush()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, cycles = [], SLEEP_CYCLES
    while len(times) < reps:
        slept = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        slept.record()
        flush.zero_()
        start.record()
        fn()
        end.record()
        covered = not slept.query()
        end.synchronize()
        if covered:
            times.append(start.elapsed_time(end))
        elif cycles >= 64 * SLEEP_CYCLES:
            raise RuntimeError("a call's enqueue outlasted a 64x sleep: it "
                               "waits for the device")
        else:
            cycles *= 2
    return float(np.median(times))


def kernel_times(fn, kernel: str, reps: int = 10) -> dict:
    """Both device times of the kernel named `kernel`, one launched by
    each call of fn: {"device_ms", "covered_ms", "profiler_records":
    [records kept, calls made]}."""
    dev, kept, calls = device_ms(fn, kernel, reps)
    return {"device_ms": dev, "covered_ms": covered_ms(fn, reps),
            "profiler_records": [kept, calls]}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def bench_config():
    """The JAX bench's snowfall configuration (bench.py:227-252), A1 path."""
    from lidar_snow_sim_tpu_torch import SnowfallConfig

    return SnowfallConfig(
        max_points=65536, window_size=128, wide_capacity=16,
        max_occluders=24, max_bumps=16, assembly="dense",
        channel_capacity=1024, block_points=128, slice_width=1152,
    )


def bank_sets(cache_dir: Path, rate_mm_h=2.5, velocity=1.6, seed=42):
    """The bench bank's 64 gunn particle sets, cached as an .npz."""
    from lidar_snow_sim_tpu_torch import (
        compute_occupancy,
        dart_throwing_fast,
        snowfall_rate_to_rainfall_rate,
    )

    rr = snowfall_rate_to_rainfall_rate(rate_mm_h, velocity)
    occ = compute_occupancy(rate_mm_h, velocity)
    path = cache_dir / f"gunn_{rr:.4f}_{occ:.3e}_{seed}.npz"
    if path.exists():
        with np.load(path) as z:
            return [z[f"c{i}"] for i in range(64)], rr, occ
    rng = np.random.default_rng(seed)
    sets = [dart_throwing_fast(occ, rr, 80.0, rng, "gunn") for _ in range(64)]
    cache_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{f"c{i}": s for i, s in enumerate(sets)})
    return sets, rr, occ


def bench_batch(batch: int = 16):
    """The batch's channel orders and RANSAC seeds, drawn as
    run_snowfall_datagen draws them for frames bench_00, bench_01, ..."""
    orders, seeds = [], []
    for j in range(batch):
        r = np.random.default_rng([0, zlib.crc32(f"bench_{j:02d}".encode())])
        orders.append(r.permutation(64))
        seeds.append(int(r.integers(2**31)))
    return orders, seeds
