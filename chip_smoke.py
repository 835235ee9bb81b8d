#!/usr/bin/env python3
"""Drive the PyTorch port's snowfall main path once on one NVIDIA GPU.

Run from the repository root: python3 chip_smoke.py

Phases, each printing one line of numbers:
  1. environment: the card's name and power limit (nvidia-smi), TF32 off;
     every csrc/*.cu built by its own nvcc, all started together;
  2. inputs at the bench scale: an 870-azimuth synthetic HDL-64 scan
     (50,475 points) and a gunn 2.5 mm/h, 1.6 m/s particle bank of 64 sets
     (~18k particles per channel; the sets are cached under
     lidar_snow_sim_tpu_torch/_build/);
  3. kernels A1 (phase A, occluders) and C1 (phase C, pulse) built from
     csrc/, launched on the card at the main path's shapes and held
     against their plain torch versions on the same inputs: exact
     equality (a1/a2 compared where dist < 1e37); CUDA-event times, median
     of 10 runs after warm-up, for each kernel and each plain version.
     Then A2 (span-routed phase A) at the JAX bench's config (route_band
     384, band_group 16) against its plain version and against A1 on the
     in-channel beams, with its chunks' mode split, and A3 (dual-banded
     phase A, band_width 256, band_group 8) against its plain version,
     coverage plane included;
  4. end to end: SnowfallAugmenter on the scene, 10 timed scans, with the
     kernels' launch counters reset just before and read just after; all
     five overflow counters 0, labels in {0, 1, 2}; the same on the routed
     config (A2) and, 3 scans, the banded one (A3); and the same small
     scene through the GPU and the CPU paths, which must agree;
  5. datagen through the CLI (python -m lidar_snow_sim_tpu_torch.tools.
     precompute ... --wet) on 4 synthetic scans, then a rerun that must
     skip all 4, then a run with --route-band 384 --band-group 16 (A2);
     then api.augment (default and routed config) and
     api.ground_water_augmentation on the card from the same particle
     files;
  6. the weather baselines on the bench scan: kernel L1 against its plain
     version on the positions LISA's Qback lookup hands it at the JAX
     bench's (48, 16) droplets (65,536 x 64), exact, CUDA-event times;
     LISA (rain 10 mm/h), fog (alpha 0.06), STF fog (beta 0.046) and the
     windowed DROR (block 128, window 2048, margin 1024, no overflow)
     end to end, scans/s on the host clock, each held against the CPU on
     the same draws; then the inspect CLI (python -m
     lidar_snow_sim_tpu_torch.tools.inspect ... --device cuda) with lisa
     (after --dror --fov), fog, stf_fog and snow+wet, the launch counters
     zeroed before each run;
  7. the batched snowfall path at the JAX bench's batch of 16 frames (the
     bench scan with 16 channel orders and RANSAC seeds drawn as the
     datagen draws them): kernels A4a (pallas_transposed) and A4b
     (pallas_pair) against their plain version (A1's, every chunk live)
     and against A1 on the in-channel beams, C2 (pulse_pair) against its
     plain version and C1, exact (its record carries C1's ms and
     device_ms from the same run), and A1 folded over the 16 frames
     (batch_fold) against 16 single launches; then batched_step with the
     default config and with each knob, output byte-identical to the
     default, launches counted around one batch (A1 once with batch_fold,
     A4a / A4b / C2 16 times with their knobs), scans/s over 3 batches;
     then run_snowfall_datagen on 16 synthetic scans with batch_fold,
     the same files as the default config;
  8. each kernel's device times (below), taken after every end-to-end
     phase, one line each.
The line before the last is the kernels' JSON record: each kernel's
launches on its path, max_abs_err, ms (CUDA events around one wrapper call,
host enqueue included) and plain_ms, device_ms (the kernel's own duration
from torch.profiler's CUPTI records, median of 10 launches after warm-up,
each with a cold L2 cache, with the records kept and the calls made),
covered_ms (CUDA events around the call's device work, enqueued behind a
sleep kernel: an independent check of device_ms;
`tools/kernel_times.kernel_times`), and bound_ms, the least time for the
same work from this run's inputs (bytes over the card's memory rate or
float32 operations over its peak, whichever is larger; no kernel's
device_ms may read below it). The last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it; so
does a machine without a CUDA device, or a directory without the port.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in ms over `reps` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a12d, ovf, a12d_p, ovf_p, k: int, name: str) -> float:
    """Hold a phase-A kernel's (a12d, ovf) against its plain version's:
    overflow and dist plane equal, a1/a2 compared where dist < 1e37;
    returns their largest difference there (0.0 when they agree)."""
    import torch

    if not torch.equal(ovf, ovf_p):
        fail(f"{name} overflow differs at {(ovf != ovf_p).sum().item()} "
             "beams")
    if not torch.equal(a12d[2 * k:], a12d_p[2 * k:]):
        fail(f"{name} dist plane differs from the plain version")
    live = torch.cat([a12d_p[2 * k:] < 1e37] * 2)
    err = (a12d[:2 * k] - a12d_p[:2 * k]).abs()[live]
    err = float(err.max()) if err.numel() else 0.0
    if err != 0.0:
        fail(f"{name} a1/a2 differ from the plain version: max {err}")
    return err


# NVIDIA H100 SXM peaks at the 700 W limit (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
HIT_TEST_OPS = 20   # one (beam, candidate) hit test, csrc/occluders.cu
WAVE_OPS = 9        # one (beam, bin, bump) waveform term, csrc/pulse.cu


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time for the work, the larger of the
    bytes over the card's memory rate and the operations over its float32
    rate."""
    t_bytes = n_bytes / HBM_BYTES * 1e3
    t_ops = n_ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _runs(starts, lens, rows, k_ext: int) -> int:
    """Distinct (bank row, column) pairs covered by the column runs
    [starts, starts + lens) of bank rows `rows` (flat tensors)."""
    import torch

    n_rows = int(rows.max()) + 1
    diff = torch.zeros(n_rows * (k_ext + 1), dtype=torch.int32,
                       device=rows.device)
    base = rows.long() * (k_ext + 1)
    lens = lens.clamp_min(0)
    diff.index_add_(0, base + starts.long(), (lens > 0).to(torch.int32))
    diff.index_add_(0, base + (starts + lens).long(),
                    -(lens > 0).to(torch.int32))
    return int((diff.view(n_rows, -1).cumsum(1) > 0).sum())


def phase_a_bound(kernel: str, args, kw, int_planes: int = 1):
    """bound() of a phase-A call from this run's inputs: the hit tests its
    candidate lists need (A1 its live chunks; A2 its routed lists; A3 its
    two bands; A4a and A4b every chunk), and the bytes of the point
    features, the chunk metadata, the distinct bank columns those lists
    read (6 property rows each), the wide rows of the rows read, and the
    outputs written once: a12d and `int_planes` int32 planes (ovf; A3
    also unc)."""
    import torch

    feats, rows = args[0], args[2]
    counts, data_t, wide_t = args[-3:]
    k_ext, wc = data_t.shape[2], wide_t.shape[2]
    blk, k = kw["blk"], kw["k_occ"]
    n_chunks = rows.shape[0]
    cnt = counts[rows.long()].long()
    if kernel in ("A1", "A4a", "A4b"):
        los = args[3].long()
        live = args[4] > 0 if kernel == "A1" else torch.ones_like(
            rows, dtype=torch.bool)
        n_s = (torch.minimum(torch.clamp(los + kw["w_sl"], max=k_ext),
                             los + cnt) - los).clamp_min(0) * live
        tests = int((n_s + wc * live).sum()) * blk
        cols = _runs(los, n_s, rows, k_ext)
        wide = int(torch.unique(rows[live]).numel()) * wc
    else:
        g_dim = blk // kw["group"]
        row_g = rows.repeat_interleave(g_dim)
        cnt_g = cnt.repeat_interleave(g_dim)
        band, wide_sl = kw["band"], kw["wide_sl"]
        if kernel == "A2":
            los, gloa, mode = args[3].long(), args[4].long(), args[5]
            full = mode == 1
            fast_g = (mode == 2).repeat_interleave(g_dim)
            n_full = (torch.minimum(torch.clamp(los + kw["w_sl"], max=k_ext),
                                    los + cnt) - los).clamp_min(0) * full
            n_band = (torch.clamp(gloa + torch.clamp(cnt_g, max=band),
                                  max=k_ext) - gloa).clamp_min(0) * fast_g
            tests = (int((n_full + wc * full).sum()) * blk
                     + int((n_band + wide_sl * fast_g).sum()) * kw["group"])
            cols = _runs(torch.cat([los, gloa]), torch.cat([n_full, n_band]),
                         torch.cat([rows, row_g]), k_ext)
            wide = (int(torch.unique(rows[full]).numel()) * wc
                    + int(torch.unique(row_g[fast_g]).numel()) * wide_sl)
        else:   # A3: band A, then the columns of band B past band A
            la, lb = args[3].long(), args[4].long()
            end = torch.clamp(la + cnt_g, max=k_ext)
            n_a = (torch.minimum(la + band, end) - la).clamp_min(0)
            b0 = torch.maximum(lb, la + band)
            n_b = (torch.minimum(lb + band, end) - b0).clamp_min(0)
            tests = int((n_a + n_b + wide_sl).sum()) * kw["group"]
            cols = _runs(torch.cat([la, b0]), torch.cat([n_a, n_b]),
                         torch.cat([row_g, row_g]), k_ext)
            wide = int(torch.unique(rows).numel()) * wide_sl
    n_bytes = (feats.numel() * 4 + sum(a.numel() * 4 for a in args[1:-3])
               + (cols + wide) * 6 * 4
               + n_chunks * blk * (3 * k + int_planes) * 4)
    return bound(n_bytes, tests * HIT_TEST_OPS)


def _sector_bytes(mask) -> int:
    """The bytes of the 32-byte sectors of a (rows, cap) float32 array
    that hold a slot of `mask`: what reading those slots moves."""
    import torch

    rows, cap = mask.shape
    m = torch.nn.functional.pad(mask.to(torch.uint8), (0, -cap % 8))
    return int(m.view(rows, -1, 8).amax(dim=2).sum()) * 32


def pulse_bound(args, kw):
    """bound() of a phase-C call from this run's inputs: the sweep trips
    each beam needs (7K + 4 operations a trip: the minimum and the retiring
    over the 2K + 2 endpoints, the K cover tests) and its windowed waveform
    (ops/pulse.pulse_windows): the bins of each beam's window union, each
    times the bumps whose windows cover it (WAVE_OPS a term). The bytes
    are those the windowed function reads, once: feats and valid whole;
    a1 and a2 of the valid slots, rr of the bumps that claim a share
    (their amplitudes), cos_b and sin_b of the walked windows, the
    target's included, each in the 32-byte sectors that hold them; cos_g
    and sin_g; and the four (cap,) outputs written."""
    import torch

    from lidar_snow_sim_tpu_torch.ops.pulse import (
        bump_amplitudes,
        pulse_windows,
    )

    feats, a1, a2, rr, valid, cos_b, sin_b, cos_g, sin_g = args
    k, cap = a1.shape
    vb = valid > 0.5
    trips = torch.clamp(2 * vb.sum(0) + 3, max=2 * k + 2)
    rr_all, amp, last, _, _ = bump_amplitudes(
        feats, a1, a2, rr, valid, beam_rad=kw["beam_rad"],
        xsi_r1=kw["xsi_r1"], xsi_r2=kw["xsi_r2"])
    lo, hi = pulse_windows(rr_all, amp, last, ipm=kw["ipm"],
                           c_tau=kw["c_tau"], m_bins=cos_g.shape[0])
    terms = int((hi - lo + 1).clamp_min(0).sum())
    n_ops = int(trips.sum()) * (7 * k + 4) + terms * WAVE_OPS
    n_bytes = ((feats.numel() + valid.numel() + cos_g.numel()
                + sin_g.numel()) * 4
               + 2 * _sector_bytes(vb) + _sector_bytes(last > 0)
               + 2 * _sector_bytes(lo <= hi) + 4 * cap * 4)
    return bound(n_bytes, n_ops)


# Each kernel's device times are taken at the end of the run, after every
# end-to-end phase: a torch.profiler session leaves the process's later
# launches slower, which would bias the scans/s the phases report.
TIMED = []


def timed(label: str, fn, kernel: str) -> dict:
    """Schedule tools/kernel_times.kernel_times(fn, kernel) for the end of
    the run (time_kernels); returns the dict it will fill."""
    times = {}
    TIMED.append((label, fn, kernel, times))
    return times


def time_kernels() -> None:
    """Run the scheduled kernel_times, one line each."""
    from lidar_snow_sim_tpu_torch.tools.kernel_times import kernel_times

    for label, fn, kernel, times in TIMED:
        times.update(kernel_times(fn, kernel))
        kept, calls = times["profiler_records"]
        print(f"{label}: device_ms {times['device_ms']:.4f} covered_ms "
              f"{times['covered_ms']:.4f} profiler_records {kept}/{calls}",
              flush=True)


def record(name, source, replaces, launches, err, ms, plain_ms, bnd,
           times, **extra):
    """One kernel's entry of the kernels line; `times` is the dict `timed`
    returned, merged in by merge_times."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None, "_times": times,
            **extra}


def merge_times(entries) -> None:
    """Merge each entry's device times (and its folded ones) into it, once
    time_kernels has run; fails if a device time reads below its bound
    (the bound would then miscount the work)."""
    for e in entries:
        for prefix in ("", "folded_"):
            times = e.pop(f"_{prefix}times", None)
            if times is None:
                continue
            if times["device_ms"] < e[f"{prefix}bound_ms"]:
                fail(f"{e['name']}: {prefix}device_ms {times['device_ms']} "
                     f"below its bound {e[prefix + 'bound_ms']}")
            e.update({prefix + key: v for key, v in times.items()})


def parity(name: str, got, want, label_col: int, atol: float) -> int:
    """Hold a result on the card against the same function on the CPU with
    the same draws: labels and keep equal on >= 99.8% of points (exp, log
    and pow round differently on the two devices, so a decision on a
    boundary may flip; tests/test_snowfall_parity.py's contract), the rest
    within rtol 1e-5; returns the number of flipped points."""
    gp, cp = got.points.cpu().numpy(), want.points.numpy()
    flip = (gp[:, label_col] != cp[:, label_col]) | (
        got.keep.cpu().numpy() != want.keep.numpy())
    if flip.mean() >= 0.002 or not np.allclose(
            gp[~flip], cp[~flip], rtol=1e-5, atol=atol):
        fail(f"{name}: card and CPU disagree ({int(flip.sum())} flipped, "
             f"max err {np.abs(gp[~flip] - cp[~flip]).max()})")
    return int(flip.sum())


def per_scan(fn, n_scans: int):
    """(last result, scans/s) of n_scans calls of fn() on the host clock,
    ending in a synchronize, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_scans):
        out = fn()
    torch.cuda.synchronize()
    return out, n_scans / (time.perf_counter() - t0)


def weather_phase(pc, sets, rr, occ, dev) -> dict:
    """Phase 6: kernel L1 against its plain version at LISA's bench shape,
    the weather baselines end to end on the bench scan (each held against
    the CPU on the same draws), then the inspect CLI on the card. Returns
    L1's entry of the kernels line."""
    import contextlib
    import io
    import math

    import torch

    from lidar_snow_sim_tpu_torch import pad_cloud
    from lidar_snow_sim_tpu_torch.models import dror
    from lidar_snow_sim_tpu_torch.models import lisa as tlisa
    from lidar_snow_sim_tpu_torch.models.fog import (
        FogAugmenter,
        FogParameterSet,
        fog_augment,
        fog_draws,
    )
    from lidar_snow_sim_tpu_torch.models.stf_fog import (
        StfFogAugmenter,
        haze_point_cloud_padded,
        stf_draws,
    )
    from lidar_snow_sim_tpu_torch.ops.lut_lookup import (
        lut_lookup_pairs,
        lut_lookup_plain,
    )
    from lidar_snow_sim_tpu_torch.ops.occluders import find_occluders
    from lidar_snow_sim_tpu_torch.ops.pulse import pulse_peaks
    from lidar_snow_sim_tpu_torch.tools import inspect as tinspect
    n_scans = 10
    cap = 65536
    cpu_gen = torch.Generator().manual_seed(0)

    # LISA at the JAX bench's capacities. L1 is held against its plain
    # version on the positions the Qback lookup hands it: the candidates'
    # diameters on the log grid, sampled from one set of draws (made on the
    # CPU, so the card and the CPU runs below share them)
    lisa = tlisa.LISA(max_droplets=48, tail_droplets=16, device=dev)
    lcfg = lisa.core_config()
    pc_n = pc.copy()
    pc_n[:, 3] /= 255.0
    padded = pad_cloud(pc_n, cap)
    draws = tlisa.lisa_draws(cap, 48, 16, cpu_gen)
    tables = lisa._dsd_tables(10.0)

    def core_args(d):
        return (torch.as_tensor(padded.points, device=d),
                torch.as_tensor(padded.mask, device=d),
                [x.to(d) for x in draws],
                torch.tensor(lisa.alpha(10.0), dtype=torch.float32, device=d),
                torch.tensor(lisa.droplet_density(10.0), dtype=torch.float32,
                             device=d),
                tlisa.lisa_tables_to_torch(tables, d))

    points_c, _, draws_c, _, density_c, tables_c = args_c = core_args(dev)
    drops = tlisa.lisa_droplets(points_c, draws_c, density_c, tables_c, lcfg)
    p, pairs = tlisa.log_pos(drops.d_mm, lcfg), tables_c.qb_pairs
    if tuple(p.shape) != (cap, 64):
        fail(f"L1 positions {tuple(p.shape)}, not ({cap}, 64)")
    t0 = time.time()
    got = lut_lookup_pairs(p, pairs)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    want = lut_lookup_plain(p, pairs)
    l1_err = float((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"L1 differs from its plain version at "
             f"{int((got != want).sum())} positions, max {l1_err}")
    l1_ms = time_ms(lambda: lut_lookup_pairs(p, pairs))
    l1_t = timed("L1", lambda: lut_lookup_pairs(p, pairs), "l1_kernel")
    l1_plain_ms = time_ms(lambda: lut_lookup_plain(p, pairs))
    print(f"L1: positions {tuple(p.shape)} cells {pairs.shape[0]} "
          f"max_abs_err {l1_err} ms {l1_ms:.4f} plain_ms {l1_plain_ms:.4f} first_call_s {first_s:.3f}",
          flush=True)

    # LISA end to end: the launch counter zeroed just before, read after
    lut_lookup_pairs.launches = 0
    (kept, stats), lisa_rate = per_scan(
        lambda: lisa.augment_compact(pc, 10.0, fixed_seed=True, seed=0),
        n_scans)
    l1_launches = lut_lookup_pairs.launches
    if l1_launches < 1:
        fail("LISA on the card never launched L1")
    if stats["droplet_overflow"] or lisa.max_droplets != 48:
        fail(f"LISA overflowed at (48, 16): {stats}, grown to "
             f"{lisa.max_droplets}")
    if kept.shape[1] != 5 or not np.isfinite(kept).all() or \
            not set(np.unique(kept[:, 4])) <= {0.0, 1.0, 2.0}:
        fail(f"LISA output malformed: {kept.shape}")
    res = {"cuda": tlisa.lisa_augment_core(*args_c, lcfg),
           "cpu": tlisa.lisa_augment_core(*core_args("cpu"), lcfg)}
    lisa_flips = parity("LISA", res["cuda"], res["cpu"], 4, 1e-6)
    if int(res["cuda"].droplet_overflow) != int(res["cpu"].droplet_overflow):
        fail("LISA droplet_overflow differs between the card and the CPU")
    print(f"lisa: rain 10 mm/h (48, 16) stats {stats} kept {kept.shape} "
          f"launches {{'L1': {l1_launches}}} scans {n_scans} scans_per_s "
          f"{lisa_rate:.3f} vs_cpu_flipped {lisa_flips}", flush=True)

    # fog alpha 0.06 and STF fog beta 0.046, end to end and against the CPU
    fog_params = FogParameterSet(alpha=0.06)
    fog_aug = FogAugmenter(fog_params, seed=0, device=dev)
    (fog_pc, fog_stats), fog_rate = per_scan(lambda: fog_aug(pc), n_scans)
    stf_aug = StfFogAugmenter(beta=0.046, seed=0, device=dev)
    (stf_pc, stf_stats), stf_rate = per_scan(lambda: stf_aug(pc), n_scans)
    padded = pad_cloud(pc, cap)
    fdraws = fog_draws(cap, cpu_gen)
    sdraws = stf_draws(cap, cpu_gen)
    res = {}
    for d in (dev, torch.device("cpu")):
        pts = torch.as_tensor(padded.points, device=d)
        msk = torch.as_tensor(padded.mask, device=d)
        res[d.type] = (
            fog_augment(fog_params, pts, msk, [x.to(d) for x in fdraws]),
            haze_point_cloud_padded(
                pts, msk, stf_aug.randomization.coefficients(d),
                [x.to(d) for x in sdraws]),
        )
    fog_flips = parity("fog", res["cuda"][0], res["cpu"][0], 4, 1e-4)
    stf_flips = parity("STF fog", res["cuda"][1], res["cpu"][1], 4, 1e-4)
    for name, out, st in (("fog", fog_pc, fog_stats),
                          ("STF fog", stf_pc, stf_stats)):
        if out.shape[1] != 5 or not np.isfinite(out).all() or \
                not set(np.unique(out[:, 4])) <= {0.0, 2.0} or \
                len(out) != len(pc) - st["num_removed"]:
            fail(f"{name} output malformed: {out.shape} {st}")
    if fog_stats["num_removed"]:
        fail(f"fog removed points: {fog_stats}")
    print(f"fog: alpha 0.06 stats {fog_stats} scans {n_scans} scans_per_s "
          f"{fog_rate:.3f} vs_cpu_flipped {fog_flips}", flush=True)
    print(f"stf_fog: beta 0.046 stats {stf_stats} scans {n_scans} "
          f"scans_per_s {stf_rate:.3f} vs_cpu_flipped {stf_flips}",
          flush=True)

    # DROR: the windowed search at the bench's block 128, window 2048,
    # margin 1024 must not overflow; it equals the full search and the CPU
    # up to pairs on the radius boundary
    n = len(pc)
    wcap = -(-n // 128) * 128
    xyz = np.full((wcap, 3), 1e6, np.float32)
    xyz[:n] = pc[:, :3]
    coef = float(np.float32(3.0) * np.float32(math.radians(0.45)))
    sr_min = float(np.float32(0.04))
    keep = {}
    for d in (dev, torch.device("cpu")):
        keep[d.type], ovf = dror.dror_windowed(
            torch.as_tensor(xyz, device=d),
            torch.arange(wcap, device=d) < n, coef, 3, sr_min,
            block=128, window=2048, margin=1024)
        if int(ovf):
            fail(f"DROR window overflow {int(ovf)} on {d.type}")
    keep_full = dror.dror_full(torch.as_tensor(xyz, device=dev),
                               torch.arange(wcap, device=dev) < n,
                               coef, 3, sr_min)
    off_full = int((keep["cuda"] != keep_full).sum())
    off_cpu = int((keep["cuda"].cpu() != keep["cpu"]).sum())
    if max(off_full, off_cpu) >= 0.002 * n:
        fail(f"DROR: windowed differs from full at {off_full}, from the CPU "
             f"at {off_cpu} of {n} points")
    dror_keep, dror_rate = per_scan(
        lambda: dror.dynamic_radius_outlier_filter(pc, device=dev), n_scans)
    if dror_keep.shape != (n,):
        fail(f"DROR keep mask malformed: {dror_keep.shape}")
    print(f"dror: window_overflow 0 removed {int((~dror_keep).sum())} of {n} "
          f"windowed_vs_full_differ {off_full} vs_cpu_differ {off_cpu} "
          f"scans {n_scans} scans_per_s {dror_rate:.3f}", flush=True)

    # the inspect CLI on the card, the counters zeroed before each run
    counted = {"A1": find_occluders, "C1": pulse_peaks, "L1": lut_lookup_pairs}
    runs = {
        "lisa": (["--augment", "lisa", "--dror", "--fov"], ("L1",)),
        "fog": (["--augment", "fog"], ()),
        "stf_fog": (["--augment", "stf_fog"], ()),
        # --fov: wet ground takes at most 32,768 points, in both packages
        "snow+wet": (["--augment", "snow+wet", "--fov", "--rate", "2.5",
                      "--velocity", "1.6"], ("A1", "C1")),
    }
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scan = tmp / "scan.bin"
        pc.tofile(scan)
        banks = tmp / "banks"
        banks.mkdir()
        for i, part in enumerate(sets):
            np.save(banks / f"gunn_{rr}_{occ}_{i + 1}.npy", part)
        for name, (argv, path) in runs.items():
            for fn in counted.values():
                fn.launches = 0
            out = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(out):
                rc = tinspect.main([str(scan), *argv, "--bank-dir",
                                    str(banks), "--device", "cuda"])
            wall_s = time.time() - t0
            launches = {k: fn.launches for k, fn in counted.items()}
            report = json.loads(out.getvalue())
            labels = report.get("labels", {})
            if rc != 0 or sum(labels.values()) != report["after_masks"]:
                fail(f"inspect {name}: rc {rc}, labels {labels}")
            if min((launches[k] for k in path), default=1) < 1:
                fail(f"inspect {name}: a kernel never launched: {launches}")
            if name == "lisa" and (report["lisa"]["droplet_overflow"]
                                   or "dror" not in report):
                fail(f"inspect lisa report: {report}")
            print(f"inspect {name}: launches {launches} wall_s {wall_s:.2f} "
                  f"after_masks {report['after_masks']} labels {labels} "
                  f"stats {report.get(name.split('+')[0])}", flush=True)
    # L1 reads each position and the table once and writes each output once;
    # about 6 operations an element (floor, clamp, the lerp)
    l1_bound = bound((2 * p.numel() + pairs.numel()) * 4, 6 * p.numel())
    return record("L1 knot-pair lookup (LISA's Qback)",
                  "lidar_snow_sim_tpu_torch/csrc/lut_lookup.cu",
                  "lidar_snow_sim_tpu/ops/lut_lookup.py:68", l1_launches,
                  l1_err, l1_ms, l1_plain_ms, l1_bound, l1_t)


def batched_phase(pc, padded, bank, bank_t, calib, calib_t, cfg, lay, a12d,
                  ovf, comp, out_p, dev) -> dict:
    """Phase 7: the batched snowfall path at the JAX bench's batch of 16
    frames (the bench scan, 16 channel orders and RANSAC seeds drawn as the
    datagen draws them). (a) kernels A4a, A4b and C2 at the bench shapes
    against their plain versions and against A1 / C1, and A1 folded over
    the 16 frames against 16 single launches; (b) batched_step with the
    default config and with each knob, byte-identical to the default, its
    launches counted around one batch; (c) run_snowfall_datagen on 16
    synthetic scans with batch_fold against the default. Returns the
    entries of the kernels line, A1's folded numbers included."""
    import torch

    from lidar_snow_sim_tpu_torch import synthetic_scan
    from lidar_snow_sim_tpu_torch.models.snowfall import (
        OVERFLOW_COUNTERS,
        SnowfallResult,
        dense_layout,
    )
    from lidar_snow_sim_tpu_torch.ops.occluders import (
        find_occluders,
        find_occluders_folded,
        find_occluders_pair,
        find_occluders_t,
        occluders_plain,
        occluders_ungated_plain,
    )
    from lidar_snow_sim_tpu_torch.ops.pulse import (
        pulse_peaks,
        pulse_peaks_pair,
        pulse_plain,
    )
    from lidar_snow_sim_tpu_torch.parallel.batched import (
        batched_step,
        frame_draws,
    )
    from lidar_snow_sim_tpu_torch.parallel.datagen import run_snowfall_datagen
    from lidar_snow_sim_tpu_torch.tools.kernel_times import bench_batch

    batch, k = 16, cfg.max_occluders
    kw = lay.occluder_kw
    feats, w0b, rows, los, has, counts, data_t, wide_t = lay.occluder_args
    args_u = (feats, w0b, rows, los, counts, data_t, wide_t)

    def ungated_plain():
        return occluders_ungated_plain(*args_u, **kw)

    # (a) A4a and A4b against their plain version and against A1
    a1_ms = time_ms(lambda: find_occluders(*lay.occluder_args, **kw))
    want = ungated_plain()
    valid = lay.valid_blk.reshape(-1)
    recs = {}
    for name, run, tpu in (("A4a", find_occluders_t, 312),
                           ("A4b", find_occluders_pair, 747)):
        got = run(*args_u, **kw)
        torch.cuda.synchronize()
        err = max_err(*got, *want, k, name)
        if not torch.equal(got[1].reshape(-1)[valid], ovf.reshape(-1)[valid]) \
                or not torch.equal(got[0][2 * k:, valid], a12d[2 * k:, valid]):
            fail(f"{name} and A1 differ on the in-channel beams")
        dead = ~lay.valid_blk.any(dim=1)
        # dead chunks are computed, so they may hold hits (A1 skips them)
        dead_hits = int((got[0][2 * k:, dead.repeat_interleave(lay.blk)]
                         < 1e37).sum())
        ms = time_ms(lambda: run(*args_u, **kw))
        times = timed(name, lambda run=run: run(*args_u, **kw),
                      name.lower() + "_kernel")
        plain_ms = time_ms(ungated_plain)
        bnd = phase_a_bound(name, args_u, kw)
        recs[name] = dict(err=err, ms=ms, times=times, plain_ms=plain_ms,
                          bound=bnd, tpu=tpu, dead_hits=dead_hits)
        print(f"{name}: chunks {lay.n_chunks} (dead {int(dead.sum())}, "
              f"computed: {dead_hits} hits) max_abs_err {err} ms {ms:.4f} "
              f"(A1 {a1_ms:.4f}) "
              f"plain_ms {plain_ms:.4f} "
              f"bound_ms {bnd[0]:.4f} ({bnd[1]}) "
              f"equal_to_A1_on_valid_beams True", flush=True)

    # C2 against its plain version (C1's) and C1, at pulse_block 512
    pblk = 512
    if (comp.cap // pblk) % 2:
        fail(f"compact capacity {comp.cap} has an odd count of {pblk} blocks")
    out_c2 = pulse_peaks_pair(*comp.pulse_args, blk=pblk, **comp.pulse_kw)
    out_c1 = pulse_peaks(*comp.pulse_args, **comp.pulse_kw)
    for name, a, b, c in zip(("peak", "idx", "touched", "remainder"),
                             out_c2, out_p, out_c1):
        if not torch.equal(a, b) or not torch.equal(a, c):
            fail(f"C2 {name} differs from its plain version or C1 at "
                 f"{int((a != b).sum())} beams")
    c2_err = max(float((out_c2[0] - out_p[0]).abs().max()),
                 float((out_c2[3] - out_p[3]).abs().max()))
    c2_ms = time_ms(lambda: pulse_peaks_pair(*comp.pulse_args, blk=pblk,
                                             **comp.pulse_kw))
    c1_ms = time_ms(lambda: pulse_peaks(*comp.pulse_args, **comp.pulse_kw))
    c2_t = timed("C2", lambda: pulse_peaks_pair(
        *comp.pulse_args, blk=pblk, **comp.pulse_kw), "c2_kernel")
    c2_plain_ms = time_ms(lambda: pulse_plain(*comp.pulse_args,
                                              **comp.pulse_kw))
    c2_bound = pulse_bound(comp.pulse_args, comp.pulse_kw)
    print(f"C2: cap {comp.cap} blocks {comp.cap // pblk} max_abs_err "
          f"{c2_err} ms {c2_ms:.4f} c1_ms {c1_ms:.4f} plain_ms "
          f"{c2_plain_ms:.4f} bound_ms {c2_bound[0]:.4f} ({c2_bound[1]})",
          flush=True)

    # the batch: the bench scan 16 times, orders and seeds as datagen draws
    orders, seeds = bench_batch(batch)
    points = torch.as_tensor(padded.points, device=dev).expand(
        batch, -1, -1).contiguous()
    mask = torch.as_tensor(padded.mask, device=dev).expand(
        batch, -1).contiguous()
    orders_t = torch.as_tensor(np.stack(orders), device=dev)
    draws = torch.stack([frame_draws(s_, cfg, None)[0]
                         for s_ in seeds]).to(dev)

    # A1 folded over the 16 frames against 16 single launches
    lays = [dense_layout(points[j], mask[j], bank_t, orders_t[j], draws[j],
                         cfg) for j in range(batch)]
    fold_args = [lay_j.occluder_args for lay_j in lays]
    n0 = find_occluders.launches
    folded = find_occluders_folded(fold_args, **kw)
    torch.cuda.synchronize()
    if find_occluders.launches != n0 + 1:
        fail("the folded A1 did not make exactly one launch")
    fold_err = 0.0
    for j, (fa, fo) in enumerate(folded):
        sa, so = find_occluders(*fold_args[j], **kw)
        fold_err = max(fold_err, max_err(fa, fo, sa, so, k, f"folded A1 "
                                                         f"frame {j}"))
    fold_ms = time_ms(lambda: find_occluders_folded(fold_args, **kw))
    fold_t = timed("A1 folded (covered_ms with the fold's concatenations)",
                   lambda: find_occluders_folded(fold_args, **kw), "a1_kernel")
    singles_ms = time_ms(lambda: [find_occluders(*a, **kw)
                                  for a in fold_args])
    fold_plain_ms = time_ms(lambda: [occluders_plain(*a, **kw)
                                     for a in fold_args], reps=3, warmup=1)
    cat = [torch.cat([a[i] for a in fold_args]) for i in range(5)]
    fold_bound = phase_a_bound("A1", (*cat, counts, data_t, wide_t), kw)
    print(f"A1 folded: frames {batch} chunks {batch * lay.n_chunks} "
          f"max_abs_err {fold_err} ms {fold_ms:.4f} 16_single_launches_ms {singles_ms:.4f} plain_ms "
          f"{fold_plain_ms:.4f} bound_ms {fold_bound[0]:.4f} "
          f"({fold_bound[1]})", flush=True)

    # (b) batched_step, default and each knob; launches counted around one
    # batch, then scans/s over 3 batches
    counted = {"A1": find_occluders, "A4a": find_occluders_t,
               "A4b": find_occluders_pair, "C1": pulse_peaks,
               "C2": pulse_peaks_pair}
    expect = {
        "default": dict(A1=batch, C1=batch),
        "batch_fold": dict(A1=1, C1=batch),
        "pallas_pair": dict(A4b=batch, C1=batch),
        "pallas_transposed": dict(A4a=batch, C1=batch),
        "pulse_pair": dict(A1=batch, C2=batch),
    }
    launches, ref = {}, None
    for knob, want_n in expect.items():
        run_cfg = cfg if knob == "default" else dataclasses.replace(
            cfg, **{knob: True})

        def step():
            return batched_step(points, mask, bank_t, calib_t, orders_t,
                                (draws, None), run_cfg)[0]

        step()
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        res = step()
        torch.cuda.synchronize()
        counts_ = {n: fn.launches for n, fn in counted.items()}
        if counts_ != {n: want_n.get(n, 0) for n in counted}:
            fail(f"batched {knob}: launches {counts_}, want {want_n}")
        launches[knob] = counts_
        counters = {n: getattr(res, n).tolist() for n in OVERFLOW_COUNTERS}
        if any(any(v) for v in counters.values()):
            fail(f"batched {knob}: overflow counters {counters}")
        if not set(torch.unique(res.planes[:, 4]).tolist()) <= {0.0, 1.0,
                                                                2.0}:
            fail(f"batched {knob}: labels outside {{0, 1, 2}}")
        if ref is None:
            ref = res
        for name, a, b in zip(SnowfallResult._fields, res, ref):
            if not torch.equal(a, b):
                fail(f"batched {knob}: {name} differs from the default")
        n_batches = 3
        t0 = time.perf_counter()
        for _ in range(n_batches):
            step()
        torch.cuda.synchronize()
        rate = n_batches * batch / (time.perf_counter() - t0)
        print(f"batched {knob}: frames {batch} launches {counts_} "
              f"stats_frame0 {(int(res.num_attenuated[0]), int(res.num_removed[0]), int(res.avg_intensity_diff[0]))} "
              f"counters 0 equal_to_default True batches {n_batches} "
              f"scans_per_s {rate:.3f}", flush=True)

    # (c) datagen on 16 synthetic scans, batch_fold against the default
    scans = {f"s{j:02d}": synthetic_scan(n_azimuth=870, seed=j, calib=calib)
             for j in range(batch)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        walls = {}
        for name, run_cfg in (("default", cfg),
                              ("batch_fold",
                               dataclasses.replace(cfg, batch_fold=True))):
            n0 = find_occluders.launches
            t0 = time.time()
            stats = run_snowfall_datagen(
                list(scans), scans.__getitem__, tmp / name, bank, calib,
                run_cfg, batch=batch, device="cuda",
            )
            walls[name] = time.time() - t0
            if stats.frames_done != batch:
                fail(f"datagen {name} wrote {stats.frames_done} scans")
            if name == "batch_fold" and \
                    find_occluders.launches - n0 != 1 + stats.capacity_growths:
                fail(f"datagen batch_fold launched A1 "
                     f"{find_occluders.launches - n0} times")
        for sid in scans:
            if (tmp / "default" / f"{sid}.bin").read_bytes() != \
                    (tmp / "batch_fold" / f"{sid}.bin").read_bytes():
                fail(f"datagen batch_fold output differs: {sid}")
    print(f"datagen batch 16: frames {batch} growths "
          f"{stats.capacity_growths} wall_s default {walls['default']:.2f} "
          f"batch_fold {walls['batch_fold']:.2f} equal_files True",
          flush=True)

    src = "lidar_snow_sim_tpu_torch/csrc/occluders.cu"
    out = {
        name: record(
            f"{name} " + ("transposed occluders (phase A, pallas_transposed)"
                          if name == "A4a" else
                          "paired occluders (phase A, pallas_pair)"),
            src, f"lidar_snow_sim_tpu/ops/pallas_occluders.py:{r['tpu']}",
            launches[{"A4a": "pallas_transposed",
                      "A4b": "pallas_pair"}[name]][name],
            r["err"], r["ms"], r["plain_ms"], r["bound"], r["times"],
            a1_ms_same_call=a1_ms, dead_chunk_hits=r["dead_hits"],
        )
        for name, r in recs.items()
    }
    out["C2"] = record(
        "C2 paired sweep and pulse peak (phase C, pulse_pair)",
        "lidar_snow_sim_tpu_torch/csrc/pulse.cu",
        "lidar_snow_sim_tpu/ops/pallas_pulse.py:244",
        launches["pulse_pair"]["C2"], c2_err, c2_ms, c2_plain_ms, c2_bound,
        c2_t, c1_ms_same_call=c1_ms,
    )
    out["A1_folded"] = dict(
        folded_launches=launches["batch_fold"]["A1"], folded_frames=batch,
        folded_max_abs_err=fold_err, folded_ms=fold_ms,
        _folded_times=fold_t,
        folded_16_single_ms=singles_ms, folded_plain_ms=fold_plain_ms,
        folded_bound_ms=fold_bound[0], folded_bound_by=fold_bound[1],
    )
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from lidar_snow_sim_tpu_torch import (
        SnowfallConfig,
        build_bank,
        load_hdl64_calib,
        pad_cloud,
        synthetic_scan,
    )
    from lidar_snow_sim_tpu_torch import _kernels
    from lidar_snow_sim_tpu_torch.tools.kernel_times import (
        bank_sets,
        bench_config,
        card_line,
    )
    from lidar_snow_sim_tpu_torch.models.snowfall import (
        OVERFLOW_COUNTERS,
        SnowfallAugmenter,
        bank_to_torch,
        calib_to_torch,
        compact_occluded,
        dense_layout,
        snowfall_augment_dense,
    )
    from lidar_snow_sim_tpu_torch.ops.fitting import ransac_draws
    from lidar_snow_sim_tpu_torch.ops.occluders import (
        find_occluders,
        find_occluders_banded,
        find_occluders_routed,
        occluders_banded_plain,
        occluders_plain,
        occluders_routed_plain,
    )
    from lidar_snow_sim_tpu_torch.ops.pulse import pulse_peaks, pulse_plain

    # --- 1. environment ---
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind!r} count {torch.cuda.device_count()} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.time()
    with ThreadPoolExecutor(len(_kernels.SIGNATURES)) as pool:
        list(pool.map(_kernels.build, _kernels.SIGNATURES))
    print(f"build: {sorted(_kernels.SIGNATURES)} built in parallel in "
          f"{time.time() - t0:.1f} s", flush=True)

    # --- 2. bench-scale inputs ---
    t0 = time.time()
    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=870, seed=0, calib=calib)
    sets, rr, occ = bank_sets(_kernels.BUILD_DIR / "banks")
    cfg = bench_config()
    bank = build_bank(sets, window_size=cfg.window_size,
                      wide_threshold=cfg.wide_threshold,
                      wide_capacity=cfg.wide_capacity)
    per_ch = np.bincount(pc[:, 4].astype(int), minlength=64)
    print(f"inputs: points {len(pc)} max_per_channel {per_ch.max()} "
          f"particles_per_channel {np.mean([len(s) for s in sets]):.0f} "
          f"data_t {tuple(bank.data_t.shape)} "
          f"{bank.data_t.nbytes / 1e6:.1f} MB setup_s {time.time() - t0:.1f}",
          flush=True)

    # --- 3. kernels vs plain versions at the main path's shapes ---
    padded = pad_cloud(pc, cfg.max_points)
    bank_t = bank_to_torch(bank, dev)
    calib_t = calib_to_torch(calib, dev)
    order = torch.as_tensor(np.random.default_rng(0).permutation(64),
                            device=dev)
    points = torch.as_tensor(padded.points, device=dev)
    mask = torch.as_tensor(padded.mask, device=dev)
    draws = ransac_draws(0, cfg.ransac_trials).to(dev)
    t0 = time.time()
    lay = dense_layout(points, mask, bank_t, order, draws, cfg)
    a12d, ovf = find_occluders(*lay.occluder_args, **lay.occluder_kw)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    a12d_p, ovf_p = occluders_plain(*lay.occluder_args, **lay.occluder_kw)
    k = cfg.max_occluders
    live = a12d_p[2 * k:] < 1e37
    a1_err = max_err(a12d, ovf, a12d_p, ovf_p, k, "A1")
    a1_ms = time_ms(lambda: find_occluders(*lay.occluder_args,
                                           **lay.occluder_kw))
    a1_t = timed("A1", lambda: find_occluders(*lay.occluder_args,
                                              **lay.occluder_kw), "a1_kernel")
    a1_plain_ms = time_ms(lambda: occluders_plain(*lay.occluder_args,
                                                  **lay.occluder_kw))
    print(f"A1: chunks {lay.n_chunks} blk {lay.blk} "
          f"slice {lay.occluder_kw['w_sl']} K {k} hits {int(live.sum())} "
          f"max_abs_err {a1_err} ms {a1_ms:.4f} "
          f"plain_ms {a1_plain_ms:.4f} first_call_incl_build_s {build_s:.1f}",
          flush=True)
    comp = compact_occluded(lay, a12d, ovf, calib_t, cfg)
    out_k = pulse_peaks(*comp.pulse_args, **comp.pulse_kw)
    out_p = pulse_plain(*comp.pulse_args, **comp.pulse_kw)
    for name, a, b in zip(("peak", "idx", "touched", "remainder"),
                          out_k, out_p):
        if not torch.equal(a, b):
            fail(f"C1 {name} differs at {(a != b).sum().item()} beams")
    c1_err = max(float((out_k[0] - out_p[0]).abs().max()),
                 float((out_k[3] - out_p[3]).abs().max()))
    c1_ms = time_ms(lambda: pulse_peaks(*comp.pulse_args, **comp.pulse_kw))
    c1_t = timed("C1", lambda: pulse_peaks(*comp.pulse_args,
                                           **comp.pulse_kw), "c1_kernel")
    c1_plain_ms = time_ms(lambda: pulse_plain(*comp.pulse_args,
                                              **comp.pulse_kw))
    print(f"C1: cap {comp.cap} occluded {int(comp.c_ok.sum())} "
          f"touched {int(out_k[2].sum())} max_abs_err {c1_err} "
          f"ms {c1_ms:.4f} plain_ms "
          f"{c1_plain_ms:.4f}", flush=True)

    # A2 at the JAX bench's config, against its plain version and A1
    cfg_r = dataclasses.replace(cfg, route_band=384, band_group=16)
    lay_r = dense_layout(points, mask, bank_t, order, draws, cfg_r)
    if lay_r.kernel != "A2":
        fail(f"the routed config laid out for {lay_r.kernel}, not A2")
    args_r, kw_r = lay_r.occluder_args, lay_r.occluder_kw
    a12d_r, ovf_r = find_occluders_routed(*args_r, **kw_r)
    a12d_rp, ovf_rp = occluders_routed_plain(*args_r, **kw_r)
    a2_err = max_err(a12d_r, ovf_r, a12d_rp, ovf_rp, k, "A2")
    valid = lay.valid_blk.reshape(-1)
    if not torch.equal(lay_r.valid_blk.reshape(-1), valid) or \
            not torch.equal(ovf_r.reshape(-1)[valid], ovf.reshape(-1)[valid]) \
            or not torch.equal(a12d_r[2 * k:, valid], a12d[2 * k:, valid]):
        fail("A2 and A1 differ on the in-channel beams")
    modes = torch.bincount(args_r[5].long(), minlength=3).tolist()
    a2_ms = time_ms(lambda: find_occluders_routed(*args_r, **kw_r))
    a2_t = timed("A2", lambda: find_occluders_routed(*args_r, **kw_r),
                 "a2_kernel")
    a2_plain_ms = time_ms(lambda: occluders_routed_plain(*args_r, **kw_r))
    print(f"A2: route_band {kw_r['band']} band_group {kw_r['group']} "
          f"wide_sl {kw_r['wide_sl']} modes_0_1_2 {modes} "
          f"window_overflow {int(lay_r.window_overflow)} max_abs_err "
          f"{a2_err} ms {a2_ms:.4f} plain_ms "
          f"{a2_plain_ms:.4f} "
          f"a1_ms {a1_ms:.4f} equal_to_A1_on_valid_beams True", flush=True)

    # A3 (band_width 256), against its plain version
    cfg_b = dataclasses.replace(cfg, band_width=256, band_group=8)
    lay_b = dense_layout(points, mask, bank_t, order, draws, cfg_b)
    if lay_b.kernel != "A3":
        fail(f"the banded config laid out for {lay_b.kernel}, not A3")
    args_b, kw_b = lay_b.occluder_args, lay_b.occluder_kw
    a12d_b, ovf_b, unc_b = find_occluders_banded(*args_b, **kw_b)
    a12d_bp, ovf_bp, unc_bp = occluders_banded_plain(*args_b, **kw_b)
    a3_err = max_err(a12d_b, ovf_b, a12d_bp, ovf_bp, k, "A3")
    if not torch.equal(unc_b, unc_bp):
        fail(f"A3 coverage differs at {(unc_b != unc_bp).sum().item()} beams")
    uncovered = int(torch.where(lay_b.cover_mask, unc_b, 0).sum())
    a3_ms = time_ms(lambda: find_occluders_banded(*args_b, **kw_b))
    a3_t = timed("A3", lambda: find_occluders_banded(*args_b, **kw_b),
                 "a3_kernel")
    a3_plain_ms = time_ms(lambda: occluders_banded_plain(*args_b, **kw_b))
    print(f"A3: band_width {kw_b['band']} band_group {kw_b['group']} "
          f"unc_beams {int(unc_b.sum())} counted {uncovered} max_abs_err "
          f"{a3_err} ms {a3_ms:.4f} plain_ms "
          f"{a3_plain_ms:.4f} "
          f"a1_ms {a1_ms:.4f}", flush=True)
    for name in ("occluders", "pulse"):   # nvcc -Xptxas -v, if built here
        log = _kernels.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}", flush=True)


    # --- 4. end to end through SnowfallAugmenter, on each phase-A path ---
    perm = np.random.default_rng(1).permutation(64)
    counted = (find_occluders, find_occluders_routed, find_occluders_banded,
               pulse_peaks)

    def drive(label, run_cfg, path, n_scans=10):
        """Warm up (growing any capacity), zero every launch counter, run
        n_scans timed scans; the counts of `path`'s kernels must be >= 1."""
        aug = SnowfallAugmenter(bank=bank, calib=calib, cfg=run_cfg, seed=0,
                                device=dev)
        for _ in range(3):
            aug(pc, order=perm)
        for fn in counted:
            fn.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_scans):
            stats, out = aug(pc, order=perm)
        end.record()
        end.synchronize()
        counts = dict(zip(("A1", "A2", "A3", "C1"),
                          (fn.launches for fn in counted)))
        e2e_ms = start.elapsed_time(end)
        res = aug.last_result
        counters = {n: int(getattr(res, n)) for n in OVERFLOW_COUNTERS}
        if any(counters.values()):
            fail(f"{label}: overflow counters after growth: {counters}")
        if not set(np.unique(out[:, 4])) <= {0.0, 1.0, 2.0}:
            fail(f"{label}: labels outside {{0, 1, 2}}")
        if out.shape[1] != 5 or not np.isfinite(out).all():
            fail(f"{label}: output not finite (n, 5): {out.shape}")
        if min(counts[name] for name in path) < 1:
            fail(f"{label}: a kernel of the path never launched: {counts}")
        print(f"{label}: stats {stats} out {out.shape} counters {counters} "
              f"launches {counts} scans {n_scans} ms {e2e_ms:.3f} "
              f"scans_per_s {n_scans * 1000.0 / e2e_ms:.3f} "
              f"grown slice_width {aug.cfg.slice_width} band_width "
              f"{aug.cfg.band_width} max_occluders {aug.cfg.max_occluders}",
              flush=True)
        return counts, stats, out

    launches, stats, out = drive("e2e", cfg, ("A1", "C1"))
    launches_r, stats_r, out_r = drive("e2e_routed", cfg_r, ("A2", "C1"))
    launches_b, stats_b, out_b = drive("e2e_banded", cfg_b, ("A3", "C1"),
                                       n_scans=3)
    for label, s2, o2 in (("routed", stats_r, out_r),
                          ("banded", stats_b, out_b)):
        if s2 != stats or not np.array_equal(o2, out):
            fail(f"the {label} path's output differs from A1's")

    # the small test scene through the GPU and the CPU paths
    small = synthetic_scan(n_azimuth=100, seed=2, calib=calib)
    rng = np.random.default_rng(5)
    small_sets = []
    for _ in range(64):
        ang = rng.uniform(0, 2 * np.pi, 300)
        d = np.sqrt(rng.uniform(0.01, 1, 300)) * 60
        r = rng.uniform(0.005, 0.05, 300)
        small_sets.append(
            np.column_stack([d * np.cos(ang), d * np.sin(ang), r])
        )
    small_bank = build_bank(small_sets, window_size=256, wide_capacity=64)
    small_cfg = SnowfallConfig(
        max_points=8192, window_size=256, wide_capacity=64, max_occluders=48,
        max_bumps=24, assembly="dense", channel_capacity=128,
        block_points=32, slice_width=256,
    )
    w = np.array([0.005, -0.003, -1.0], np.float32)
    w /= np.linalg.norm(w)
    sp = pad_cloud(small, small_cfg.max_points)
    results = {}
    for d in ("cuda", "cpu"):
        results[d] = snowfall_augment_dense(
            torch.as_tensor(sp.points, device=d),
            torch.as_tensor(sp.mask, device=d),
            bank_to_torch(small_bank, d), calib_to_torch(calib, d),
            torch.as_tensor(np.random.default_rng(3).permutation(64),
                            device=d),
            None, small_cfg,
            plane=(torch.as_tensor(w, device=d),
                   torch.tensor(-1.55, device=d)),
        )
    g, c = results["cuda"], results["cpu"]
    for name in OVERFLOW_COUNTERS:
        if int(getattr(g, name)) != int(getattr(c, name)):
            fail(f"GPU and CPU disagree on {name}")
    n = len(small)
    gp, cp = g.planes.cpu().numpy()[:, :n], c.planes.numpy()[:, :n]
    off = (gp[3:] != cp[3:]).any(axis=0) | (
        g.keep.cpu().numpy()[:n] != c.keep.numpy()[:n]
    )
    xyz_err = float(np.abs(gp[:3] - cp[:3])[:, ~off].max())
    # transcendentals (atan2, sin, cos, arccos) round differently on the
    # two devices, so a decision on a boundary may flip: the parity
    # contract of tests/test_snowfall_parity.py allows < 0.2% of points
    if off.mean() >= 0.002 or xyz_err > 1e-4:
        fail(f"GPU vs CPU: {off.sum()} of {n} points differ, "
             f"xyz err {xyz_err}")
    print(f"gpu_vs_cpu: points {n} differing {int(off.sum())} "
          f"xyz_max_abs_err {xyz_err} stats_gpu "
          f"{(int(g.num_attenuated), int(g.num_removed))} stats_cpu "
          f"{(int(c.num_attenuated), int(c.num_removed))}", flush=True)

    # --- 5. datagen through the CLI, then the resume ---
    from lidar_snow_sim_tpu_torch.tools import precompute

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lidar = tmp / "lidar_hdl64_strongest"
        banks = tmp / "banks"
        lidar.mkdir()
        banks.mkdir()
        lines = []
        for s in range(4):
            synthetic_scan(n_azimuth=870, seed=s, calib=calib).tofile(
                lidar / f"scene_{s:05d}.bin"
            )
            lines.append(f"scene,{s:05d}")
        (tmp / "split.txt").write_text("\n".join(lines) + "\n")
        for i, part in enumerate(sets):
            np.save(banks / f"gunn_{rr}_{occ}_{i + 1}.npy", part)
        argv = [
            "--split", str(tmp / "split.txt"), "--lidar-dir", str(lidar),
            "--bank-dir", str(banks), "--out-root", str(tmp / "out"),
            "--modes", "gunn", "--rates", "2.5", "--velocities", "1.6",
            "--batch", "4", "--wet", "--device", "cuda",
        ]
        t0 = time.time()
        if precompute.main(argv) != 0:
            fail("precompute returned non-zero")
        first_s = time.time() - t0
        out_dir = (tmp / "out" / "snowfall_simulation" / "gunn"
                   / f"lidar_hdl64_strongest_rainrate_{int(rr)}")
        bins = sorted(out_dir.glob("*.bin"))
        if len(bins) != 4 or not (out_dir / "_manifest.json").exists():
            fail(f"datagen wrote {len(bins)} scans, manifest "
                 f"{(out_dir / '_manifest.json').exists()}")
        manifest = json.loads((out_dir / "_manifest.json").read_text())
        rows = [np.fromfile(b, np.float32).reshape(-1, 5) for b in bins]
        if not all(np.isfinite(r).all() for r in rows):
            fail("datagen output not finite")
        if precompute.main(argv) != 0:
            fail("precompute rerun returned non-zero")
        rerun = json.loads((out_dir / "_manifest.json").read_text())
        if rerun["stats"]["frames_skipped"] != 4 or \
                rerun["stats"]["frames_done"] != 0:
            fail(f"resume did not skip all 4 scans: {rerun['stats']}")
        n_r = find_occluders_routed.launches
        argv_r = [*argv, "--route-band", "384", "--band-group", "16"]
        argv_r[argv_r.index("--out-root") + 1] = str(tmp / "out_routed")
        if precompute.main(argv_r) != 0:
            fail("precompute --route-band returned non-zero")
        routed_dir = tmp / "out_routed" / out_dir.relative_to(tmp / "out")
        if find_occluders_routed.launches - n_r < 1:
            fail("precompute --route-band did not launch A2")
        for b in bins:
            if not np.array_equal(
                    np.fromfile(routed_dir / b.name, np.float32),
                    np.fromfile(b, np.float32)):
                fail(f"precompute --route-band output differs: {b.name}")

        # the reference API on the card, from the same particle files
        from lidar_snow_sim_tpu_torch import api

        n0 = find_occluders.launches, pulse_peaks.launches
        api_stats, api_pc = api.augment(
            pc, f"gunn_{rr}_{occ}", cfg.beam_divergence_deg,
            root_path=str(banks), device="cuda",
        )
        wet_pc = api.ground_water_augmentation(api_pc, device="cuda")
        if min(find_occluders.launches - n0[0],
               pulse_peaks.launches - n0[1]) < 1:
            fail("api.augment did not launch both kernels")
        n_r = find_occluders_routed.launches
        api_r = api.augment(
            pc, f"gunn_{rr}_{occ}", cfg.beam_divergence_deg,
            root_path=str(banks), device="cuda",
            config=dict(route_band=384, band_group=16),
        )
        if find_occluders_routed.launches - n_r < 1:
            fail("api.augment with route_band did not launch A2")
        if api_r[1].shape[1] != 5 or not np.isfinite(api_r[1]).all():
            fail(f"api routed output malformed: {api_r[1].shape}")
        for name, arr in (("augment", api_pc), ("wet", wet_pc)):
            if arr.shape[1] != 5 or not np.isfinite(arr).all() or \
                    not set(np.unique(arr[:, 4])) <= {0.0, 1.0, 2.0}:
                fail(f"api {name} output malformed: {arr.shape}")
    print(f"datagen: frames {manifest['stats']['frames_done']} points_out "
          f"{[len(r) for r in rows]} growths "
          f"{manifest['stats']['capacity_growths']} first_run_s "
          f"{first_s:.1f} rerun_skipped {rerun['stats']['frames_skipped']} "
          f"route_band_run_equal True", flush=True)

    print(f"api: augment stats {api_stats} out {api_pc.shape} routed stats "
          f"{api_r[0]} out {api_r[1].shape} "
          f"ground_water_augmentation out {wet_pc.shape}", flush=True)

    l1 = weather_phase(pc, sets, rr, occ, dev)
    batched = batched_phase(pc, padded, bank, bank_t, calib, calib_t, cfg,
                            lay, a12d, ovf, comp, out_p, dev)

    occ_src = "lidar_snow_sim_tpu_torch/csrc/occluders.cu"
    tpu_occ = "lidar_snow_sim_tpu/ops/pallas_occluders.py"
    kernels = [
        record("A1 nearest-K occluders (phase A)", occ_src, f"{tpu_occ}:150",
               launches["A1"], a1_err, a1_ms, a1_plain_ms,
               phase_a_bound("A1", lay.occluder_args, lay.occluder_kw),
               a1_t, **batched["A1_folded"]),
        record("C1 sweep and pulse peak (phase C)",
               "lidar_snow_sim_tpu_torch/csrc/pulse.cu",
               "lidar_snow_sim_tpu/ops/pallas_pulse.py:173", launches["C1"],
               c1_err, c1_ms, c1_plain_ms,
               pulse_bound(comp.pulse_args, comp.pulse_kw), c1_t),
        record("A2 span-routed occluders (phase A, route_band)", occ_src,
               f"{tpu_occ}:584", launches_r["A2"], a2_err, a2_ms,
               a2_plain_ms, phase_a_bound("A2", args_r, kw_r), a2_t),
        record("A3 dual-banded occluders (phase A, band_width)", occ_src,
               f"{tpu_occ}:423", launches_b["A3"], a3_err, a3_ms,
               a3_plain_ms, phase_a_bound("A3", args_b, kw_b, int_planes=2),
               a3_t),
        batched["A4a"],
        batched["A4b"],
        batched["C2"],
        l1,
    ]
    # --- 8. each kernel's device times, after every end-to-end phase ---
    time_kernels()
    merge_times(kernels)
    batched["C2"]["c1_device_ms_same_call"] = c1_t["device_ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
