#!/usr/bin/env python3
"""Drive the PyTorch port's snowfall main path once on one NVIDIA GPU, then
the detector's inference and training paths.

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
     (after --dror --fov), fog, stf_fog and snow+wet (the JAX CLI's window
     assembly: W1 and W2), the launch counters zeroed before each run;
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
     the same files as the default config; then batched_step on a window
     config (assembly="window") over 2 frames, W1 and W2 once a frame, equal
     byte for byte to snowfall_augment run frame by frame;
  8. each kernel's device times (below), taken after every end-to-end
     phase, one line each;
  9. the PointPillars detector (run before phase 8, whose profiler
     sessions would slow it) at the full width of PointPillarsConfig()
     (432 x 496 pillar grid, 12,000 x 32 points, PFN 64, backbone
     64/128/256 with 3/5/5 layers, 321,408 anchors, nms_pre_max 4,096,
     nms_post_max 500) with seeded random weights, on phase 4's augmented
     cloud (x, y, z, intensity / 255): voxelize equal to the CPU's byte for
     byte, head maps within 1e-4 of the CPU's (with the TF32 flags on),
     predictions equal up to flips that a decision of their own at a
     boundary explains (matched as sets, see _flips); post_process on
     seeded head maps where 6,000 anchors pass (two-stage top-k, a
     4,096-candidate NMS) the same way; the infer CLI (python -m
     lidar_snow_sim_tpu_torch.tools.infer ... --random-params --device
     cuda); detect's time (median of 10 after 2 warm-ups) and its parts,
     the NMS sweeps, the IoU block and the peak memory. The detector has
     no kernel of its own (cuDNN convolutions and torch ops), so the
     kernels' record below is unchanged;
 10. PointPillars training at the same full width with seeded random
     weights (run before phase 8 too): the train CLI (python -m
     lidar_snow_sim_tpu_torch.tools.train --synthetic 8 --batch 4 --device
     cuda) in float32 and in bfloat16 with --augment, 4 steps straight and
     2 + --resume 2 in processes of their own: every loss finite with
     num_pos >= 1, the resumed checkpoint equal to the straight one byte
     for byte (params, mu, nu); one float32 step on the card against the
     CPU at batch 1 (labels equal off decisions within 1e-5 of their
     threshold, loss 1e-4 relative, each gradient within 1e-3 of its
     largest value or, where the CPU's own gradient moves more under 1e-7
     weight perturbations, within twice that move; running stats 1e-4);
     the trained params through the
     infer CLI and its predictions through the evaluate CLI (card table ==
     CPU table); the experiment tool on the card, whose snowify launches
     W1 and W2 (the JAX experiment's window config). Each dtype's step
     time (CUDA events, median of 5 after 2 warm-ups), steps/s, device
     busy time, launches and busy share, target assignment's share of the
     busy time (torch.profiler) and the peak memory. Training reaches no
     Pallas kernel, so the kernels' record is unchanged;
 11. the viewer's live server (python -m lidar_snow_sim_tpu_torch.tools.
     viewer scan.bin --serve --device cuda ...) on the bench scan, served
     from a thread (run before phase 8 too): GET /, snow on /augment (W1
     and W2, the JAX CLI's window assembly), a slider move, LISA (L1),
     /infer twice with the full-width detector and an unknown
     augmentation (400); every frame equal to the
     inspect pipeline's, /infer equal to detect's (server_phase);
 12. the window assembly (assembly="window", the JAX package's default) on
     its kernels W1 (occluders) and W2 (sweep, bumps, pulse peak): both
     against their plain versions exactly, with equal counters, at the JAX
     inspect CLI's config on the channel-sorted bench scan (measured), the
     JAX experiment's and a starved one (both overflows nonzero); a window
     scan on a given plane launching W1, W2 and P2 once each and equal
     byte for byte to the
     plain window path on the card, to the dense assembly through
     SnowfallAugmenter, and within the parity contract of the CPU's; its
     scan time, launches and busy share beside the plain path's, the dense
     path's and the plain scan before the kernels (window_phase);
 13. the card-vs-oracle parity tool (tools/parity_gpu, before phase 8 too)
     on the JAX parity tool's scene (5,727 points): the window (W1, W2),
     dense (A1, C1) and span-routed dense (A2 in both modes, C1)
     assemblies, each classified against the port's NumPy oracle: ok,
     oracle stats (29, 847, 194), no overflow, 0 unexplained mismatches
     and a mismatch rate under 0.002 for each, A1, A2, C1, W1 and W2
     launched (parity_phase);
 14. the reference grid (before phase 8 too): the port's gen_banks in a
     subprocess per combo, native sampler only, for gunn's five precompute
     (rate, velocity) pairs and sekhon's lightest (384 files, deleted at
     the end); the precompute CLI on the card over those six combos on
     four 870-azimuth scans at --batch 4 (A1 and C1 launched, labels in
     {0, 1, 2}); one frame of gunn's lightest combo on the card against
     the CPU with the run's grown config, order and draws (the parity
     contract), its kept rows equal to the CLI's file; per combo the
     sampler's seconds, particles a channel, the grown slice width and
     scans/s (grid_phase);
 15. the multi-device paths (before phase 8 too), on two cards where
     there are two, else on the one card twice: make_sharded_step on the
     bench scene at batch 4 equal to batched_step byte for byte, A1 and C1
     launched once a frame on each shard; run_snowfall_datagen(mesh=...)
     writing the files of a run without one; in two spawned ranks (NCCL on
     a card each, gloo on one card) all_hosts_stats summing made-up
     counters above 2^24 exactly, and a full-width float32 data-parallel
     train step at batch 4 against the one-process step (loss and running
     stats 1e-4, `_grad_gate` against the card's own gradient moves);
     then tools/dryrun_multichip at n = 2 (multi_gpu_phase);
 16. the measuring tools (before phase 8 too): ab snow base route256 and
     ab lisa base at chains of 1 and 3 steps (every arm overflow 0, step
     time above 0, A1, A2, C1 and L1 launched), profile_bench --model
     snow naming a1_kernel and c1_kernel, datagen_bench --frames 8
     --batch 4 with every key of the JAX tool's report (tools_phase);
 17. the snowfall preamble's kernels P1 (RANSAC plane) and P2 (noise
     floor) on the bench scan padded to 65,536 rows and channel-sorted, as
     the window scan passes it: each against its plain version on the card
     (P1: the crop's size, median and MAD, every trial's inliers and the
     chosen trial equal, (w, h) within 1e-6; P2 on the plain plane: the
     ground band, y_hi and each row's bin equal, the floor within 1e-4 of
     max(|floor|, 1)), then each one's ms, plain_ms, bound and device times,
     and the whole preamble's ms and launches on the kernels and plain
     (preamble_phase).
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
import os
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
        dev = times["device_ms"]
        dev = (f"None (truncated, short reading "
               f"{times['device_ms_short']:.4f})" if dev is None
               else f"{dev:.4f}")
        print(f"{label}: device_ms {dev} covered_ms "
              f"{times['covered_ms']:.4f} profiler_records {kept}/{calls}"
              f"{' retaken' if times.get('retaken') else ''}", flush=True)


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
    (the bound would then miscount the work). A record whose device_ms is
    truncated (tools/kernel_times.settle) holds its covered_ms to the
    bound instead."""
    for e in entries:
        for prefix in ("", "folded_"):
            times = e.pop(f"_{prefix}times", None)
            if times is None:
                continue
            held = "device_ms" if times["device_ms"] is not None \
                else "covered_ms"
            if times[held] < e[f"{prefix}bound_ms"]:
                fail(f"{e['name']}: {prefix}{held} {times[held]} below its "
                     f"bound {e[prefix + 'bound_ms']}")
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
    from lidar_snow_sim_tpu_torch.ops.occluders import find_occluders_window
    from lidar_snow_sim_tpu_torch.ops.pulse import window_pulse_peaks
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
    counted = {"W1": find_occluders_window, "W2": window_pulse_peaks,
               "L1": lut_lookup_pairs}
    runs = {
        "lisa": (["--augment", "lisa", "--dror", "--fov"], ("L1",)),
        "fog": (["--augment", "fog"], ()),
        "stf_fog": (["--augment", "stf_fog"], ()),
        # --fov: wet ground takes at most 32,768 points, in both packages
        "snow+wet": (["--augment", "snow+wet", "--fov", "--rate", "2.5",
                      "--velocity", "1.6"], ("W1", "W2")),
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
        find_occluders_window,
        occluders_plain,
        occluders_ungated_plain,
    )
    from lidar_snow_sim_tpu_torch.ops.pulse import (
        pulse_peaks,
        pulse_peaks_pair,
        pulse_plain,
        window_pulse_peaks,
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

    # (d) the window assembly on the batched step: 2 frames equal to
    # snowfall_augment (window) run frame by frame, byte for byte
    from lidar_snow_sim_tpu_torch.models.snowfall import snowfall_augment

    wcfg = dataclasses.replace(cfg, assembly="window")
    t0 = time.time()
    w_counted = (find_occluders_window, window_pulse_peaks)
    for fn in w_counted:
        fn.launches = 0
    got = batched_step(points[:2], mask[:2], bank_t, calib_t, orders_t[:2],
                       (draws[:2], None), wcfg)[0]
    w_launches = [fn.launches for fn in w_counted]
    if w_launches != [2, 2]:
        fail(f"window batched_step launched W1, W2 {w_launches} times, not "
             "once a frame")
    for f in range(2):
        want = snowfall_augment(points[f], mask[f], bank_t, calib_t,
                                orders_t[f], draws[f], wcfg)
        for name, a, b in zip(SnowfallResult._fields, got, want):
            if not torch.equal(a[f], b):
                fail(f"window batched_step frame {f}: {name} differs from "
                     "snowfall_augment")
    counters = [int(getattr(got, n).sum()) for n in OVERFLOW_COUNTERS]
    stats0 = tuple(int(getattr(got, n)[0]) for n in (
        "num_attenuated", "num_removed", "avg_intensity_diff"))
    print(f"batched window: frames 2 W1_W2_launches {w_launches} "
          f"equal_to_snowfall_augment True "
          f"counters {counters} stats_frame0 {stats0} "
          f"s {time.time() - t0:.1f}", flush=True)

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


def _flips(got, want, scores, cfg) -> tuple:
    """(flips, near, unexplained) of card predictions `got` against CPU
    predictions `want`. A prediction of either run is a flip when the other
    run kept none with its label and its box within 1e-4 (matched one to
    one, in keep order). A flip is near a boundary when a decision about
    that prediction lies within 1e-5 of its threshold: its score near
    score_thresh or near the nms_pre_max-th anchor score (where more pass),
    or its IoU with a box kept by either run near nms_thresh. A flip is
    explained when it is near, or follows from an explained flip: it
    overlaps one beyond nms_thresh - 1e-5 (suppression passed on), or its
    run is at nms_post_max and an explained flip outranks it (the cap).
    `unexplained` also counts matched predictions out of keep order."""
    import torch

    from lidar_snow_sim_tpu_torch.ops.rotated_iou import boxes_iou_bev

    runs = []
    for p in (got, want):
        k = int(p.count)
        runs.append((p.boxes[:k].cpu(), p.labels[:k].cpu(),
                     p.scores[:k].cpu(), k))
    (bg, lg, sg, kg), (bc, lc, sc, kc) = runs
    pair = (lg[:, None] == lc[None, :]) & (
        (bg[:, None, :] - bc[None, :, :]).abs().amax(-1) <= 1e-4)
    used, match = set(), {}
    for i in range(kg):
        for j in torch.nonzero(pair[i]).flatten().tolist():
            if j not in used:
                used.add(j)
                match[i] = j
                break
    out_of_order = sum(a >= b for a, b in zip(list(match.values()),
                                               list(match.values())[1:]))
    # every kept box of both runs: (box, score, run, rank)
    boxes = torch.cat([bg, bc])
    score = torch.cat([sg, sc])
    run_of = [0] * kg + [1] * kc
    rank = list(range(kg)) + list(range(kc))
    flip = [i not in match for i in range(kg)] + \
        [j not in used for j in range(kc)]
    flips = sum(flip)
    if not flips:
        return 0, 0, out_of_order
    s = scores.reshape(-1)
    kth = None
    if int((s > cfg.score_thresh).sum()) > cfg.nms_pre_max:
        kth = torch.topk(s, cfg.nms_pre_max).values[-1]
    iou = boxes_iou_bev(boxes[:, [0, 1, 3, 4, 6]], boxes[:, [0, 1, 3, 4, 6]])
    iou.fill_diagonal_(0.0)
    near_iou = ((iou - cfg.nms_thresh).abs() < 1e-5).any(1)
    near = [
        f and bool((score[i] - cfg.score_thresh).abs() < 1e-5
                   or (kth is not None and (score[i] - kth).abs() < 1e-5)
                   or near_iou[i])
        for i, f in enumerate(flip)]
    explained = list(near)
    at_cap = (kg == cfg.nms_post_max, kc == cfg.nms_post_max)
    changed = True
    while changed:
        changed = False
        for i, f in enumerate(flip):
            if not f or explained[i]:
                continue
            for e, ok in enumerate(explained):
                if ok and (iou[i, e] > cfg.nms_thresh - 1e-5 or (
                        at_cap[run_of[i]] and score[e] >= score[i])):
                    explained[i] = changed = True
                    break
    return flips, sum(near), flips - sum(explained) + out_of_order


def _hold(name, got, want, scores, cfg) -> tuple:
    """Fail unless card predictions agree with the CPU's (count, labels and
    boxes within 1e-4) up to flips that a decision within 1e-5 of its
    threshold explains (see _flips); returns (flips, near)."""
    flips, near, unexplained = _flips(got, want, scores, cfg)
    if unexplained:
        fail(f"{name}: {unexplained} of {flips} flipped predictions (and "
             f"out-of-order ones) differ between the card and the CPU with "
             f"no decision at a boundary; near {near}")
    for c in ("points_dropped", "pillars_dropped", "nms_pre_overflow",
              "topk_block_miss", "prefix_overflow"):
        if int(getattr(got, c)) != int(getattr(want, c)):
            fail(f"{name}: {c} {int(getattr(got, c))} on the card, "
                 f"{int(getattr(want, c))} on the CPU")
    return flips, near


def _near_assignment(anchors, gt_boxes, cfg, tol: float = 1e-5):
    """(N,) bool: anchors with an assignment decision within `tol` of its
    threshold, from this device's IoU: the anchor's best same-class IoU
    near its class's matched or unmatched threshold, or its IoU with a gt
    near that gt's best where the best is tied (another anchor within
    `tol` of it too) or near 0 (which decides whether the gt force-matches
    at all)."""
    import torch

    from lidar_snow_sim_tpu_torch.ops.rotated_iou import boxes_iou_bev

    n = anchors.shape[0]
    nrot = len(cfg.anchor_rotations)
    cls_of = (torch.arange(n) % cfg.num_anchors_per_loc) // nrot
    gcls = gt_boxes[:, 7].long()
    same = (cls_of[:, None] == gcls[None, :] - 1) & (gcls[None, :] > 0)
    iou = torch.where(same, boxes_iou_bev(anchors, gt_boxes[:, :7]), -1.0)
    amax, gmax = iou.amax(1), iou.amax(0)
    near = torch.zeros(n, dtype=torch.bool)
    for thresholds in (cfg.anchor_match_thresholds,
                       cfg.anchor_unmatch_thresholds):
        near |= (amax - torch.tensor(thresholds)[cls_of]).abs() < tol
    at_best = same & ((iou - gmax[None, :]).abs() < tol)
    tied = (at_best.sum(0) > 1) | (gmax.abs() < tol)
    near |= (at_best & tied[None, :]).any(1)
    return near


def _label_flips(got, want, near) -> tuple:
    """(flips, unexplained) of labels `got` against `want`: an anchor
    whose labels differ is explained where `near` (`_near_assignment`)."""
    flip = got.cpu() != want.cpu()
    return int(flip.sum()), int((flip & ~near.cpu()).sum())


def _grad_gate(err: dict, noise: dict, tol: float = 1e-3,
               factor: float = 2.0) -> list:
    """Names of the gradients whose error `err[name]` (`_rel_err` against
    the CPU) exceeds both `tol` and `factor` x `noise[name]`, the largest
    change that 1e-7 relative perturbations of the weights make to the
    CPU's own gradient: where a gradient is that sensitive (ReLU gates and
    max ties flip, and the following BN's mean subtraction cancels most of
    the sum), float32 rounding alone moves it past `tol`."""
    return sorted(n for n, e in err.items()
                  if e > tol and e > factor * noise[n])


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 where both are 0)."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


def detector_phase(cloud, dev, cfg=None) -> None:
    """Phase 9: the PointPillars detector at the full width of
    PointPillarsConfig() with seeded random weights, on the phase-4
    augmented cloud as the infer CLI feeds it (x, y, z, intensity / 255).
    The card against the port on the CPU: voxelize byte for byte, head maps
    within 1e-4 (with the caller's TF32 flags on: the forward pass turns
    them off for the call), detect's predictions up to flips that a
    decision at a boundary explains (see _flips); then post_process on seeded head maps where 6,000 anchors pass
    (two-stage top-k, a 4,096-candidate NMS) the same way; then the infer
    CLI on the card. Times detect (median of 10 CUDA-event runs after 2
    warm-ups), its four parts and the IoU matrix at nms_pre_max
    candidates by rows a block, then the device busy time and launches of
    detect, its post-process and the matrix (torch.profiler), and prints the NMS sweeps, the IoU
    block and the peak memory beside the card's name and power limit."""
    import contextlib
    import io

    import torch

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
    from lidar_snow_sim_tpu_torch.ops.rotated_iou import (
        IOU_BLOCK,
        boxes_iou_bev,
    )
    from lidar_snow_sim_tpu_torch.tools import infer
    from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line

    t_phase = time.time()
    cfg = cfg or tpp.PointPillarsConfig()
    h, w = cfg.feature_map_size
    n_anch = h * w * cfg.num_anchors_per_loc
    params = tpp.init_params(cfg, torch.Generator().manual_seed(0))
    net = tpp.PointPillars(cfg, params, device=dev)
    net_cpu = tpp.PointPillars(cfg, params, device="cpu")
    points = cloud[:, :4].astype(np.float32)
    points[:, 3] *= 1.0 / 255.0
    valid = np.ones(len(points), bool)
    pts_g, pts_c = torch.as_tensor(points, device=dev), torch.as_tensor(points)
    val_g, val_c = torch.as_tensor(valid, device=dev), torch.as_tensor(valid)

    vox_g = tpp.voxelize(pts_g, val_g, cfg)
    vox_c = tpp.voxelize(pts_c, val_c, cfg)
    for name in vox_c._fields:
        a, b = getattr(vox_g, name).cpu(), getattr(vox_c, name)
        if a.dtype != b.dtype or a.numpy().tobytes() != b.numpy().tobytes():
            fail(f"detector: voxelize {name} differs between card and CPU")

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        maps_g = tpp.forward_features(pts_g, val_g, net)[:3]
        if not (torch.backends.cuda.matmul.allow_tf32
                and torch.backends.cudnn.allow_tf32):
            fail("detector: the forward pass did not restore the TF32 flags")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
    maps_c = tpp.forward_features(pts_c, val_c, net_cpu)[:3]
    map_err = max(float((g.cpu() - c).abs().max())
                  for g, c in zip(maps_g, maps_c))
    if map_err > 1e-4 or not all(bool(torch.isfinite(m).all())
                                 for m in maps_g):
        fail(f"detector: head maps differ from the CPU by {map_err}")

    preds = tpp.detect(points, valid, net, device=dev)
    preds_c = tpp.detect(points, valid, net_cpu, device="cpu")
    flips, near = _hold("detect", preds, preds_c,
                  torch.sigmoid(maps_c[0].amax(-1)), cfg)
    if preds.boxes.shape != (cfg.nms_post_max, 7) or not bool(
            torch.isfinite(preds.boxes).all()):
        fail(f"detector: boxes malformed {tuple(preds.boxes.shape)}")

    # a loaded NMS: 6,000 anchors pass score_thresh, with logits spaced
    # 6.7e-4 apart (no near-ties at the k-th score); the rest at -10
    gen = torch.Generator().manual_seed(1)
    a, ncls = cfg.num_anchors_per_loc, len(cfg.class_names)
    n_pass = 6000
    cls = torch.full((a, ncls, h * w), -10.0)
    pick = torch.randperm(n_anch, generator=gen)[:n_pass]
    cls[pick // (h * w), torch.randint(ncls, (n_pass,), generator=gen),
        pick % (h * w)] = torch.linspace(-2.0, 2.0, n_pass)[
        torch.randperm(n_pass, generator=gen)]
    scores_loaded = torch.sigmoid(cls.amax(1))
    cls = cls.reshape(a * ncls, h, w)
    box = 0.1 * torch.randn(a * 7, h, w, generator=gen)
    dir_ = torch.randn(a * cfg.num_dir_bins, h, w, generator=gen)
    loaded_c = tpp.post_process(cls, box, dir_, net_cpu.anchors, cfg)
    loaded = tpp.post_process(cls.to(dev), box.to(dev), dir_.to(dev),
                              net.anchors, cfg)
    loaded_flips, loaded_near = _hold("loaded NMS", loaded, loaded_c,
                                      scores_loaded, cfg)
    if int(loaded_c.nms_pre_overflow) + int(loaded_c.topk_block_miss) < \
            n_pass - cfg.nms_pre_max:
        fail("loaded NMS: fewer candidates than nms_pre_max passed")

    # the infer CLI on the card, on the bench scan written to disk
    with tempfile.TemporaryDirectory() as tmp:
        scan = Path(tmp) / "scan.bin"
        cloud.astype(np.float32).tofile(scan)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = infer.main([str(scan), "--random-params", "--device", dev.type,
                             "--predictions", str(Path(tmp) / "preds.txt")])
        full = json.loads(out.getvalue())
        report = full["inference"]
        if rc != 0 or report["input_points"] != full["after_masks"]:
            fail(f"infer CLI: rc {rc} report {report}")

    # times on the card
    def parts():
        with torch.no_grad():
            vox = tpp.voxelize(pts_g, val_g, cfg)
            feat = tpp.pillar_features(vox, cfg)
            pfeat = tpp.pfn_forward(feat, net, cfg)
            live = (vox.num_points > 0)[:, None]
            spatial = tpp.scatter_bev(pfeat * live.to(pfeat.dtype), vox, cfg)
            bev = tpp.backbone_forward(spatial, net, cfg)
            maps = tpp.head_forward_chw(bev, net, cfg)
        return vox, spatial, maps

    vox, spatial, maps = parts()
    split = {}
    with torch.no_grad():
        split["voxelize"] = time_ms(lambda: tpp.voxelize(pts_g, val_g, cfg))
        split["pfn_scatter"] = time_ms(lambda: tpp.scatter_bev(
            tpp.pfn_forward(tpp.pillar_features(vox, cfg), net, cfg)
            * (vox.num_points > 0)[:, None].float(), vox, cfg))
        split["backbone_head"] = time_ms(lambda: tpp.head_forward_chw(
            tpp.backbone_forward(spatial, net, cfg), net, cfg))
        split["post_process"] = time_ms(lambda: tpp.post_process(
            maps[0][0], maps[1][0], maps[2][0], net.anchors, cfg))
        split["post_process_loaded"] = time_ms(lambda: tpp.post_process(
            cls.to(dev), box.to(dev), dir_.to(dev), net.anchors, cfg))
    detect_ms = time_ms(lambda: tpp.detect(points, valid, net, device=dev))
    # the IoU matrix alone at nms_pre_max candidates, by rows a block
    g2 = torch.Generator().manual_seed(2)
    k = cfg.nms_pre_max
    cand = torch.cat([60 * torch.rand(k, 2, generator=g2),
                      0.5 + 4 * torch.rand(k, 2, generator=g2),
                      6.3 * torch.rand(k, 1, generator=g2) - 3.15], 1).to(dev)
    iou_ms = {rows: round(time_ms(lambda: boxes_iou_bev(
        cand, cand, block_rows=rows)), 4) for rows in (256, 512, 1024, 2048,
                                                        4096)}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tpp.detect(points, valid, net, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    # device busy time and launches, under torch.profiler (after every
    # timing above: a profiler session slows the process's later launches)
    busy = {}
    for name, fn in (("detect", lambda: tpp.detect(points, valid, net,
                                                   device=dev)),
                     ("post_process", lambda: tpp.post_process(
                         maps[0][0], maps[1][0], maps[2][0], net.anchors,
                         cfg)),
                     ("iou", lambda: boxes_iou_bev(cand, cand))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
        busy[name] = (round(sum(e.time_range.elapsed_us() for e in ks) / 1e3,
                            4), len(ks))
    print(f"detector: card {card_line()!r} grid {cfg.grid_size} pillars "
          f"{int(vox_c.num_pillars)} of {cfg.max_pillars} x "
          f"{cfg.max_points_per_pillar} points_dropped "
          f"{int(vox_c.points_dropped)} pillars_dropped "
          f"{int(vox_c.pillars_dropped)} anchors {n_anch} voxelize_equal True "
          f"head_map_max_abs_err {map_err} count {int(preds.count)} "
          f"cpu_count {int(preds_c.count)} flips {flips} near {near} "
          f"nms_sweeps "
          f"{preds.nms_sweeps} nms_pre_overflow {int(preds.nms_pre_overflow)}"
          f" topk_block_miss {int(preds.topk_block_miss)} | loaded: passing "
          f"{n_pass} count {int(loaded.count)} cpu_count "
          f"{int(loaded_c.count)} flips {loaded_flips} near {loaded_near} "
          f"nms_sweeps "
          f"{loaded.nms_sweeps} nms_pre_overflow "
          f"{int(loaded.nms_pre_overflow)} topk_block_miss "
          f"{int(loaded.topk_block_miss)} | iou_block_pairs {IOU_BLOCK} "
          f"rows_at_{cfg.nms_pre_max} {IOU_BLOCK // cfg.nms_pre_max} | "
          f"detect_ms {detect_ms:.4f} split_ms "
          f"{ {k: round(v, 4) for k, v in split.items()} } iou_ms_by_rows "
          f"{iou_ms} device_busy_ms_and_launches {busy} peak_mib "
          f"{peak / 2**20:.1f} base_mib {base / 2**20:.1f} infer_cli "
          f"predictions {report['num_predictions']} phase_s "
          f"{time.time() - t_phase:.1f}", flush=True)


def _run_all(cmds: dict, cwd: Path, timeout: float = 600) -> dict:
    """Start every command of {name: argv} at once; {name: stderr} once all
    have ended. Fails on a non-zero exit; kills what is left on the way
    out."""
    import subprocess

    procs = {}
    try:
        for name, argv in cmds.items():
            procs[name] = subprocess.Popen(
                argv, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        logs = {}
        for name, p in procs.items():
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                fail(f"{name}: exit {p.returncode}\n{out[-2000:]}\n"
                     f"{err[-4000:]}")
            logs[name] = err
        return logs
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _logged_steps(err: str) -> list:
    """[(step, loss, num_pos)] from a train CLI's log."""
    import re

    return [(int(s), float(loss), float(pos)) for s, loss, pos in re.findall(
        r"step (\d+)/\d+ loss=(\S+) .*? pos=(\S+) ", err)]


def _busy(fn) -> tuple:
    """(device busy ms, kernel launches) of fn() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # a span's record_function range also shows on the card's timeline, as
    # a user annotation: not a launch, and its time is not busy time
    ks = [e for e in prof.events()
          if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return sum(e.time_range.elapsed_us() for e in ks) / 1e3, len(ks)


def _step_on(net, where, pts, valid, gt, anchors) -> tuple:
    """One batch-1 `forward_backward` on `where`: (labels, loss,
    {name: grad}, running stats)."""
    from lidar_snow_sim_tpu_torch.models.detector_train import (
        forward_backward,
    )

    loss, _, stats, labels = forward_backward(
        net, pts[None].to(where), valid[None].to(where), gt[None].to(where),
        anchors.to(where))
    return (labels[0], loss,
            {n: p.grad for n, p in net.named_parameters()}, stats)


def training_phase(cloud, dev) -> None:
    """Phase 10: PointPillars training at the full width of
    PointPillarsConfig() with seeded random weights. The train CLI
    (python -m lidar_snow_sim_tpu_torch.tools.train --synthetic 8 --batch 4
    --device cuda), float32 and then bfloat16 with --augment: 4 steps
    straight, and 2 steps then --resume 2, as processes of their own.
    Gates: every step's loss finite with num_pos >= 1; the resumed run's
    checkpoint (params, mu, nu) equal to the straight run's byte for byte;
    one float32 step on the card against the CPU at batch 1 (labels equal
    but where a decision lies within 1e-5 of its threshold, loss within
    1e-4 relative, each gradient within 1e-3 of its largest value or
    within twice the CPU's own change under three 1e-7 weight
    perturbations, `_grad_gate`, the running stats within 1e-4); the
    bfloat16 run's
    params_tpu.npz through
    the infer CLI, and its predictions scored by the evaluate CLI against
    themselves, on the card as on the CPU; the experiment tool on
    the card, with kernels A1 and C1 launched by its snowify. Times each
    dtype's step in this process as the CLI runs it (CUDA events, median
    of 5 after 2 warm-ups), its device busy time and launches and those of
    its target assignment (torch.profiler), and its peak memory."""
    import contextlib
    import io

    import torch

    from lidar_snow_sim_tpu_torch.models import detector_augment as taug
    from lidar_snow_sim_tpu_torch.models import detector_train as tdt
    from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
    from lidar_snow_sim_tpu_torch.ops.occluders import find_occluders_window
    from lidar_snow_sim_tpu_torch.ops.pulse import window_pulse_peaks
    from lidar_snow_sim_tpu_torch.tools import evaluate, experiment, infer
    from lidar_snow_sim_tpu_torch.tools import train as ttrain
    from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line

    t_phase = time.time()
    root = Path(__file__).resolve().parent
    steps, batch = 4, 4
    base = [sys.executable, "-m", "lidar_snow_sim_tpu_torch.tools.train",
            "--synthetic", "8", "--batch", str(batch), "--steps", str(steps),
            "--device", dev.type, "--log-every", "1", "--save-every", "1000",
            "--seed", "0"]
    flags = {"float32": ["--dtype", "float32"],
             "bfloat16": ["--dtype", "bfloat16", "--augment"]}
    cfg0 = tpp.PointPillarsConfig()
    h, w = cfg0.feature_map_size
    n_anch = h * w * cfg0.num_anchors_per_loc

    class Frames:   # the CLI's arguments that _collect_frames reads
        synthetic, seed, max_points, max_gt = 8, 0, 65536, 64

    frames = ttrain._collect_frames(Frames, cfg0)
    anchors = torch.as_tensor(tpp.generate_anchors(cfg0)).reshape(-1, 7)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def run(name, dtype, *extra):
            return [*base, *flags[dtype], *extra, "--out", str(tmp / name)]

        t0 = time.time()
        logs = _run_all({
            f"{d}_{k}": run(f"{d}_{k}", d, *x) for d in flags
            for k, x in (("full", ()), ("part", ("--limit-steps", "2")))},
            root)
        logs.update(_run_all({f"{d}_resume": run(f"{d}_part", d, "--resume")
                              for d in flags}, root))
        cli_s = time.time() - t0
        for d in flags:
            got = _logged_steps(logs[f"{d}_full"])
            if [s for s, _, _ in got] != list(range(1, steps + 1)) or not all(
                    np.isfinite(loss) and pos >= 1 for _, loss, pos in got):
                fail(f"train {d}: steps, losses and positives {got}")
            resumed = _logged_steps(logs[f"{d}_resume"])
            if [s for s, _, _ in resumed] != [3, 4]:
                fail(f"train {d}: the resumed run logged {resumed}")
            with np.load(tmp / f"{d}_full" / "ckpt_0000004.npz") as a, \
                    np.load(tmp / f"{d}_part" / "ckpt_0000004.npz") as b:
                if sorted(a.files) != sorted(b.files):
                    fail(f"train {d}: the checkpoints' keys differ")
                differ = [k for k in a.files if k.startswith(
                    ("params/", "mu/", "nu/", "step", "count"))
                    and a[k].tobytes() != b[k].tobytes()]
                if differ:
                    fail(f"train {d}: --resume differs from the straight run "
                         f"in {len(differ)} arrays, e.g. {differ[:3]}")
            print(f"train CLI {d}: losses {[x[1] for x in got]} num_pos "
                  f"{[x[2] for x in got]} resume_equal True", flush=True)

        # the step as the CLI runs it, timed in this process
        timing = {}
        for d in flags:
            cfg = dataclasses.replace(cfg0, compute_dtype=d)
            step_fn, init = tdt.make_train_step(
                cfg, anchors, ttrain.make_schedule(10, 0.003))
            state = init(tpp.PointPillars(
                cfg, tpp.init_params(cfg, torch.Generator().manual_seed(0)),
                device=dev))

            def make_batch(it):
                idx = np.random.default_rng((0, it)).choice(
                    len(frames), batch, replace=False)
                pts = torch.as_tensor(np.stack([frames[i][0] for i in idx]),
                                      device=dev)
                gts = torch.as_tensor(np.stack([frames[i][1] for i in idx]),
                                      device=dev)
                if d == "bfloat16":
                    gen = torch.Generator().manual_seed(ttrain.step_seed(0,
                                                                         it))
                    pts, gts = taug.world_augment(pts, gts, *taug.world_draws(
                        gen, batch))
                return pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                       device=dev), gts

            times = []
            with ttrain.deterministic():
                for it in range(7):
                    args = make_batch(it)
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    state, metrics = step_fn(state, *args)
                    end.record()
                    end.synchronize()
                    if it >= 2:
                        times.append(start.elapsed_time(end))
                if not np.isfinite(float(metrics["loss"])):
                    fail(f"train {d}: a non-finite loss in the timed steps")
                args = make_batch(7)
                torch.cuda.reset_peak_memory_stats()
                base_mem = torch.cuda.memory_allocated()
                step_fn(state, *args)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                busy = _busy(lambda: step_fn(state, *args))
                with torch.no_grad():
                    assign = _busy(lambda: tdt.assign_batch(
                        anchors.to(dev), args[2], cfg))
            step_ms = float(np.median(times))
            timing[d] = dict(
                step_ms=round(step_ms, 4),
                steps_per_s=round(1000.0 / step_ms, 4),
                device_busy_ms=round(busy[0], 4), launches=busy[1],
                busy_share=round(busy[0] / step_ms, 4),
                assign_busy_ms=round(assign[0], 4),
                assign_launches=assign[1],
                assign_share=round(assign[0] / busy[0], 4),
                peak_mib=round(peak / 2**20, 1),
                base_mib=round(base_mem / 2**20, 1))
            print(f"train step {d}: card {card_line()!r} batch {batch} "
                  f"anchors {n_anch} {timing[d]}", flush=True)
            del state

        # one float32 step, the card against the CPU, at batch 1
        params = tpp.init_params(cfg0, torch.Generator().manual_seed(0))
        pts, gt = (torch.as_tensor(x) for x in frames[0])
        valid = torch.ones(len(pts), dtype=torch.bool)
        got = _step_on(tpp.PointPillars(cfg0, params, device=dev), dev, pts,
                       valid, gt, anchors)
        want = _step_on(tpp.PointPillars(cfg0, params, device="cpu"), "cpu",
                        pts, valid, gt, anchors)
        # the CPU's own gradients under 1e-7 relative weight perturbations
        noise = dict.fromkeys(want[2], 0.0)
        for seed in (1, 2, 3):
            gen = torch.Generator().manual_seed(seed)
            moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                     for k, v in params.items()}
            other = _step_on(tpp.PointPillars(cfg0, moved, device="cpu"),
                             "cpu", pts, valid, gt, anchors)[2]
            for n, g in other.items():
                noise[n] = max(noise[n], _rel_err(g, want[2][n]))
        near = _near_assignment(anchors, gt, cfg0, tol=1e-5)
        flips, unexplained = _label_flips(got[0], want[0], near)
        loss_err = _rel_err(got[1], want[1])
        grad_err = {n: _rel_err(g, want[2][n]) for n, g in got[2].items()}
        worst = max(grad_err, key=grad_err.get)
        bad = _grad_gate(grad_err, noise)
        stats_err = max(float((v.cpu() - want[3][k]).abs().max())
                        for k, v in got[3].items())
        over = [n for n, e in grad_err.items() if e > 1e-3]
        to_noise = max((grad_err[n] / max(noise[n], 1e-30) for n in over),
                       default=0.0)
        if unexplained or loss_err > 1e-4 or bad or stats_err > 1e-4:
            fail(f"train step card vs CPU: label flips {flips} unexplained "
                 f"{unexplained}, loss {loss_err}, gradients over the gate "
                 f"{[(n, grad_err[n], noise[n]) for n in bad]}, running "
                 f"stats {stats_err}")
        print(f"train step card vs cpu (float32, batch 1): positives "
              f"{int((want[0] > 0).sum())} ignored {int((want[0] < 0).sum())}"
              f" label_flips {flips} near {int(near.sum())} loss "
              f"{float(got[1])} cpu {float(want[1])} loss_rel_err {loss_err}"
              f" grad_max_rel_err {grad_err[worst]} ({worst}, cpu noise "
              f"{noise[worst]}) grads_over_1e-3 {len(over)} of "
              f"{len(grad_err)} cpu_noise_max {max(noise.values())} "
              f"cpu_noise_over_1e-3 {sum(e > 1e-3 for e in noise.values())} "
              f"max_err_to_noise_over_1e-3 {to_noise} "
              f"running_stats_max_abs_err {stats_err}", flush=True)

        # handoff: the trained params into the infer and evaluate CLIs
        scan = tmp / "scan.bin"
        cloud.astype(np.float32).tofile(scan)
        preds = tmp / "preds.txt"
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = infer.main([str(scan), "--params",
                             str(tmp / "bfloat16_full" / "params_tpu.npz"),
                             "--device", dev.type, "--predictions",
                             str(preds)])
        n_pred = json.loads(out.getvalue())["inference"]["num_predictions"]
        tables = {}
        for where in (dev.type, "cpu"):
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                evaluate.main(["--predictions", str(preds), "--labels",
                               str(preds), "--device", where, "--out",
                               str(tmp / f"table_{where}.json")])
            tables[where] = json.loads(
                (tmp / f"table_{where}.json").read_text())
        table = tables[dev.type]
        aps = [v for c in table["ap"].values() for m in c.values()
               for v in m.values()]
        if rc != 0 or table["det_boxes"] != n_pred or \
                json.dumps(table) != json.dumps(tables["cpu"]) or (
                    n_pred and not any(np.isfinite(aps))):
            fail(f"handoff: infer rc {rc}, {n_pred} predictions, tables "
                 f"{tables}")
        print(f"handoff: infer predictions {n_pred} scored against "
              f"themselves, card table == cpu table, ap "
              f"{ {c: v['3d'] for c, v in table['ap'].items()} }",
              flush=True)

        # the experiment tool on the card; its snowify runs W1 and W2 (the
        # JAX tool's window config)
        for fn in (find_occluders_window, window_pulse_peaks):
            fn.launches = 0
        t0 = time.time()
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = experiment.main([
                "--out", str(tmp / "exp.json"), "--work", str(tmp / "exp"),
                "--train-frames", "4", "--eval-frames", "2", "--steps", "4",
                "--finetune-steps", "2", "--batch", "2", "--device",
                dev.type])
        counts = {"W1": find_occluders_window.launches,
                  "W2": window_pulse_peaks.launches}
        art = json.loads((tmp / "exp.json").read_text())
        if rc not in (0, 1) or min(counts.values()) < 1 or \
                art["platform"] != dev.type or \
                art["datagen"]["train"]["removed"] < 1:
            fail(f"experiment: rc {rc} launches {counts} datagen "
                 f"{art['datagen']}")
        print(f"experiment: rc {rc} launches {counts} datagen "
              f"{art['datagen']} ap {art['ap_R40_moderate']} s "
              f"{time.time() - t0:.1f} | train CLI processes s {cli_s:.1f} "
              f"phase_s {time.time() - t_phase:.1f}", flush=True)


def server_phase(pc, sets, rr, occ, dev) -> None:
    """Phase 11: the viewer's live server on the card. The bench scan and
    its particle files under the viewer's prefix; tools.viewer's parser and
    tools.serve.make_server on --port 0, --device, --augment snow at the
    bench's rate (2.5 mm/h, 1.6 m/s), --random-params (the full-width
    PointPillarsConfig()), no --fov, served from a thread. Each request is
    sent twice: cold, then warm (the server's result cache emptied first,
    except for /infer, whose displayed cloud stays cached), with numpy's
    global seed set before every snow send and the launch counters zeroed.
    Gates: the codes (400 for an unknown augmentation, else 200); W1 and W2
    (the JAX CLI's window assembly) launched in each warm snow request, L1 in the warm LISA one; every
    /augment frame equal byte for byte to `_frame_payload` of run_pipeline
    with the same args and seed; both /infer answers equal to the boxes of
    `detect` called directly on the displayed cloud; the label counts
    summing to after_masks. Prints each request's wall ms (host clock
    around the HTTP call, then a synchronize) and the page's size."""
    import copy
    import threading
    import urllib.error
    import urllib.request

    import torch

    from lidar_snow_sim_tpu_torch.models.pointpillars import (
        detect,
        predictions_array,
    )
    from lidar_snow_sim_tpu_torch.ops.lut_lookup import lut_lookup_pairs
    from lidar_snow_sim_tpu_torch.ops.occluders import find_occluders_window
    from lidar_snow_sim_tpu_torch.ops.pulse import window_pulse_peaks
    from lidar_snow_sim_tpu_torch.tools.infer import prediction_boxes
    from lidar_snow_sim_tpu_torch.tools.inspect import run_pipeline
    from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line
    from lidar_snow_sim_tpu_torch.tools.serve import make_server
    from lidar_snow_sim_tpu_torch.tools.viewer import (
        _box_entries,
        _frame_payload,
        build_parser,
    )

    t_phase = time.time()
    counted = {"W1": find_occluders_window, "W2": window_pulse_peaks,
               "L1": lut_lookup_pairs}
    # (label, path, body or None for GET, numpy seed, code, kernels)
    requests = [
        ("GET /", "/", None, 100, 200, ("W1", "W2")),
        ("augment {}", "/augment", {}, 100, 200, ("W1", "W2")),
        ("augment seed 1", "/augment", {"seed": 1}, 101, 200, ("W1", "W2")),
        ("augment lisa", "/augment", {"augment": "lisa"}, None, 200,
         ("L1",)),
        ("infer {}", "/infer", {}, 100, 200, ()),
        ("augment bogus", "/augment", {"augment": "bogus"}, None, 400, ()),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scan = tmp / "scan.bin"
        pc.tofile(scan)
        banks = tmp / "banks"
        banks.mkdir()
        for i, part in enumerate(sets):
            np.save(banks / f"gunn_{rr}_{occ}_{i + 1}.npy", part)
        ap = build_parser()
        args = ap.parse_args([
            str(scan), "--serve", "--host", "127.0.0.1", "--port", "0",
            "--device", dev.type, "--augment", "snow", "--bank-dir",
            str(banks), "--rate", "2.5", "--velocity", "1.6",
            "--random-params"])
        srv = make_server(args, ap)
        app = srv.RequestHandlerClass.app
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = "http://%s:%d" % srv.server_address[:2]

        def send(path, body, seed):
            """(code, page text or JSON, wall ms, launches) of a request."""
            if seed is not None:
                np.random.seed(seed)
            for fn in counted.values():
                fn.launches = 0
            req = urllib.request.Request(
                url + path, method="GET" if body is None else "POST",
                data=None if body is None else json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    code, raw = r.status, r.read()
            except urllib.error.HTTPError as e:
                code, raw = e.code, e.read()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out = raw.decode() if body is None else json.loads(raw)
            return code, out, ms, {k: fn.launches for k, fn in
                                   counted.items()}

        report, answers = {}, {}
        try:
            for label, path, body, seed, want, kernels in requests:
                sends = []
                for warm in (False, True):
                    if warm and path != "/infer":
                        app._results.clear()
                        app._order.clear()
                    sends.append(send(path, body, seed))
                for code, out, _, launches in sends:
                    if code != want:
                        fail(f"server {label}: code {code}, not {want}: "
                             f"{str(out)[:300]}")
                launches = sends[1][3]
                if min((launches[k] for k in kernels), default=1) < 1:
                    fail(f"server {label}: a kernel of the path never "
                         f"launched in the warm request: {launches}")
                if sends[0][1] != sends[1][1]:
                    fail(f"server {label}: the warm answer differs from the "
                         "cold one")
                answers[label] = sends[1][1]
                report[label] = {"code": sends[1][0],
                                 "cold_ms": round(sends[0][2], 3),
                                 "warm_ms": round(sends[1][2], 3),
                                 "launches": launches}
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
        if thread.is_alive():
            fail("server: the serving thread did not stop")

        page = answers["GET /"]
        if 'id="inferbtn"' not in page or "const FRAMES" not in page:
            fail("server: the page lacks its live controls")
        # every frame against run_pipeline with the same args and seed
        cloud = None
        for label, path, body, seed, _, _ in requests[1:4]:
            fargs = copy.copy(args)
            for k, v in body.items():
                setattr(fargs, k, v)
            if seed is not None:
                np.random.seed(seed)
            pc_ref, rep, boxes = run_pipeline(fargs, ap)
            want = json.loads(json.dumps(
                _frame_payload(pc_ref, boxes, args.max_points)))
            got = answers[label]
            if got["frame"] != want:
                fail(f"server {label}: the frame differs from run_pipeline's")
            stats = got["stats"]
            if sum(stats["labels"].values()) != stats["after_masks"] or \
                    stats["after_masks"] != rep["after_masks"]:
                fail(f"server {label}: labels {stats['labels']} vs "
                     f"after_masks {stats['after_masks']}")
            if label == "augment {}":
                cloud = pc_ref
        # /infer: detect called directly on the displayed cloud
        cfg, net = app._get_engine()
        pts = np.asarray(cloud[:, :4], np.float32).copy()
        pts[:, 3] *= args.intensity_scale
        preds = detect(pts, None, net, device=dev)
        arr = predictions_array(preds)
        want = json.loads(json.dumps(_box_entries(
            None, prediction_boxes(arr, cfg.class_names))))
        inf = answers["infer {}"]
        if inf["boxes"] != want or \
                inf["stats"]["inference"]["input_points"] != len(pts) or \
                inf["stats"]["inference"]["num_predictions"] != len(arr):
            fail(f"server infer: {len(inf['boxes'])} boxes differ from "
                 f"detect's {len(want)}")
    print(f"server: card {card_line()!r} points {len(pc)} "
          f"after_masks {answers['augment {}']['stats']['after_masks']} "
          f"page_bytes {len(page.encode())} requests {report} "
          f"infer_predictions {len(arr)} phase_s "
          f"{time.time() - t_phase:.1f}", flush=True)


def window_occluder_bound(inputs, mask, window_size: int, k_occ: int):
    """bound() of a kernel-W1 call from this run's inputs (`ops/occluders.
    w1_inputs`), counted over the live points (`mask`; the padding rows,
    sorted last, are no consumer's work): their hit tests (window_size +
    n_wide candidates each); the bytes of their features, rows, starts and
    live flags, of the distinct bank columns their windows read (x, y, r,
    dist, the sort angle and pang: 6 rows), of the wide columns of the
    rows read (x, y, r, dist, pang), and of their outputs written once:
    (live, K) a1, a2, dist and valid, and the overflow."""
    import torch

    feats, row, lo, _, data_t, _, _, wang_t = inputs
    k_ext, n_wide = data_t.shape[2], wang_t.shape[2]
    lo, row = lo.long()[mask], row[mask]
    start = lo.clamp(0, k_ext - 1)
    cols = _runs(start, (torch.clamp(lo + window_size, max=k_ext) - start
                         ).clamp_min(1), row, k_ext)
    live = int(mask.sum())
    n_bytes = (live * ((feats.shape[1] + 2) * 4 + 1)
               + (cols * 6 + int(torch.unique(row).numel()) * n_wide * 5) * 4
               + live * (k_occ * 13 + 4))
    return bound(n_bytes, live * (window_size + n_wide) * HIT_TEST_OPS)


TRIG_OPS = 40   # one cos and sin pair of a pulse phase (phase_cos_sin)


def window_pulse_bound(inputs, mask, max_bumps: int, beam_rad: float,
                       ipm: int, c_tau: float):
    """bound() of a kernel-W2 call from this run's inputs (`ops/pulse.
    w2_inputs`), counted over the live points (`mask`; the padding rows
    are no consumer's work). Operations: each point's sweep, (2 nv + 2)^2
    compares to rank its endpoints and 2 nv (2 nv + 1) cover tests (nv
    valid occluders), the cos and sin of each selected bump's and of the
    target's phase (TRIG_OPS), and its waveform terms, WAVE_OPS for each
    bin of each walked window (the selected bumps' and the target's).
    Bytes, each read once: the live points' range and edges (3 feature
    floats), max_int, live flags and valid flags; a1 and a2 of the valid
    slots and the range of the selected bumps, each in the 32-byte sectors
    that hold them; the grid's cos and sin; the four (live,) outputs."""
    import torch

    from lidar_snow_sim_tpu_torch.ops.sweep import occlusion_sweep

    feats, _, a1, a2, dist, valid = inputs[:6]
    m_bins = inputs[-1].shape[0]
    k = a1.shape[1]
    live = int(mask.sum())
    valid = valid & mask[:, None]
    nv = valid.sum(dim=1).long()
    sweep_ops = int(((2 * nv + 2) ** 2 + 2 * nv * (2 * nv + 1))[mask].sum())
    ratio, _, _ = occlusion_sweep(feats[:, 1], feats[:, 2], a1, a2, valid,
                                  beam_rad)
    top, idx = torch.sort(ratio, dim=1, descending=True, stable=True)
    sel = torch.zeros_like(valid)
    sel.scatter_(1, idx[:, :max_bumps], top[:, :max_bumps] > 0)

    def bins(r):
        lo = torch.ceil(r * ipm).clamp(min=0)
        hi = torch.floor((r + c_tau) * ipm).clamp(max=m_bins - 1)
        return (hi - lo + 1).clamp_min(0)

    terms = float(torch.where(sel, bins(dist), 0).sum()
                  + torch.where(mask, bins(feats[:, 0]), 0).sum())
    trig = int(sel.sum()) + live
    n_bytes = ((live * 4 + m_bins * 2) * 4 + live * (k + 1)
               + 2 * _sector_bytes(valid) + _sector_bytes(sel) + live * 13)
    return bound(n_bytes, sweep_ops + terms * WAVE_OPS + trig * TRIG_OPS)


def window_spans(inp, k_ext: int, window: int, points: int) -> dict:
    """The bank columns kernel W1's CTAs of `points` consecutive points
    stage (csrc/occluders.cu, w1_kernel): for each CTA with a live point,
    the union [min lo, max lo + window - 1] (clamped to the row) of its
    live points on the row of its first one; their median and maximum, and
    the CTAs whose live points lie on two or more rows."""
    lo = inp.lo.cpu().numpy()
    row = inp.bank_row.cpu().numpy()
    live = inp.mask.cpu().numpy()
    widths, crossing = [], 0
    for c0 in range(0, len(lo), points):
        on = live[c0:c0 + points]
        if not on.any():
            continue
        r, lo_c = row[c0:c0 + points][on], lo[c0:c0 + points][on]
        mine = r == r[0]
        crossing += int(not mine.all())
        widths.append(int(np.clip(lo_c[mine] + window - 1, 0, k_ext - 1).max()
                          - np.clip(lo_c[mine], 0, k_ext - 1).min() + 1))
    return {"points": points, "median": float(np.median(widths)),
            "max": int(max(widths)), "ctas": len(widths),
            "crossing_rows": crossing}


# The proof that kernel W2's cos and sin (phase_cos_sin in csrc/pulse.cu)
# are torch's: every non-negative float32 (bit patterns 0 .. +inf), taken
# as the phase itself and times the pulse phase, in chunks of TRIG_CHUNK.
TRIG_CHUNK = 1 << 26
TRIG_LAST = 0x7F800000   # +inf
HALF_PLANE_LAST = 0x40E00000   # 7.0
# cos_positive's bounds (csrc/occluders.cu): the first float32 above pi/2
# and the last below 3 pi/2
HALF_PI_ABOVE = float(np.frombuffer(np.uint32(0x3FC90FDB).tobytes(),
                                    np.float32)[0])
THREE_HALF_PI_BELOW = float(np.frombuffer(np.uint32(0x4096CBE3).tobytes(),
                                          np.float32)[0])


def trig_proof(phase: float, dev, step: int = 1) -> dict:
    """Hold kernel W2's cos and sin (ops/pulse.trig_table) against
    torch.cos and torch.sin on the card: of x for every float32 x in [0,
    +inf] (bit patterns 0 .. 0x7f800000, every `step`-th), and of the
    phase product fl(phase * x), as torch takes it, for the same x. Equal
    means bitwise, NaN where NaN. Also kernel W1's half-plane rule
    (cos_positive in csrc/occluders.cu: |x| below the first float above
    pi/2 or above the last float below 3 pi/2) against torch.cos(x) > 0
    for every float32 x with |x| <= 7 (W1 takes it on x in [-2 pi,
    2 pi]).
    Returns, for each of the three tests, the values checked, the count
    that differ and the first that differs."""
    import torch

    from lidar_snow_sim_tpu_torch.ops.pulse import trig_table

    out = {}
    for name, scale in (("x", 1.0), ("phase_x", phase)):
        checked, differ, first = 0, 0, None
        for c0 in range(0, TRIG_LAST + 1, TRIG_CHUNK * step):
            n = min(TRIG_CHUNK, (TRIG_LAST - c0) // step + 1)
            x = (torch.arange(n, dtype=torch.int32, device=dev) * step
                 + c0).view(torch.float32)
            arg = x if scale == 1.0 else scale * x
            c, s = trig_table(c0, n, scale, dev, step=step)
            for got, want in ((c, torch.cos(arg)), (s, torch.sin(arg))):
                bad = (got != want) & ~(got.isnan() & want.isnan())
                nb = int(bad.sum())
                if nb and first is None:
                    k = int(torch.nonzero(bad)[0])
                    first = {"x": float(x[k]), "arg": float(arg[k]),
                             "got": float(got[k]), "want": float(want[k])}
                differ += nb
            checked += n
        out[name] = {"checked": checked, "differ": differ, "first": first}
    checked, differ, first = 0, 0, None
    for lo, hi in ((0, HALF_PLANE_LAST), (-(1 << 31), -(1 << 31)
                                          + HALF_PLANE_LAST)):
        for c0 in range(lo, hi + 1, TRIG_CHUNK * step):
            n = min(TRIG_CHUNK, (hi - c0) // step + 1)
            x = (torch.arange(n, dtype=torch.int32, device=dev) * step
                 + c0).view(torch.float32)
            a = x.abs()
            rule = (a < HALF_PI_ABOVE) | (a > THREE_HALF_PI_BELOW)
            bad = rule != (torch.cos(x) > 0)
            nb = int(bad.sum())
            if nb and first is None:
                first = {"x": float(x[int(torch.nonzero(bad)[0])])}
            differ += nb
            checked += n
    out["half_plane"] = {"checked": checked, "differ": differ,
                         "first": first}
    return out


def _first_diff(a, b) -> str:
    """Where two tensors first differ, and their values there."""
    import torch

    d = torch.nonzero((a != b) & ~(a.isnan() & b.isnan())
                      if a.is_floating_point() else a != b)
    at = tuple(d[0].tolist())
    return f"{len(d)} entries, first at {at}: {a[at].item()} vs {b[at].item()}"


def _same(a, b) -> bool:
    """Equal tensors, NaN where NaN."""
    import torch

    return torch.equal(a, b) or (a.is_floating_point() and torch.equal(
        a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num()))


def window_kernels(label, srt, bank, calib, cfg, order, plane, dev,
                   measure: bool = False) -> dict:
    """Phase 12's kernel checks at `cfg`: kernel W1 and then W2 on the
    window assembly's inputs for the channel-sorted scan `srt`, held
    against their plain versions on the card, every output equal (a peak
    NaN where the other is), without a live mask and with the scan's mask
    as it (the padding rows empty), and the counters they give. With
    `measure`: each one's ms (W1's call making the feature rows W2 then
    reads), plain_ms, bound and device times (timed), the device times of
    the calls without the live mask (every padding row computed), and the
    staged spans of W1's CTAs (window_spans)."""
    import torch

    from lidar_snow_sim_tpu_torch import pad_cloud
    from lidar_snow_sim_tpu_torch.config import SPEED_OF_LIGHT
    from lidar_snow_sim_tpu_torch.models import snowfall as ts
    from lidar_snow_sim_tpu_torch.ops import occluders as occ_ops
    from lidar_snow_sim_tpu_torch.ops import pulse as pulse_ops

    padded = pad_cloud(srt, cfg.max_points)
    bank_t = ts.bank_to_torch(bank, dev)
    inp = ts.window_inputs(
        torch.as_tensor(padded.points, device=dev),
        torch.as_tensor(padded.mask, device=dev), bank_t,
        ts.calib_to_torch(calib, dev), torch.as_tensor(order, device=dev),
        None, cfg, plane=plane)
    calls = {}
    for live in (False, True):
        tag = f"W1 {label}{' live' if live else ''}"
        args, kw = ts.window_occluder_call(inp, bank_t, cfg)
        if not live:
            kw["live"] = None   # every row
        occ = occ_ops.find_occluders_window(*args, **kw)
        occ_p = occ_ops.occluders_window_plain(*args, **kw)
        for name, a, b in zip(("a1", "a2", "dist", "valid", "overflow"),
                              occ, occ_p):
            if not torch.equal(a, b):
                fail(f"{tag}: {name} differs from the plain version: "
                     f"{_first_diff(a, b)}")
        pargs, pkw = ts.window_pulse_call(inp, occ, cfg)
        pkw["live"] = kw["live"]
        pk = pulse_ops.window_pulse_peaks(*pargs, **pkw)
        pk_p = pulse_ops.window_pulse_plain(*pargs, **pkw)
        for name, a, b in zip(("peak", "bin", "touched", "bump_overflow"),
                              pk, pk_p):
            if not _same(a, b):
                fail(f"W2 {label}{' live' if live else ''}: {name} differs "
                     f"from the plain version: {_first_diff(a, b)}")
        calls[live] = (args, kw, occ, pargs, pkw, pk)
    args, kw, occ, pargs, pkw, pk = calls[True]
    m = inp.mask
    out = {"points": int(m.sum()), "hits": int(occ[3][m].sum()),
           "touched": int(pk[2][m].sum()),
           "occluder_overflow": int(occ[4][m].sum()),
           "bump_overflow": int(pk[3][m].sum())}
    if measure:
        w1_kw = dict(window_size=kw["window_size"], delta=kw["delta"],
                     k_occ=kw["k_occ"])
        w2_kw = dict(beam_rad=pkw["beam_rad"], ipm=pkw["ipm"],
                     tau_h=pkw["tau_h"], max_bumps=pkw["max_bumps"])
        ins = {}
        for live, (a_, k_, _, pa_, pk_, _) in calls.items():
            ins[live] = (
                occ_ops.w1_inputs(*a_, live=k_["live"]),
                pulse_ops.w2_inputs(*pa_, tau_h=pk_["tau_h"],
                                    live=pk_["live"]))
        ins1, ins2 = ins[True]
        xyz = inp.xyz

        def w1_call():
            # the scan makes the feature rows once, for W1 and W2: W1's
            # call is timed with them
            feats = occ_ops.point_features(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                           cfg.beam_divergence_rad)
            return occ_ops.find_occluders_window(feats, *args[1:], **kw)

        out["W1"] = dict(
            ms=time_ms(w1_call),
            plain_ms=time_ms(lambda: occ_ops.occluders_window_plain(
                *args, **kw), reps=3, warmup=1),
            bound=window_occluder_bound(ins1, m, cfg.window_size,
                                        cfg.max_occluders),
            times=timed("W1", lambda: occ_ops.launch_w1(ins1, **w1_kw),
                        "w1_kernel"),
            ungated=timed("W1 without the live mask",
                          lambda: occ_ops.launch_w1(ins[False][0], **w1_kw),
                          "w1_kernel"))
        out["W2"] = dict(
            ms=time_ms(lambda: pulse_ops.window_pulse_peaks(*pargs, **pkw)),
            plain_ms=time_ms(lambda: pulse_ops.window_pulse_plain(
                *pargs, **pkw), reps=3, warmup=1),
            bound=window_pulse_bound(
                ins2, m, cfg.max_bumps, cfg.beam_divergence_rad,
                cfg.intervals_per_meter, SPEED_OF_LIGHT * cfg.tau_h),
            times=timed("W2", lambda: pulse_ops.launch_w2(ins2, **w2_kw),
                        "w2_kernel"),
            ungated=timed("W2 without the live mask",
                          lambda: pulse_ops.launch_w2(ins[False][1], **w2_kw),
                          "w2_kernel"))
        out["spans"] = [window_spans(inp, bank_t.data_t.shape[2],
                                     cfg.window_size, pts)
                        for pts in (16, 32, 64)]
    return out


# the window scan on the card before kernels W1 and W2, plain torch with
# the sweep's claims summed by sum(dim=2) (this phase on an NVIDIA H100
# 80GB HBM3, 700.00 W)
WINDOW_PLAIN_BEFORE = {"ms": 324.953, "launches": 28885}


def window_phase(pc, sets, calib, dev) -> list:
    """Phase 12: the window assembly on the card, on its kernels W1 and W2.
    (a) W1 and W2 against their plain versions, exactly, with and without
    the scan's mask as their live mask, at three configs on the
    channel-sorted bench scan: the JAX inspect CLI's (window_size 256,
    wide_capacity 128, max_occluders 64, max_bumps 32, point_chunk 2048;
    measured, with W1's staged spans), the JAX experiment's (128, 16, 24,
    16) and a starved one (the inspect CLI's with max_occluders 2 and
    max_bumps 1), whose occluder and bump overflows must both be nonzero;
    then W2's cos and sin against torch's on every non-negative float32
    (trig_proof). (b) SnowfallAugmenter
    with the inspect CLI's window config and with the dense assembly (the
    layout the port's inspect CLI took before) on the same order and draws:
    outputs and stats equal byte for byte, every counter 0. (c) One
    window scan (snowfall_augment) with every launch counter zeroed before:
    W1, W2 and P2 (the plane is given, so no P1) once each and no other
    kernel of the port; its result equal
    byte for byte to the plain window path on the card (window_augment,
    plain=True), and within the parity contract of the CPU's with one
    injected plane (RANSAC fitted once on the CPU). Prints the window
    scan's ms (CUDA events, median of 5), launches and busy share
    (torch.profiler's device time over the scan's ms) beside the plain
    window path's, the dense assembly's and the plain scan before the
    kernels (WINDOW_PLAIN_BEFORE). Returns
    W1's and W2's records for the kernels line."""
    import torch

    from lidar_snow_sim_tpu_torch import SnowfallConfig, build_bank, pad_cloud
    from lidar_snow_sim_tpu_torch.models import snowfall as ts
    from lidar_snow_sim_tpu_torch.ops import occluders as occ_ops
    from lidar_snow_sim_tpu_torch.ops import pulse as pulse_ops
    from lidar_snow_sim_tpu_torch.ops.fitting import (
        ransac_draws,
        ransac_plane,
    )
    from lidar_snow_sim_tpu_torch.ops.laser import noise_floor_at
    from lidar_snow_sim_tpu_torch.ops.lut_lookup import lut_lookup_pairs
    from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line

    t_phase = time.time()
    srt = np.ascontiguousarray(pc[np.argsort(pc[:, 4], kind="stable")])
    cap = 1 << int(np.ceil(np.log2(len(srt))))
    pch = max(cap // 64, 256)
    common = dict(max_points=cap, window_size=256, wide_capacity=128,
                  max_occluders=64, max_bumps=32, point_chunk=2048)
    cfgs = {"window": SnowfallConfig(**common),
            "dense": SnowfallConfig(
                **common, assembly="dense", channel_capacity=pch,
                block_points=max(min(128, pch // 8), 32))}
    wcfg = cfgs["window"]
    exp_cfg = SnowfallConfig(
        max_points=cap, window_size=128, wide_capacity=16, max_occluders=24,
        max_bumps=16, point_chunk=2048,
        channel_capacity=max(cap // 32, 128))
    starved = dataclasses.replace(wcfg, max_occluders=2, max_bumps=1)

    def bank_for(cfg):
        return build_bank(sets, window_size=cfg.window_size,
                          wide_threshold=cfg.wide_threshold,
                          wide_capacity=cfg.wide_capacity)

    bank, exp_bank = bank_for(wcfg), bank_for(exp_cfg)
    order = np.random.default_rng(0).permutation(64)
    padded = pad_cloud(srt, cap)
    draws = ransac_draws(0, wcfg.ransac_trials)
    w, h = ransac_plane(torch.as_tensor(padded.points[:, :3]),
                        torch.as_tensor(padded.mask), draws)
    plane = {d: (w.to(d), h.to(d)) for d in (dev.type, "cpu")}

    # (a) the kernels against their plain versions at three configs
    checks = {
        "inspect": window_kernels("inspect", srt, bank, calib, wcfg, order,
                                  plane[dev.type], dev, measure=True),
        "experiment": window_kernels("experiment", srt, exp_bank, calib,
                                     exp_cfg, order, plane[dev.type], dev),
        "starved": window_kernels("starved", srt, bank, calib, starved,
                                  order, plane[dev.type], dev),
    }
    if not (checks["starved"]["occluder_overflow"] > 0
            and checks["starved"]["bump_overflow"] > 0):
        fail(f"window starved config: overflows {checks['starved']}")
    print(f"window kernels: card {card_line()!r} equal_to_plain True "
          f"with_and_without_live_mask True "
          + " ".join(f"{k} { {n: v for n, v in c.items() if n[0] != 'W'} }"
                     for k, c in checks.items()), flush=True)
    t0 = time.time()
    proof = trig_proof(pulse_ops.pulse_phase(wcfg.tau_h), dev)
    if any(v["differ"] for v in proof.values()):
        fail(f"kernel W2's cos/sin or W1's half-plane rule differ from "
             f"torch's: {proof}")
    print(f"window trig proof: card {card_line()!r} cos and sin of every "
          f"float32 in [0, inf] and of its pulse phase equal torch's, W1's "
          f"half-plane rule equals torch.cos > 0 on |x| <= 7 "
          f"{proof} seconds {time.time() - t0:.1f}", flush=True)

    # (b) SnowfallAugmenter: the window assembly against the dense one
    outs, grown = {}, {}
    for name, cfg in cfgs.items():
        aug = ts.SnowfallAugmenter(bank=bank, calib=calib, cfg=cfg, seed=0,
                                   device=dev)
        stats, out = aug(srt, order=order)
        counters = {n: int(getattr(aug.last_result, n))
                    for n in ts.OVERFLOW_COUNTERS}
        if any(counters.values()):
            fail(f"window phase {name}: counters {counters}")
        outs[name] = (stats, out)
        grown[name] = aug.cfg != cfg
    if outs["window"][0] != outs["dense"][0] or \
            outs["window"][1].tobytes() != outs["dense"][1].tobytes():
        fail(f"window and dense assemblies differ: stats "
             f"{outs['window'][0]} vs {outs['dense'][0]}, rows "
             f"{len(outs['window'][1])} vs {len(outs['dense'][1])}")

    # (c) one window scan: its launches, the plain path, the CPU
    def args_on(d, cfg):
        return (torch.as_tensor(padded.points, device=d),
                torch.as_tensor(padded.mask, device=d),
                ts.bank_to_torch(bank, d), ts.calib_to_torch(calib, d),
                torch.as_tensor(order, device=d), draws.to(d), cfg)

    counted = {"W1": occ_ops.find_occluders_window,
               "W2": pulse_ops.window_pulse_peaks,
               "A1": occ_ops.find_occluders,
               "A2": occ_ops.find_occluders_routed,
               "A3": occ_ops.find_occluders_banded,
               "A4a": occ_ops.find_occluders_t,
               "A4b": occ_ops.find_occluders_pair,
               "C1": pulse_ops.pulse_peaks, "C2": pulse_ops.pulse_peaks_pair,
               "L1": lut_lookup_pairs, "P1": ransac_plane,
               "P2": noise_floor_at}
    a = args_on(dev.type, wcfg)
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    got = ts.snowfall_augment(*a, plane=plane[dev.type])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    # the plane is given: the preamble runs P2 alone
    if launches != dict(dict.fromkeys(counted, 0), W1=1, W2=1, P2=1):
        fail(f"a window scan launched {launches}, not W1, W2 and P2 once "
             f"each")
    want = ts.window_augment(*a, plane=plane[dev.type], plain=True)
    for name, x, y in zip(ts.SnowfallResult._fields, got, want):
        if not torch.equal(x, y):
            fail(f"window scan: {name} differs from the plain window path: "
                 f"{_first_diff(x, y)}")
    cpu = ts.snowfall_augment(*args_on("cpu", wcfg), plane=plane["cpu"])
    n = len(srt)
    differ, xyz_err = _card_cpu_parity("window card vs CPU", got, cpu, n)

    timing = {}
    runs = {"window": lambda: ts.snowfall_augment(*a, plane=plane[dev.type]),
            "window_plain": lambda: ts.window_augment(
                *a, plane=plane[dev.type], plain=True)}
    ad = args_on(dev.type, cfgs["dense"])
    runs["dense"] = lambda: ts.snowfall_augment(*ad, plane=plane[dev.type])
    for name, fn in runs.items():
        ms = time_ms(fn, reps=5, warmup=1)
        busy, n_launch = _busy(fn)
        timing[name] = {"ms": round(ms, 3), "launches": n_launch,
                        "busy_ms": round(busy, 3),
                        "busy_share": round(busy / ms, 3)}
    print(f"window: card {card_line()!r} points {n} cap {cap} stats "
          f"{outs['window'][0]} rows {len(outs['window'][1])} "
          f"equal_to_dense True grown {grown} kernel_launches {launches} "
          f"equal_to_plain_path True vs_cpu_differing {differ} "
          f"xyz_max_abs_err {xyz_err} {timing} plain_before_kernels "
          f"{WINDOW_PLAIN_BEFORE} phase_s {time.time() - t_phase:.1f}",
          flush=True)
    m = checks["inspect"]
    return [record(f"{k} " + ("window occluders (window assembly)"
                              if k == "W1" else
                              "window sweep and pulse peak (window assembly)"),
                   f"lidar_snow_sim_tpu_torch/csrc/"
                   f"{'occluders' if k == 'W1' else 'pulse'}.cu",
                   "lidar_snow_sim_tpu/models/snowfall.py:"
                   + ("112" if k == "W1" else "151"),
                   launches[k], 0.0, m[k]["ms"], m[k]["plain_ms"],
                   m[k]["bound"], m[k]["times"],
                   replaces_kind="XLA-fused in lax.map (no Pallas kernel)")
            for k in ("W1", "W2")]


def preamble_bound(n: int, n_live: int, trials: int, n_crop: int):
    """((bound_ms, bound_by) of P1, of P2): P1 reads the mask, the live
    rows' xyz and the draws and tests every trial on every crop point (6
    operations); P2 reads the mask, every range and the live rows' xyz and
    intensity, writes every floor, and makes ~40 operations a live row."""
    p1 = bound(n + 12 * n_live + 12 * trials, 6 * trials * n_crop)
    p2 = bound(9 * n + 16 * n_live, 40 * n_live)
    return p1, p2


def preamble_phase(pc, dev) -> list:
    """Phase 17: kernels P1 and P2 on the bench scan padded to 65,536 rows
    and channel-sorted (the window scan's layout), held against their
    plain versions on the card, then timed beside them, and the whole
    preamble (`_plane_and_noise`) on the kernels against the plain
    composition. Returns P1's and P2's records for the kernels line."""
    import torch

    from lidar_snow_sim_tpu_torch import SnowfallConfig, pad_cloud
    from lidar_snow_sim_tpu_torch.models import snowfall as ts
    from lidar_snow_sim_tpu_torch.ops import fitting, laser
    from lidar_snow_sim_tpu_torch.ops.geometry import norm3
    from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line

    srt = np.ascontiguousarray(pc[np.argsort(pc[:, 4], kind="stable")])
    padded = pad_cloud(srt, 65536)
    pts = torch.as_tensor(padded.points, device=dev)
    mask = torch.as_tensor(padded.mask, device=dev)
    xyz, intensity, dist = pts[:, :3], pts[:, 3], norm3(pts[:, :3])
    cfg = SnowfallConfig()
    draws = fitting.ransac_draws(0, cfg.ransac_trials).to(dev)

    out, info = fitting.ransac_plane_p1(xyz, mask, draws)
    crop, med, mad, inliers = fitting.ransac_trials_plain(xyz, mask, draws)
    counts = inliers.sum(dim=1)
    if not (int(info[0]) == int(crop.sum()) and torch.equal(out[4], med)
            and torch.equal(out[5], mad)
            and torch.equal(info[2:].long(), counts)
            and int(info[1]) == int(torch.argmax(counts))):
        fail(f"P1: crop {int(info[0])} vs {int(crop.sum())}, median/MAD "
             f"{out[4:6].tolist()} vs {[float(med), float(mad)]}, trial "
             f"{int(info[1])} vs {int(torch.argmax(counts))}")
    w, h = fitting.ransac_plane_plain(xyz, mask, draws)
    w_err = max(float((out[:3] - w).abs().max()), float((out[3] - h).abs()))
    if w_err > 1e-6:
        fail(f"P1: (w, h) {out[:4].tolist()} vs {w.tolist()}, {float(h)}")
    noise, stats, ground = laser.noise_floor_p2(xyz, intensity, mask, dist,
                                                (w, h), cfg)
    g, incident = laser.ground_and_incidence(xyz, mask, dist, (w, h),
                                             cfg.ground_delta)
    bins, y_hi = laser.noise_floor_bins(norm3(xyz),
                                        intensity / torch.cos(incident), g)
    want = laser.noise_floor_at_plain(xyz, intensity, mask, dist, (w, h),
                                      cfg)
    noise_err = float(((noise - want).abs() / want.abs().clamp_min(1.0))
                      .max())
    if not (torch.equal(ground != 0, g) and torch.equal(stats[1], y_hi)
            and torch.equal(stats[10:60].long(), bins)) or noise_err > 1e-4:
        fail(f"P2: ground {int(((ground != 0) != g).sum())} differ, y_hi "
             f"{float(stats[1])} vs {float(y_hi)}, bins equal "
             f"{torch.equal(stats[10:60].long(), bins)}, floor {noise_err}")

    fitting.ransac_plane.launches = laser.noise_floor_at.launches = 0
    ts._plane_and_noise(xyz, intensity, mask, dist, draws, cfg, None)
    torch.cuda.synchronize()
    launches = {"P1": fitting.ransac_plane.launches,
                "P2": laser.noise_floor_at.launches}
    if launches != {"P1": 1, "P2": 1}:
        fail(f"a preamble launched {launches}, not P1 and P2 once each")

    def plain_preamble():
        plane = fitting.ransac_plane_plain(xyz, mask, draws)
        return laser.noise_floor_at_plain(xyz, intensity, mask, dist, plane,
                                          cfg)

    preamble = {}
    for name, fn in (("kernels", lambda: ts._plane_and_noise(
            xyz, intensity, mask, dist, draws, cfg, None)),
            ("plain", plain_preamble)):
        busy, n_launch = _busy(fn)
        preamble[name] = {"ms": round(time_ms(fn, reps=5, warmup=1), 4),
                          "launches": n_launch, "busy_ms": round(busy, 4)}
    n_live = int(mask.sum())
    b1, b2 = preamble_bound(65536, n_live, cfg.ransac_trials,
                            int(crop.sum()))
    p1 = dict(ms=time_ms(lambda: fitting.ransac_plane_p1(xyz, mask, draws)),
              plain_ms=time_ms(lambda: fitting.ransac_plane_plain(
                  xyz, mask, draws), reps=3, warmup=1),
              times=timed("P1", lambda: fitting.ransac_plane_p1(
                  xyz, mask, draws), "p1_kernel"))
    p2 = dict(ms=time_ms(lambda: laser.noise_floor_p2(
                  xyz, intensity, mask, dist, (w, h), cfg)),
              plain_ms=time_ms(lambda: laser.noise_floor_at_plain(
                  xyz, intensity, mask, dist, (w, h), cfg), reps=3,
                  warmup=1),
              times=timed("P2", lambda: laser.noise_floor_p2(
                  xyz, intensity, mask, dist, (w, h), cfg), "p2_kernel"))
    print(f"preamble: card {card_line()!r} points {n_live} rows 65536 crop "
          f"{int(crop.sum())} ground {int(g.sum())} p1_equal_to_plain True "
          f"w_h_max_abs_err {w_err} p2_bins_equal True floor_max_rel_err "
          f"{noise_err} launches {launches} {preamble}", flush=True)
    src = "lidar_snow_sim_tpu_torch/csrc/preamble.cu"
    return [record("P1 RANSAC ground plane (snowfall preamble)", src,
                   "lidar_snow_sim_tpu/ops/fitting.py ransac_plane", 1,
                   w_err, p1["ms"], p1["plain_ms"], b1, p1["times"],
                   replaces_kind="XLA-fused (no Pallas kernel)"),
            record("P2 noise floor at every point (snowfall preamble)", src,
                   "lidar_snow_sim_tpu/ops/laser.py "
                   "estimate_laser_parameters", 1, noise_err, p2["ms"],
                   p2["plain_ms"], b2, p2["times"],
                   replaces_kind="XLA-fused (no Pallas kernel)")]


PARITY_STATS = dict(num_attenuated=29, num_removed=847,
                    avg_intensity_diff=194)   # PARITY_TPU.json's, the oracle's
PARITY_VARIANTS = ("window", "dense_pallas", "dense_pallas_routed")


def _parity_gate(report: dict, launches: dict) -> list:
    """Phase 13's gates on a tools/parity_gpu report and the launches
    counted around its run: ok, the oracle's stats, the three variants each
    with no overflow, 0 unexplained mismatches and a rate under 0.002, and
    A1, A2, C1 (the dense variants) and W1, W2 (the window variant)
    launched. Returns the failures (none when all hold)."""
    bad = []
    if report.get("ok") is not True:
        bad.append("the report is not ok")
    if report.get("oracle_stats") != PARITY_STATS:
        bad.append(f"oracle_stats {report.get('oracle_stats')}")
    variants = report.get("assemblies", {})
    if tuple(variants) != PARITY_VARIANTS:
        bad.append(f"variants {list(variants)}")
    for name, a in variants.items():
        if any(a["overflows"].values()):
            bad.append(f"{name}: overflows {a['overflows']}")
        if a["num_unexplained"] != 0 or not a["mismatch_rate"] < 0.002:
            bad.append(f"{name}: {a['num_unexplained']} unexplained, "
                       f"mismatch rate {a['mismatch_rate']}")
    for kernel in ("A1", "A2", "C1", "W1", "W2"):
        if launches.get(kernel, 0) < 1:
            bad.append(f"{kernel} never launched")
    return bad


def parity_phase(dev) -> None:
    """Phase 13: tools/parity_gpu on the card (the JAX parity tool's scene,
    5,727 points; window, dense on A1 and C1, span-routed dense on A2 in
    both modes and C1) into a temporary report, the launch counters zeroed
    before and read after; every gate of _parity_gate. Prints each
    variant's mismatch counts with the card's name and power limit."""
    from lidar_snow_sim_tpu_torch.ops.occluders import (
        find_occluders,
        find_occluders_routed,
        find_occluders_window,
    )
    from lidar_snow_sim_tpu_torch.ops.pulse import (
        pulse_peaks,
        window_pulse_peaks,
    )
    from lidar_snow_sim_tpu_torch.tools import parity_gpu

    t_phase = time.time()
    counted = {"A1": find_occluders, "A2": find_occluders_routed,
               "C1": pulse_peaks, "W1": find_occluders_window,
               "W2": window_pulse_peaks}
    for fn in counted.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "PARITY_GPU.json"
        rc = parity_gpu.main([str(out), "--device", dev.type])
        report = json.loads(out.read_text())
    launches = {k: fn.launches for k, fn in counted.items()}
    bad = _parity_gate(report, launches)
    if rc != 0 or bad:
        fail(f"parity phase: exit {rc}, {bad}")
    counts = {name: {"mismatches": a["num_mismatches"],
                     "unexplained": a["num_unexplained"],
                     "rate": a["mismatch_rate"]}
              for name, a in report["assemblies"].items()}
    print(f"parity: card {report['card']!r} torch {report['torch']} points "
          f"{report['points']} oracle_stats "
          f"{tuple(report['oracle_stats'].values())} {counts} launches "
          f"{launches} phase_s {time.time() - t_phase:.1f}", flush=True)


def _grid_combos() -> list:
    """(mode, snowfall rate, terminal velocity) of phase 14: gunn's five
    precompute pairs and sekhon's lightest rainfall rate only, the choice of
    tests/test_reference_grid.py:54-59."""
    from lidar_snow_sim_tpu_torch.sampling.distributions import (
        snowfall_rate_to_rainfall_rate,
    )
    from lidar_snow_sim_tpu_torch.tools.precompute import (
        SNOWFALL_RATES,
        TERMINAL_VELOCITIES,
    )

    pairs = list(zip(SNOWFALL_RATES, TERMINAL_VELOCITIES))
    lightest = min(pairs, key=lambda p: snowfall_rate_to_rainfall_rate(*p))
    return [("gunn", s, v) for s, v in pairs] + [("sekhon", *lightest)]


def _card_cpu_parity(name, g, c, n: int) -> tuple:
    """Hold a SnowfallResult from the card against the CPU's on the same
    inputs (the parity contract): every overflow counter equal; labels,
    intensities and keep equal on >= 99.8% of the n points, xyz within
    1e-4 elsewhere. Returns (points that differ, largest xyz error)."""
    from lidar_snow_sim_tpu_torch.models.snowfall import OVERFLOW_COUNTERS

    for counter in OVERFLOW_COUNTERS:
        if int(getattr(g, counter)) != int(getattr(c, counter)):
            fail(f"{name}: {counter} differs between the card and the CPU")
    gp = np.asarray(g.planes.cpu())[:, :n]
    cp = np.asarray(c.planes.cpu())[:, :n]
    off = (gp[3:] != cp[3:]).any(axis=0) | (
        np.asarray(g.keep.cpu())[:n] != np.asarray(c.keep.cpu())[:n])
    xyz = np.abs(gp[:3] - cp[:3])[:, ~off]
    xyz_err = float(xyz.max()) if xyz.size else 0.0
    if off.mean() >= 0.002 or xyz_err > 1e-4:
        fail(f"{name}: {int(off.sum())} of {n} points differ between the "
             f"card and the CPU, xyz err {xyz_err}")
    return int(off.sum()), xyz_err


def grid_phase(calib, dev) -> None:
    """Phase 14: the reference grid. (a) The port's gen_banks in a
    subprocess per (mode, rate, velocity) of _grid_combos, 64 lines each
    (384 files, the native sampler only); (b) the precompute CLI on the
    card over those six combos: four synthetic_scan(870) scans and a split
    naming them, --batch 4, the CLI's other defaults (65,536 points, dense,
    capacities that self-tune, the camera FOV filter), the launch counters
    zeroed before; every frame written, labels in {0, 1, 2}, A1 and C1
    launched; (c) the first frame of gunn's lightest combo (the most
    particles) through batched_step on the card and on the CPU with the
    run's grown config, its datagen order and draws and the same bank:
    the parity contract, and the card's kept rows equal to the CLI's file.
    Prints the sampler's seconds, the mean particles a channel, the grown
    slice width and the scans/s of each combo beside the card's name and
    power limit. The bank files are deleted at the end."""
    import contextlib
    import io
    import subprocess

    import torch

    from lidar_snow_sim_tpu_torch import native, synthetic_scan
    from lidar_snow_sim_tpu_torch.camera import camera_fov_mask
    from lidar_snow_sim_tpu_torch.config import SnowfallConfig
    from lidar_snow_sim_tpu_torch.models.snowfall import (
        SnowfallResult,
        bank_to_torch,
        calib_to_torch,
    )
    from lidar_snow_sim_tpu_torch.ops.occluders import find_occluders
    from lidar_snow_sim_tpu_torch.ops.pulse import pulse_peaks
    from lidar_snow_sim_tpu_torch.parallel.batched import (
        batched_step,
        frame_draws,
    )
    from lidar_snow_sim_tpu_torch.parallel.datagen import frame_order_seed
    from lidar_snow_sim_tpu_torch.sampling.banks import load_bank_files
    from lidar_snow_sim_tpu_torch.sampling.distributions import (
        compute_occupancy,
        snowfall_rate_to_rainfall_rate,
    )
    from lidar_snow_sim_tpu_torch.tools import precompute
    from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line

    t_phase = time.time()
    combos = _grid_combos()
    root = Path(__file__).resolve().parent
    t0 = time.time()
    native.build()
    build_s = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        banks = tmp / "banks"
        sampler_s = {}
        for mode, s, v in combos:
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "lidar_snow_sim_tpu_torch.tools."
                 "gen_banks", "--out-dir", str(banks), "--rates", str(s),
                 "--velocities", str(v), "--modes", mode, "--lines", "64",
                 "--workers", "8"],
                cwd=root, capture_output=True, text=True, timeout=300)
            last = proc.stdout.strip().splitlines()[-1:]
            if proc.returncode != 0 or not last or \
                    "by the native sampler, 0 numpy-fallback files" \
                    not in last[0]:
                fail(f"gen_banks {mode} {s} {v}: exit {proc.returncode} "
                     f"{proc.stdout[-500:]} {proc.stderr[-1500:]}")
            sampler_s[f"{mode}_{s}_{v}"] = (
                float(last[0].rsplit(", ", 1)[1].rstrip("s")),
                round(time.time() - t0, 2))
        n_files = len(list(banks.glob("*.npy")))
        if n_files != 64 * len(combos):
            fail(f"gen_banks wrote {n_files} files, not {64 * len(combos)}")
        bank_mb = sum(f.stat().st_size for f in banks.glob("*.npy")) / 1e6

        lidar = tmp / "lidar_hdl64_strongest"
        lidar.mkdir()
        lines = []
        for k in range(4):
            synthetic_scan(n_azimuth=870, seed=k, calib=calib).tofile(
                lidar / f"scene_{k:05d}.bin")
            lines.append(f"scene,{k:05d}")
        (tmp / "split.txt").write_text("\n".join(lines) + "\n")
        common = ["--split", str(tmp / "split.txt"), "--lidar-dir",
                  str(lidar), "--bank-dir", str(banks), "--out-root",
                  str(tmp / "out"), "--batch", "4", "--device", dev.type]
        for fn in (find_occluders, pulse_peaks):
            fn.launches = 0
        t0 = time.time()
        for mode in ("gunn", "sekhon"):
            pairs = [(s, v) for m, s, v in combos if m == mode]
            argv = [*common, "--modes", mode,
                    "--rates", *(str(s) for s, _ in pairs),
                    "--velocities", *(str(v) for _, v in pairs)]
            with contextlib.redirect_stdout(io.StringIO()):
                if precompute.main(argv) != 0:
                    fail(f"precompute {mode} returned non-zero")
        datagen_s = time.time() - t0
        launches = {"A1": find_occluders.launches, "C1": pulse_peaks.launches}
        if min(launches.values()) < 1:
            fail(f"grid datagen: a kernel never launched: {launches}")

        report = {}
        for mode, s, v in combos:
            rr = snowfall_rate_to_rainfall_rate(s, v)
            occ = compute_occupancy(s, v)
            out_dir = (tmp / "out" / "snowfall_simulation" / mode
                       / f"{lidar.name}_rainrate_{int(rr)}")
            manifest = json.loads((out_dir / "_manifest.json").read_text())
            st = manifest["stats"]
            if st["frames_done"] != 4:
                fail(f"grid {mode} {s}: {st['frames_done']} frames written")
            for b in sorted(out_dir.glob("*.bin")):
                rows = np.fromfile(b, np.float32).reshape(-1, 5)
                if not np.isfinite(rows).all() or \
                        not set(np.unique(rows[:, 4])) <= {0.0, 1.0, 2.0}:
                    fail(f"grid {mode} {s}: {b.name} malformed")
            parts = [len(np.load(f, mmap_mode="r")) for f in
                     banks.glob(f"{mode}_{rr}_{occ}_*.npy")]
            report[f"{mode}_{s}_{v}"] = dict(
                sampler_s=sampler_s[f"{mode}_{s}_{v}"][0],
                particles=round(float(np.mean(parts)), 1),
                slice_width=manifest["config"]["slice_width"],
                growths=st["capacity_growths"],
                scans_per_s=round(st["frames_done"] / st["wall_s"], 3))

        # (c) gunn's lightest combo, one frame, card against the CPU
        mode, s, v = combos[0]
        rr = snowfall_rate_to_rainfall_rate(s, v)
        occ = compute_occupancy(s, v)
        out_dir = (tmp / "out" / "snowfall_simulation" / mode
                   / f"{lidar.name}_rainrate_{int(rr)}")
        cfg = SnowfallConfig(**json.loads(
            (out_dir / "_manifest.json").read_text())["config"])
        bank = load_bank_files(banks, f"{mode}_{rr}_{occ}",
                               window_size=cfg.window_size,
                               wide_threshold=cfg.wide_threshold,
                               wide_capacity=cfg.wide_capacity)
        sid = precompute.reference_sample_order(tmp / "split.txt")[0]
        scan = np.fromfile(lidar / f"{sid}.bin", np.float32).reshape(-1, 5)
        scan = scan[camera_fov_mask(scan[:, :3], None).numpy()]
        order, seed = frame_order_seed(0, sid, calib.num_lasers)
        draws = frame_draws(seed, cfg, None)[0]
        # the datagen's padding: zero rows past the scan
        points = np.zeros((1, cfg.max_points, 5), np.float32)
        points[0, :len(scan)] = scan
        res = {}
        for d in (dev.type, "cpu"):
            out = batched_step(
                torch.as_tensor(points, device=d),
                torch.arange(cfg.max_points, device=d)[None] < len(scan),
                bank_to_torch(bank, d), calib_to_torch(calib, d),
                torch.as_tensor(order[None], device=d),
                (draws[None].to(d), None), cfg)[0]
            res[d] = SnowfallResult(*(x[0] for x in out))
        differ, xyz_err = _card_cpu_parity("grid frame", res[dev.type],
                                           res["cpu"], len(scan))
        g = res[dev.type]
        keep = g.keep.cpu().numpy()
        kept = g.planes.cpu().numpy()[:, keep].T.copy()
        kept[:, 3] = np.round(kept[:, 3])
        written = np.fromfile(out_dir / f"{sid}.bin", np.float32)
        if kept.astype(np.float32).tobytes() != written.tobytes():
            fail(f"grid frame {sid}: the card's kept rows differ from the "
                 "CLI's file")
    print(f"grid: card {card_line()!r} native_build_s {build_s:.1f} files "
          f"{n_files} bank_mb {bank_mb:.1f} datagen_s {datagen_s:.1f} "
          f"launches {launches} combos {report} frame {sid} "
          f"({mode} {s} mm/h, {len(scan)} points) vs_cpu_differing {differ} "
          f"xyz_max_abs_err {xyz_err} equal_to_cli_file True phase_s "
          f"{time.time() - t_phase:.1f}", flush=True)


def _mesh_devices(n: int = 2) -> list:
    """n distinct cards where there are n, else the one card n times."""
    import torch

    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def _shard_launch_gate(calls: dict, shards: int, frames: int) -> list:
    """Phase 15's launch gate: `calls` maps each kernel (A1, C1) to the
    shards that launched it, with their counts. Every shard must launch
    each kernel, once a frame: `shards` shards, `frames` launches in
    all."""
    bad = []
    for name, per_thread in calls.items():
        if len(per_thread) != shards or sum(per_thread.values()) != frames \
                or min(per_thread.values(), default=0) < 1:
            bad.append(f"{name} launched {dict(per_thread)} over "
                       f"{shards} shards of {frames} frames")
    return bad


def _stats_gate(merged: list, locals_: list, fields) -> list:
    """Phase 15's all_hosts_stats gate: every rank's merged counters equal
    the sum of the ranks' local ones, exactly; the wall time stays
    local."""
    bad = []
    for rank, m in enumerate(merged):
        for f in fields:
            want = sum(loc[f] for loc in locals_)
            if m[f] != want:
                bad.append(f"rank {rank} {f} {m[f]} != {want}")
        if m["wall_s"] != locals_[rank]["wall_s"]:
            bad.append(f"rank {rank} wall_s {m['wall_s']} is not its own")
    return bad


def _stats_rank(rank, device, local: dict) -> dict:
    """A rank of phase 15's all_hosts_stats check: its made-up local
    counters (rank-dependent, one above 2^24) merged over the ranks."""
    import dataclasses as dc

    from lidar_snow_sim_tpu_torch.parallel.datagen import DatagenStats
    from lidar_snow_sim_tpu_torch.parallel.distributed import all_hosts_stats

    return dc.asdict(all_hosts_stats(DatagenStats(
        **_stats_local(local, rank))))


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _dp_step_rank(rank, device, world: int, frames: list, cfg, seed: int,
                  perturb: float = 0.0, sums: bool = False):
    """One float32 train step (Adam at 3e-3) of `cfg` (phase 15: the full
    width) over world ranks (data-parallel when world > 1) on this rank's
    share of `frames`, on `device`: rank 0's (metrics, gradients, running
    stats) as numpy. With `perturb`, the weights are moved by that
    relative amount (seeded), and with `sums` one process takes the BN
    statistics from reduced sums as the ranks do (`_bn_train`'s `reduce`,
    here the identity), to measure how far rounding alone moves the
    gradients."""
    import torch

    from lidar_snow_sim_tpu_torch.models import detector_train as tdt
    from lidar_snow_sim_tpu_torch.models import pointpillars as tpp

    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    params = tpp.init_params(cfg, torch.Generator().manual_seed(0))
    if perturb:
        gen = torch.Generator().manual_seed(seed)
        params = {k: v * (1 + perturb * torch.randn(v.shape, generator=gen))
                  if v.is_floating_point() else v for k, v in params.items()}
    step, init = tdt.make_train_step(cfg, tpp.generate_anchors(cfg),
                                     lambda it: 3e-3,
                                     data_parallel=world > 1)
    per = len(frames) // world
    mine = frames[rank * per:(rank + 1) * per]
    pts, gts = (torch.as_tensor(np.stack([f[i] for f in mine]),
                                device=device) for i in (0, 1))
    valid = torch.ones(pts.shape[:2], dtype=torch.bool, device=device)
    if sums:
        net = tpp.PointPillars(cfg, params, device=device)
        anchors = torch.as_tensor(tpp.generate_anchors(cfg)).reshape(-1, 7)
        _, metrics, stats, _ = tdt.forward_backward(
            net, pts, valid, gts, anchors.to(device), reduce=lambda t: t)
        _sync(device)
        return ({k: float(v) for k, v in metrics.items()},
                {k: p.grad.detach().cpu().numpy()
                 for k, p in net.named_parameters()},
                {k: v.detach().cpu().numpy() for k, v in stats.items()})
    state, metrics = step(init(tpp.PointPillars(cfg, params, device=device)),
                          pts, valid, gts)
    _sync(device)
    if rank != 0:
        return None
    stats = {k: v.detach().cpu().numpy() for k, v in
             state.net.state_dict().items() if "running" in k}
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.detach().cpu().numpy()
             for k, p in state.net.named_parameters()}, stats)


def _phase15_rank(rank, device, local: dict, frames: list, cfg) -> tuple:
    """Phase 15's two-rank process: the stats merge, then the data-parallel
    train step and the same step under three 1e-7 weight perturbations
    (rank 0's gradients: the data-parallel side's own sensitivity), with
    the rank's wall time of each step (the first builds the process's
    cuDNN state)."""
    merged = _stats_rank(rank, device, local)
    steps_s, outs = [], []
    for kw in [dict(seed=0)] + [dict(seed=s, perturb=1e-7)
                                for s in (1, 2, 3)]:
        _sync(device)
        t0 = time.perf_counter()
        outs.append(_dp_step_rank(rank, device, 2, frames, cfg, **kw))
        steps_s.append(time.perf_counter() - t0)
    return merged, outs[0], steps_s, [m and m[1] for m in outs[1:]]


def multi_gpu_phase(pc, sets, calib, dev) -> None:
    """Phase 15: the multi-device paths, on two cards where there are two,
    else on the one card twice. `make_sharded_step` on the bench scene at
    batch 4 (bench_batch's orders and seeds) over a (2, 1) mesh equal to
    `batched_step` byte for byte, with A1 and C1 launched once a frame
    on each shard; `run_snowfall_datagen(mesh=...)` over 4 scans writing
    the files of a run without one; in one two-rank process
    group, `all_hosts_stats` summing made-up counters (one above 2^24)
    exactly, and a full-width float32 data-parallel train step at batch 4
    (2 frames a rank) against the one-process step: loss within 1e-4
    relative, running stats within 1e-4, each gradient within 1e-3 of its
    largest value or twice the larger move that rounding alone makes on
    the card, of the one-process step's (three 1e-7 weight perturbations,
    statistics taken from sums) and of the data-parallel step's (the same
    perturbations) (`_grad_gate`); then the port's
    `tools/dryrun_multichip` at n = 2."""
    import collections
    import itertools
    import threading

    import torch

    from lidar_snow_sim_tpu_torch import build_bank, pad_cloud, synthetic_scan
    from lidar_snow_sim_tpu_torch.models import snowfall as tsnow
    from lidar_snow_sim_tpu_torch.models.snowfall import (
        bank_to_torch,
        calib_to_torch,
    )
    from lidar_snow_sim_tpu_torch.ops.occluders import find_occluders
    from lidar_snow_sim_tpu_torch.ops.pulse import pulse_peaks
    from lidar_snow_sim_tpu_torch.parallel import batched as tbatched
    from lidar_snow_sim_tpu_torch.parallel import distributed
    from lidar_snow_sim_tpu_torch.parallel.batched import (
        batched_step,
        frame_draws,
        make_sharded_step,
    )
    from lidar_snow_sim_tpu_torch.parallel.datagen import (
        DatagenStats,
        run_snowfall_datagen,
    )
    from lidar_snow_sim_tpu_torch.parallel.mesh import make_mesh
    from lidar_snow_sim_tpu_torch.tools import train as ttrain
    from lidar_snow_sim_tpu_torch.tools.dryrun_multichip import (
        dryrun_multichip,
    )
    from lidar_snow_sim_tpu_torch.tools.kernel_times import (
        bench_batch,
        bench_config,
        card_line,
    )

    t_phase = time.time()
    card = card_line()
    devices = _mesh_devices(2)
    mesh = make_mesh(2, 1, devices=devices)
    cfg = bench_config()
    bank = build_bank(sets, window_size=cfg.window_size,
                      wide_threshold=cfg.wide_threshold,
                      wide_capacity=cfg.wide_capacity)
    bank_t, calib_t = bank_to_torch(bank, dev), calib_to_torch(calib, dev)
    b = 4
    orders, seeds = bench_batch(b)
    padded = pad_cloud(pc, cfg.max_points)
    points = torch.as_tensor(np.stack([padded.points] * b), device=dev)
    mask = torch.as_tensor(np.stack([padded.mask] * b), device=dev)
    orders_t = torch.as_tensor(np.stack(orders), device=dev)
    draws = (torch.stack([frame_draws(s, cfg, None)[0] for s in seeds])
             .to(dev), None)
    want, _ = batched_step(points, mask, bank_t, calib_t, orders_t, draws,
                           cfg)
    step = make_sharded_step(mesh, cfg)
    step(points, mask, bank_t, calib_t, orders_t, draws)   # copies, builds
    torch.cuda.synchronize()

    # which shard launched each kernel: each shard's batched_step call
    # marks the host thread it runs on with the shard's number
    calls = {"A1": collections.Counter(), "C1": collections.Counter()}
    shard = threading.local()
    shards = itertools.count()
    threads = set()
    orig = {"find_occluders": tsnow.find_occluders,
            "pulse_peaks": tsnow.pulse_peaks,
            "batched_step": tbatched.batched_step}

    def marking(*args, **kw):
        shard.id = next(shards)
        threads.add(threading.get_ident())
        return orig["batched_step"](*args, **kw)

    def recording(name, fn):
        def wrapper(*args, **kw):
            calls[name][shard.id] += 1
            return fn(*args, **kw)
        return wrapper

    for fn in (find_occluders, pulse_peaks):
        fn.launches = 0
    tsnow.find_occluders = recording("A1", orig["find_occluders"])
    tsnow.pulse_peaks = recording("C1", orig["pulse_peaks"])
    tbatched.batched_step = marking
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = step(points, mask, bank_t, calib_t, orders_t, draws)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
    finally:
        tsnow.find_occluders = orig["find_occluders"]
        tsnow.pulse_peaks = orig["pulse_peaks"]
        tbatched.batched_step = orig["batched_step"]
    launches = {"A1": find_occluders.launches, "C1": pulse_peaks.launches}
    bad = _shard_launch_gate(calls, len(devices), b)
    if launches != {"A1": b, "C1": b}:
        bad.append(f"launch counters {launches}")
    differ = [f for f in tsnow.SnowfallResult._fields
              if not torch.equal(getattr(got, f).cpu(),
                                 getattr(want, f).cpu())]
    if bad or differ:
        fail(f"sharded step: {bad} fields differing {differ}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched_step(points, mask, bank_t, calib_t, orders_t, draws, cfg)
    torch.cuda.synchronize()
    unsharded_s = time.perf_counter() - t0
    print(f"sharded step: card {card!r} devices {[str(d) for d in devices]}"
          f" batch {b} equal_to_unsharded True launches {launches} "
          f"host_threads {len(threads)} "
          f"per_shard A1 {sorted(calls['A1'].values())} C1 "
          f"{sorted(calls['C1'].values())} scans_per_s sharded "
          f"{b / sharded_s:.4f} unsharded {b / unsharded_s:.4f}", flush=True)

    # mesh datagen: the same files as a run without a mesh
    scans = {f"m{i}": synthetic_scan(n_azimuth=870, seed=i, calib=calib)
             for i in range(4)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        runs = {}
        for name, kw in (("plain", dict(device=dev)), ("mesh",
                                                        dict(mesh=mesh))):
            t0 = time.time()
            stats = run_snowfall_datagen(
                sorted(scans), scans.__getitem__, tmp / name, bank, calib,
                cfg, batch=4, **kw)
            runs[name] = (stats, time.time() - t0)
        manifest = json.loads((tmp / "mesh" / "_manifest.json").read_text())
        same = all((tmp / "plain" / f"{s}.bin").read_bytes()
                   == (tmp / "mesh" / f"{s}.bin").read_bytes()
                   for s in scans)
        if not same or runs["mesh"][0].frames_done != 4 or \
                manifest.get("mesh") != mesh.shape:
            fail(f"mesh datagen: files equal {same}, {runs['mesh'][0]}, "
                 f"manifest mesh {manifest.get('mesh')}")
    print(f"mesh datagen: card {card!r} frames 4 files_equal True mesh "
          f"{mesh.shape} s plain {runs['plain'][1]:.2f} mesh "
          f"{runs['mesh'][1]:.2f} growths {runs['mesh'][0].capacity_growths}",
          flush=True)

    # two ranks: the stats merge, then the full-width data-parallel step
    class Frames:   # the train CLI's arguments that _collect_frames reads
        synthetic, seed, max_points, max_gt = 8, 0, 65536, 64

    det_cfg = _dp_config()
    frames = ttrain._collect_frames(Frames, det_cfg)[:4]
    local = dataclasses.asdict(DatagenStats(
        frames_done=3, frames_skipped=1, frames_failed=0,
        points_in=2**24 + 1, points_out=2**24 - 3, attenuated=7,
        removed=5, wall_s=0.0))
    local.pop("batches")
    t0 = time.time()
    ranks = distributed.spawn_ranks(_phase15_rank, devices, local, frames,
                                    det_cfg)
    ranks_s = time.time() - t0
    fields = ("frames_done", "frames_skipped", "frames_failed", "points_in",
              "points_out", "attenuated", "removed")
    locals_ = [_stats_local(local, r) for r in range(2)]
    bad = _stats_gate([r[0] for r in ranks], locals_, fields)
    if bad:
        fail(f"all_hosts_stats: {bad}")
    dp_m, dp_g, dp_stats = ranks[0][1]
    _sync(dev)
    t0 = time.perf_counter()
    ref_m, ref_g, ref_stats = _dp_step_rank(0, dev, 1, frames, det_cfg, 0)
    one_s = time.perf_counter() - t0
    # how far rounding alone moves each side's gradients: the one-process
    # step under three 1e-7 weight perturbations and with the statistics
    # taken from sums as the ranks take them (the reduction order alone),
    # and the data-parallel step under the same perturbations (its
    # convolutions run at half the batch: other algorithms, other
    # rounding)
    noise_1p = dict.fromkeys(ref_g, 0.0)
    variants = [dict(seed=s, perturb=1e-7) for s in (1, 2, 3)] + [
        dict(seed=0, sums=True)]
    for kw in variants:
        other = _dp_step_rank(0, dev, 1, frames, det_cfg, **kw)[1]
        for n, g in other.items():
            noise_1p[n] = max(noise_1p[n], _rel_err(
                torch.as_tensor(g), torch.as_tensor(ref_g[n])))
    noise_dp = {n: max(_rel_err(torch.as_tensor(m[n]),
                                torch.as_tensor(dp_g[n]))
                       for m in ranks[0][3]) for n in dp_g}
    noise = {n: max(noise_1p[n], noise_dp[n]) for n in ref_g}
    err = {n: _rel_err(torch.as_tensor(g), torch.as_tensor(ref_g[n]))
           for n, g in dp_g.items()}
    loss_err = abs(dp_m["loss"] - ref_m["loss"]) / abs(ref_m["loss"])
    stats_err = max(float(np.abs(v - ref_stats[k]).max())
                    for k, v in dp_stats.items())
    bad = _grad_gate(err, noise)
    worst = max(err, key=err.get)
    over = [n for n, e in err.items() if e > 1e-3]
    to_noise = max((err[n] / max(noise[n], 1e-30) for n in over),
                   default=0.0)
    if bad or loss_err > 1e-4 or stats_err > 1e-4:
        fail(f"data-parallel step: loss {loss_err}, running stats "
             f"{stats_err}, gradients over the gate "
             f"{[(n, err[n], noise[n]) for n in bad]}; over 1e-3 "
             f"{[(n, err[n], noise_1p[n], noise_dp[n]) for n in over]}")
    print(f"two ranks: card {card!r} backend "
          f"{distributed.backend_for(devices)} all_hosts_stats "
          f"points_in {ranks[0][0]['points_in']} (exact int64) | "
          f"data-parallel step float32 batch 4, 2 frames a rank: loss "
          f"{dp_m['loss']} one-process {ref_m['loss']} loss_rel_err "
          f"{loss_err} grad_max_rel_err {err[worst]} ({worst}, card noise "
          f"{noise[worst]}) grads_over_1e-3 {len(over)} of {len(err)} "
          f"max_err_to_noise_over_1e-3 {to_noise} card_noise_max one-process "
          f"{max(noise_1p.values())} data-parallel "
          f"{max(noise_dp.values())} err_to_one_process_noise_max "
          f"{max((err[n] / max(noise_1p[n], 1e-30) for n in over),
                 default=0.0)}"
          f" running_stats_max_abs_err {stats_err} "
          f"rank_steps_s {[[round(t, 4) for t in r[2]] for r in ranks]} "
          f"one_process_step_s {one_s:.4f} processes_s {ranks_s:.1f}",
          flush=True)

    t0 = time.time()
    for line in dryrun_multichip(2, devices):
        print(f"{line} | card {card!r}", flush=True)
    print(f"multi-gpu: card {card!r} dryrun_s {time.time() - t0:.1f} "
          f"phase_s {time.time() - t_phase:.1f}", flush=True)


def _dp_config():
    """Phase 15's detector: the full width of PointPillarsConfig()."""
    from lidar_snow_sim_tpu_torch.models.pointpillars import (
        PointPillarsConfig,
    )

    return PointPillarsConfig()


def _stats_local(local: dict, rank: int) -> dict:
    """The local counters `_stats_rank` gives rank `rank`."""
    return {k: v * (rank + 1) if isinstance(v, int) else float(rank)
            for k, v in local.items()}


AB_KEYS = ("step_ms", "scans_per_sec", "spread_ms", "overflow")
DATAGEN_BENCH_KEYS = (
    "metric", "value", "unit", "frames", "wall_s", "steady_scans_per_sec",
    "steady_median_scans_per_sec", "steady_frames", "compile_batches_s",
    "tunnel", "transfer_bound_ceiling_scans_per_sec",
    "transfer_bytes_per_frame", "mean_points_per_scan", "batch", "backend",
    "wet", "manifest_stats", "scene_setup_s", "bank_setup_s",
    "device_resident_scans_per_sec", "device_step_ms_per_frame",
    "measured_loop_overhead_pct", "pcie8gbps_overhead_pct_of_device_step",
    "resume_walk_s",
)


def _ab_gate(report: dict, arms) -> list:
    """Phase 16's gate on an `ab` report: every asked arm present, with
    all its keys, overflow 0 and a step time above 0."""
    bad = []
    for arm in arms:
        r = report.get(arm)
        if r is None or any(k not in r for k in AB_KEYS):
            bad.append(f"{arm}: {r}")
        elif r["overflow"] != 0 or not r["step_ms"] > 0:
            bad.append(f"{arm}: overflow {r['overflow']} step_ms "
                       f"{r['step_ms']}")
    return bad


def _profile_gate(text: str, kernels=("a1_kernel", "c1_kernel")) -> list:
    """Phase 16's gate on profile_bench's output: each kernel named."""
    return [k for k in kernels if k not in text]


def _datagen_bench_gate(report: dict, frames: int) -> list:
    """Phase 16's gate on datagen_bench's report: every key of the JAX
    tool's present, `frames` frames done, the rates above 0."""
    bad = [f"missing {k}" for k in DATAGEN_BENCH_KEYS if k not in report]
    if report.get("frames") != frames:
        bad.append(f"frames {report.get('frames')} != {frames}")
    for k in ("value", "device_resident_scans_per_sec"):
        if not (report.get(k) or 0) > 0:
            bad.append(f"{k} {report.get(k)}")
    return bad


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def tools_phase(dev) -> None:
    """Phase 16: the measuring tools on the card. `ab snow base route256`
    and `ab lisa base` at short chains (1 and 3 steps, 2 reps): every arm
    with overflow 0 and a step time above 0, A1 and A2 and C1 (snow) and
    L1 (lisa) launched; `profile_bench --model snow --iters 1 --top 10`
    naming A1 and C1; `datagen_bench --frames 8 --batch 4` with 8 frames
    done and every key of the JAX tool's report."""
    import contextlib
    import io

    from lidar_snow_sim_tpu_torch.ops.lut_lookup import lut_lookup_pairs
    from lidar_snow_sim_tpu_torch.ops.occluders import (
        find_occluders,
        find_occluders_routed,
    )
    from lidar_snow_sim_tpu_torch.ops.pulse import pulse_peaks
    from lidar_snow_sim_tpu_torch.tools import ab, datagen_bench
    from lidar_snow_sim_tpu_torch.tools import profile_bench
    from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line

    t_phase = time.time()
    card = card_line()
    counted = {"A1": find_occluders, "A2": find_occluders_routed,
               "C1": pulse_peaks, "L1": lut_lookup_pairs}
    chains = ["--short", "1", "--long", "3", "--reps", "2"]
    for model, arms, kernels in (("snow", ("base", "route256"),
                                  ("A1", "A2", "C1")),
                                 ("lisa", ("base",), ("L1",))):
        for fn in counted.values():
            fn.launches = 0
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            rc = ab.main([model, *arms, *chains])
        report = _last_json(out.getvalue())
        launches = {k: counted[k].launches for k in kernels}
        bad = _ab_gate(report["arms"], arms)
        if rc != 0 or bad or min(launches.values()) < 1:
            fail(f"ab {model}: rc {rc} {bad} launches {launches}")
        arms_ms = {a: {k: round(v, 4) for k, v in r.items()}
                   for a, r in report["arms"].items()}
        print(f"ab {model}: card {card!r} {arms_ms} launches {launches} s "
              f"{time.time() - t0:.1f}", flush=True)

    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = profile_bench.main(["--model", "snow", "--iters", "1",
                                 "--top", "10"])
    text = out.getvalue()
    missing = _profile_gate(text)
    if rc != 0 or missing:
        fail(f"profile_bench: rc {rc}, not named {missing}:\n{text}")
    kernel_rows = text.split("port kernels:")[-1].strip().splitlines()
    head = [ln for ln in text.splitlines() if ln.startswith("model ")]
    print(f"profile_bench snow: card {card!r} {head[0] if head else ''} "
          f"kernels {[' '.join(r.split()) for r in kernel_rows]} s "
          f"{time.time() - t0:.1f}", flush=True)

    out = io.StringIO()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(out):
        rc = datagen_bench.main(["--frames", "8", "--batch", "4",
                                 "--root", tmp])
    report = _last_json(out.getvalue())
    bad = _datagen_bench_gate(report, 8)
    if rc != 0 or bad:
        fail(f"datagen_bench: rc {rc} {bad}")
    keep = ("value", "steady_scans_per_sec", "steady_median_scans_per_sec",
            "steady_frames", "compile_batches_s", "tunnel",
            "transfer_bound_ceiling_scans_per_sec",
            "device_resident_scans_per_sec", "device_step_ms_per_frame",
            "measured_loop_overhead_pct", "resume_walk_s", "backend")
    print(f"datagen_bench: frames 8 batch 4 "
          f"{ {k: report[k] for k in keep} } growths "
          f"{report['manifest_stats']['capacity_growths']} s "
          f"{time.time() - t0:.1f} | phase_s {time.time() - t_phase:.1f}",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    # phase 10 trains with deterministic algorithms, which need this set
    # before the process's first cuBLAS call (torch reads it once)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # transcendentals (atan2, sin, cos, arccos) round differently on the
    # two devices, so a decision on a boundary may flip: the parity
    # contract of tests/test_snowfall_parity.py allows < 0.2% of points
    n = len(small)
    differ, xyz_err = _card_cpu_parity("GPU vs CPU", g, c, n)
    print(f"gpu_vs_cpu: points {n} differing {differ} "
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
    # phases 9 and 10 run before phase 8's profiler sessions, which would
    # slow them
    detector_phase(out, dev)
    training_phase(out, dev)
    server_phase(pc, sets, rr, occ, dev)
    window = window_phase(pc, sets, calib, dev)
    parity_phase(dev)
    grid_phase(calib, dev)
    multi_gpu_phase(pc, sets, calib, dev)
    tools_phase(dev)
    preamble = preamble_phase(pc, dev)

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
        *window,
        *preamble,
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
