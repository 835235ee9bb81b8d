#!/usr/bin/env python3
"""Drive the PyTorch port's snowfall main path once on one NVIDIA GPU.

Run from the repository root: python3 chip_smoke.py

Phases, each printing one line of numbers:
  1. environment: the card's name and power limit (nvidia-smi), TF32 off;
  2. inputs at the bench scale: an 870-azimuth synthetic HDL-64 scan
     (50,475 points) and a gunn 2.5 mm/h, 1.6 m/s particle bank of 64 sets
     (~18k particles per channel; the sets are cached under
     lidar_snow_sim_tpu_torch/_build/);
  3. kernels A1 (phase A, occluders) and C1 (phase C, pulse) built from
     csrc/, launched on the card at the main path's shapes and held
     against their plain torch versions on the same inputs: exact
     equality (a1/a2 compared where dist < 1e37); CUDA-event times, median
     of 10 runs after warm-up, for each kernel and each plain version;
  4. end to end: SnowfallAugmenter on the scene, 10 timed scans, with the
     kernels' launch counters reset just before and read just after; all
     five overflow counters 0, labels in {0, 1, 2}; and the same small
     scene through the GPU and the CPU paths, which must agree;
  5. datagen through the CLI (python -m lidar_snow_sim_tpu_torch.tools.
     precompute ... --wet) on 4 synthetic scans, then a rerun that must
     skip all 4; then api.augment and api.ground_water_augmentation on the
     card from the same particle files.
The line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before it; so
does a machine without a CUDA device, or a directory without the port.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
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
        occluders_plain,
    )
    from lidar_snow_sim_tpu_torch.ops.pulse import pulse_peaks, pulse_plain

    # --- 1. environment ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind!r} count {torch.cuda.device_count()} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # --- 2. bench-scale inputs ---
    t0 = time.time()
    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=870, seed=0, calib=calib)
    sets, rr, occ = bank_sets(_kernels.BUILD_DIR / "banks")
    cfg = SnowfallConfig(
        max_points=65536, window_size=128, wide_capacity=16,
        max_occluders=24, max_bumps=16, assembly="dense",
        channel_capacity=1024, block_points=128, slice_width=1152,
    )
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
    if not torch.equal(ovf, ovf_p):
        fail(f"A1 overflow differs at {(ovf != ovf_p).sum().item()} beams")
    if not torch.equal(a12d[2 * k:], a12d_p[2 * k:]):
        fail("A1 dist plane differs from the plain version")
    a_err = (a12d[:2 * k] - a12d_p[:2 * k]).abs()[torch.cat([live, live])]
    a1_err = float(a_err.max()) if a_err.numel() else 0.0
    if a1_err != 0.0:
        fail(f"A1 a1/a2 differ from the plain version: max {a1_err}")
    a1_ms = time_ms(lambda: find_occluders(*lay.occluder_args,
                                           **lay.occluder_kw))
    a1_plain_ms = time_ms(lambda: occluders_plain(*lay.occluder_args,
                                                  **lay.occluder_kw))
    print(f"A1: chunks {lay.n_chunks} blk {lay.blk} "
          f"slice {lay.occluder_kw['w_sl']} K {k} hits {int(live.sum())} "
          f"max_abs_err {a1_err} ms {a1_ms:.4f} plain_ms {a1_plain_ms:.4f} "
          f"first_call_incl_build_s {build_s:.1f}", flush=True)
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
    c1_plain_ms = time_ms(lambda: pulse_plain(*comp.pulse_args,
                                              **comp.pulse_kw))
    print(f"C1: cap {comp.cap} occluded {int(comp.c_ok.sum())} "
          f"touched {int(out_k[2].sum())} max_abs_err {c1_err} "
          f"ms {c1_ms:.4f} plain_ms {c1_plain_ms:.4f}", flush=True)
    for name in ("occluders", "pulse"):   # nvcc -Xptxas -v, if built here
        log = _kernels.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}", flush=True)


    # --- 4. end to end through SnowfallAugmenter ---
    aug = SnowfallAugmenter(bank=bank, calib=calib, cfg=cfg, seed=0,
                            device=dev)
    perm = np.random.default_rng(1).permutation(64)
    for _ in range(3):           # warm-up; grows any capacity it needs
        aug(pc, order=perm)
    find_occluders.launches = 0
    pulse_peaks.launches = 0
    n_scans = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_scans):
        stats, out = aug(pc, order=perm)
    end.record()
    end.synchronize()
    launches = {"A1": find_occluders.launches, "C1": pulse_peaks.launches}
    e2e_ms = start.elapsed_time(end)
    res = aug.last_result
    counters = {n: int(getattr(res, n)) for n in OVERFLOW_COUNTERS}
    if any(counters.values()):
        fail(f"overflow counters after growth: {counters}")
    if not set(np.unique(out[:, 4])) <= {0.0, 1.0, 2.0}:
        fail("labels outside {0, 1, 2}")
    if out.shape[1] != 5 or not np.isfinite(out).all():
        fail(f"output not finite (n, 5): {out.shape}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    print(f"e2e: stats {stats} out {out.shape} counters {counters} "
          f"launches {launches} scans {n_scans} ms {e2e_ms:.3f} "
          f"scans_per_s {n_scans * 1000.0 / e2e_ms:.3f} "
          f"grown slice_width {aug.cfg.slice_width} "
          f"max_occluders {aug.cfg.max_occluders}", flush=True)

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
        for name, arr in (("augment", api_pc), ("wet", wet_pc)):
            if arr.shape[1] != 5 or not np.isfinite(arr).all() or \
                    not set(np.unique(arr[:, 4])) <= {0.0, 1.0, 2.0}:
                fail(f"api {name} output malformed: {arr.shape}")
    print(f"datagen: frames {manifest['stats']['frames_done']} points_out "
          f"{[len(r) for r in rows]} growths "
          f"{manifest['stats']['capacity_growths']} first_run_s "
          f"{first_s:.1f} rerun_skipped {rerun['stats']['frames_skipped']}",
          flush=True)

    print(f"api: augment stats {api_stats} out {api_pc.shape} "
          f"ground_water_augmentation out {wet_pc.shape}", flush=True)

    kernels = [
        {"name": "A1 nearest-K occluders (phase A)", "route": "cuda",
         "source": "lidar_snow_sim_tpu_torch/csrc/occluders.cu",
         "replaces": "lidar_snow_sim_tpu/ops/pallas_occluders.py:150",
         "launches": launches["A1"], "max_abs_err": a1_err,
         "ms": a1_ms, "plain_ms": a1_plain_ms},
        {"name": "C1 sweep and pulse peak (phase C)", "route": "cuda",
         "source": "lidar_snow_sim_tpu_torch/csrc/pulse.cu",
         "replaces": "lidar_snow_sim_tpu/ops/pallas_pulse.py:173",
         "launches": launches["C1"], "max_abs_err": c1_err,
         "ms": c1_ms, "plain_ms": c1_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
