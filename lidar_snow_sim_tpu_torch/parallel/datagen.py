"""Offline dataset generation: batched and resumable (counterpart of
`lidar_snow_sim_tpu/parallel/datagen.py`; reference script
`tools/snowfall/precompute.py:47-106`).

Scans are padded to a fixed capacity, batched through
`datagen_packed_step` on one device, and written as STF-format .bin files
with the reference's skip-if-exists resume. Outputs land where the
reference puts them, so they drop into OpenPCDet training unchanged:
  {out_root}/snowfall_simulation/{mode}/{lidar_folder}_rainrate_{int(rr)}/{id}.bin
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
import zlib
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from lidar_snow_sim_tpu.parallel.datagen import DatagenStats
from lidar_snow_sim_tpu_torch.models.snowfall import (
    OVERFLOW_COUNTERS,
    bank_to_torch,
    calib_to_torch,
    check_supported,
    grown_config,
)
from lidar_snow_sim_tpu_torch.parallel.batched import datagen_packed_step

logger = logging.getLogger(__name__)

_OVF = OVERFLOW_COUNTERS + ("out_overflow",)   # out_meta columns 4..9


def _unpack_rows(planes: np.ndarray, wet: bool) -> np.ndarray:
    """(4|5, n) plane-major output -> (n, 5) rows, undoing the
    (intensity << 2 | label) int32 pack of snowfall-only runs."""
    if wet:
        return np.ascontiguousarray(planes.T)
    pk = np.ascontiguousarray(planes[3]).view(np.int32)
    out = np.empty((planes.shape[1], 5), np.float32)
    out[:, :3] = planes[:3].T
    out[:, 3] = (pk >> 2).astype(np.float32)
    out[:, 4] = (pk & 3).astype(np.float32)
    return out


def run_snowfall_datagen(
    sample_ids: Sequence[str],
    load_fn: Callable[[str], np.ndarray],
    out_dir: str | Path,
    bank,
    calib,
    snow_cfg,
    batch: int = 8,
    seed: int = 0,
    shuffle_channels: bool = True,
    fov_filter=None,
    overwrite: bool = False,
    wet_cfg=None,
    out_frac: float = 0.8,
    device: str | torch.device = "cpu",
) -> DatagenStats:
    """Augment every sample id on `device` and write `{out_dir}/{id}.bin`.

    load_fn maps a sample id to an (N, 5) float32 scan. Existing outputs are
    skipped (resume, precompute.py:91-92). A scan larger than max_points
    grows it; any counted overflow grows the capacity behind it and reruns
    the batch, so nothing is silently truncated. Per-frame randomness (the
    channel order and the RANSAC seed) is a pure function of (seed, sample
    id), so outputs do not depend on batch boundaries or resumes.
    `out_frac` sizes the returned rows as a fraction of max_points; a frame
    keeping more grows it to max_points. A `_manifest.json` with the run
    stats is written next to the outputs.
    """
    check_supported(snow_cfg)
    dev = torch.device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stats = DatagenStats()
    t_start = time.time()
    bank_t = bank_to_torch(bank, dev)
    calib_t = calib_to_torch(calib, dev)
    k_ext = int(np.asarray(bank.data_t).shape[2])
    wet = wet_cfg is not None

    def default_out_points(cfg):
        cap = -(-int(out_frac * cfg.max_points) // 2048) * 2048
        return min(cap, cfg.max_points)

    out_points = default_out_points(snow_cfg)

    def grow(cfg, out_pts, counts):
        """(grown config, grown out_points or None); (None, None) when no
        capacity behind an overflow can grow. window_overflow doubles
        band_width and slice_width (`grown_config`, as the JAX package's
        datagen does)."""
        new_out = None
        for name, count in zip(_OVF, counts):
            if not count:
                continue
            if name == "out_overflow":
                if out_pts >= cfg.max_points:
                    return None, None
                new_out = cfg.max_points
                continue
            cfg = grown_config(cfg, name, k_ext, calib.num_lasers)
            if cfg is None:
                return None, None
        return cfg, new_out

    def make_args(raw, cfg):
        """Pad and pack one batch: points (B, N, 4) f32, chan (B, N) uint8,
        in_meta (B, 3 + C) int32. Short batches repeat frame 0 with
        n_points = 0."""
        n_cap = cfg.max_points
        pts = np.zeros((batch, n_cap, 4), np.float32)
        chan = np.zeros((batch, n_cap), np.uint8)
        meta = np.zeros((batch, 3 + calib.num_lasers), np.int32)
        for j in range(batch):
            sid, _, pc = raw[j] if j < len(raw) else (f"_pad{j}", None, None)
            if pc is not None:
                pts[j, :len(pc)] = pc[:, :4]
                chan[j, :len(pc)] = pc[:, 4].astype(np.uint8)
                meta[j, 0] = len(pc)
            else:
                pts[j], chan[j] = pts[0], chan[0]
            r = np.random.default_rng([seed, zlib.crc32(sid.encode())])
            order = (r.permutation(calib.num_lasers) if shuffle_channels
                     else np.arange(calib.num_lasers))
            meta[j, 2] = int(r.integers(2**31))   # seed_lo; seed_hi = 0
            meta[j, 3:] = order
        return (torch.from_numpy(pts).to(dev), torch.from_numpy(chan).to(dev),
                torch.from_numpy(meta))

    todo = []
    for sid in sample_ids:
        out_path = out_dir / f"{sid}.bin"
        if out_path.exists() and not overwrite:
            stats.frames_skipped += 1
        else:
            todo.append((sid, out_path))

    first_batch = True
    for i in range(0, len(todo), batch):
        t0 = time.time()
        # the first batch builds and loads the kernels
        events = 1 if first_batch else 0
        first_batch = False
        raw = []
        for sid, out_path in todo[i:i + batch]:
            try:
                pc = load_fn(sid)
            except Exception as e:  # noqa: BLE001 - per-frame fault tolerance
                logger.warning("failed to load %s: %s", sid, e)
                stats.frames_failed += 1
                continue
            if fov_filter is not None:
                pc = pc[fov_filter(pc[:, :3])]
            raw.append((sid, out_path, pc))
        if not raw:
            continue
        need = max(len(pc) for _, _, pc in raw)
        if need > snow_cfg.max_points:
            chunk = snow_cfg.point_chunk
            new_cap = -(-need // chunk) * chunk
            logger.warning("datagen max_points grew %d -> %d",
                           snow_cfg.max_points, new_cap)
            snow_cfg = dataclasses.replace(snow_cfg, max_points=new_cap)
            out_points = default_out_points(snow_cfg)
            stats.capacity_growths += 1
            events += 1
        for _attempt in range(8):
            args = make_args(raw, snow_cfg)
            planes_c, out_meta = datagen_packed_step(
                *args, bank_t, calib_t, snow_cfg, wet_cfg=wet_cfg,
                out_points=out_points,
            )
            planes_c = planes_c.cpu().numpy()
            out_meta = out_meta.cpu().numpy()
            ovf = out_meta[:, 4:10].sum(axis=0)
            if not ovf.any():
                break
            grown, grown_out = grow(snow_cfg, out_points, ovf.tolist())
            if grown is None:
                raise RuntimeError(
                    "datagen capacity overflow not auto-resolvable: "
                    + str(dict(zip(_OVF, ovf.tolist())))
                )
            snow_cfg = grown
            out_points = grown_out or out_points
            logger.warning("datagen capacities grew after %s",
                           dict(zip(_OVF, ovf.tolist())))
            stats.capacity_growths += 1
            events += 1
        else:
            raise RuntimeError("datagen capacity overflows persisted")
        for j, (sid, out_path, pc) in enumerate(raw):
            aug = _unpack_rows(planes_c[j, :, :out_meta[j, 0]], wet)
            aug.astype(np.float32).tofile(out_path)
            stats.frames_done += 1
            stats.points_in += len(pc)
            stats.points_out += len(aug)
            stats.attenuated += int(out_meta[j, 1])
            stats.removed += int(out_meta[j, 2])
        stats.batches.append(
            {"frames": len(raw), "s": round(time.time() - t0, 4),
             "compiles": events}
        )

    stats.wall_s = time.time() - t_start
    try:
        (out_dir / "_manifest.json").write_text(json.dumps(
            {
                "stats": stats.as_dict(),
                "frames": len(sample_ids),
                "batch": batch,
                "seed": seed,
                "wet_ground": wet,
                "device": str(dev),
            },
            indent=2,
        ))
    except OSError as e:
        logger.warning("could not write manifest: %s", e)
    return stats
