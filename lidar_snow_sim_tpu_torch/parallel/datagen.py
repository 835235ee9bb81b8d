"""Offline dataset generation: batched and resumable (counterpart of
`lidar_snow_sim_tpu/parallel/datagen.py`; reference script
`tools/snowfall/precompute.py:47-106`).

Scans are padded to a fixed capacity, batched through
`datagen_packed_step` on one device or, with a `mesh`, sharded over the
mesh's devices (`parallel/batched.make_sharded_packed_step`), and written
as STF-format .bin files with the reference's skip-if-exists resume. One
IO thread loads the next batch while the current one computes. Outputs
land where the reference puts them, so they drop into OpenPCDet training
unchanged:
  {out_root}/snowfall_simulation/{mode}/{lidar_folder}_rainrate_{int(rr)}/{id}.bin
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.models.snowfall import (
    OVERFLOW_COUNTERS,
    bank_to_torch,
    calib_to_torch,
    grown_config,
)
from lidar_snow_sim_tpu_torch.parallel.batched import (
    datagen_packed_step,
    make_sharded_packed_step,
)

logger = logging.getLogger(__name__)

_OVF = OVERFLOW_COUNTERS + ("out_overflow",)   # out_meta columns 4..9


@dataclasses.dataclass
class DatagenStats:
    """Counts and wall clocks of one `run_snowfall_datagen` call (the JAX
    package's record, `lidar_snow_sim_tpu/parallel/datagen.py`)."""

    frames_done: int = 0
    frames_skipped: int = 0
    frames_failed: int = 0
    points_in: int = 0
    points_out: int = 0
    points_dropped: int = 0   # residual input points dropped (always 0:
    # max_points grows instead)
    capacity_growths: int = 0
    attenuated: int = 0
    removed: int = 0
    wall_s: float = 0.0
    # per-batch wall clocks {frames, s, compiles}; "compiles" counts the
    # batch's set-up events (the first batch builds the kernels, a growth
    # reruns the batch), so steady-state batches can be told apart
    batches: list = dataclasses.field(default_factory=list)

    def as_dict(self):
        return dataclasses.asdict(self)

    def steady_scans_per_sec(self):
        """Throughput over the batches that ran no set-up event (kernel
        build, capacity growth rerun); None if every batch ran one."""
        clean = [b for b in self.batches if not b["compiles"]]
        frames = sum(b["frames"] for b in clean)
        secs = sum(b["s"] for b in clean)
        return (frames / secs) if secs > 0 else None

    def steady_median_scans_per_sec(self):
        """Median per-batch throughput over those batches: robust to a
        stall that lands on one batch."""
        clean = sorted(b["frames"] / b["s"] for b in self.batches
                       if not b["compiles"] and b["s"] > 0)
        return clean[len(clean) // 2] if clean else None


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


def frame_order_seed(seed: int, sid: str, num_lasers: int,
                     shuffle_channels: bool = True):
    """(channel order, RANSAC seed) of frame `sid`: a pure function of the
    run's seed and the sample id."""
    r = np.random.default_rng([seed, zlib.crc32(sid.encode())])
    order = (r.permutation(num_lasers) if shuffle_channels
             else np.arange(num_lasers))
    return order, int(r.integers(2**31))


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
    mesh=None,
    wet_cfg=None,
    out_frac: float = 0.8,
    device: str | torch.device = "cuda",
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
    stats and the config the run ended with (its grown capacities) is
    written next to the outputs.

    With a `mesh` (`parallel/mesh.make_mesh`) each batch is sharded over
    the mesh's devices in place of `device`, and the manifest records the
    mesh's shape; the files are those of a run without one. The batch must
    be a multiple of the mesh's 'data' axis, as in the JAX package.
    """
    if mesh is not None and batch % mesh.shape["data"] != 0:
        raise ValueError(
            f"batch {batch} not divisible by mesh data axis "
            f"{mesh.shape['data']}"
        )
    # with a mesh the batch is staged on the host and each shard moves to
    # its device (make_sharded_packed_step)
    dev = torch.device("cpu") if mesh is not None else resolve_device(device)
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
            order, meta[j, 2] = frame_order_seed(   # seed_lo; seed_hi = 0
                seed, sid, calib.num_lasers, shuffle_channels)
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

    def load_batch(chunk):
        """Load and FOV-filter one batch: (rows, failed loads). Runs on the
        IO thread, so the next batch's reads overlap the device's step."""
        raw, failed = [], 0
        for sid, out_path in chunk:
            try:
                pc = load_fn(sid)
            except Exception as e:  # noqa: BLE001 - per-frame fault tolerance
                logger.warning("failed to load %s: %s", sid, e)
                failed += 1
                continue
            if fov_filter is not None:
                pc = pc[fov_filter(pc[:, :3])]
            raw.append((sid, out_path, pc))
        return raw, failed

    sharded = None   # (config, out_points, the mesh step made for them)

    def run_step(args, cfg, out_pts):
        nonlocal sharded
        if mesh is None:
            return datagen_packed_step(*args, bank_t, calib_t, cfg,
                                       wet_cfg=wet_cfg, out_points=out_pts)
        if sharded is None or sharded[:2] != (cfg, out_pts):
            sharded = (cfg, out_pts, make_sharded_packed_step(
                mesh, cfg, wet_cfg, out_pts))
        return sharded[2](*args, bank_t, calib_t)

    chunks = [todo[i:i + batch] for i in range(0, len(todo), batch)]
    first_batch = True
    with ThreadPoolExecutor(max_workers=1) as io_pool:
        pending = io_pool.submit(load_batch, chunks[0]) if chunks else None
        for ci in range(len(chunks)):
            t0 = time.time()
            raw, failed = pending.result()
            stats.frames_failed += failed
            if ci + 1 < len(chunks):   # the next batch loads meanwhile
                pending = io_pool.submit(load_batch, chunks[ci + 1])
            if not raw:
                continue
            # the first batch builds and loads the kernels
            events = 1 if first_batch else 0
            first_batch = False
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
                planes_c, out_meta = run_step(args, snow_cfg, out_points)
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
                "device": str(dev) if mesh is None
                else ",".join(str(d) for d in mesh.flat),
                "config": dataclasses.asdict(snow_cfg),
                **({} if mesh is None else {"mesh": mesh.shape}),
            },
            indent=2,
        ))
    except OSError as e:
        logger.warning("could not write manifest: %s", e)
    return stats


def iter_reference_grid(
    modes: Iterable[str] = ("gunn", "sekhon"),
    snowfall_rates=(0.5, 1.0, 2.0, 2.5, 1.5),
    terminal_velocities=(2.0, 1.6, 2.0, 1.6, 0.6),
):
    """The reference datagen grid: (mode, rainfall_rate, occupancy) combos
    (precompute.py:20-21,53-60)."""
    from lidar_snow_sim_tpu_torch.sampling.distributions import (
        compute_occupancy,
        snowfall_rate_to_rainfall_rate,
    )

    for mode in modes:
        for s, v in zip(snowfall_rates, terminal_velocities):
            yield (mode, snowfall_rate_to_rainfall_rate(s, v),
                   compute_occupancy(s, v))
