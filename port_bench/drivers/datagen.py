"""Offline datagen: batches of frames through the port's
`parallel/batched.datagen_packed_step`, packed, copied to the card,
stepped and copied back as `parallel/datagen.run_snowfall_datagen`
packs, steps and unpacks them; nothing is written to disk. A frame whose
overflow counters are not all 0 fails. Traffic keys: "batch".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.config import SnowfallConfig
from lidar_snow_sim_tpu_torch.models.snowfall import (
    OVERFLOW_COUNTERS,
    bank_to_torch,
    calib_to_torch,
    grown_config,
)
from lidar_snow_sim_tpu_torch.parallel.batched import datagen_packed_step
from lidar_snow_sim_tpu_torch.sampling.banks import build_bank

_OVF = OVERFLOW_COUNTERS + ("out_overflow",)   # out_meta columns 4..9


def _out_points(cfg, frac: float = 0.8) -> int:
    cap = -(-int(frac * cfg.max_points) // 2048) * 2048
    return min(cap, cfg.max_points)


def unpack_rows(planes, n_keep):
    """(4, P) packed planes -> (n_keep, 5) rows, undoing the
    (round(intensity) << 2 | label) int32 pack."""
    planes = planes[:, :n_keep]
    pk = np.ascontiguousarray(planes[3]).view(np.int32)
    out = np.empty((n_keep, 5), np.float32)
    out[:, :3] = planes[:3].T
    out[:, 3] = (pk >> 2).astype(np.float32)
    out[:, 4] = (pk & 3).astype(np.float32)
    return out


class Driver:
    row_order = "scan"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = SnowfallConfig(**ctx.config["snowfall"])
        bank = build_bank(ctx.particle_sets,
                          window_size=self.cfg.window_size,
                          wide_threshold=self.cfg.wide_threshold,
                          wide_capacity=self.cfg.wide_capacity)
        self.k_ext = int(bank.data_t.shape[2])
        self.bank_t = bank_to_torch(bank, ctx.device)
        self.calib_t = calib_to_torch(ctx.program_calib, ctx.device)
        self.batch = int(ctx.traffic["batch"])
        self.n_lasers = ctx.program_calib.num_lasers
        self.out_points = _out_points(self.cfg)
        self.growths = []
        self.step = datagen_packed_step
        self._next = 0

    def _batch(self):
        n = len(self.ctx.frames)
        idx = [(self._next + j) % n for j in range(self.batch)]
        self._next = (self._next + self.batch) % n
        return idx

    def _run(self, idx):
        """Pack, step and fetch one batch: (planes (B, 4, P), meta)."""
        cfg, dev = self.cfg, self.ctx.device
        pts = np.zeros((self.batch, cfg.max_points, 4), np.float32)
        chan = np.zeros((self.batch, cfg.max_points), np.uint8)
        meta = np.zeros((self.batch, 3 + self.n_lasers), np.int32)
        for j, f in enumerate(idx):
            fr = self.ctx.frames[f]
            pts[j, :len(fr.scan)] = fr.scan[:, :4]
            chan[j, :len(fr.scan)] = fr.scan[:, 4].astype(np.uint8)
            meta[j, 0] = len(fr.scan)
            meta[j, 2] = fr.ransac_seed          # seed_lo; seed_hi = 0
            meta[j, 3:] = fr.order
        planes, out_meta = self.step(
            torch.from_numpy(pts).to(dev), torch.from_numpy(chan).to(dev),
            torch.from_numpy(meta), self.bank_t, self.calib_t, cfg,
            out_points=self.out_points)
        return planes.cpu().numpy(), out_meta.cpu().numpy()

    def _grow(self, counts) -> bool:
        """Grow what overflowed, as run_snowfall_datagen does; False when
        nothing can grow."""
        for name, count in zip(_OVF, counts):
            if not count:
                continue
            if name == "out_overflow":
                if self.out_points >= self.cfg.max_points:
                    return False
                self.out_points = self.cfg.max_points
                continue
            grown = grown_config(self.cfg, name, self.k_ext, self.n_lasers)
            if grown is None:
                return False
            self.cfg = grown
        self.growths.append([n for n, c in zip(_OVF, counts) if c])
        return True

    def warm(self):
        need = max(len(f.scan) for f in self.ctx.frames)
        if need > self.cfg.max_points:
            chunk = self.cfg.point_chunk
            self.cfg = dataclasses.replace(
                self.cfg, max_points=-(-need // chunk) * chunk)
            self.out_points = _out_points(self.cfg)
            self.growths.append(["max_points"])
        for _ in range(8):
            ovf = np.zeros(len(_OVF), np.int64)
            for _ in range(-(-len(self.ctx.frames) // self.batch)):
                _, meta = self._run(self._batch())
                ovf += meta[:, 4:10].sum(axis=0)
            if not ovf.any():
                break
            if not self._grow(ovf.tolist()):
                raise RuntimeError(f"capacity overflow not resolvable: "
                                   f"{dict(zip(_OVF, ovf.tolist()))}")
        else:
            raise RuntimeError("capacity overflows persisted")
        self._next = 0

    def unit(self):
        idx = self._batch()
        planes, meta = self._run(idx)
        failed = meta[:, 4:10].any(axis=1)
        return {"frames": idx,
                "rows": [None if failed[j] else
                         unpack_rows(planes[j], int(meta[j, 0]))
                         for j in range(len(idx))],
                "stats": [tuple(int(v) for v in meta[j, 1:4])
                          for j in range(len(idx))],
                "failed": int(failed.sum()), "latencies": []}
