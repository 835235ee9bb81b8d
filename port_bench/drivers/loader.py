"""On-the-fly augmentation in a training loader: one scan a call through
the port's `models/snowfall.SnowfallAugmenter` (host array in, host
array out; it grows a capacity and reruns on an overflow), with the
frame's channel order passed in, in a closed loop: the next call starts
when the last returns. A call that raises fails its frame. Traffic keys:
none.
"""

from __future__ import annotations

import time

from lidar_snow_sim_tpu_torch.config import SnowfallConfig
from lidar_snow_sim_tpu_torch.models.snowfall import SnowfallAugmenter
from lidar_snow_sim_tpu_torch.sampling.banks import build_bank

from port_bench.inputs import draws_seed


class Driver:
    row_order = "channel"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = cfg = SnowfallConfig(**ctx.config["snowfall"])
        bank = build_bank(ctx.particle_sets, window_size=cfg.window_size,
                          wide_threshold=cfg.wide_threshold,
                          wide_capacity=cfg.wide_capacity)
        # the augmenter's RANSAC seed, drawn from the run's seed
        self.seed = draws_seed(ctx.traffic, ctx.run_seed, ctx.frames[0])
        self.aug = SnowfallAugmenter(bank=bank, calib=ctx.program_calib,
                                     cfg=cfg, seed=self.seed,
                                     device=ctx.device)
        self._next = 0

    @property
    def growths(self) -> list:
        """The capacities the augmenter grew in set-up."""
        return [f for f in self.cfg.__dataclass_fields__
                if getattr(self.aug.cfg, f) != getattr(self.cfg, f)]

    def warm(self):
        for fr in self.ctx.frames:
            self.aug(fr.scan, order=fr.order)

    def unit(self):
        f = self._next
        self._next = (f + 1) % len(self.ctx.frames)
        fr = self.ctx.frames[f]
        t0 = time.perf_counter()
        try:
            stats, rows = self.aug(fr.scan, order=fr.order)
        except RuntimeError:
            return {"frames": [f], "rows": [None], "stats": [None],
                    "failed": 1, "latencies": [time.perf_counter() - t0]}
        return {"frames": [f], "rows": [rows], "stats": [stats],
                "failed": 0, "latencies": [time.perf_counter() - t0]}
