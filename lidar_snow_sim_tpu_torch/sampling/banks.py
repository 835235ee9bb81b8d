"""Device-resident particle banks (the port's copy of
`lidar_snow_sim_tpu/sampling/banks.py`, held bitwise against it by
tests/test_torch_host.py).

The reference loads one `.npy` particle file *per channel, per scan, inside the
hot path* (`tools/snowfall/simulation.py:329`) and brute-forces every particle
against every beam. Here all 64 per-channel particle sets of one
(distribution, rate, occupancy) combo are baked into a single angle-sorted,
padded device LUT, built once on host:

- Particles are split into "narrow" (angular half-width asin(r/d) below
  `wide_threshold`) and "wide" lists. Narrow particles are sorted by center
  azimuth and extended with ±2pi wraparound copies so any beam's angular
  neighborhood is one contiguous window, found by binary search. Wide
  particles (rare: centers within ~0.5 m of the sensor) are tested against
  every beam.

- Each beam then gathers a fixed-size window of `window_size` candidates plus
  the wide list; the exact reference intersection test prunes them. Window
  overflow is *counted* (never silently dropped) so capacity bugs surface in
  stats/tests.

Bank rows are indexed by the particle-file index; the per-scan channel shuffle
(reference simulation.py:482-486) becomes a permutation array `order` so that
channel c reads bank row order[c].
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np

TWO_PI = 2.0 * np.pi
_FILLER_ANGLE = 1e9
_FILLER_DIST = 1e9

# per-channel azimuth -> bank-index LUT: uniform bins over [LUT_LO, LUT_HI]
# (sort azimuths are signed (-pi, pi]; +-2pi wrap pads stay in range for any
# realistic pad block). The dense assembly reads lut[row, bin(t) - 1] /
# lut[row, bin(t) + 2] as CONSERVATIVE slice bounds — one tiny gather per
# chunk instead of a ~15-step sequential binary-search chain.
LUT_BINS = 16384  # ~1e-3 rad/bin: the +-1-bin conservative guard then costs
# only a few bank columns even at the heaviest rate (~2.9k particles/rad),
# which matters for the banded phase A where guard + 128-alignment slack
# must fit inside band_width
LUT_LO = -8.0
LUT_HI = 8.0


class ParticleBank(NamedTuple):
    """Angle-sorted, padded particle LUT for all channels of one combo.

    data/angle rows are the *extended* arrays: [front wrap pad (angle-2pi),
    sorted narrow particles, back wrap pad (angle+2pi), filler]. All arrays are
    numpy on host; `bank_to_torch` (models/snowfall.py) moves them to a device.

    data_t/wide_t are transposed property-major copies for the phase-A kernels
    (each property a contiguous row; the wrapped azimuth and tangent
    half-width are precomputed columns):
    rows = [x, y, r, dist, azimuth in [0, 2pi), asin(r/d), sort_angle, 0]
    where sort_angle is the SIGNED extended sort azimuth (with the +-2pi
    wrap shifts) used by the banded kernel's per-point coverage check;
    wide_t rows carry 0 there (wide candidates are always tested).
    """

    data: np.ndarray        # (C, K_ext, 4) f32: x, y, r, dist
    angle: np.ndarray       # (C, K_ext) f32, ascending
    count: np.ndarray       # (C,) i32: narrow count (excludes pads/filler)
    start: np.ndarray       # (C,) i32: index of first non-pad entry (== pad)
    wide: np.ndarray        # (C, W, 4) f32: x, y, r, dist
    wide_count: np.ndarray  # (C,) i32
    data_t: np.ndarray      # (C, 8, K_ext) f32 transposed + derived columns
    wide_t: np.ndarray      # (C, 8, W) f32
    lut: np.ndarray         # (C, LUT_BINS + 1) i32: searchsorted(angle, edge)

    @property
    def num_channels(self) -> int:
        return int(self.data.shape[0])

    @property
    def pad(self) -> int:
        return int(self.start[0])

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self)


def build_bank(
    particle_sets: Sequence[np.ndarray],
    window_size: int = 1024,
    wide_threshold: float = 5e-3,
    wide_capacity: int = 128,
) -> ParticleBank:
    """Build a ParticleBank from per-channel (N_i, 3) [x, y, r] arrays."""
    C = len(particle_sets)
    pad = window_size

    narrow_rows = []
    wide_rows = []
    for p in particle_sets:
        p = np.asarray(p, dtype=np.float64).reshape(-1, 3)
        x, y, r = p[:, 0], p[:, 1], p[:, 2]
        dist = np.hypot(x, y)
        halfwidth = np.arcsin(np.clip(r / np.maximum(dist, 1e-12), 0.0, 1.0))
        is_wide = halfwidth > wide_threshold
        # SIGNED azimuth (-pi, pi]: forward-FOV scans (the datagen workload,
        # precompute.py:96-99) are then contiguous in sort order instead of
        # wrapping at 0, which keeps dense-assembly block spans tight. The
        # +-2pi pad entries cover window lookups across the +-pi seam.
        ang = np.arctan2(y, x)
        nr = np.column_stack([x, y, r, dist, ang])[~is_wide]
        nr = nr[np.argsort(nr[:, 4], kind="stable")]
        narrow_rows.append(nr)
        wd = np.column_stack([x, y, r, dist])[is_wide]
        if len(wd) > wide_capacity:
            raise ValueError(
                f"wide-particle overflow: {len(wd)} > capacity {wide_capacity};"
                " raise wide_capacity or wide_threshold"
            )
        wide_rows.append(wd)

    k_max = max((len(nr) for nr in narrow_rows), default=0)
    k_ext = k_max + 2 * pad

    data = np.zeros((C, k_ext, 4), dtype=np.float32)
    angle = np.full((C, k_ext), _FILLER_ANGLE, dtype=np.float32)
    data[:, :, 3] = _FILLER_DIST
    count = np.zeros(C, dtype=np.int32)
    start = np.full(C, pad, dtype=np.int32)
    wide = np.zeros((C, wide_capacity, 4), dtype=np.float32)
    wide[:, :, 3] = _FILLER_DIST
    wide_count = np.zeros(C, dtype=np.int32)

    def _transpose_props(
        arr4: np.ndarray, sort_angle: np.ndarray | None = None
    ) -> np.ndarray:
        """(K, 4) [x,y,r,dist] -> (8, K) property rows with derived azimuth
        (wrapped to [0, 2pi)), tangent half-width, and (data rows only) the
        signed extended sort-angle column."""
        k = len(arr4)
        out = np.zeros((8, k), dtype=np.float32)
        if k == 0:
            return out
        x, y, r, d = (arr4[:, i] for i in range(4))
        out[0], out[1], out[2], out[3] = x, y, r, d
        ang = np.arctan2(y, x)
        out[4] = np.where(ang < 0, ang + TWO_PI, ang)
        out[5] = np.arcsin(np.clip(r / np.maximum(d, 1e-12), 0.0, 1.0))
        # filler entries (dist >= 1e9): keep azimuth huge so no test passes
        out[4] = np.where(d >= _FILLER_DIST, _FILLER_ANGLE, out[4])
        if sort_angle is not None:
            out[6] = sort_angle
        return out

    for c, (nr, wd) in enumerate(zip(narrow_rows, wide_rows)):
        n = len(nr)
        count[c] = n
        if n > 0:
            # wraparound pads: take with wrap so channels with n < pad still
            # tile correctly; adjust angles by the number of full wraps.
            front_idx = np.arange(-pad, 0)
            back_idx = np.arange(0, pad)
            front = nr[np.mod(front_idx, n)]
            back = nr[np.mod(back_idx, n)]
            front_wraps = np.floor_divide(front_idx, n)  # negative
            back_wraps = np.floor_divide(back_idx, n) + 1
            block = np.concatenate(
                [
                    np.column_stack([front[:, :4], front[:, 4] + TWO_PI * front_wraps]),
                    nr,
                    np.column_stack([back[:, :4], back[:, 4] + TWO_PI * back_wraps]),
                ]
            )
            m = len(block)
            data[c, :m] = block[:, :4].astype(np.float32)
            angle[c, :m] = block[:, 4].astype(np.float32)
        if len(wd) > 0:
            wide[c, : len(wd)] = wd.astype(np.float32)
            wide_count[c] = len(wd)

    data_t = np.stack(
        [_transpose_props(row, ang_row) for row, ang_row in zip(data, angle)]
    )
    # lane dimension padded to a multiple of 128 (Mosaic DMA alignment);
    # filler lanes carry dist=1e9 so no intersection test can pass
    wc_pad = max(((wide_capacity + 127) // 128) * 128, 128)
    wide_padded = np.zeros((C, wc_pad, 4), dtype=np.float32)
    wide_padded[:, :, 3] = _FILLER_DIST
    wide_padded[:, :wide_capacity] = wide
    wide_t = np.stack([_transpose_props(row) for row in wide_padded])
    edges = np.linspace(LUT_LO, LUT_HI, LUT_BINS + 1).astype(np.float32)
    lut = np.stack(
        [np.searchsorted(row, edges, side="left") for row in angle]
    ).astype(np.int32)
    return ParticleBank(
        data, angle, count, start, wide, wide_count, data_t, wide_t, lut
    )


def load_bank_files(
    directory: str | Path,
    prefix: str,
    num_channels: int = 64,
    **kwargs,
) -> ParticleBank:
    """Load the reference's per-channel particle files
    `{prefix}_{i}.npy` for i in 1..num_channels (simulation.py:78) into a bank."""
    directory = Path(directory)
    sets = [
        np.load(directory / f"{prefix}_{i + 1}.npy") for i in range(num_channels)
    ]
    return build_bank(sets, **kwargs)


def bank_from_numpy(bank) -> ParticleBank:
    """The port's ParticleBank from any object with ParticleBank's fields
    (such as the JAX package's bank), its arrays copied to numpy."""
    return ParticleBank(*(np.asarray(getattr(bank, f)).copy()
                          for f in ParticleBank._fields))
