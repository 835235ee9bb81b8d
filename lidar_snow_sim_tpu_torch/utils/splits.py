"""STF/DENSE split-file handling (the port's copy of
`lidar_snow_sim_tpu/utils/splits.py`).

Split files are CSV lines of `date,frame` sample IDs (e.g.
`2019-09-11_18-41-27,02580`), as shipped with the SeeingThroughFog devkit and
the reference repo's `splits/` directory.
"""

from __future__ import annotations

from pathlib import Path


def read_split(path: str | Path) -> list[str]:
    """Read a split file into sorted `date_frame` sample IDs.

    Matches the reference datagen script's normalization
    (`tools/snowfall/precompute.py:62`): commas become underscores, sorted.
    """
    with open(path) as f:
        ids = ["_".join(line.strip().split(",")) for line in f if line.strip()]
    return sorted(ids)


def reorder_second_half_first(ids: list[str]) -> list[str]:
    """The reference's resume-friendly iteration order
    (`tools/snowfall/precompute.py:64-68`): second half in order, then the
    first half reversed."""
    k, m = divmod(len(ids), 2)
    first = ids[: k + min(1, m)]
    second = ids[k + min(1, m):]
    return second + list(reversed(first))
