"""SeeingThroughFog (DENSE) metadata helpers (the port's copy of
`lidar_snow_sim_tpu/utils/stf_meta.py`).

Host-side equivalents of the reference's STF meta utilities
(`tools/wet_ground/utils.py:36-72`): per-frame meta-JSON loading, boolean
filters over weather / environment / daytime / infrastructure flags, and the
road-wetness ground-truth reader. These are IO/orchestration utilities — they
never touch the device path.
"""

from __future__ import annotations

import json
from pathlib import Path


def read_meta_label(path: str | Path) -> dict:
    """Load a per-frame STF meta JSON."""
    with open(path) as f:
        return json.load(f)


def filter_weather(meta: dict, weather_type: str) -> bool:
    """True iff the frame's weather flag (e.g. 'clear', 'snow', 'fog') is set."""
    return bool(meta["weather"][weather_type])


def filter_env(meta: dict, env_type: str) -> bool:
    """True iff the environment flag (e.g. 'urban', 'highway') is set."""
    return bool(meta["meta"]["environment"][env_type])


def filter_daytime(meta: dict, day_type: str) -> bool:
    """True iff the daytime flag ('day' / 'night') is set."""
    return bool(meta["daytime"][day_type])


def filter_infra(meta: dict, infra_type: str) -> bool:
    """True iff the infrastructure flag (e.g. 'tunnel') is set."""
    return bool(meta["meta"]["infrastructure"][infra_type])


def read_road_wetness(path: str | Path):
    """(water_thickness_m, surface_state) from a road-state JSON, or None.

    Mirrors the reference's silent-failure contract
    (`tools/wet_ground/utils.py:65-72`): unreadable/malformed files yield None
    rather than raising, so dataset sweeps skip frames without wetness GT.
    """
    try:
        with open(path) as f:
            data = json.load(f)
        return float(data["water_thickness"]), data["surface_state_result"]
    except (OSError, KeyError, ValueError, TypeError, json.JSONDecodeError):
        return None


def temporal_neighbors(
    sample_id: str, offsets=range(-6, 5), sep: str = ","
) -> list[str]:
    """Neighboring frame IDs of an STF sample (`date,frame` convention).

    The viewer navigates past/future sweeps in the -6..+4 range
    (`pointcloud_viewer.py` temporal frames; SURVEY.md §2.1). Frame numbers
    are zero-padded to the input's width; negative frames are skipped.
    """
    date, frame = sample_id.split(sep)
    width = len(frame)
    base = int(frame)
    out = []
    for off in offsets:
        f = base + off
        if f < 0:
            continue
        out.append(f"{date}{sep}{f:0{width}d}")
    return out


def select_frames(
    meta_dir: str | Path,
    frame_ids: list[str],
    *,
    weather: str | None = None,
    environment: str | None = None,
    daytime: str | None = None,
    infrastructure: str | None = None,
    suffix: str = ".json",
) -> list[str]:
    """Filter a split's frame IDs by any combination of meta flags.

    Convenience composition of the four filters over a directory of per-frame
    meta JSONs named `<frame_id><suffix>`; missing metas are skipped.
    """
    meta_dir = Path(meta_dir)
    kept = []
    for fid in frame_ids:
        p = meta_dir / f"{fid}{suffix}"
        if not p.exists():
            continue
        meta = read_meta_label(p)
        try:
            if weather is not None and not filter_weather(meta, weather):
                continue
            if environment is not None and not filter_env(meta, environment):
                continue
            if daytime is not None and not filter_daytime(meta, daytime):
                continue
            if infrastructure is not None and not filter_infra(
                meta, infrastructure
            ):
                continue
        except KeyError:
            continue
        kept.append(fid)
    return kept
