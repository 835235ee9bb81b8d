"""Multi-format / multi-dataset point-cloud loaders (the port's copy of
`lidar_snow_sim_tpu/utils/datasets.py`).

Host-side equivalents of the reference viewer's loader surface
(`pointcloud_viewer.py:1770-2139,3232-3364`): the viewer reads 10 datasets in
four container formats and normalizes everything to the N x 5
(x, y, z, intensity, channel) contract. Here each loader returns that
normalized array directly; dataset-specific column surgery is captured in
`DATASET_COLUMNS` instead of if-chains, and the PLY/pickle readers are
dependency-free (no plyfile / pandas required — a pandas DataFrame in a
pickle is still handled when pandas is importable).

Intensity scales differ per dataset (KITTI-family stores [0, 1]); loaders
rescale to the reference's [0, 255] convention.
"""

from __future__ import annotations

import gzip
import pickle
import struct
from pathlib import Path

import numpy as np

# dataset name -> (container, columns per point in the raw file,
#                  intensity scale to reach [0, 255])
DATASET_FORMATS = {
    "DENSE": ("bin", 5, 1.0),
    "KITTI": ("bin", 4, 255.0),
    "nuScenes": ("bin", 5, 1.0),
    "Lyft": ("bin", 5, 1.0),
    "Waymo": ("bin", 4, 255.0),
    "CADC": ("bin", 4, 255.0),
    "Honda3D": ("ply", None, 1.0),
    "Argoverse": ("ply", None, 1.0),
    "PandaSet": ("pkl", None, 1.0),
    "A2D2": ("npz", None, 1.0),
}


def normalize_pc(pc: np.ndarray, intensity_scale: float = 1.0) -> np.ndarray:
    """Coerce an (N, >=3) array to the (N, 5) float32 contract."""
    pc = np.asarray(pc, dtype=np.float32)
    n, c = pc.shape
    out = np.zeros((n, 5), dtype=np.float32)
    out[:, : min(c, 5)] = pc[:, : min(c, 5)]
    if c >= 4:
        out[:, 3] = np.clip(pc[:, 3] * intensity_scale, 0.0, 255.0)
    return out


def load_bin(path: str | Path, columns: int = 5,
             intensity_scale: float = 1.0) -> np.ndarray:
    """KITTI/STF-style raw float32 binary with a fixed column count."""
    raw = np.fromfile(str(path), dtype=np.float32).reshape(-1, columns)
    return normalize_pc(raw, intensity_scale)


def load_pkl(path: str | Path, drop_columns=("t",)) -> np.ndarray:
    """Pickled array or DataFrame (optionally gzipped), e.g. PandaSet.

    DataFrames drop `drop_columns` (the reference drops the timestamp column,
    `pointcloud_viewer.py:3325-3328`).
    """
    opener = gzip.open if str(path).endswith("gz") else open
    with opener(str(path), "rb") as f:
        data = pickle.load(f)
    if hasattr(data, "values") and hasattr(data, "drop"):  # DataFrame
        cols = [c for c in drop_columns if c in data.columns]
        data = data.drop(columns=cols).values
    return normalize_pc(np.asarray(data))


_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
    "float64": ("d", 8), "uchar": ("B", 1), "uint8": ("B", 1),
    "char": ("b", 1), "int8": ("b", 1), "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2), "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
}


def load_ply(path: str | Path, keep_columns=None) -> np.ndarray:
    """Minimal PLY reader (ascii + binary little/big endian), first element.

    Replaces the plyfile dependency of `load_from_ply`
    (`pointcloud_viewer.py:3332-3346`); keep_columns selects raw property
    indices before normalization (the reference deletes dataset-specific
    columns — pass the complement here).
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        count = None
        props: list[str] = []
        in_first_element = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                if in_first_element:
                    break  # only the first element block is read
                in_first_element = True
                count = int(tok[2])
            elif tok[0] == b"property" and in_first_element:
                props.append(tok[1].decode())
            elif tok[0] == b"end_header":
                break

        if count is None:
            raise ValueError(f"{path}: no element in PLY header")
        if fmt == "ascii":
            rows = np.loadtxt(
                f, max_rows=count, dtype=np.float64, ndmin=2
            )
        else:
            endian = "<" if "little" in fmt else ">"
            spec = endian + "".join(_PLY_TYPES[p][0] for p in props)
            size = struct.calcsize(spec)
            buf = f.read(size * count)
            rows = np.array(
                [struct.unpack_from(spec, buf, i * size) for i in range(count)],
                dtype=np.float64,
            )
    if keep_columns is not None:
        rows = rows[:, list(keep_columns)]
    return normalize_pc(rows)


def load_npz(path: str | Path, points_key: str = "points",
             extra_keys=("reflectance", "lidar_id")) -> np.ndarray:
    """NPZ loader (A2D2-style): stack xyz with per-point extras
    (`pointcloud_viewer.py:3348-3364`)."""
    with np.load(str(path)) as npz:
        cols = [np.asarray(npz[points_key])]
        for k in extra_keys:
            if k in npz:
                cols.append(np.asarray(npz[k]).reshape(len(cols[0]), -1))
    return normalize_pc(np.column_stack(cols))


# class -> index lookup of the reference's prediction renderer
# (`pointcloud_viewer.py:1425-1428`); unknown names map past the table like
# the reference's IndexError fallback color
PCDET_CLASS_LOOKUP = {"Car": 0, "Pedestrian": 1, "Cyclist": 2}


def load_result_pkl(path: str | Path) -> list:
    """OpenPCDet evaluation output ``result.pkl`` — the container behind
    the reference viewer's saved-results visualization (`load_results`,
    `pointcloud_viewer.py:1388-1408`): a list of per-frame dicts with
    ``frame_id`` / ``boxes_lidar`` (N, 7) / ``name`` (N,) / ``score`` (N,),
    returned sorted by frame_id exactly like the reference."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return sorted(data, key=lambda d: d["frame_id"])


def result_predictions(result: list, frame_id,
                       lookup: dict | None = None) -> np.ndarray:
    """(N, 9) ``[box7 | class idx | score]`` prediction array for one frame
    (`visualize_predictions`, `pointcloud_viewer.py:1412-1437`). Raises
    KeyError when the frame is absent — the reference asserts the frame
    match instead of silently rendering the wrong predictions."""
    lookup = lookup or PCDET_CLASS_LOOKUP
    for d in result:
        if str(d["frame_id"]) == str(frame_id):
            boxes = np.asarray(d["boxes_lidar"], np.float32).reshape(-1, 7)
            p = np.zeros((len(boxes), 9), np.float32)
            p[:, :7] = boxes
            p[:, 7] = [lookup.get(n, len(lookup)) for n in d["name"]]
            p[:, 8] = np.asarray(d["score"], np.float32)
            return p
    raise KeyError(f"frame {frame_id!r} not in result pkl")


def load_pcdet_dict(path: str | Path):
    """A pickled OpenPCDet data_dict (`show_pcdet_dict`,
    `pointcloud_viewer.py:2500-2556`): returns (points (N, 5) normalized,
    gt_boxes (G, >=7) float32 — column 7, when present, is the 1-based
    class id pcdet appends)."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    gt = np.asarray(
        d.get("gt_boxes", np.zeros((0, 7), np.float32)), np.float32
    )
    return normalize_pc(np.asarray(d["points"])), gt


def find_camera_image(scan_path: str | Path) -> Path | None:
    """The synchronized camera frame of a DENSE scan (`populate_image`,
    `pointcloud_viewer.py:3053-3065`): ``../cam_stereo_left_lut/<stem>.png``
    relative to the lidar folder. Returns None when absent."""
    p = Path(scan_path)
    img = p.parent.parent / "cam_stereo_left_lut" / (p.stem + ".png")
    return img if img.exists() else None


def load_pointcloud(path: str | Path, dataset: str = "DENSE") -> np.ndarray:
    """Dispatch on dataset name (DATASET_FORMATS) or file extension."""
    path = Path(path)
    if dataset in DATASET_FORMATS:
        kind, columns, scale = DATASET_FORMATS[dataset]
    else:
        kind = path.suffix.lstrip(".").replace("pkl.gz", "pkl")
        columns, scale = 5, 1.0
    if kind == "bin":
        return load_bin(path, columns=columns, intensity_scale=scale)
    if kind == "pkl":
        return load_pkl(path)
    if kind == "ply":
        return load_ply(path)
    if kind == "npz":
        return load_npz(path)
    raise ValueError(f"unsupported container {kind!r} for {path}")
