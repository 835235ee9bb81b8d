"""3D bounding boxes: KITTI-label parsing, corner geometry, BEV overlay
(the port's copy of `lidar_snow_sim_tpu/utils/boxes.py`).

Headless equivalent of the reference viewer's ground-truth / prediction box
surface (`pointcloud_viewer.py:2557-2609,3067-3120`): parse KITTI-format
label lines (the STF `gt_labels` and OpenPCDet prediction format), build the
8 box corners in the LiDAR frame, mark which points fall inside a box, and
rasterize box outlines onto a BEV image from utils.render.

The viewer draws classes {PassengerCar, Pedestrian, RidableVehicle}; the
same identity -> color mapping is kept.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

BOX_CLASSES = ("PassengerCar", "Pedestrian", "RidableVehicle")
BOX_COLORS = {
    "PassengerCar": (66, 245, 96),
    "Pedestrian": (245, 178, 66),
    "RidableVehicle": (66, 182, 245),
}


@dataclasses.dataclass
class Box3D:
    """Axis z-up 3D box in the LiDAR frame (center, size, yaw)."""

    x: float
    y: float
    z: float           # center z (not bottom)
    length: float      # along heading
    width: float
    height: float
    yaw: float         # rotation about +z
    identity: str = ""
    score: float = 1.0

    @property
    def distance(self) -> float:
        return float(np.sqrt(self.x**2 + self.y**2 + self.z**2))

    def corners(self) -> np.ndarray:
        """(8, 3) corners; first 4 bottom CCW, then top."""
        l2, w2, h2 = self.length / 2, self.width / 2, self.height / 2
        c = np.array(
            [
                [l2, w2, -h2], [-l2, w2, -h2], [-l2, -w2, -h2], [l2, -w2, -h2],
                [l2, w2, h2], [-l2, w2, h2], [-l2, -w2, h2], [l2, -w2, h2],
            ]
        )
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        rot = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
        return c @ rot.T + np.array([self.x, self.y, self.z])

    def contains(self, pts: np.ndarray) -> np.ndarray:
        """(N,) bool: points inside the box (LiDAR frame)."""
        d = pts[:, :3] - np.array([self.x, self.y, self.z])
        cy, sy = np.cos(-self.yaw), np.sin(-self.yaw)
        lx = d[:, 0] * cy - d[:, 1] * sy
        ly = d[:, 0] * sy + d[:, 1] * cy
        return (
            (np.abs(lx) <= self.length / 2)
            & (np.abs(ly) <= self.width / 2)
            & (np.abs(d[:, 2]) <= self.height / 2)
        )


def parse_kitti_label_line(line: str) -> Box3D | None:
    """One KITTI label line -> Box3D in camera-style convention mapped to a
    z-up box. Columns: type trunc occl alpha bbox(4) h w l x y z ry [score].

    KITTI boxes are camera-frame with y down; here we keep the numbers but
    interpret (x, y, z) as LiDAR-frame center with z at box bottom + h/2,
    which matches OpenPCDet's lidar-frame label exports for DENSE.
    """
    tok = line.strip().split()
    if len(tok) < 15:
        return None
    h, w, l = float(tok[8]), float(tok[9]), float(tok[10])
    x, y, z = float(tok[11]), float(tok[12]), float(tok[13])
    ry = float(tok[14])
    score = float(tok[15]) if len(tok) > 15 else 1.0
    return Box3D(
        x=x, y=y, z=z + h / 2, length=l, width=w, height=h, yaw=ry,
        identity=tok[0], score=score,
    )


def read_label_file(path: str | Path,
                    classes=BOX_CLASSES) -> list[Box3D]:
    """Parse a KITTI-format label file, keeping the viewer's class set
    (pass classes=None for everything)."""
    boxes = []
    p = Path(path)
    if not p.exists():
        return boxes
    for line in p.read_text().splitlines():
        b = parse_kitti_label_line(line)
        if b is None:
            continue
        if classes is not None and b.identity not in classes:
            continue
        boxes.append(b)
    return boxes


# prediction-class colors (the reference's DET_COLORS role,
# `pointcloud_viewer.py:1453-1459`): index = PCDET_CLASS_LOOKUP value
DET_COLORS = ((240, 225, 60), (60, 225, 240), (240, 60, 210))
DET_FALLBACK_COLOR = (255, 255, 255)


def boxes_from_array(arr: np.ndarray, class_names=None,
                     scores=None) -> list[Box3D]:
    """(G, >=7) ``[x y z dx dy dz yaw (cls) (score)]`` rows -> Box3D list
    (z is the CENTER, the pcdet lidar-box convention — both `gt_boxes` in a
    pcdet data_dict and `boxes_lidar` in a result pkl use it). Column 7,
    when present and `class_names` given, selects the identity: prediction
    arrays carry the 0-based `PCDET_CLASS_LOOKUP` index, pcdet gt_boxes the
    1-based class id — pass the matching name tuple."""
    arr = np.asarray(arr, np.float64)
    out = []
    for i, row in enumerate(arr):
        ident = ""
        if class_names is not None and arr.shape[1] > 7:
            ci = int(row[7])
            if 0 <= ci < len(class_names):
                ident = class_names[ci]
        score = float(row[8]) if arr.shape[1] > 8 else (
            float(scores[i]) if scores is not None else 1.0
        )
        out.append(Box3D(
            x=float(row[0]), y=float(row[1]), z=float(row[2]),
            length=float(row[3]), width=float(row[4]), height=float(row[5]),
            yaw=float(row[6]), identity=ident, score=score,
        ))
    return out


def points_in_boxes(pts: np.ndarray, boxes: list[Box3D]) -> np.ndarray:
    """(N,) int: index of the first containing box, -1 outside all boxes."""
    out = np.full(len(pts), -1, dtype=np.int64)
    for i, b in reversed(list(enumerate(boxes))):
        out[b.contains(pts)] = i
    return out


def draw_boxes_bev(
    img: np.ndarray,
    boxes: list[Box3D],
    map_size=(80.0, 15.0),
    resolution: int = 10,
) -> np.ndarray:
    """Rasterize box outlines onto a BEV image from utils.render.bev_image
    (same map_size/resolution conventions). Returns the image (modified in
    place)."""
    h, w = img.shape[:2]
    for b in boxes:
        color = np.array(BOX_COLORS.get(b.identity, (255, 255, 255)), np.uint8)
        bot = b.corners()[:4, :2]
        for i in range(4):
            p0, p1 = bot[i], bot[(i + 1) % 4]
            n = max(int(np.hypot(*(p1 - p0)) * resolution * 2), 2)
            t = np.linspace(0.0, 1.0, n)[:, None]
            seg = p0[None, :] * (1 - t) + p1[None, :] * t
            xi = (resolution * (seg[:, 0] + map_size[0])).astype(np.int64)
            yi = (resolution * (seg[:, 1] + map_size[1])).astype(np.int64)
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            img[yi[ok], xi[ok]] = color
    return img
