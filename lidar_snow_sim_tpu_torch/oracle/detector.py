"""NumPy oracle for detector geometry: rotated IoU + greedy NMS.

Independent float64 implementation (classic Sutherland–Hodgman polygon
clipping with Python loops) used to golden-test the fixed-shape candidate
enumeration in `ops/rotated_iou.py`. Semantics follow OpenPCDet's
`pcdet.ops.iou3d_nms` (the surface the reference's live-inference path
consumes, `pointcloud_viewer.py:2388-2436`).
"""

from __future__ import annotations

import numpy as np


def corners_bev(box) -> np.ndarray:
    """(5,) [x, y, dx, dy, heading] -> (4, 2) CCW corners."""
    x, y, dx, dy, h = (float(box[i]) for i in range(5))
    c, s = np.cos(h), np.sin(h)
    local = np.array(
        [[dx / 2, dy / 2], [-dx / 2, dy / 2],
         [-dx / 2, -dy / 2], [dx / 2, -dy / 2]]
    )
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + np.array([x, y])


def _clip_polygon(poly: list, edge_p0: np.ndarray, edge_p1: np.ndarray):
    """Clip polygon (vertex list) to the left half-plane of edge p0->p1."""
    e = edge_p1 - edge_p0

    def inside(p):
        return e[0] * (p[1] - edge_p0[1]) - e[1] * (p[0] - edge_p0[0]) >= -1e-12

    out = []
    n = len(poly)
    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        cin, nin = inside(cur), inside(nxt)
        if cin:
            out.append(cur)
        if cin != nin:
            d = nxt - cur
            denom = e[0] * d[1] - e[1] * d[0]
            if abs(denom) > 1e-16:
                t = (e[0] * (edge_p0[1] - cur[1])
                     - e[1] * (edge_p0[0] - cur[0])) / denom
                out.append(cur + np.clip(t, 0.0, 1.0) * d)
    return out


def intersection_area_bev(box_a, box_b) -> float:
    ca = corners_bev(np.asarray(box_a, np.float64))
    cb = corners_bev(np.asarray(box_b, np.float64))
    poly = [ca[i] for i in range(4)]
    for i in range(4):
        poly = _clip_polygon(poly, cb[i], cb[(i + 1) % 4])
        if len(poly) < 3:
            return 0.0
    p = np.array(poly)
    q = np.roll(p, -1, axis=0)
    return float(0.5 * abs(np.sum(p[:, 0] * q[:, 1] - q[:, 0] * p[:, 1])))


def _bev5(boxes: np.ndarray) -> np.ndarray:
    boxes = np.asarray(boxes, np.float64)
    if boxes.shape[-1] >= 7:
        return boxes[:, [0, 1, 3, 4, 6]]
    return boxes[:, :5]


def iou_bev(boxes_a, boxes_b) -> np.ndarray:
    a = _bev5(boxes_a)
    b = _bev5(boxes_b)
    out = np.zeros((len(a), len(b)))
    for i in range(len(a)):
        for j in range(len(b)):
            inter = intersection_area_bev(a[i], b[j])
            union = a[i, 2] * a[i, 3] + b[j, 2] * b[j, 3] - inter
            out[i, j] = inter / max(union, 1e-8)
    return out


def iou3d(boxes_a, boxes_b) -> np.ndarray:
    """7-DoF 3D IoU (BEV footprint x z overlap), pcdet boxes_iou3d_gpu."""
    a = np.asarray(boxes_a, np.float64)
    b = np.asarray(boxes_b, np.float64)
    out = np.zeros((len(a), len(b)))
    for i in range(len(a)):
        for j in range(len(b)):
            inter_bev = intersection_area_bev(
                a[i, [0, 1, 3, 4, 6]], b[j, [0, 1, 3, 4, 6]]
            )
            dz = min(a[i, 2] + a[i, 5] / 2, b[j, 2] + b[j, 5] / 2) - max(
                a[i, 2] - a[i, 5] / 2, b[j, 2] - b[j, 5] / 2
            )
            inter = inter_bev * max(dz, 0.0)
            vol = a[i, 3] * a[i, 4] * a[i, 5] + b[j, 3] * b[j, 4] * b[j, 5]
            out[i, j] = inter / max(vol - inter, 1e-8)
    return out


def voxelize(points, pc_range, voxel_size, max_points_per_voxel,
             max_voxels):
    """Literal OpenPCDet VoxelGenerator semantics (the spconv
    Point2VoxelCPU behavior pcdet's transform_points_to_voxels wraps):
    walk points in stream order; each new in-range voxel is appended in
    first-appearance order (up to max_voxels); each voxel keeps its first
    max_points_per_voxel points; later points/voxels are silently dropped.

    Returns (voxels (V, P, F), coords (V, 3) zyx, num_points (V,),
    n_points_dropped, n_voxels_dropped).
    """
    points = np.asarray(points)
    r = np.asarray(pc_range, np.float64)
    v = np.asarray(voxel_size, np.float64)
    grid = np.round((r[3:] - r[:3]) / v).astype(np.int64)

    voxel_of: dict = {}
    voxels: list = []
    coords: list = []
    counts: list = []
    pts_dropped = vox_dropped = 0
    for p in points:
        ijk = np.floor((p[:3] - r[:3]) / v).astype(np.int64)
        if np.any(ijk < 0) or np.any(ijk >= grid):
            continue
        key = (int(ijk[2]), int(ijk[1]), int(ijk[0]))  # (z, y, x)
        slot = voxel_of.get(key)
        if slot is None:
            if len(voxels) >= max_voxels:
                vox_dropped += 1
                pts_dropped += 1
                voxel_of[key] = -1
                continue
            slot = len(voxels)
            voxel_of[key] = slot
            voxels.append(
                np.zeros((max_points_per_voxel, points.shape[1]),
                         points.dtype)
            )
            coords.append(key)
            counts.append(0)
        elif slot == -1:
            pts_dropped += 1  # its voxel was dropped; count the point too
            continue
        if counts[slot] < max_points_per_voxel:
            voxels[slot][counts[slot]] = p
            counts[slot] += 1
        else:
            pts_dropped += 1
    if voxels:
        return (
            np.stack(voxels), np.array(coords, np.int32),
            np.array(counts, np.int32), pts_dropped, vox_dropped,
        )
    f = points.shape[1]
    return (
        np.zeros((0, max_points_per_voxel, f), points.dtype),
        np.zeros((0, 3), np.int32), np.zeros((0,), np.int32), 0, 0,
    )


def nms_rotated(boxes, scores, iou_threshold: float) -> list:
    """Greedy rotated NMS; returns kept indices in descending score order."""
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind="stable")
    kept: list = []
    for i in order:
        ok = True
        for j in kept:
            inter = intersection_area_bev(_bev5(boxes)[i], _bev5(boxes)[j])
            union = (
                _bev5(boxes)[i, 2] * _bev5(boxes)[i, 3]
                + _bev5(boxes)[j, 2] * _bev5(boxes)[j, 3]
                - inter
            )
            if inter / max(union, 1e-8) > iou_threshold:
                ok = False
                break
        if ok:
            kept.append(int(i))
    return kept
