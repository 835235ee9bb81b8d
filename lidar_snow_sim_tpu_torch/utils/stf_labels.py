"""SeeingThroughFog (DENSE) ground-truth label + calib-tree reading (the
port's copy of `lidar_snow_sim_tpu/utils/stf_labels.py`).

Equivalent of the consumed surface of the STF devkit inside
`lib/LiDAR_fog_sim` (`pointcloud_viewer.py:53,3067-3120`):

    rgb_calib = load_calib_data(root, 'calib_cam_stereo_left.json',
                                'calib_tf_tree_full.json',
                                velodyne_name='lidar_hdl64_s3_roof')
    camera_to_velodyne = rgb_calib[1]
    label = read_label(label_file, label_path,
                       camera_to_velodyne=camera_to_velodyne)

`populate_dense_boxes` then reads each annotation's ``identity``,
``posx_lidar/posy_lidar/posz_lidar``, ``length/width/height`` and
``rotx/roty/rotz`` to place 3-D boxes. The devkit source is not checked out
in the reference snapshot, so this module reimplements the documented
behavior: the calib tree is a ROS-style list of stamped transforms composed
by walking frames, labels are KITTI-style camera-frame rows transformed to
the LiDAR frame (deltas vs the original devkit are inventoried in
PARITY.md).
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np

# STF class identities consumed by the viewer's box filter
# (`pointcloud_viewer.py:3093`).
DENSE_CLASSES = ("PassengerCar", "Pedestrian", "RidableVehicle")


def _quat_to_mat(x: float, y: float, z: float, w: float) -> np.ndarray:
    n = math.sqrt(x * x + y * y + z * z + w * w) or 1.0
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _tf_to_mat(tf: dict) -> np.ndarray:
    t = tf["transform"]["translation"]
    r = tf["transform"]["rotation"]
    m = np.eye(4)
    m[:3, :3] = _quat_to_mat(r["x"], r["y"], r["z"], r["w"])
    m[:3, 3] = (t["x"], t["y"], t["z"])
    return m


def _load_tf_tree(path: Path) -> dict[str, tuple[str, np.ndarray]]:
    """child frame -> (parent frame, parent_from_child 4x4)."""
    raw = json.loads(Path(path).read_text())
    if isinstance(raw, dict):
        raw = raw.get("transforms", list(raw.values()))
    out = {}
    for tf in raw:
        parent = tf.get("header", {}).get("frame_id", tf.get("frame_id"))
        child = tf.get("child_frame_id")
        if parent is None or child is None:
            continue
        out[child] = (parent, _tf_to_mat(tf))
    return out


def _frame_to_root(tree, frame) -> np.ndarray:
    """root_from_frame by walking parents until the tree runs out."""
    m = np.eye(4)
    seen = set()
    while frame in tree and frame not in seen:
        seen.add(frame)
        frame, parent_from_child = tree[frame]
        m = parent_from_child @ m
    return m


def load_calib_data(
    path_total_dataset,
    name_camera_calib: str,
    tf_tree: str,
    velodyne_name: str = "lidar_hdl64_s3_roof",
):
    """(velodyne_to_camera, camera_to_velodyne, P, R, vtc, None, None).

    Matches the devkit's return-tuple layout as consumed by the viewer
    (index 1 = camera_to_velodyne, `pointcloud_viewer.py:3077-3079`). The
    camera frame is read from the camera calib JSON (``frame_id`` /
    ``camera_frame`` key, default 'cam_stereo_left_optical').
    """
    root = Path(path_total_dataset)
    cam = json.loads((root / name_camera_calib).read_text())
    tree = _load_tf_tree(root / tf_tree)

    cam_frame = cam.get(
        "frame_id", cam.get("camera_frame", "cam_stereo_left_optical")
    )
    root_from_cam = _frame_to_root(tree, cam_frame)
    root_from_velo = _frame_to_root(tree, velodyne_name)
    velodyne_to_camera = np.linalg.inv(root_from_cam) @ root_from_velo
    camera_to_velodyne = np.linalg.inv(velodyne_to_camera)

    p = np.asarray(cam.get("P", np.zeros(12)), float).reshape(3, 4)
    r = np.asarray(cam.get("R", np.eye(3).ravel()), float).reshape(3, 3)
    vtc = p @ np.vstack([velodyne_to_camera[:3], [0, 0, 0, 1]])
    return (velodyne_to_camera, camera_to_velodyne, p, r, vtc, None, None)


def read_label(label_file, label_path=None, camera_to_velodyne=None):
    """List of annotation dicts for one frame.

    Devkit call shape (`pointcloud_viewer.py:3083-3085`): ``label_file`` is
    the path WITHOUT the '.txt' suffix (appended here, like the devkit).
    Rows are KITTI-style camera-frame labels:

        identity truncated occluded alpha x1 y1 x2 y2 h w l X Y Z rot_y
        [score ...]

    Returned dicts carry the viewer-consumed keys: ``identity``,
    ``length/width/height``, camera ``posx/posy/posz``, LiDAR-frame
    ``posx_lidar/posy_lidar/posz_lidar`` (via camera_to_velodyne) and
    ``rotx/roty/rotz`` (LiDAR-frame Euler; yaw from the KITTI camera
    rot_y, roll/pitch 0 — the devkit's extra rotation columns are parsed
    when present).
    """
    path = Path(str(label_file) + ".txt")
    if not path.exists() and label_path is not None:
        path = Path(label_path) / path.name
    out = []
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        tok = line.split()
        if len(tok) < 15:
            continue
        try:
            vals = [float(v) for v in tok[1:15]]
        except ValueError:
            continue
        h, w, length = vals[7], vals[8], vals[9]
        x, y, z = vals[10], vals[11], vals[12]
        rot_y = vals[13]
        ann = {
            "identity": tok[0],
            "truncated": vals[0],
            "occlusion": vals[1],
            "alpha": vals[2],
            # 2D image bbox (x1, y1, x2, y2) — consumed by the KITTI
            # difficulty buckets in utils.eval_ap (bbox height in px)
            "bbox": (vals[3], vals[4], vals[5], vals[6]),
            "height": h,
            "width": w,
            "length": length,
            "posx": x,
            "posy": y,
            "posz": z,
            "roty": 0.0,
            "rotx": 0.0,
            "score": float(tok[15]) if len(tok) > 15 else 1.0,
        }
        # camera-frame yaw -> LiDAR-frame yaw (KITTI convention)
        ann["rotz"] = -rot_y - np.pi / 2
        if camera_to_velodyne is not None:
            pl = camera_to_velodyne @ np.array([x, y, z, 1.0])
            ann["posx_lidar"], ann["posy_lidar"], ann["posz_lidar"] = pl[:3]
            # KITTI centers boxes at the BOTTOM face in camera y; the
            # viewer re-adds height/2 itself (pointcloud_viewer.py:3117)
        else:
            ann["posx_lidar"] = ann["posy_lidar"] = ann["posz_lidar"] = 0.0
        out.append(ann)
    return out


def dense_boxes(label_file, label_path=None, camera_to_velodyne=None,
                classes=DENSE_CLASSES):
    """Annotations -> utils.boxes.Box3D list (LiDAR frame, center at the
    box middle) for BEV rendering / point-in-box queries."""
    from lidar_snow_sim_tpu_torch.utils.boxes import Box3D

    out = []
    for ann in read_label(label_file, label_path, camera_to_velodyne):
        if classes is not None and ann["identity"] not in classes:
            continue
        out.append(
            Box3D(
                x=ann["posx_lidar"],
                y=ann["posy_lidar"],
                z=ann["posz_lidar"] + ann["height"] / 2,
                length=ann["length"],
                width=ann["width"],
                height=ann["height"],
                yaw=ann["rotz"],
                identity=ann["identity"],
                score=ann["score"],
            )
        )
    return out
