"""KITTI-style camera calibration and camera-FOV point filtering on tensors
(counterpart of `lidar_snow_sim_tpu/camera.py`).

The reference's datagen and `augment` tail use three operations of pcdet's
`calibration_kitti.Calibration` (`tools/snowfall/simulation.py:32-47`):
lidar_to_rect, rect_to_img and get_fov_flag with img_shape (1024, 1920).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

# the DENSE HDL-64 rig, a byte-for-byte copy of the JAX package's data file
DEFAULT_CALIB_FILE = Path(__file__).parent / "data" / "calib_hdl64.txt"
DEFAULT_IMG_SHAPE = (1024, 1920)  # (H, W), simulation.py:536


def _read_kitti_calib(path: str | Path) -> dict[str, np.ndarray]:
    """Parse a KITTI-format calib txt (``KEY: v0 v1 ...`` lines)."""
    out: dict[str, np.ndarray] = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or ":" not in line:
            continue
        key, vals = line.split(":", 1)
        try:
            out[key.strip()] = np.array([float(v) for v in vals.split()])
        except ValueError:
            continue
    return out


@dataclasses.dataclass(frozen=True)
class CameraCalibration:
    """Pinhole camera calibration (KITTI convention): P2 (3, 4) projection,
    R0 (3, 3) rectification, V2C (3, 4) LiDAR -> camera extrinsics."""

    P2: np.ndarray
    R0: np.ndarray
    V2C: np.ndarray

    @classmethod
    def from_file(cls, path: str | Path) -> "CameraCalibration":
        raw = _read_kitti_calib(path)
        p2 = raw["P2"].reshape(3, 4)
        r0 = raw.get("R0_rect", raw.get("R0", np.eye(3).ravel())).reshape(3, 3)
        v2c_key = "Tr_velo_to_cam" if "Tr_velo_to_cam" in raw else "Tr_velo2cam"
        return cls(P2=p2, R0=r0, V2C=raw[v2c_key].reshape(3, 4))

    @classmethod
    def default_dense_hdl64(cls) -> "CameraCalibration":
        """The DENSE rig shipped with the JAX package."""
        return cls.from_file(DEFAULT_CALIB_FILE)

    @property
    def lidar_to_rect_matrix(self) -> np.ndarray:
        """(4, 3): right-multiply homogeneous lidar points -> rect frame."""
        m = np.vstack([self.R0 @ self.V2C, [0.0, 0.0, 0.0, 1.0]])
        return m[:3].T

    def lidar_to_rect(self, pts_lidar: torch.Tensor) -> torch.Tensor:
        """(N, 3) LiDAR points -> (N, 3) rectified-camera points."""
        m = torch.as_tensor(self.lidar_to_rect_matrix, dtype=torch.float32,
                            device=pts_lidar.device)
        return pts_lidar @ m[:3] + m[3]

    def rect_to_img(self, pts_rect: torch.Tensor):
        """(N, 3) rect points -> ((N, 2) pixel coords, (N,) rect depth),
        pcdet's semantics: pixels divide by the rect-frame z, and depth is
        proj_z - P2[2, 3]."""
        p2 = torch.as_tensor(self.P2, dtype=torch.float32,
                             device=pts_rect.device)
        hom = torch.cat([pts_rect, torch.ones_like(pts_rect[:, :1])], dim=1)
        proj = hom @ p2.T
        rz = pts_rect[:, 2]
        pts_img = proj[:, :2] / torch.where(rz == 0, 1e-9, rz)[:, None]
        depth = proj[:, 2] - float(self.P2.T[3, 2])
        return pts_img, depth


def get_fov_flag(pts_rect, img_shape, calib: CameraCalibration):
    """In-camera-FOV mask (simulation.py:39-47): the projection lands in the
    (H, W) image and the rect depth is non-negative."""
    pts_img, depth = calib.rect_to_img(pts_rect)
    h, w = img_shape
    inside = (
        (pts_img[:, 0] >= 0)
        & (pts_img[:, 0] < w)
        & (pts_img[:, 1] >= 0)
        & (pts_img[:, 1] < h)
    )
    return inside & (depth >= 0)


def camera_fov_mask(pts_lidar, calib: CameraCalibration | None = None,
                    img_shape=DEFAULT_IMG_SHAPE) -> torch.Tensor:
    """LiDAR-frame FOV mask of an (N, 3) tensor (or array, taken to the
    CPU), as the `augment` tail and `run_snowfall_datagen` use it."""
    if calib is None:
        calib = CameraCalibration.default_dense_hdl64()
    pts = torch.as_tensor(pts_lidar, dtype=torch.float32)
    return get_fov_flag(calib.lidar_to_rect(pts), img_shape, calib)
