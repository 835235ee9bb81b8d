"""pcdet DataAugmentor equivalents for detector training (counterpart of
`lidar_snow_sim_tpu/models/detector_augment.py`).

OpenPCDet's DataAugmentor pipeline for pointpillar configs is

    gt_sampling -> random_world_flip(x) -> random_world_rotation(+-pi/4)
    -> random_world_scaling([0.95, 1.05])

(public OpenPCDet `pcdet/datasets/augmentor/{data_augmentor,
database_sampler,augmentor_utils}.py` semantics); `tools/train.py` runs
the same stages.

The world transforms are elementwise tensor math over the fixed (B, N, 4)
/ (B, G, 8) batch on its device. Their per-frame draws are an argument
(`world_augment`), drawn by `world_draws` from a `torch.Generator`, so a
test can feed the JAX package's own `jax.random` draws. The gt-sampling
database is host-side numpy, as pcdet's dataloader is: the JAX package's
code with its imports pointed at the port's `utils`, deterministic per
(seed, step, frame).

Conventions match `tools/train.py`: gt rows are
(x, y, z_center, dx=length, dy=width, dz=height, yaw, class_id) with
class_id 0 marking padding rows; point pads sit at 1e3 (outside any
point_cloud_range, so they die in voxelization regardless of transform).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch


# ---------------------------------------------------------------------------
# world transforms (tensors, on the batch's device)


@dataclasses.dataclass(frozen=True)
class WorldAugmentConfig:
    """pcdet pointpillar defaults: flip along x (y sign), rotation
    U[-pi/4, pi/4], scaling U[0.95, 1.05]."""

    flip_x: bool = True
    rot_range: float = float(np.pi / 4)
    scale_min: float = 0.95
    scale_max: float = 1.05


def world_draws(generator: torch.Generator, b: int,
                cfg: WorldAugmentConfig = WorldAugmentConfig()):
    """Per-frame draws for `world_augment` from `generator` (on the CPU):
    flip (b,) bool with probability 0.5 (all False without flip_x), angle
    (b,) U[-rot_range, rot_range), scale (b,) U[scale_min, scale_max)."""
    u = torch.rand(3, b, generator=generator, dtype=torch.float64)
    flip = (u[0] < 0.5) & cfg.flip_x
    angle = (-cfg.rot_range + 2 * cfg.rot_range * u[1]).float()
    scale = (cfg.scale_min + (cfg.scale_max - cfg.scale_min) * u[2]).float()
    return flip, angle, scale


def world_augment(points, gt, flip, angle, scale):
    """Apply flip/rotation/scaling to a (B, N, 4) point batch and its
    (B, G, 8) gt boxes with the per-frame draws flip (B,) bool, angle (B,)
    and scale (B,) (`world_draws`; moved to the batch's device here).

    pcdet augmentor_utils semantics:
      - random_flip_along_x: where flip, y -> -y (points and box centers),
        yaw -> -yaw;
      - global_rotation: rotate points/centers about +z by angle,
        yaw += angle;
      - global_scaling: scale point xyz, box center AND dims by scale;
        yaw unchanged.
    Padding rows transform harmlessly: class-0 gt rows stay class 0 (the
    target assigner masks on class), 1e3 point pads stay far out of range.
    """
    dev = points.device
    flip, angle, scale = (t.to(dev) for t in (flip, angle, scale))
    sign = torch.where(flip, -1.0, 1.0)[:, None]
    py = points[..., 1] * sign
    gy = gt[..., 1] * sign
    gyaw = gt[..., 6] * sign

    c = torch.cos(angle)[:, None]
    s = torch.sin(angle)[:, None]
    px, pz = points[..., 0], points[..., 2]
    rx = px * c - py * s
    ry = px * s + py * c
    gx, gz = gt[..., 0], gt[..., 2]
    grx = gx * c - gy * s
    gry = gx * s + gy * c
    gyaw = gyaw + angle[:, None]

    sc = scale[:, None]
    out_points = torch.stack(
        [rx * sc, ry * sc, pz * sc, points[..., 3]], dim=-1
    )
    out_gt = torch.cat(
        [
            torch.stack([grx * sc, gry * sc, gz * sc], dim=-1),
            gt[..., 3:6] * sc[..., None],
            gyaw[..., None],
            gt[..., 7:8],
        ],
        dim=-1,
    )
    return out_points, out_gt


# ---------------------------------------------------------------------------
# BEV OBB overlap (host, exact separating-axis test)


def _bev_intersects(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, 7) x (K, 7) -> (M, K) bool: do the BEV rectangles overlap?

    Exact SAT for oriented rectangles (4 candidate axes per pair) — the
    database sampler only needs overlap>0 rejection (pcdet rejects sampled
    boxes at any BEV IoU > 0), not the IoU value itself.
    """
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), bool)

    def axes(boxes):
        c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
        ax = np.stack([c, s], axis=-1)           # heading axis
        ay = np.stack([-s, c], axis=-1)          # lateral axis
        return ax, ay

    a_ax, a_ay = axes(a)
    b_ax, b_ay = axes(b)
    d = a[:, None, :2] - b[None, :, :2]          # (M, K, 2)

    sep = np.zeros((len(a), len(b)), bool)
    # test the 4 axes; separated iff |d.u| > ra(u) + rb(u) on any
    for u_m in (a_ax[:, None, :], a_ay[:, None, :],
                b_ax[None, :, :], b_ay[None, :, :]):
        u = np.broadcast_to(u_m, d.shape)
        proj = np.abs(np.sum(d * u, axis=-1))
        ra = (
            a[:, None, 3] / 2 * np.abs(np.sum(a_ax[:, None] * u, axis=-1))
            + a[:, None, 4] / 2 * np.abs(np.sum(a_ay[:, None] * u, axis=-1))
        )
        rb = (
            b[None, :, 3] / 2 * np.abs(np.sum(b_ax[None, :] * u, axis=-1))
            + b[None, :, 4] / 2 * np.abs(np.sum(b_ay[None, :] * u, axis=-1))
        )
        sep |= proj > ra + rb
    return ~sep


def _points_in_box(pts: np.ndarray, box: np.ndarray) -> np.ndarray:
    """(N, >=3) x (7,) -> (N,) bool, z-centered box (Box3D.contains math)."""
    d = pts[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    lx = d[:, 0] * c - d[:, 1] * s
    ly = d[:, 0] * s + d[:, 1] * c
    return (
        (np.abs(lx) <= box[3] / 2)
        & (np.abs(ly) <= box[4] / 2)
        & (np.abs(d[:, 2]) <= box[5] / 2)
    )


# ---------------------------------------------------------------------------
# gt-sampling database (host)


class GTSampleDB:
    """pcdet DataBaseSampler equivalent, built directly from a scans+labels
    directory (pcdet bakes the same thing into `create_groundtruth_database`
    pickles). Each entry keeps the gt box at its ORIGINAL pose plus its
    interior points — pcdet pastes samples at the pose they were cut from,
    it does not re-place them."""

    def __init__(self, entries: dict):
        # {class_name: [(box7 f32, points (K, 4) f32)]}
        self.entries = {k: v for k, v in entries.items() if v}

    @classmethod
    def build(cls, scans_dir, labels_dir, class_names, *, columns=5,
              intensity_scale=1.0 / 255.0, min_points=5):
        """Scan the corpus once; keep boxes with >= min_points interior
        points (pcdet filter_by_min_points, default 5)."""
        from lidar_snow_sim_tpu_torch.utils.boxes import read_label_file
        from lidar_snow_sim_tpu_torch.utils.pointcloud import load_velodyne_bin

        entries: dict = {n: [] for n in class_names}
        for b in sorted(Path(scans_dir).glob("*.bin")):
            lf = Path(labels_dir) / (b.stem + ".txt")
            if not lf.exists():
                continue
            boxes = [
                bx for bx in read_label_file(lf, classes=None)
                if bx.identity in entries
            ]
            if not boxes:
                continue
            pc = load_velodyne_bin(b, columns=columns)[:, :4].astype(
                np.float32
            )
            pc[:, 3] *= intensity_scale
            for bx in boxes:
                box7 = np.array(
                    [bx.x, bx.y, bx.z, bx.length, bx.width, bx.height,
                     bx.yaw], np.float32,
                )
                inside = _points_in_box(pc, box7)
                if int(inside.sum()) >= min_points:
                    entries[bx.identity].append((box7, pc[inside].copy()))
        return cls(entries)

    def stats(self) -> dict:
        return {k: len(v) for k, v in self.entries.items()}

    def sample_into(self, rng: np.random.Generator, points: np.ndarray,
                    gt: np.ndarray, targets: dict, name_to_id: dict,
                    pad_value: float = 1e3):
        """Paste sampled gt boxes+points into one fixed-shape frame.

        points (N, 4) with pads at pad_value; gt (G, 8) with class-0 pads.
        targets: {class_name: desired total count} (pcdet SAMPLE_GROUPS,
        e.g. Car:15 — counts are TOTALS including the scene's own boxes).
        Returns (points', gt', n_pasted) with the SAME fixed shapes: scene
        points inside pasted boxes are removed (pcdet
        remove_points_in_boxes3d), the sample's interior points take their
        place, and the result is re-padded/subsampled to N.
        """
        g_valid = gt[:, 7] > 0
        existing = gt[g_valid, :7]
        existing_ids = gt[g_valid, 7]
        n_fixed, g_fixed = len(points), len(gt)

        placed: list = []       # (box7, class_id, pts)
        occupied = existing
        for name, want in targets.items():
            pool = self.entries.get(name, [])
            if not pool:
                continue
            have = int(np.sum(existing_ids == name_to_id[name]))
            need = min(want - have, g_fixed - len(existing) - len(placed))
            if need <= 0:
                continue
            order = rng.permutation(len(pool))
            taken = 0
            for j in order:
                if taken >= need:
                    break
                box7, pts = pool[j]
                if _bev_intersects(box7[None], occupied).any():
                    continue
                placed.append((box7, float(name_to_id[name]), pts))
                occupied = np.concatenate([occupied, box7[None]], axis=0)
                taken += 1
        if not placed:
            return points, gt, 0

        # remove scene points inside the pasted boxes, then paste
        live = ~np.all(points[:, :3] >= pad_value, axis=1)
        scene = points[live]
        keep = np.ones(len(scene), bool)
        for box7, _cid, _pts in placed:
            keep &= ~_points_in_box(scene, box7)
        parts = [scene[keep]] + [p for _b, _c, p in placed]
        merged = np.concatenate(parts, axis=0).astype(np.float32)
        if len(merged) > n_fixed:
            sel = rng.choice(len(merged), n_fixed, replace=False)
            merged = merged[sel]
        elif len(merged) < n_fixed:
            pad = np.full((n_fixed - len(merged), 4), 0.0, np.float32)
            pad[:, :3] = pad_value
            merged = np.concatenate([merged, pad], axis=0)

        out_gt = gt.copy()
        base = int(g_valid.sum())
        for i, (box7, cid, _pts) in enumerate(placed):
            out_gt[base + i, :7] = box7
            out_gt[base + i, 7] = cid
        return merged, out_gt, len(placed)


def parse_sample_groups(spec: str) -> dict:
    """'Car:15,Pedestrian:10' -> {'Car': 15, 'Pedestrian': 10} (pcdet
    SAMPLE_GROUPS syntax flattened into one flag)."""
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, cnt = part.partition(":")
        out[name.strip()] = int(cnt)
    return out
