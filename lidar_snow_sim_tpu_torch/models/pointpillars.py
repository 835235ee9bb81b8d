"""PointPillars detector inference and training forward on tensors
(counterpart of `lidar_snow_sim_tpu/models/pointpillars.py`).

The reference's live inference (`pointcloud_viewer.py:2388-2498`) runs an
OpenPCDet PointPillars network from an experiment directory on the
displayed cloud and renders `pred_boxes/pred_labels/pred_scores` as a
(K, 9) array. This module gives the same contract on PyTorch:

- `PointPillars` is an `nn.Module` whose state dict carries pcdet's names
  (`vfe.pfn_layers.i.{linear,norm}`, `backbone_2d.{blocks,deblocks}.i.k`,
  `dense_head.conv_{cls,box,dir_cls}`), so a pcdet checkpoint and the JAX
  package's flat parameter dict (`params_from_jax`) load by name;
- `voxelize` keeps pcdet's VoxelGenerator semantics with fixed shapes and
  counted truncation (one stable sort on the voxel id, then gathers and
  unique-index scatters), then the PFN, the BEV scatter, the conv backbone
  (cuDNN convolutions), the anchor head, and `post_process`: best class,
  score threshold, top `nms_pre_max`, rotated NMS (`ops/rotated_iou.py`);
- `detect` keeps everything on the device; its only host reads are the
  NMS fixpoint's convergence test (one a sweep) and, for the caller, the
  final `count`;
- `train_forward` is the batched training forward for
  `models/detector_train.py`: batch-statistic BN (`_bn_train`, masked
  over live pillars in the PFN), the head's maps flattened over the
  anchors (`head_forward`), the new running stats returned, not written;
  `encode_boxes` is pcdet's residual encoding of the targets.

With `compute_dtype="float32"` the convolutions and the PFN's product run
in true float32 whatever the caller's TF32 flags say (the flags are set
for the call and restored); with "bfloat16" the network runs in bf16 and
the decode stays float32, as in the JAX package. Every division by a
Python number goes through `ops/f32.div`: the voxel index is a boundary
decision, and torch's CUDA division by a scalar multiplies by its
reciprocal. Entry points run on the card unless the CPU is asked for.

Two counters differ from the JAX package's, which mixes each with
another condition (see `Predictions` and `VoxelizeResult`): the two-stage
top-k's possible block misses are `topk_block_miss`, apart from pcdet's
`nms_pre_overflow`; and under `voxel_active_points`, `pillars_dropped`
also counts the pillar heads the prefix clips.

This module imports torch and numpy only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.ops.f32 import div
from lidar_snow_sim_tpu_torch.ops.rotated_iou import nms_rotated

_BN_EPS = 1e-3  # pcdet uses BatchNorm(eps=1e-3, momentum=0.01) throughout
_BN_MOMENTUM = 0.01
_SENTINEL = 2**31 - 1  # voxel id of a point outside the grid


@dataclasses.dataclass(frozen=True)
class PointPillarsConfig:
    """Static PointPillars hyperparameters (OpenPCDet yaml equivalents);
    the JAX package's fields and defaults (OpenPCDet's public KITTI
    ``pointpillar.yaml``). `config_from_openpcdet_yaml` maps an
    experiment's own yaml onto them.

    `pillar_gather` and `bev_packed` choose a layout of the same bytes in
    the JAX package; the port keeps them so that a JAX config carries over
    field for field, and they change nothing here (one layout, the same
    outputs: tests/test_torch_detector.py holds both against the JAX
    package with them set).
    `topk_block_m` > 0 selects the two-stage top-k in `post_process` (per
    128-anchor block the top m, then one sort of the candidates), 0 the
    global stable sort. `voxel_active_points` > 0 scatters only that
    prefix of the voxel-sorted points (exact while the scan's in-range
    points fit; what lies beyond is counted in `prefix_overflow`).
    """

    class_names: tuple = ("Car", "Pedestrian", "Cyclist")
    # DATA_CONFIG.POINT_CLOUD_RANGE [x0, y0, z0, x1, y1, z1]
    point_cloud_range: tuple = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
    # DATA_PROCESSOR transform_points_to_voxels
    voxel_size: tuple = (0.16, 0.16, 4.0)
    max_points_per_pillar: int = 32
    max_pillars: int = 12000
    # MODEL.VFE
    pfn_filters: tuple = (64,)
    # MODEL.BACKBONE_2D
    layer_nums: tuple = (3, 5, 5)
    layer_strides: tuple = (2, 2, 2)
    num_filters: tuple = (64, 128, 256)
    upsample_strides: tuple = (1, 2, 4)
    num_upsample_filters: tuple = (128, 128, 128)
    # MODEL.DENSE_HEAD (AnchorHeadSingle); one (sizes, bottom, rots) per class
    anchor_sizes: tuple = (
        (3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73)
    )
    anchor_bottom_heights: tuple = (-1.78, -0.6, -0.6)
    anchor_rotations: tuple = (0.0, 1.5707963)
    anchor_match_thresholds: tuple = (0.6, 0.5, 0.5)
    anchor_unmatch_thresholds: tuple = (0.45, 0.35, 0.35)
    feature_map_stride: int = 2
    dir_offset: float = 0.78539
    dir_limit_offset: float = 0.0
    num_dir_bins: int = 2
    # MODEL.POST_PROCESSING
    score_thresh: float = 0.1
    nms_thresh: float = 0.01
    nms_pre_max: int = 4096
    nms_post_max: int = 500
    # "float32" | "bfloat16": the network's dtype; decode stays float32
    compute_dtype: str = "float32"
    pillar_gather: bool = False   # JAX layout switch; no effect here
    bev_packed: bool = False      # JAX layout switch; no effect here
    topk_block_m: int = 16
    voxel_active_points: int = 0

    @property
    def grid_size(self) -> tuple:
        """(nx, ny, nz) full-resolution voxel grid."""
        r = self.point_cloud_range
        v = self.voxel_size
        return (
            int(round((r[3] - r[0]) / v[0])),
            int(round((r[4] - r[1]) / v[1])),
            int(round((r[5] - r[2]) / v[2])),
        )

    @property
    def feature_map_size(self) -> tuple:
        """(ny_f, nx_f) anchor/head grid (backbone output stride)."""
        nx, ny, _ = self.grid_size
        s = self.feature_map_stride
        return (ny // s, nx // s)

    @property
    def num_anchors_per_loc(self) -> int:
        return len(self.class_names) * len(self.anchor_rotations)


def config_from_openpcdet_yaml(path) -> PointPillarsConfig:
    """Parse the subset of an OpenPCDet experiment yaml this engine needs
    (the fields `init_config` touches, `pointcloud_viewer.py:2438-2457`);
    unknown sections are ignored."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)

    kw: dict = {}
    if "CLASS_NAMES" in cfg:
        kw["class_names"] = tuple(cfg["CLASS_NAMES"])
    data = cfg.get("DATA_CONFIG", {})
    if "POINT_CLOUD_RANGE" in data:
        kw["point_cloud_range"] = tuple(
            float(v) for v in data["POINT_CLOUD_RANGE"])
    for proc in data.get("DATA_PROCESSOR", []):
        if proc.get("NAME") == "transform_points_to_voxels":
            kw["voxel_size"] = tuple(float(v) for v in proc["VOXEL_SIZE"])
            kw["max_points_per_pillar"] = int(proc["MAX_POINTS_PER_VOXEL"])
            mv = proc.get("MAX_NUMBER_OF_VOXELS", {})
            if isinstance(mv, Mapping):
                kw["max_pillars"] = int(mv.get("test", mv.get("train", 12000)))
            else:
                kw["max_pillars"] = int(mv)
    model = cfg.get("MODEL", {})
    vfe = model.get("VFE", {})
    if "NUM_FILTERS" in vfe:
        kw["pfn_filters"] = tuple(int(v) for v in vfe["NUM_FILTERS"])
    bb = model.get("BACKBONE_2D", {})
    for src, dst in (
        ("LAYER_NUMS", "layer_nums"), ("LAYER_STRIDES", "layer_strides"),
        ("NUM_FILTERS", "num_filters"),
        ("UPSAMPLE_STRIDES", "upsample_strides"),
        ("NUM_UPSAMPLE_FILTERS", "num_upsample_filters"),
    ):
        if src in bb:
            kw[dst] = tuple(int(v) for v in bb[src])
    head = model.get("DENSE_HEAD", {})
    agc = head.get("ANCHOR_GENERATOR_CONFIG", [])
    if agc:
        kw["anchor_sizes"] = tuple(
            tuple(float(x) for x in a["anchor_sizes"][0]) for a in agc
        )
        kw["anchor_bottom_heights"] = tuple(
            float(a["anchor_bottom_heights"][0]) for a in agc
        )
        kw["anchor_rotations"] = tuple(
            float(r) for r in agc[0]["anchor_rotations"]
        )
        kw["anchor_match_thresholds"] = tuple(
            float(a["matched_threshold"]) for a in agc
        )
        kw["anchor_unmatch_thresholds"] = tuple(
            float(a["unmatched_threshold"]) for a in agc
        )
        kw["feature_map_stride"] = int(agc[0].get("feature_map_stride", 2))
    if "DIR_OFFSET" in head:
        kw["dir_offset"] = float(head["DIR_OFFSET"])
    if "DIR_LIMIT_OFFSET" in head:
        kw["dir_limit_offset"] = float(head["DIR_LIMIT_OFFSET"])
    if "NUM_DIR_BINS" in head:
        kw["num_dir_bins"] = int(head["NUM_DIR_BINS"])
    post = model.get("POST_PROCESSING", {})
    if "SCORE_THRESH" in post:
        kw["score_thresh"] = float(post["SCORE_THRESH"])
    nms = post.get("NMS_CONFIG", {})
    if "NMS_THRESH" in nms:
        kw["nms_thresh"] = float(nms["NMS_THRESH"])
    if "NMS_PRE_MAXSIZE" in nms:
        kw["nms_pre_max"] = int(nms["NMS_PRE_MAXSIZE"])
    if "NMS_POST_MAXSIZE" in nms:
        kw["nms_post_max"] = int(nms["NMS_POST_MAXSIZE"])
    return PointPillarsConfig(**kw)


# ---------------------------------------------------------------------------
# parameters


def param_shapes(cfg: PointPillarsConfig) -> dict:
    """{openpcdet_state_dict_name: shape} for every learnable/stat array."""
    shapes: dict = {}

    def bn(prefix, c):
        shapes[f"{prefix}.weight"] = (c,)
        shapes[f"{prefix}.bias"] = (c,)
        shapes[f"{prefix}.running_mean"] = (c,)
        shapes[f"{prefix}.running_var"] = (c,)

    in_ch = 10
    for i, c in enumerate(cfg.pfn_filters):
        shapes[f"vfe.pfn_layers.{i}.linear.weight"] = (c, in_ch)
        bn(f"vfe.pfn_layers.{i}.norm", c)
        in_ch = c

    c_in = cfg.pfn_filters[-1]
    for i, (n, c) in enumerate(zip(cfg.layer_nums, cfg.num_filters)):
        # Sequential [ZeroPad2d, Conv2d, BN, ReLU, (Conv2d, BN, ReLU) * n]
        shapes[f"backbone_2d.blocks.{i}.1.weight"] = (c, c_in, 3, 3)
        bn(f"backbone_2d.blocks.{i}.2", c)
        for j in range(n):
            shapes[f"backbone_2d.blocks.{i}.{3 * j + 4}.weight"] = (c, c, 3, 3)
            bn(f"backbone_2d.blocks.{i}.{3 * j + 5}", c)
        c_in = c
    for i, (u, c, cu) in enumerate(
        zip(cfg.upsample_strides, cfg.num_filters, cfg.num_upsample_filters)
    ):
        if u >= 1:
            # ConvTranspose2d(c, cu, u, stride=u): torch weight (in, out, k, k)
            shapes[f"backbone_2d.deblocks.{i}.0.weight"] = (c, cu, u, u)
        else:  # downsample conv variant (stride 1/u)
            k = int(round(1 / u))
            shapes[f"backbone_2d.deblocks.{i}.0.weight"] = (cu, c, k, k)
        bn(f"backbone_2d.deblocks.{i}.1", cu)

    c_cat = sum(cfg.num_upsample_filters)
    a = cfg.num_anchors_per_loc
    ncls = len(cfg.class_names)
    shapes["dense_head.conv_cls.weight"] = (a * ncls, c_cat, 1, 1)
    shapes["dense_head.conv_cls.bias"] = (a * ncls,)
    shapes["dense_head.conv_box.weight"] = (a * 7, c_cat, 1, 1)
    shapes["dense_head.conv_box.bias"] = (a * 7,)
    shapes["dense_head.conv_dir_cls.weight"] = (a * cfg.num_dir_bins, c_cat,
                                                1, 1)
    shapes["dense_head.conv_dir_cls.bias"] = (a * cfg.num_dir_bins,)
    return shapes


def init_params(cfg: PointPillarsConfig,
                generator: torch.Generator) -> dict:
    """Random parameters on the CPU from `generator`, by the JAX package's
    rules (kaiming-style fans; pcdet's head init: conv_cls bias
    -log((1 - 0.01) / 0.01), conv_box.weight ~ N(0, 0.001); BN weight and
    running_var 1, bias and running_mean 0). Names are drawn in sorted
    order, so one seed gives one set of weights on every device."""
    params: dict = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name == "dense_head.conv_cls.bias":
            params[name] = torch.full(shape, -math.log((1 - 0.01) / 0.01))
        elif name == "dense_head.conv_box.weight":
            params[name] = 0.001 * torch.randn(shape, generator=generator)
        elif len(shape) == 1:
            one = name.endswith(("running_var", ".weight"))
            params[name] = torch.ones(shape) if one else torch.zeros(shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            std = math.sqrt(2.0 / max(fan_in, 1))
            params[name] = std * torch.randn(shape, generator=generator)
    return params


def params_from_jax(params: Mapping[str, Any],
                    cfg: PointPillarsConfig) -> dict:
    """The JAX package's flat {pcdet name: array} parameters (numpy arrays
    or tensors) as a float32 state dict for `PointPillars`. The names must
    be exactly `param_shapes(cfg)`'s and every shape must match; anything
    else raises ValueError. (`num_batches_tracked` buffers, which neither
    package uses at inference, are not part of it.)"""
    shapes = param_shapes(cfg)
    problems = [f"missing: {k} {shapes[k]}" for k in shapes
                if k not in params]
    problems += [f"unknown: {k}" for k in params if k not in shapes]
    state = {}
    for name, shape in shapes.items():
        if name not in params:
            continue
        v = params[name]
        t = (v.detach() if isinstance(v, torch.Tensor)
             else torch.tensor(np.asarray(v))).to("cpu", torch.float32)
        if tuple(t.shape) != tuple(shape):
            problems.append(f"shape mismatch: {name} {tuple(t.shape)} != "
                            f"{tuple(shape)}")
        state[name] = t
    if problems:
        raise ValueError("parameters do not match the config:\n  "
                         + "\n  ".join(problems))
    return state


class PointPillars(nn.Module):
    """The pcdet PointPillars module tree (PillarVFE, BaseBEVBackbone,
    AnchorHeadSingle) holding the detector's weights under pcdet's
    state-dict names, on `device` (default the card; raises where there is
    none). `params` is a flat {name: array} dict (`init_params`,
    `params_from_jax`'s input, a converted checkpoint), checked by
    `params_from_jax`. The forward pass is `detect`; the anchor grid rides
    along as a buffer that is not part of the state dict."""

    def __init__(self, cfg: PointPillarsConfig, params: Mapping[str, Any],
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg

        vfe = nn.Module()
        pfn = nn.ModuleList()
        in_ch = 10
        for c in cfg.pfn_filters:
            layer = nn.Module()
            layer.linear = nn.Linear(in_ch, c, bias=False)
            layer.norm = nn.BatchNorm1d(c, eps=_BN_EPS, momentum=0.01)
            pfn.append(layer)
            in_ch = c
        vfe.pfn_layers = pfn
        self.vfe = vfe

        bb = nn.Module()
        blocks, deblocks = nn.ModuleList(), nn.ModuleList()
        c_in = cfg.pfn_filters[-1]
        for n, s, c in zip(cfg.layer_nums, cfg.layer_strides,
                           cfg.num_filters):
            layers = [nn.ZeroPad2d(1), nn.Conv2d(c_in, c, 3, stride=s,
                                                 bias=False),
                      nn.BatchNorm2d(c, eps=_BN_EPS, momentum=0.01),
                      nn.ReLU()]
            for _ in range(n):
                layers += [nn.Conv2d(c, c, 3, padding=1, bias=False),
                           nn.BatchNorm2d(c, eps=_BN_EPS, momentum=0.01),
                           nn.ReLU()]
            blocks.append(nn.Sequential(*layers))
            c_in = c
        for u, c, cu in zip(cfg.upsample_strides, cfg.num_filters,
                            cfg.num_upsample_filters):
            if u >= 1:
                up = nn.ConvTranspose2d(c, cu, u, stride=u, bias=False)
            else:
                k = int(round(1 / u))
                up = nn.Conv2d(c, cu, k, stride=k, bias=False)
            deblocks.append(nn.Sequential(
                up, nn.BatchNorm2d(cu, eps=_BN_EPS, momentum=0.01), nn.ReLU()))
        bb.blocks, bb.deblocks = blocks, deblocks
        self.backbone_2d = bb

        a = cfg.num_anchors_per_loc
        c_cat = sum(cfg.num_upsample_filters)
        head = nn.Module()
        head.conv_cls = nn.Conv2d(c_cat, a * len(cfg.class_names), 1)
        head.conv_box = nn.Conv2d(c_cat, a * 7, 1)
        head.conv_dir_cls = nn.Conv2d(c_cat, a * cfg.num_dir_bins, 1)
        self.dense_head = head

        missing, unexpected = self.load_state_dict(
            params_from_jax(params, cfg), strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:  # params_from_jax checked the names
            raise ValueError(f"module tree and param_shapes disagree: "
                             f"{missing} {unexpected}")
        self.register_buffer("anchors", torch.from_numpy(
            generate_anchors(cfg)), persistent=False)
        self.to(dev).eval()

    @property
    def device(self) -> torch.device:
        return self.anchors.device

    def forward(self, points, valid=None):
        return detect(points, valid, self, device=self.device)


# ---------------------------------------------------------------------------
# voxelization


class VoxelizeResult(NamedTuple):
    """Pillar tensors and truncation counters (int32, on the device).

    `pillars_dropped` counts pcdet's pillars beyond `max_pillars`; under
    `voxel_active_points` it also counts the pillar heads beyond the
    prefix, so that `num_pillars + pillars_dropped` is every pillar of the
    scan. Where the prefix holds at least `max_pillars` pillars, or clips
    no head, it then equals the run without the prefix (the JAX package
    counts only the heads inside the prefix). Points beyond the prefix
    that would have been kept are `prefix_overflow`, not `points_dropped`.
    """

    pillars: Any          # (V, P, 4)
    coords: Any           # (V, 3) int32, (z, y, x)
    num_points: Any       # (V,) int32
    num_pillars: Any      # scalar int32
    points_dropped: Any   # scalar int32
    pillars_dropped: Any  # scalar int32
    prefix_overflow: Any  # in-range points beyond voxel_active_points


def _voxel_index(col, lo: float, size: float, n: int):
    """floor((col - lo) / size) as int32, correctly rounded on every
    device, clamped to [-1, n] so the cast keeps the in-range decision."""
    return torch.clamp(torch.floor(div(col - lo, size)), -1, n).to(
        torch.int32)


def voxelize(points: torch.Tensor, valid: torch.Tensor,
             cfg: PointPillarsConfig) -> VoxelizeResult:
    """Fixed-shape pillar voxelization with OpenPCDet VoxelGenerator
    semantics: pillars ordered by FIRST APPEARANCE of their voxel in the
    point stream, each keeping its first `max_points_per_pillar` points in
    stream order; pillars beyond `max_pillars` and points beyond the
    per-pillar cap are dropped (as pcdet does) but COUNTED.

    points: (N, 4) [x, y, z, feat] float32; valid: (N,) bool. One stable
    sort on the voxel id (stream order within a run), the pillar rank of
    each run's head by a second stable sort, gathered down each run from
    its head, then unique-index scatters. Equal to the JAX package's output
    byte for byte, under `pillar_gather` too (see `VoxelizeResult` for the
    one counter that differs under `voxel_active_points`).
    """
    n = points.shape[0]
    dev = points.device
    i32 = torch.int32
    vmax, pmax = cfg.max_pillars, cfg.max_points_per_pillar
    r = cfg.point_cloud_range
    nx, ny, nz = cfg.grid_size

    ix = _voxel_index(points[:, 0], r[0], cfg.voxel_size[0], nx)
    iy = _voxel_index(points[:, 1], r[1], cfg.voxel_size[1], ny)
    iz = _voxel_index(points[:, 2], r[2], cfg.voxel_size[2], nz)
    in_range = (
        valid
        & (ix >= 0) & (ix < nx)
        & (iy >= 0) & (iy < ny)
        & (iz >= 0) & (iz < nz)
    )
    vid = torch.where(in_range, (iz * ny + iy) * nx + ix, _SENTINEL)

    svid, perm = torch.sort(vid, stable=True)
    cols = points[perm]                                   # (N, 4) sorted
    sidx = perm.to(i32)
    sval = svid != _SENTINEL
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    boundary[1:] = svid[1:] != svid[:-1]
    head = boundary & sval
    pos = torch.arange(n, dtype=i32, device=dev)
    head_pos = torch.cummax(torch.where(head, pos, -1), 0).values
    within = pos - head_pos                               # rank in pillar

    # pillar rank = first-appearance order = rank of the head's stream
    # index among the heads; the sort's permutation is then inverted
    head_key = torch.where(head, sidx, n)
    run_rank_order = torch.sort(head_key, stable=True).indices
    rank_of_pos = torch.empty(n, dtype=i32, device=dev)
    rank_of_pos[run_rank_order] = pos
    # each point takes its run head's rank; head_pos is -1 only before the
    # first head, where sval is False
    vrank = rank_of_pos[torch.clamp_min(head_pos, 0).long()]

    ok = sval & (vrank < vmax) & (within < pmax)
    points_dropped = (sval & ~ok).sum().to(i32)
    ap = cfg.voxel_active_points
    prefix_overflow = torch.zeros((), dtype=i32, device=dev)
    if not ap or ap >= n:
        ap = n
    else:
        prefix_overflow = ok[ap:].sum().to(i32)
    n_heads = head[:ap].sum()
    num_pillars = torch.clamp_max(n_heads, vmax)
    # heads the prefix clips are dropped pillars too
    pillars_dropped = (n_heads - num_pillars + head[ap:].sum()).to(i32)

    # per-pillar counts = min(run length, pmax) at the heads, the run
    # length clipped at the scatter prefix; next boundary by a reverse
    # running min
    hsel = head & (vrank < vmax)
    head_slot = torch.where(hsel, vrank, vmax).long()[:ap]
    bpos = torch.where(boundary, pos, n)
    next_boundary = torch.full_like(pos, n)
    next_boundary[:-1] = torch.flip(
        torch.cummin(torch.flip(bpos, (0,)), 0).values, (0,))[1:]
    rlen = torch.clamp_max(torch.clamp_max(next_boundary, ap) - pos, pmax)

    slot = torch.where(ok, vrank.long() * pmax + within, vmax * pmax)[:ap]
    buf = torch.zeros(vmax * pmax + 1, 4, dtype=points.dtype, device=dev)
    buf[slot] = torch.where(ok[:, None], cols, 0.0)[:ap]
    pillars = buf[:-1].view(vmax, pmax, 4)

    pvid = torch.zeros(vmax + 1, dtype=i32, device=dev)
    pvid[head_slot] = torch.where(hsel, svid, 0)[:ap]
    counts = torch.zeros(vmax + 1, dtype=i32, device=dev)
    counts[head_slot] = torch.where(hsel, rlen, 0)[:ap]
    pvid, counts = pvid[:-1], counts[:-1]
    coords = torch.stack(
        [pvid // (nx * ny), (pvid // nx) % ny, pvid % nx], dim=-1)

    return VoxelizeResult(
        pillars=pillars,
        coords=coords,
        num_points=counts,
        num_pillars=num_pillars.to(i32),
        points_dropped=points_dropped,
        pillars_dropped=pillars_dropped,
        prefix_overflow=prefix_overflow,
    )


# ---------------------------------------------------------------------------
# network blocks


@contextlib.contextmanager
def _true_float32():
    """cuDNN convolutions and cuBLAS products in IEEE float32 for the
    duration of the call, whatever the caller's TF32 flags; the caller's
    other cuDNN flags are kept, and every flag is restored after."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        # flags() sets each argument it is given, and its `enabled`
        # defaults to False: pass the caller's values
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         benchmark_limit=cudnn.benchmark_limit,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = old


def _bn(x, norm: nn.Module, dim: int = 1):
    """Inference batch norm along `dim` with running stats (eps 1e-3), in
    the JAX package's order: (x - mean) * rsqrt(var + eps) * w + b."""
    shape = [1] * x.ndim
    shape[dim] = x.shape[dim]

    def g(t):
        return t.to(x.dtype).view(shape)

    inv = torch.rsqrt(norm.running_var.float() + _BN_EPS)
    return (x - g(norm.running_mean)) * g(inv) * g(norm.weight) + g(norm.bias)


def _bn_train(x, norm: nn.Module, dim: int = 1, mask=None, reduce=None):
    """Training batch norm along `dim` (the JAX package's `_bn(train=True)`):
    batch statistics in float32 over every other dim, weighted by `mask`
    (broadcast to x) where given, normalized with the biased variance.
    Returns (y, running_mean, running_var): the running stats after this
    batch (momentum 0.01, running_var from the Bessel-corrected variance),
    detached and not written into `norm`.

    With `reduce` (data parallelism: `parallel/distributed.all_reduce_sum`)
    the statistics are those of every rank's batch together: the masked
    sum, sum of squares and count are reduced, differentiably, before the
    mean and variance are taken."""
    dim = dim % x.ndim
    red = tuple(i for i in range(x.ndim) if i != dim)
    shape = [1] * x.ndim
    shape[dim] = x.shape[dim]
    xf = x.float()
    if reduce is not None:
        w = (torch.ones_like(xf) if mask is None
             else torch.broadcast_to(mask.float(), x.shape))
        sums = reduce(torch.stack([torch.sum(xf * w, dim=red),
                                   torch.sum(xf * xf * w, dim=red),
                                   torch.sum(w, dim=red)]))
        n = torch.clamp_min(sums[2], 1.0)
        mean = sums[0] / n
        var = sums[1] / n - mean * mean
        bessel = n / torch.clamp_min(n - 1.0, 1.0)
    elif mask is None:
        mean = torch.mean(xf, dim=red)
        var = torch.mean(xf * xf, dim=red) - mean * mean
        nf = float(np.prod([x.shape[i] for i in red]))
        bessel = nf / max(nf - 1.0, 1.0)
    else:
        w = torch.broadcast_to(mask.float(), x.shape)
        n = torch.clamp_min(torch.sum(w, dim=red), 1.0)
        mean = torch.sum(xf * w, dim=red) / n
        var = torch.sum(xf * xf * w, dim=red) / n - mean * mean
        bessel = n / torch.clamp_min(n - 1.0, 1.0)
    m = _BN_MOMENTUM
    with torch.no_grad():
        run_mean = (1 - m) * norm.running_mean + m * mean
        run_var = (1 - m) * norm.running_var + m * var * bessel
    inv = torch.rsqrt(var + _BN_EPS).to(x.dtype).view(shape)
    y = (x - mean.to(x.dtype).view(shape)) * inv
    return (y * norm.weight.to(x.dtype).view(shape)
            + norm.bias.to(x.dtype).view(shape)), run_mean, run_var


def _norm(x, norm: nn.Module, name: str, stats, dim: int = 1, mask=None,
          reduce=None):
    """`_bn` where `stats` is None; else `_bn_train` (with `reduce`), the
    new running stats put in `stats` under `name`'s state-dict keys."""
    if stats is None:
        return _bn(x, norm, dim)
    y, stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = \
        _bn_train(x, norm, dim, mask, reduce)
    return y


def pillar_features(vox: VoxelizeResult, cfg: PointPillarsConfig):
    """PillarVFE's 10-feature encoding: [xyzi, cluster offset, center
    offset] with padded points zeroed (pcdet PillarVFE.forward)."""
    pts = vox.pillars                                     # (V, P, 4)
    cnt = torch.clamp_min(vox.num_points, 1)[:, None, None].to(pts.dtype)
    pmask = (
        torch.arange(cfg.max_points_per_pillar, device=pts.device)[None, :]
        < vox.num_points[:, None]
    )[..., None].to(pts.dtype)                            # (V, P, 1)

    mean = torch.sum(pts[..., :3] * pmask, dim=1, keepdim=True) / cnt
    f_cluster = pts[..., :3] - mean

    r = cfg.point_cloud_range
    vx, vy, vz = cfg.voxel_size
    cx = vox.coords[:, 2:3].to(pts.dtype) * vx + (vx / 2 + r[0])
    cy = vox.coords[:, 1:2].to(pts.dtype) * vy + (vy / 2 + r[1])
    cz = vox.coords[:, 0:1].to(pts.dtype) * vz + (vz / 2 + r[2])
    f_center = torch.stack(
        [pts[..., 0] - cx, pts[..., 1] - cy, pts[..., 2] - cz], dim=-1)
    feat = torch.cat([pts, f_cluster, f_center], dim=-1)  # (V, P, 10)
    return feat * pmask


def pfn_forward(feat, net: PointPillars, cfg: PointPillarsConfig,
                stats=None, live=None, reduce=None):
    """PFN: linear -> BN -> ReLU -> max over the points. (..., V, P, 10) ->
    (..., V, C); padded points take part in the max, as in pcdet. With a
    `stats` dict the BN runs in train mode (see `_norm`), its statistics
    weighted by the `live` (..., V) pillar mask where given: dead
    fixed-shape slots must not dilute them. The max is `amax`, which
    splits the gradient evenly among tied points, as JAX's does."""
    x = feat
    mask = None if live is None else live[..., None, None]
    for i, layer in enumerate(net.vfe.pfn_layers):
        x = torch.matmul(x, layer.linear.weight.to(x.dtype).t())
        x = torch.relu(_norm(x, layer.norm, f"vfe.pfn_layers.{i}.norm",
                             stats, dim=-1, mask=mask, reduce=reduce))
    return torch.amax(x, dim=-2)                          # (..., V, C)


def scatter_bev(pfeat, vox: VoxelizeResult, cfg: PointPillarsConfig):
    """PointPillarScatter: (V, C) -> (1, C, ny, nx), a channels-last view
    of one (ny * nx, C) canvas written by one unique-index scatter. Live
    pillars are those holding points (robust under a prefix overflow);
    dead ones write zeros to a sentinel row that is dropped."""
    nx, ny, _ = cfg.grid_size
    c = pfeat.shape[1]
    live = vox.num_points > 0
    flat_ix = torch.where(live, vox.coords[:, 1] * nx + vox.coords[:, 2],
                          ny * nx)
    canvas = pfeat.new_zeros(ny * nx + 1, c)
    canvas[flat_ix.long()] = torch.where(live[:, None], pfeat, 0)
    return canvas[:-1].view(1, ny, nx, c).permute(0, 3, 1, 2)


def backbone_forward(spatial, net: PointPillars, cfg: PointPillarsConfig,
                     stats=None, reduce=None):
    """BaseBEVBackbone: stages of a stride-s 3x3 conv (pcdet's ZeroPad2d(1)
    + padding 0, i.e. padding 1) and n 3x3 convs, each stage upsampled to
    the feature-map stride and concatenated. (B, C, ny, nx) ->
    (B, sum(num_upsample_filters), H, W). With a `stats` dict the BNs run
    in train mode (see `_norm`)."""
    x = spatial
    ups = []
    for i, (n, s) in enumerate(zip(cfg.layer_nums, cfg.layer_strides)):
        blk = net.backbone_2d.blocks[i]
        pre = f"backbone_2d.blocks.{i}"
        x = F.conv2d(x, blk[1].weight.to(x.dtype), stride=s, padding=1)
        x = torch.relu(_norm(x, blk[2], f"{pre}.2", stats, reduce=reduce))
        for j in range(n):
            x = F.conv2d(x, blk[3 * j + 4].weight.to(x.dtype), padding=1)
            x = torch.relu(_norm(x, blk[3 * j + 5], f"{pre}.{3 * j + 5}",
                                 stats, reduce=reduce))
        u = cfg.upsample_strides[i]
        deblk = net.backbone_2d.deblocks[i]
        if u >= 1:
            # ConvTranspose2d(k=u, stride=u) takes pcdet's (in, out, k, k)
            y = F.conv_transpose2d(x, deblk[0].weight.to(x.dtype), stride=u)
        else:
            k = int(round(1 / u))
            y = F.conv2d(x, deblk[0].weight.to(x.dtype), stride=k)
        ups.append(torch.relu(_norm(y, deblk[1],
                                    f"backbone_2d.deblocks.{i}.1", stats,
                                    reduce=reduce)))
    return torch.cat(ups, dim=1)


def head_forward_chw(feat, net: PointPillars, cfg: PointPillarsConfig):
    """AnchorHeadSingle 1x1 convs, channel-major float32 outputs:
    (B, A*ncls, H, W), (B, A*7, H, W), (B, A*nbins, H, W)."""
    outs = []
    for name in ("conv_cls", "conv_box", "conv_dir_cls"):
        conv = getattr(net.dense_head, name)
        y = F.conv2d(feat, conv.weight.to(feat.dtype))
        y = y + conv.bias.to(y.dtype)[None, :, None, None]
        outs.append(y.float())
    return tuple(outs)


def head_forward(feat, net: PointPillars, cfg: PointPillarsConfig):
    """The head's maps in pcdet's NCHW->NHWC permute layout, flattened over
    the (H, W, A) anchors: (B, N_anchors, {ncls, 7, nbins}) float32."""
    b = feat.shape[0]
    cls_c, box_c, dir_c = head_forward_chw(feat, net, cfg)
    a = cfg.num_anchors_per_loc

    def flat(y):
        return y.permute(0, 2, 3, 1).reshape(b, -1, y.shape[1] // a)

    return flat(cls_c), flat(box_c), flat(dir_c)


# ---------------------------------------------------------------------------
# anchors + box coder


def generate_anchors(cfg: PointPillarsConfig) -> np.ndarray:
    """(H, W, A, 7) anchor grid, A ordered class-major then rotation —
    pcdet AnchorGenerator (align_center=False: anchors on the corners of
    the grid_size/stride cells, scaled to the range)."""
    h, w = cfg.feature_map_size
    r = cfg.point_cloud_range
    xs = np.linspace(r[0], r[3], w, dtype=np.float64)
    ys = np.linspace(r[1], r[4], h, dtype=np.float64)
    anchors = np.zeros((h, w, cfg.num_anchors_per_loc, 7), np.float64)
    a = 0
    for ci, size in enumerate(cfg.anchor_sizes):
        z = cfg.anchor_bottom_heights[ci] + size[2] / 2
        for rot in cfg.anchor_rotations:
            anchors[:, :, a, 0] = xs[None, :]
            anchors[:, :, a, 1] = ys[:, None]
            anchors[:, :, a, 2] = z
            anchors[:, :, a, 3:6] = size
            anchors[:, :, a, 6] = rot
            a += 1
    return anchors.astype(np.float32)


def decode_boxes(box_preds, anchors):
    """pcdet ResidualCoder.decode_torch (7-DoF, angle as residual)."""
    xa, ya, za, dxa, dya, dza, ra = torch.split(anchors, 1, dim=-1)
    xt, yt, zt, dxt, dyt, dzt, rt = torch.split(box_preds, 1, dim=-1)
    diag = torch.sqrt(dxa * dxa + dya * dya)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * dza + za
    dxg = torch.exp(dxt) * dxa
    dyg = torch.exp(dyt) * dya
    dzg = torch.exp(dzt) * dza
    rg = rt + ra
    return torch.cat([xg, yg, zg, dxg, dyg, dzg, rg], dim=-1)


def encode_boxes(gt, anchors):
    """pcdet ResidualCoder.encode_torch (dx/dy/dz floored at 1e-5)."""
    xa, ya, za, dxa, dya, dza, ra = torch.split(anchors, 1, dim=-1)
    xg, yg, zg, dxg, dyg, dzg, rg = torch.split(gt, 1, dim=-1)
    dxg = torch.clamp_min(dxg, 1e-5)
    dyg = torch.clamp_min(dyg, 1e-5)
    dzg = torch.clamp_min(dzg, 1e-5)
    diag = torch.sqrt(dxa * dxa + dya * dya)
    return torch.cat([
        (xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
        torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
        rg - ra,
    ], dim=-1)


def limit_period(val, offset, period):
    return val - torch.floor(div(val, period) + offset) * period


# ---------------------------------------------------------------------------
# full forward


class Predictions(NamedTuple):
    """Fixed-shape detections (padded to nms_post_max) and counters; the
    tensors stay on the device."""

    boxes: Any            # (post_max, 7)
    scores: Any           # (post_max,)
    labels: Any           # (post_max,) int32, 1-based like pcdet
    count: Any            # scalar int32
    points_dropped: Any = 0
    pillars_dropped: Any = 0
    # candidates above score_thresh beyond nms_pre_max: pcdet's silent
    # top-k truncation, counted
    nms_pre_overflow: Any = 0
    # in-range points beyond cfg.voxel_active_points (not pcdet semantics:
    # nonzero means the static scatter prefix was undersized)
    prefix_overflow: Any = 0
    # blocks of the two-stage top-k whose (m+1)-th score beats the k-th
    # selected one, so a true top-k member may have been missed (raise
    # topk_block_m); nms_pre_overflow + topk_block_miss is the JAX
    # package's nms_pre_overflow
    topk_block_miss: Any = 0
    nms_sweeps: int = 0   # fixpoint sweeps of nms_rotated (host int)


def _features_bev(points, valid, net, cfg: PointPillarsConfig):
    """(N, 4) cloud -> ((1, C, H, W) backbone output, vox)."""
    vox = voxelize(points, valid, cfg)
    feat = pillar_features(vox, cfg)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    pfeat = pfn_forward(feat.to(dtype), net, cfg)
    live = (vox.num_points > 0)[:, None]
    spatial = scatter_bev(pfeat * live.to(pfeat.dtype), vox, cfg)
    return backbone_forward(spatial, net, cfg), vox


@torch.no_grad()
def forward_features(points, valid, net: PointPillars):
    """points (N, 4) -> (cls, box, dir) head maps in pcdet's
    (H, W, A, c) layout, float32, and the VoxelizeResult."""
    with _true_float32():
        bev, vox = _features_bev(points, valid, net, net.cfg)
        maps = head_forward(bev, net, net.cfg)
    h, w = net.cfg.feature_map_size
    a = net.cfg.num_anchors_per_loc
    cls, box, dir_ = (y[0].reshape(h, w, a, y.shape[-1]) for y in maps)
    return cls, box, dir_, vox


def train_forward(points, valid, net: PointPillars, device="cuda",
                  reduce=None):
    """Batched training forward with batch-statistic BN (the JAX package's
    `detector_train.train_forward`).

    points (B, N, 4), valid (B, N) bool (numpy or tensors), run on
    `device` (default the card; raises where there is none), where `net`
    must live. Each frame is
    voxelized, its dead pillars (rank >= num_pillars) are masked out of the
    PFN's statistics and zeroed before the scatter, then the batched
    backbone and head run in `cfg.compute_dtype` (BN statistics in
    float32). Returns (cls (B, N_anchors, ncls), box (B, N_anchors, 7),
    dir (B, N_anchors, nbins), float32, and {state-dict name: tensor} of
    the running stats after this batch). The stats are not written into
    `net`: the caller commits them (`detector_train`). With `reduce` (see
    `_bn_train`) every BN takes its statistics over all ranks' batches.
    Call it inside `_true_float32()` for IEEE float32 convolutions, the
    backward pass included."""
    where = _on_net_device(net, device)
    points = torch.as_tensor(points, dtype=torch.float32, device=where)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=where)
    cfg = net.cfg
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    voxs = [voxelize(p, v, cfg) for p, v in zip(points, valid)]
    feat = torch.stack([pillar_features(v, cfg) for v in voxs])
    num_pillars = torch.stack([v.num_pillars for v in voxs])
    live = (torch.arange(cfg.max_pillars, device=points.device)[None, :]
            < num_pillars[:, None])                       # (B, V)
    stats: dict = {}
    pfeat = pfn_forward(feat.to(dtype), net, cfg, stats=stats, live=live,
                        reduce=reduce)
    pfeat = pfeat * live[..., None].to(pfeat.dtype)
    spatial = torch.cat([scatter_bev(f, v, cfg) for f, v in zip(pfeat, voxs)])
    bev = backbone_forward(spatial, net, cfg, stats=stats, reduce=reduce)
    cls, box, dir_ = head_forward(bev, net, cfg)
    return cls, box, dir_, stats


def post_process(cls_c, box_c, dir_c, anchors,
                 cfg: PointPillarsConfig) -> Predictions:
    """Sigmoid scores -> class-agnostic rotated NMS (pcdet post_processing
    with MULTI_CLASSES_NMS False): per-anchor best class, score threshold,
    top `nms_pre_max` (stable: ties keep the lower flat index), rotated
    NMS at `nms_thresh`, keep `nms_post_max`.

    Inputs are one frame's channel-major head maps, (A*ncls, H, W),
    (A*7, H, W), (A*nbins, H, W), and the (H, W, A, 7) anchor grid; flat
    anchor indices are (a, y, x)-ordered. Rows are decoded only at top-k
    scale. With `topk_block_m` = m > 0 (and 128 | anchors, blocks * m >=
    nms_pre_max) the top-k is two-stage: each 128-anchor block's top m,
    then one stable sort of the candidates, equal to the global sort
    unless some block held more than m of the top k, which
    `topk_block_miss` counts.
    """
    a = cfg.num_anchors_per_loc
    ncls = len(cfg.class_names)
    h, w = cls_c.shape[1], cls_c.shape[2]
    dev = cls_c.device
    i32 = torch.int32

    cls4 = cls_c.reshape(a, ncls, h, w)
    # per-anchor best class: sigmoid is monotone, so reduce logits first
    scores = torch.sigmoid(torch.amax(cls4, dim=1)).reshape(-1)

    ok = scores > cfg.score_thresh
    pre_overflow = torch.clamp_min(ok.sum() - cfg.nms_pre_max, 0).to(i32)
    block_miss = torch.zeros((), dtype=i32, device=dev)
    masked = torch.where(ok, scores, -1.0)
    n_anch = masked.shape[0]
    m = cfg.topk_block_m
    if (m and m < 128 and n_anch % 128 == 0
            and (n_anch // 128) * m >= cfg.nms_pre_max):
        blocks = n_anch // 128
        neg_sorted, widx_s = torch.sort((-masked).view(blocks, 128), dim=1,
                                        stable=True)
        cand_scores = -neg_sorted[:, :m].reshape(-1)       # block-major
        cand_idx = (torch.arange(blocks, device=dev)[:, None] * 128
                    + widx_s[:, :m]).reshape(-1)
        bound = -neg_sorted[:, m]        # per-block (m+1)-th best score
        order = torch.sort(-cand_scores, stable=True).indices
        sel = order[: cfg.nms_pre_max]
        top_ix = cand_idx[sel]
        top_scores = cand_scores[sel]
        kth = top_scores[cfg.nms_pre_max - 1]
        block_miss = (bound > kth).sum().to(i32)
    else:
        top_ix = torch.sort(-masked, stable=True).indices[: cfg.nms_pre_max]
        top_scores = masked[top_ix]
    top_valid = top_scores > cfg.score_thresh

    a_ix = top_ix // (h * w)
    rem = top_ix % (h * w)
    y_ix = rem // w
    x_ix = rem % w
    labels = torch.argmax(cls4[a_ix, :, y_ix, x_ix], dim=-1).to(i32) + 1
    boxes = decode_boxes(
        box_c.reshape(a, 7, h, w)[a_ix, :, y_ix, x_ix],
        anchors[y_ix, x_ix, a_ix],
    )
    dir_labels = torch.argmax(
        dir_c.reshape(a, cfg.num_dir_bins, h, w)[a_ix, :, y_ix, x_ix],
        dim=-1)
    period = 2 * math.pi / cfg.num_dir_bins
    rot = limit_period(boxes[:, 6] - cfg.dir_offset, cfg.dir_limit_offset,
                       period)
    heading = rot + cfg.dir_offset + period * dir_labels.to(torch.float32)
    top_boxes = torch.cat([boxes[:, :6], heading[:, None]], dim=1)
    keep, count, sweeps = nms_rotated(
        top_boxes[:, [0, 1, 3, 4, 6]], top_scores, top_valid,
        iou_threshold=cfg.nms_thresh, post_max=cfg.nms_post_max,
    )
    sel = torch.clamp_min(keep, 0).long()
    kmask = keep >= 0
    return Predictions(
        boxes=torch.where(kmask[:, None], top_boxes[sel], 0.0),
        scores=torch.where(kmask, top_scores[sel], 0.0),
        labels=torch.where(kmask, labels[sel], 0),
        count=count,
        nms_pre_overflow=pre_overflow,
        topk_block_miss=block_miss,
        nms_sweeps=sweeps,
    )


def _on_net_device(net: PointPillars, device) -> torch.device:
    """The net's device, which must be `device` (resolved: a CUDA device
    raises where there is no card)."""
    dev = resolve_device(device)
    where = net.device
    if where.type != dev.type or (dev.index is not None
                                  and where.index != dev.index):
        raise ValueError(f"running on {dev}, but the net is on {where}")
    return where


@torch.no_grad()
def detect(points, valid, net: PointPillars, anchors=None,
           device="cuda") -> Predictions:
    """Inference on one (N, 4) cloud [x, y, z, feat] (numpy or tensor;
    `valid` (N,) bool or None for all) -> Predictions with the voxelizer's
    counters. Runs on `device` (default the card; raises where there is
    none), where `net` must live. `anchors` defaults to the net's grid.
    The viewer's (K, 9) array is `predictions_array` of the result."""
    where = _on_net_device(net, device)
    points = torch.as_tensor(points, dtype=torch.float32, device=where)
    valid = (torch.ones(points.shape[0], dtype=torch.bool, device=where)
             if valid is None else torch.as_tensor(valid, dtype=torch.bool,
                                                   device=where))
    anchors = net.anchors if anchors is None else torch.as_tensor(
        anchors, dtype=torch.float32, device=where)
    cfg = net.cfg
    with _true_float32():
        bev, vox = _features_bev(points, valid, net, cfg)
        cls_c, box_c, dir_c = head_forward_chw(bev, net, cfg)
    preds = post_process(cls_c[0], box_c[0], dir_c[0], anchors, cfg)
    return preds._replace(
        points_dropped=vox.points_dropped,
        pillars_dropped=vox.pillars_dropped,
        prefix_overflow=vox.prefix_overflow,
    )


def predictions_array(preds: Predictions) -> np.ndarray:
    """(count, 9) numpy [x y z dx dy dz heading label score] — the
    reference's prediction-array contract (`pointcloud_viewer.py:
    2428-2436`)."""
    k = int(preds.count)
    out = np.zeros((k, 9), np.float32)
    out[:, :7] = preds.boxes[:k].cpu().numpy()
    out[:, 7] = preds.labels[:k].cpu().numpy()
    out[:, 8] = preds.scores[:k].cpu().numpy()
    return out
