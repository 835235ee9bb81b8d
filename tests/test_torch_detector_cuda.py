"""The port's detector on the card against the port on the CPU.

These tests need an NVIDIA GPU and skip elsewhere (the detector path has
no kernel of its own: its work is cuDNN convolutions and torch ops). They
import no jax, so they also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_detector_cuda.py

Tolerances: voxelize outputs and counters byte for byte; head maps 1e-4
absolute (true float32 on the card, with the caller's TF32 flags on);
predictions equal in count and labels, boxes within 1e-4, scores within
1e-5; the blocked IoU matrix equal to one unblocked block bit for bit.
`test_detect_raises_without_cuda` runs everywhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu_torch import load_hdl64_calib, synthetic_scan
from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
from lidar_snow_sim_tpu_torch.ops import rotated_iou as tiou

SMALL = tpp.PointPillarsConfig(
    class_names=("Car", "Pedestrian"),
    point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
    voxel_size=(0.5, 0.5, 4.0),
    max_points_per_pillar=8,
    max_pillars=256,
    pfn_filters=(16,),
    layer_nums=(1, 2, 1),
    layer_strides=(2, 2, 2),
    num_filters=(16, 32, 64),
    upsample_strides=(1, 2, 4),
    num_upsample_filters=(16, 16, 16),
    anchor_sizes=((3.9, 1.6, 1.56), (0.8, 0.6, 1.73)),
    anchor_bottom_heights=(-1.78, -0.6),
    anchor_match_thresholds=(0.6, 0.5),
    anchor_unmatch_thresholds=(0.45, 0.35),
    nms_pre_max=64,
    nms_post_max=16,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(cfg, seed=0):
    p = tpp.init_params(cfg, torch.Generator().manual_seed(seed))
    p["dense_head.conv_cls.bias"] = torch.zeros_like(
        p["dense_head.conv_cls.bias"])   # about half the anchors pass
    return p


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    pts = np.column_stack([
        rng.uniform(-2, 18, n), rng.uniform(-10, 10, n),
        rng.uniform(-4, 2, n), rng.uniform(0, 1, n),
    ]).astype(np.float32)
    return pts, rng.uniform(size=n) >= 0.05


def _scan_points():
    """The 870-azimuth synthetic HDL-64 scan, intensity / 255."""
    pc = synthetic_scan(n_azimuth=870, seed=0, calib=load_hdl64_calib())
    pts = pc[:, :4].copy()
    pts[:, 3] *= np.float32(1 / 255)
    return pts


def _voxelize_equal(pts, valid, cfg, dev):
    a = tpp.voxelize(torch.as_tensor(pts, device=dev),
                     torch.as_tensor(valid, device=dev), cfg)
    b = tpp.voxelize(torch.as_tensor(pts), torch.as_tensor(valid), cfg)
    for name in b._fields:
        x, y = getattr(a, name).cpu(), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.numpy().tobytes() == y.numpy().tobytes(), name
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(), dict(max_pillars=64, max_points_per_pillar=4),
    dict(voxel_active_points=700, max_pillars=64),
])
def test_cuda_small_voxelize_equals_cpu(cuda, over):
    pts, valid = _cloud(1, 3000)
    _voxelize_equal(pts, valid, dataclasses.replace(SMALL, **over), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [dict(), dict(max_pillars=4000),
                                  dict(voxel_active_points=20000)])
def test_cuda_full_width_voxelize_equals_cpu(cuda, over):
    pts = _scan_points()
    cfg = dataclasses.replace(tpp.PointPillarsConfig(), **over)
    vox = _voxelize_equal(pts, np.ones(len(pts), bool), cfg, cuda)
    assert int(vox.num_pillars) > 1000
    if over:
        assert int(vox.pillars_dropped) + int(vox.prefix_overflow) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_small_detect_equals_cpu(cuda, seed):
    """Maps and predictions of the card against the CPU, with the caller's
    TF32 flags on: the forward pass sets them off for the call only."""
    params = _params(SMALL, seed)
    pts, valid = _cloud(seed, 3000)
    gpu = tpp.PointPillars(SMALL, params, device=cuda)
    cpu = tpp.PointPillars(SMALL, params, device="cpu")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        maps_g = tpp.forward_features(torch.as_tensor(pts, device=cuda),
                                      torch.as_tensor(valid, device=cuda),
                                      gpu)[:3]
        got = tpp.detect(pts, valid, gpu, device=cuda)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
    maps_c = tpp.forward_features(torch.as_tensor(pts), torch.as_tensor(valid),
                                  cpu)[:3]
    for g, c in zip(maps_g, maps_c):
        assert float((g.cpu() - c).abs().max()) <= 1e-4
    want = tpp.detect(pts, valid, cpu, device="cpu")
    assert int(got.count) == int(want.count) > 0
    assert torch.equal(got.labels.cpu(), want.labels)
    assert float((got.boxes.cpu() - want.boxes).abs().max()) <= 1e-4
    assert float((got.scores.cpu() - want.scores).abs().max()) <= 1e-5
    for name in ("points_dropped", "pillars_dropped", "nms_pre_overflow",
                 "topk_block_miss", "prefix_overflow"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 4096])
def test_cuda_blocked_iou_equals_one_block(cuda, n):
    rng = np.random.default_rng(n)
    boxes = torch.as_tensor(np.column_stack([
        rng.uniform(-40, 40, n), rng.uniform(-40, 40, n),
        rng.uniform(0.5, 6, n), rng.uniform(0.5, 4, n),
        rng.uniform(-np.pi, np.pi, n),
    ]).astype(np.float32), device=cuda)
    whole = tiou.boxes_iou_bev(boxes, boxes, block_rows=n)
    assert torch.equal(tiou.boxes_iou_bev(boxes, boxes), whole)
    assert torch.equal(tiou.boxes_iou_bev(boxes, boxes, block_rows=37),
                       whole)
    cpu = tiou.boxes_iou_bev(boxes[:300].cpu(), boxes.cpu())
    assert float((whole[:300].cpu() - cpu).abs().max()) <= 1e-5
    scores = torch.as_tensor(rng.uniform(0, 1, n).astype(np.float32),
                             device=cuda)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    # sin and cos round differently on the two devices, so an IoU within
    # 1e-5 of the threshold may be decided either way: take the first
    # threshold from 0.01 up with no pair that close
    iou = whole.cpu().numpy()
    thr = next(t for t in np.arange(0.01, 0.5, 0.01, dtype=np.float32)
               if np.abs(iou - t).min() > 1e-5)
    k_g, c_g, s_g = tiou.nms_rotated(boxes, scores, valid,
                                     iou_threshold=float(thr), post_max=500)
    k_c, c_c, s_c = tiou.nms_rotated(boxes.cpu(), scores.cpu(), valid.cpu(),
                                     iou_threshold=float(thr), post_max=500)
    assert torch.equal(k_g.cpu(), k_c) and int(c_g) == int(c_c)
    assert s_g == s_c


def test_detect_raises_without_cuda(monkeypatch):
    """With no card, the module, detect and the infer CLI left at their
    default device raise; none of them falls back to the CPU."""
    from lidar_snow_sim_tpu_torch.tools import infer

    params = _params(SMALL)
    net = tpp.PointPillars(SMALL, params, device="cpu")
    pts, valid = _cloud(0, 200)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpp.PointPillars(SMALL, params)
    with pytest.raises(RuntimeError, match="cuda"):
        tpp.detect(pts, valid, net)
    with pytest.raises(RuntimeError, match="cuda"):
        infer.main(["scan.bin", "--random-params"])
    with pytest.raises(ValueError, match="net is on"):
        tpp.detect(pts, valid, net, device="meta")
