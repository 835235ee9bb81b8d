"""The port's detector training on the card against the port on the CPU.

These tests need an NVIDIA GPU and skip elsewhere (training has no kernel
of its own: cuDNN convolutions and torch ops). They import no jax, so they
also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_train_cuda.py

Tolerances: assigned labels equal except anchors whose decision lies
within 1e-5 of its threshold (chip_smoke.py's `_near_assignment`),
regression targets within 1e-5 where the labels agree; one float32 step's
loss within 1e-5 relative, each gradient within 1e-4 of its largest
value, the running stats within 1e-5; the eval overlaps within 1e-5;
--resume byte for byte on the card.
"""

import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu_torch.models import detector_train as tdt
from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
from lidar_snow_sim_tpu_torch.utils import eval_ap

ROOT = Path(__file__).resolve().parents[1]
SMOKE = runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="chip_smoke_gate")

SMALL = tpp.PointPillarsConfig(
    class_names=("Car", "Pedestrian"),
    point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
    voxel_size=(0.5, 0.5, 4.0),
    max_points_per_pillar=8,
    max_pillars=128,
    pfn_filters=(16,),
    layer_nums=(1, 1, 1),
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

SMALL_YAML = """
CLASS_NAMES: [Car, Pedestrian]
DATA_CONFIG:
    POINT_CLOUD_RANGE: [0.0, -8.0, -3.0, 16.0, 8.0, 1.0]
    DATA_PROCESSOR:
        - NAME: transform_points_to_voxels
          VOXEL_SIZE: [0.5, 0.5, 4.0]
          MAX_POINTS_PER_VOXEL: 8
          MAX_NUMBER_OF_VOXELS: {train: 128, test: 128}
MODEL:
    VFE: {NUM_FILTERS: [16]}
    BACKBONE_2D:
        LAYER_NUMS: [1, 1, 1]
        LAYER_STRIDES: [2, 2, 2]
        NUM_FILTERS: [16, 32, 64]
        UPSAMPLE_STRIDES: [1, 2, 4]
        NUM_UPSAMPLE_FILTERS: [16, 16, 16]
    DENSE_HEAD:
        ANCHOR_GENERATOR_CONFIG:
            - class_name: Car
              anchor_sizes: [[3.9, 1.6, 1.56]]
              anchor_rotations: [0, 1.57]
              anchor_bottom_heights: [-1.78]
              matched_threshold: 0.6
              unmatched_threshold: 0.45
            - class_name: Pedestrian
              anchor_sizes: [[0.8, 0.6, 1.73]]
              anchor_rotations: [0, 1.57]
              anchor_bottom_heights: [-0.6]
              matched_threshold: 0.5
              unmatched_threshold: 0.35
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gt(rng, g=16, spread=(0.0, 16.0, -8.0, 8.0)):
    gt = np.zeros((g, 8), np.float32)
    k = g // 2
    gt[:k, 0] = rng.uniform(spread[0], spread[1], k)
    gt[:k, 1] = rng.uniform(spread[2], spread[3], k)
    gt[:k, 2] = rng.uniform(-2, 0, k)
    gt[:k, 3] = rng.uniform(0.5, 5, k)
    gt[:k, 4] = rng.uniform(0.4, 2, k)
    gt[:k, 5] = rng.uniform(1, 2, k)
    gt[:k, 6] = rng.uniform(-np.pi, np.pi, k)
    gt[:k, 7] = rng.integers(1, 3, k)
    return torch.as_tensor(gt)


@pytest.mark.cuda
@pytest.mark.parametrize("full_width", [False, True])
def test_assign_targets_card_matches_cpu(cuda, full_width):
    cfg = tpp.PointPillarsConfig() if full_width else SMALL
    anchors = torch.as_tensor(tpp.generate_anchors(cfg)).reshape(-1, 7)
    r = cfg.point_cloud_range
    for seed in range(3):
        gt = _gt(np.random.default_rng(seed), 64 if full_width else 16,
                 (r[0], r[3], r[1], r[4]))
        want = tdt.assign_targets(anchors, gt, cfg)
        got = [t.cpu() for t in tdt.assign_targets(anchors.to(cuda),
                                                    gt.to(cuda), cfg)]
        near = SMOKE["_near_assignment"](anchors, gt, cfg, tol=1e-5)
        flips, unexplained = SMOKE["_label_flips"](got[0], want[0], near)
        assert unexplained == 0, flips
        same = got[0] == want[0]
        assert torch.equal(got[2][same], want[2][same])
        assert float((got[1] - want[1])[same].abs().max()) <= 1e-5
        assert int((want[0] > 0).sum()) > 0


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda):
    params = tpp.init_params(SMALL, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    pts = torch.as_tensor(np.column_stack([
        rng.uniform(-2, 18, 3000), rng.uniform(-10, 10, 3000),
        rng.uniform(-4, 2, 3000), rng.uniform(0, 1, 3000)]).astype(
            np.float32))
    valid = torch.ones(3000, dtype=torch.bool)
    gt = _gt(rng, 8)
    anchors = torch.as_tensor(tpp.generate_anchors(SMALL)).reshape(-1, 7)
    step = SMOKE["_step_on"]
    got = step(tpp.PointPillars(SMALL, params, device=cuda), cuda, pts,
               valid, gt, anchors)
    want = step(tpp.PointPillars(SMALL, params, device="cpu"), "cpu", pts,
                valid, gt, anchors)
    near = SMOKE["_near_assignment"](anchors, gt, SMALL, tol=1e-5)
    assert SMOKE["_label_flips"](got[0], want[0], near)[1] == 0
    assert SMOKE["_rel_err"](got[1], want[1]) <= 1e-5
    for name, g in got[2].items():
        assert SMOKE["_rel_err"](g, want[2][name]) <= 1e-4, name
    for name, v in got[3].items():
        assert float((v.cpu() - want[3][name]).abs().max()) <= 1e-5, name


@pytest.mark.cuda
def test_eval_overlaps_card_match_cpu(cuda):
    rng = np.random.default_rng(0)
    a = np.column_stack([rng.uniform(0, 40, (30, 2)), rng.uniform(-1, 1, 30),
                         rng.uniform(0.5, 5, (30, 3)),
                         rng.uniform(-np.pi, np.pi, 30)])
    b = a[rng.integers(0, 30, 50)] + rng.normal(0, 0.3, (50, 7))
    for metric in ("3d", "bev"):
        got = eval_ap._pair_overlaps(a, b, metric, cuda)
        want = eval_ap._pair_overlaps(a, b, metric, "cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _cli(tmp_path, out, *extra):
    argv = [sys.executable, "-m", "lidar_snow_sim_tpu_torch.tools.train",
            "--synthetic", "4", "--steps", "4", "--batch", "2",
            "--max-points", "2048", "--max-gt", "8", "--config",
            str(tmp_path / "small.yaml"), "--out", str(tmp_path / out),
            "--save-every", "2", "--log-every", "1", "--seed", "3",
            "--device", "cuda", *extra]
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [("--dtype", "float32"),
                                   ("--dtype", "bfloat16", "--augment")])
def test_resume_is_bit_exact_on_the_card(cuda, tmp_path, flags):
    (tmp_path / "small.yaml").write_text(SMALL_YAML)
    _cli(tmp_path, "full", *flags)
    _cli(tmp_path, "part", *flags, "--limit-steps", "2")
    _cli(tmp_path, "part", *flags, "--resume")
    for name in ("ckpt_0000004.npz", "params_tpu.npz"):
        with np.load(tmp_path / "full" / name) as a, \
                np.load(tmp_path / "part" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].tobytes() == b[k].tobytes(), k
