"""The port's NumPy oracle (`lidar_snow_sim_tpu_torch/oracle/`) held bitwise
against the JAX package's (`lidar_snow_sim_tpu/oracle/`).

The port's copy differs only in its imports, so every public function must
give the same result on the same inputs: arrays equal bit for bit (dtype
and shape included), dicts, lists and floats equal. The inputs: the parity
scene of tests/test_snowfall_parity.py (the parity tools' `build_scene`), a
wet-ground scene (a synthetic scan with its ground), random detector boxes
and points, all made from seeds with numpy.
"""

import numpy as np
import pytest

from lidar_snow_sim_tpu.oracle import detector as jdet
from lidar_snow_sim_tpu.oracle import fitting as jfit
from lidar_snow_sim_tpu.oracle import parity as jpar
from lidar_snow_sim_tpu.oracle import snowfall as jsnow
from lidar_snow_sim_tpu.oracle import wet_ground as jwet
from lidar_snow_sim_tpu_torch import oracle as toracle
from lidar_snow_sim_tpu_torch.oracle import detector as tdet
from lidar_snow_sim_tpu_torch.oracle import fitting as tfit
from lidar_snow_sim_tpu_torch.oracle import parity as tpar
from lidar_snow_sim_tpu_torch.oracle import snowfall as tsnow
from lidar_snow_sim_tpu_torch.oracle import wet_ground as twet
from lidar_snow_sim_tpu_torch.tools.parity_gpu import build_scene

BEAM_DIV_DEG = float(np.degrees(3e-3))
_W = np.array([0.005, -0.003, -1.0])
PLANE = (_W / np.linalg.norm(_W), -1.55)


def _same(a, b, path="out"):
    """a and b equal bit for bit, recursively through tuples, lists and
    dicts; arrays with equal dtype, shape and bytes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b), path
        assert a == b or (a != a and b != b), path


@pytest.fixture(scope="module")
def parity_scene():
    calib, pc, sets, bank, order, cfg = build_scene()
    return calib, pc, sets, order


@pytest.fixture(scope="module")
def wet_scene():
    from lidar_snow_sim_tpu_torch.utils.synthetic import synthetic_scan

    return synthetic_scan(n_azimuth=220, seed=0).astype(np.float64)


def _channel(scene, channel):
    """(pc rows, ranges, beams, occlusion dicts) of one channel of the
    parity scene, built by the JAX oracle."""
    calib, pc, sets, order = scene
    cpc = pc[pc[:, 4] == channel].astype(np.float64)
    d = np.linalg.norm(cpc[:, :3], axis=1)
    center = jsnow._wrap_02pi(np.arctan2(cpc[:, 1], cpc[:, 0]))
    rad = np.radians(BEAM_DIV_DEG)
    beams = np.column_stack([jsnow._wrap_02pi(center - rad / 2),
                             jsnow._wrap_02pi(center + rad / 2)])
    return cpc, d, beams, sets[order[channel]]


@pytest.mark.parametrize("kw", [
    dict(plane=PLANE, device_semantics=True),
    dict(plane=PLANE),
    dict(legacy_sort=True, plane=PLANE, noise_floor=0.6),
    dict(),   # RANSAC
])
def test_augment_bitwise(parity_scene, kw):
    calib, pc, sets, order = parity_scene
    args = (pc.astype(np.float64), sets, calib, order, BEAM_DIV_DEG)
    got = tsnow.augment(*args, **kw)
    _same(got, jsnow.augment(*args, **kw))
    assert toracle.augment_oracle is tsnow.augment
    if kw.get("device_semantics"):
        assert got[0] == (29, 847, 194)


@pytest.mark.parametrize("channel", [3, 17, 21, 30])
def test_channel_functions_bitwise(parity_scene, channel):
    """occlusion_dicts, resimulate_channel, pulse_decision_margins and
    hit_set_margins on one channel of the parity scene."""
    calib, pc, sets, order = parity_scene
    cpc, d, beams, parts = _channel(parity_scene, channel)
    occl = tsnow.occlusion_dicts(beams, d, parts, BEAM_DIV_DEG)
    want = jsnow.occlusion_dicts(beams, d, parts, BEAM_DIV_DEG)
    _same(occl, want)
    assert sum(len(o) for o in occl) > len(occl)   # some beam is occluded
    cal = (float(calib.min_intensity[channel]),
           float(calib.focal_distance[channel]),
           float(calib.focal_slope[channel]))
    _same(tsnow.resimulate_channel(cpc, occl, channel, *cal),
          jsnow.resimulate_channel(cpc, want, channel, *cal))
    occluded = [j for j, o in enumerate(occl) if len(o) > 1]
    for j in sorted(set(occluded) | set(range(0, len(cpc), 12))):
        _same(tsnow.pulse_decision_margins(d[j], cpc[j, 3], occl[j],
                                           channel, *cal),
              jsnow.pulse_decision_margins(d[j], cpc[j, 3], want[j],
                                           channel, *cal))
        _same(tsnow.hit_set_margins(cpc[j, :3], d[j], beams[j, 0],
                                    beams[j, 1], parts),
              jsnow.hit_set_margins(cpc[j, :3], d[j], beams[j, 0],
                                    beams[j, 1], parts))


def test_classify_parity_bitwise(parity_scene):
    """classify_parity on the scan itself with every label 0 (so each point
    the oracle changes is a mismatch) and a few rows moved off every
    boundary, so both mismatch lists are filled."""
    calib, pc, sets, order = parity_scene
    got = pc.astype(np.float64)
    got[:, 4] = 0
    rows = np.random.default_rng(0).choice(len(got), 12, replace=False)
    got[rows, :3] += 1.0
    args = (pc, got, sets, calib, order, BEAM_DIV_DEG)
    out = tpar.classify_parity(*args)
    _same(out, jpar.classify_parity(*args))
    assert len(out["mismatches"]) > 12 and len(out["unexplained"]) >= 12


def test_fitting_bitwise(wet_scene):
    pc = wet_scene
    _same(tfit.ransac_plane(pc[:, :3]), jfit.ransac_plane(pc[:, :3]))
    _same(tfit.ransac_plane(pc[:, :3], trials=16, seed=3),
          jfit.ransac_plane(pc[:, :3], trials=16, seed=3))
    w, h = jfit.ransac_plane(pc[:, :3])
    hog = pc[:, :3] @ w + h
    g = pc[(hog < 0.5) & (hog > -0.5)]
    assert len(g) > 1000
    dist = np.linalg.norm(g[:, :3], axis=1)
    incident = np.arccos((g[:, :3] @ w) / (dist * np.linalg.norm(w)))
    for method in ("linear", "poly"):
        for dev in (False, True):
            np.random.seed(5)
            got = tfit.estimate_laser_parameters(
                g, incident, estimation_method=method, device_semantics=dev)
            np.random.seed(5)
            want = jfit.estimate_laser_parameters(
                g, incident, estimation_method=method, device_semantics=dev)
            _same(got, want)
    norm = g[:, 3] / np.cos(incident)
    for dev in (False, True):
        _same(tfit.noise_floor_bins(dist, norm, len(g),
                                    device_semantics=dev),
              jfit.noise_floor_bins(dist, norm, len(g),
                                    device_semantics=dev))
    _same(tfit.linregress_fit(dist, g[:, 3]),
          jfit.linregress_fit(dist, g[:, 3]))
    y = 0.01 * dist ** 3 - dist + np.random.default_rng(1).normal(
        0, 0.05, len(dist))
    _same(tfit.ransac_polyfit(dist, y, rng=np.random.default_rng(2)),
          jfit.ransac_polyfit(dist, y, rng=np.random.default_rng(2)))
    np.random.seed(4)
    got = tfit.ransac_polyfit(dist, y)
    np.random.seed(4)
    _same(got, jfit.ransac_polyfit(dist, y))


@pytest.mark.parametrize("kw", [
    dict(plane=(np.array([0.0, 0.0, -1.0]), -1.55), device_semantics=True),
    dict(),
    dict(replace=False, estimation_method="poly", water_height=0.002),
    dict(flat_earth=True),
])
def test_ground_water_augmentation_bitwise(wet_scene, kw):
    np.random.seed(9)
    got = twet.ground_water_augmentation(wet_scene, **kw)
    np.random.seed(9)
    _same(got, jwet.ground_water_augmentation(wet_scene, **kw))
    assert got.shape != wet_scene.shape or (got != wet_scene).any()


def test_ground_water_augmentation_bails_bitwise(wet_scene):
    """Fewer than 1,000 ground points: the input comes back unchanged."""
    few = wet_scene[:500]
    got = twet.ground_water_augmentation(few)
    _same(got, jwet.ground_water_augmentation(few))


def _boxes(rng, n):
    return np.column_stack([
        rng.uniform(-10, 10, (n, 2)), rng.uniform(-1, 1, n),
        rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, n),
    ])


@pytest.mark.parametrize("seed", range(3))
def test_detector_bitwise(seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 30), _boxes(rng, 20)
    b[:4] = a[:4]                       # coincident pairs
    b[4:8, :2] = a[4:8, :2] + 0.3       # overlapping pairs
    _same(tdet.iou_bev(a, b), jdet.iou_bev(a, b))
    _same(tdet.iou3d(a, b), jdet.iou3d(a, b))
    assert (jdet.iou_bev(a, b) > 0).sum() >= 8
    scores = rng.uniform(0, 1, len(a))
    _same(tdet.nms_rotated(a, scores, 0.1), jdet.nms_rotated(a, scores, 0.1))
    pts = np.column_stack([rng.uniform(0, 20, (3000, 2)),
                           rng.uniform(-3, 1, 3000),
                           rng.uniform(0, 1, 3000)]).astype(np.float32)
    for max_vox in (40, 10_000):
        _same(tdet.voxelize(pts, (0, 0, -3, 16, 16, 1), (0.5, 0.5, 4), 5,
                            max_vox),
              jdet.voxelize(pts, (0, 0, -3, 16, 16, 1), (0.5, 0.5, 4), 5,
                            max_vox))
