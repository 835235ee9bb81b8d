"""The port's own copies of the JAX package's host modules, held bitwise
against the originals, the converters that carry JAX-package objects over,
and the entry points' device rule: the card unless the CPU is asked for.

Both packages build the bank, the calibration, the synthetic scan and the
Mie table from the same seeds; every array must be equal bit for bit.
"""

import dataclasses
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu import calib as jcalib
from lidar_snow_sim_tpu import config as jconfig
from lidar_snow_sim_tpu.ops import mie as jmie
from lidar_snow_sim_tpu.sampling import banks as jbanks
from lidar_snow_sim_tpu.sampling import dart as jdart
from lidar_snow_sim_tpu.tools.precompute import (
    reference_sample_order as jax_sample_order,
)
from lidar_snow_sim_tpu.utils import pointcloud as jpc
from lidar_snow_sim_tpu.utils import synthetic as jsyn
from lidar_snow_sim_tpu_torch import calib as tcalib
from lidar_snow_sim_tpu_torch import config as tconfig
from lidar_snow_sim_tpu_torch.ops import mie as tmie
from lidar_snow_sim_tpu_torch.sampling import banks as tbanks
from lidar_snow_sim_tpu_torch.sampling import dart as tdart
from lidar_snow_sim_tpu_torch.tools.precompute import reference_sample_order
from lidar_snow_sim_tpu_torch.utils import pointcloud as tpc
from lidar_snow_sim_tpu_torch.utils import synthetic as tsyn


def _equal(a, b):
    """Bitwise equality of two arrays, dtypes included."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _sets(module, seed):
    rng = np.random.default_rng(seed)
    return [module.dart_throwing_fast(2e-7, 5.0, 80.0, rng, "gunn")
            for _ in range(64)]


@pytest.mark.parametrize("seed,dist", [(7, "gunn"), (11, "sekhon")])
def test_dart_throwing_fast_bitwise(seed, dist):
    for occ in (2e-7, 1e-6):
        a = jdart.dart_throwing_fast(occ, 5.0, 80.0,
                                     np.random.default_rng(seed), dist)
        b = tdart.dart_throwing_fast(occ, 5.0, 80.0,
                                     np.random.default_rng(seed), dist)
        _equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(window_size=256, wide_capacity=64),
    dict(window_size=128, wide_capacity=16, wide_threshold=2e-3),
])
def test_build_bank_bitwise(kw):
    sets = _sets(jdart, 7)
    want = jbanks.build_bank(sets, **kw)
    got = tbanks.build_bank(_sets(tdart, 7), **kw)
    assert type(got).__module__ == "lidar_snow_sim_tpu_torch.sampling.banks"
    assert got._fields == want._fields
    for name in want._fields:
        _equal(getattr(got, name), getattr(want, name))


def test_bank_from_numpy_carries_a_jax_bank():
    want = jbanks.build_bank(_sets(jdart, 3), window_size=256,
                             wide_capacity=64)
    got = tbanks.bank_from_numpy(want)
    assert isinstance(got, tbanks.ParticleBank)
    for name in want._fields:
        _equal(getattr(got, name), getattr(want, name))


def test_load_hdl64_calib_bitwise():
    want, got = jcalib.load_hdl64_calib(), tcalib.load_hdl64_calib()
    assert got.num_lasers == want.num_lasers
    for name in want._fields:
        _equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("kw", [
    dict(n_azimuth=100, seed=2),
    dict(n_azimuth=100, fov_deg=360.0, seed=4),
    dict(n_azimuth=60, seed=1),
])
def test_synthetic_scan_bitwise(kw):
    _equal(tsyn.synthetic_scan(calib=tcalib.load_hdl64_calib(), **kw),
           jsyn.synthetic_scan(calib=jcalib.load_hdl64_calib(), **kw))


@pytest.mark.parametrize("kw", [dict(), dict(n_points=48, d_max_mm=2.0)])
def test_bake_mie_lut_bitwise(kw):
    want, got = jmie.bake_mie_lut(**kw), tmie.bake_mie_lut(**kw)
    assert tmie.WATER_M_905NM == jmie.WATER_M_905NM
    for f in dataclasses.fields(want):
        _equal(getattr(got, f.name), getattr(want, f.name))


def test_reference_sample_order_equal(tmp_path):
    split = tmp_path / "split.txt"
    split.write_text("".join(f"2018-02-0{d},{f:05d}\n"
                             for d in (3, 1, 2) for f in (7, 3, 11)) + "\n")
    assert reference_sample_order(split) == jax_sample_order(split)


def test_pad_cloud_bitwise():
    pc = jsyn.synthetic_scan(n_azimuth=60, seed=1)
    want, got = jpc.pad_cloud(pc, 8192), tpc.pad_cloud(pc, 8192)
    _equal(got.points, want.points)
    _equal(got.mask, want.mask)
    with pytest.raises(ValueError):
        tpc.pad_cloud(pc, len(pc) - 1)


def _nondefault(cls):
    """An instance of config class `cls` with every field off its default."""
    values = {}
    for f in dataclasses.fields(cls):
        v = f.default
        if isinstance(v, bool):
            values[f.name] = not v
        elif isinstance(v, int):
            values[f.name] = v + 3
        elif isinstance(v, float):
            values[f.name] = v * 1.5 + 0.25
        else:
            values[f.name] = v + "_x"
    return cls(**values)


@pytest.mark.parametrize("name", ["SnowfallConfig", "WetGroundConfig",
                                  "PlaneFitConfig"])
def test_config_from_jax_round_trips_every_field(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert [(f.name, f.default) for f in dataclasses.fields(tcls)] == \
        [(f.name, f.default) for f in dataclasses.fields(jcls)]
    for src in (jcls(), _nondefault(jcls)):
        got = tconfig.config_from_jax(src)
        assert type(got) is tcls
        assert dataclasses.asdict(got) == dataclasses.asdict(src)
    if name == "SnowfallConfig":
        assert tconfig.config_from_jax(jcls()).range_grid().tobytes() == \
            jcls().range_grid().tobytes()


def test_pointpillars_config_matches_jax():
    """The port's PointPillarsConfig has the JAX dataclass's fields and
    defaults, and the same derived grid."""
    from lidar_snow_sim_tpu.models import pointpillars as jpp
    from lidar_snow_sim_tpu_torch.models import pointpillars as tpp

    jcls, tcls = jpp.PointPillarsConfig, tpp.PointPillarsConfig
    assert [(f.name, f.default) for f in dataclasses.fields(tcls)] == \
        [(f.name, f.default) for f in dataclasses.fields(jcls)]
    for prop in ("grid_size", "feature_map_size", "num_anchors_per_loc"):
        assert getattr(tcls(), prop) == getattr(jcls(), prop)
    assert tpp.param_shapes(tcls()) == jpp.param_shapes(jcls())


def test_config_from_jax_raises_on_unknown_fields():
    @dataclasses.dataclass(frozen=True)
    class SnowfallConfig(jconfig.SnowfallConfig):
        extra_knob: int = 1

    with pytest.raises(ValueError, match="extra_knob"):
        tconfig.config_from_jax(SnowfallConfig())

    @dataclasses.dataclass
    class OtherConfig:
        x: int = 0

    with pytest.raises(TypeError):
        tconfig.config_from_jax(OtherConfig())


@pytest.fixture(scope="module")
def small_bank():
    return tbanks.build_bank(_sets(tdart, 3), window_size=256,
                             wide_capacity=64)


def _entry_points(tmp_path, bank):
    """(name, call) for every entry point, each with its default device."""
    from lidar_snow_sim_tpu_torch import api
    from lidar_snow_sim_tpu_torch.models import dror, fog, lisa, stf_fog
    from lidar_snow_sim_tpu_torch.models.snowfall import SnowfallAugmenter
    from lidar_snow_sim_tpu_torch.models.wet_ground import WetGroundAugmenter
    from lidar_snow_sim_tpu_torch.parallel.datagen import run_snowfall_datagen
    from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
    from lidar_snow_sim_tpu_torch.tools import evaluate, experiment, infer
    from lidar_snow_sim_tpu_torch.tools import inspect as tinspect
    from lidar_snow_sim_tpu_torch.tools import parity_gpu, precompute, train
    from lidar_snow_sim_tpu_torch.tools import viewer
    from lidar_snow_sim_tpu_torch.utils import eval_ap

    pc = tsyn.synthetic_scan(n_azimuth=20, seed=1)
    scan = tmp_path / "scan.bin"
    pc.tofile(scan)
    calib = tcalib.load_hdl64_calib()
    cfg = tconfig.SnowfallConfig(assembly="dense", max_points=8192,
                                 channel_capacity=128, block_points=32)
    det_cfg = tpp.PointPillarsConfig(
        pfn_filters=(8,), layer_nums=(1, 1, 1), num_filters=(8, 8, 8),
        num_upsample_filters=(8, 8, 8), max_pillars=64)
    det_params = tpp.init_params(det_cfg, torch.Generator().manual_seed(0))
    det_cpu = tpp.PointPillars(det_cfg, det_params, device="cpu")
    return {
        "api.augment": lambda: api.augment(pc, "none", 0.17,
                                           root_path=str(tmp_path)),
        "api.ground_water_augmentation":
            lambda: api.ground_water_augmentation(pc),
        "SnowfallAugmenter": lambda: SnowfallAugmenter(bank, calib, cfg),
        "WetGroundAugmenter": lambda: WetGroundAugmenter()(pc),
        "LISA": lambda: lisa.LISA(),
        "FogAugmenter": lambda: fog.FogAugmenter(),
        "simulate_fog": lambda: fog.simulate_fog(fog.FogParameterSet(), pc,
                                                 10.0),
        "StfFogAugmenter": lambda: stf_fog.StfFogAugmenter(),
        "dynamic_radius_outlier_filter":
            lambda: dror.dynamic_radius_outlier_filter(pc),
        "run_snowfall_datagen": lambda: run_snowfall_datagen(
            ["f0"], lambda sid: pc, tmp_path / "out", bank, calib, cfg),
        "inspect CLI": lambda: tinspect.main([str(scan), "--augment", "fog"]),
        "precompute CLI": lambda: precompute.main([
            "--split", str(tmp_path / "none.txt"), "--lidar-dir",
            str(tmp_path), "--bank-dir", str(tmp_path)]),
        "PointPillars": lambda: tpp.PointPillars(det_cfg, det_params),
        "detect": lambda: tpp.detect(pc[:, :4], None, det_cpu),
        "infer CLI": lambda: infer.main([str(scan), "--random-params"]),
        "train_forward": lambda: tpp.train_forward(
            pc[None, :, :4], np.ones((1, len(pc)), bool), det_cpu),
        "train CLI": lambda: train.main([
            "--synthetic", "2", "--steps", "1", "--batch", "1",
            "--max-points", "256", "--out", str(tmp_path / "out")]),
        "eval_ap.evaluate": lambda: eval_ap.evaluate(
            [eval_ap.gt_frame(np.ones((1, 7)), ["Car"])],
            [eval_ap.det_frame(np.ones((1, 7)), ["Car"], [0.5])]),
        "evaluate CLI": lambda: evaluate.main([
            "--predictions", str(scan), "--labels", str(scan)]),
        "experiment CLI": lambda: experiment.main([
            "--out", str(tmp_path / "out" / "e.json"), "--work",
            str(tmp_path / "out")]),
        "viewer CLI": lambda: viewer.main([
            str(scan), "--out", str(tmp_path / "out" / "v.html")]),
        "viewer --serve": lambda: viewer.main([str(scan), "--serve",
                                               "--port", "0"]),
        "parity_gpu CLI": lambda: parity_gpu.main([
            str(tmp_path / "out" / "PARITY_GPU.json")]),
    }


ENTRY_POINTS = ["api.augment", "api.ground_water_augmentation",
                "SnowfallAugmenter", "WetGroundAugmenter", "LISA",
                "FogAugmenter", "simulate_fog", "StfFogAugmenter",
                "dynamic_radius_outlier_filter", "run_snowfall_datagen",
                "inspect CLI", "precompute CLI", "PointPillars", "detect",
                "infer CLI", "train_forward", "train CLI", "eval_ap.evaluate",
                "evaluate CLI", "experiment CLI", "viewer CLI",
                "viewer --serve", "parity_gpu CLI"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card_and_never_fall_back(
        name, tmp_path, monkeypatch, small_bank):
    """With no card, an entry point left at its default device raises; it
    does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points(tmp_path, small_bank)[name]
    with pytest.raises(RuntimeError, match="cuda"):
        call()
    assert not (tmp_path / "out").exists()


def test_resolve_device():
    from lidar_snow_sim_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_detector_augment_numpy_parts_bitwise():
    """The copied host code of detector_augment: the BEV overlap test, the
    interior-point test and the SAMPLE_GROUPS parser."""
    from lidar_snow_sim_tpu.models import detector_augment as jaug
    from lidar_snow_sim_tpu_torch.models import detector_augment as taug

    rng = np.random.default_rng(0)

    def boxes(n):
        return np.column_stack([
            rng.uniform(-10, 10, (n, 2)), rng.uniform(-1, 1, n),
            rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, n),
        ]).astype(np.float32)

    a, b = boxes(40), boxes(30)
    b[:5] = a[:5]                    # coincident boxes
    _equal(taug._bev_intersects(a, b), jaug._bev_intersects(a, b))
    _equal(taug._bev_intersects(a[:0], b), jaug._bev_intersects(a[:0], b))
    pts = rng.uniform(-10, 10, (500, 4)).astype(np.float32)
    for box in a[:8]:
        _equal(taug._points_in_box(pts, box), jaug._points_in_box(pts, box))
    spec = " Car:15, Pedestrian:10,,Cyclist:0 "
    assert taug.parse_sample_groups(spec) == jaug.parse_sample_groups(spec)
    assert taug.WorldAugmentConfig() == taug.WorldAugmentConfig(
        **dataclasses.asdict(jaug.WorldAugmentConfig()))


@pytest.mark.parametrize("seed", range(4))
def test_eval_ap_numpy_parts_bitwise(seed):
    """The copied protocol of eval_ap: ignore states, both matchers, the
    recall thresholds, AP on given overlaps, and the frame builders."""
    from lidar_snow_sim_tpu.utils import eval_ap as jeval
    from lidar_snow_sim_tpu_torch.utils import eval_ap as teval
    from lidar_snow_sim_tpu_torch.utils.boxes import Box3D

    rng = np.random.default_rng(seed)
    names = ["Car", "Van", "Pedestrian", "Person_sitting", "Cyclist",
             "DontCare"]
    n_gt, n_dt = int(rng.integers(1, 12)), int(rng.integers(0, 16))
    gt = jeval.gt_frame(rng.normal(0, 5, (n_gt, 7)),
                        list(rng.choice(names, n_gt)),
                        truncated=rng.uniform(0, 0.6, n_gt),
                        occluded=rng.integers(0, 3, n_gt),
                        bbox_height=rng.uniform(10, 60, n_gt))
    dt = jeval.det_frame(rng.normal(0, 5, (n_dt, 7)),
                         list(rng.choice(names[:5], n_dt)),
                         rng.integers(0, 4, n_dt) / 4.0)
    overlaps = rng.integers(0, 5, (n_gt, n_dt)) / 5.0
    for cls in ("Car", "Pedestrian", "Cyclist"):
        for diff in range(3):
            want = jeval._clean_frame(gt, dt, cls, diff)
            got = teval._clean_frame(gt, dt, cls, diff)
            _equal(got[0], want[0])
            _equal(got[1], want[1])
            assert got[2] == want[2]
            for fp in (False, True):
                args = (overlaps, dt["scores"], want[0], want[1], 0.4,
                        0.3 if fp else 0.0, fp)
                for fn in ("_frame_statistics", "_frame_statistics_ref"):
                    a = getattr(teval, fn)(*args)
                    b = getattr(jeval, fn)(*args)
                    assert a[:3] == b[:3] and list(a[3]) == list(b[3])
            for mode in ("R40", "R11"):
                kw = dict(difficulty=diff, recall_mode=mode,
                          _overlaps=[overlaps])
                a = teval.average_precision([gt], [dt], cls, **kw)
                b = jeval.average_precision([gt], [dt], cls, **kw)
                assert (np.isnan(a) and np.isnan(b)) or a == b
    scores = rng.uniform(0, 1, 60)
    _equal(teval._get_thresholds(scores, 50), jeval._get_thresholds(scores,
                                                                     50))
    anns = [{"identity": "Car", "truncated": 0.1, "occlusion": 1,
             "bbox": (10.0, 20.0, 60.0, 65.0), "height": 1.6, "width": 1.8,
             "length": 4.0, "posx_lidar": 5.0, "posy_lidar": 1.0,
             "posz_lidar": -1.6, "rotz": 0.2}]
    arr = np.column_stack([rng.normal(0, 5, (6, 7)), rng.integers(0, 5, 6),
                           rng.uniform(0, 1, 6)])
    bx = [Box3D(x=1.0, y=2.0, z=0.5, length=4.0, width=1.8, height=1.5,
                yaw=0.3, identity="Car", score=0.7)]
    for got, want in (
            (teval.gt_frame_from_annotations(anns),
             jeval.gt_frame_from_annotations(anns)),
            (teval.det_frame_from_predictions(arr, ("Car", "Pedestrian")),
             jeval.det_frame_from_predictions(arr, ("Car", "Pedestrian"))),
            (teval.gt_frame_from_boxes(bx), jeval.gt_frame_from_boxes(bx)),
            (teval.det_frame_from_boxes(bx), jeval.det_frame_from_boxes(bx))):
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                _equal(got[k], want[k])
            else:
                assert got[k] == want[k]
    for const in ("MIN_HEIGHT", "MAX_OCCLUSION", "MAX_TRUNCATION",
                  "DIFFICULTY_NAMES", "SIMILAR_CLASSES",
                  "DEFAULT_IOU_THRESH"):
        assert getattr(teval, const) == getattr(jeval, const)


def test_stf_labels_transforms_bitwise():
    """The copied stf_labels: quaternion and TF-record matrices (its
    calib and label files are held in tests/test_torch_eval.py)."""
    from lidar_snow_sim_tpu.utils import stf_labels as jstf
    from lidar_snow_sim_tpu_torch.utils import stf_labels as tstf

    rng = np.random.default_rng(2)
    for q in rng.normal(0, 1, (20, 4)):
        _equal(tstf._quat_to_mat(*q), jstf._quat_to_mat(*q))
        tf = {"transform": {
            "translation": dict(zip("xyz", rng.normal(0, 2, 3))),
            "rotation": dict(zip("xyzw", q))}}
        _equal(tstf._tf_to_mat(tf), jstf._tf_to_mat(tf))


def test_stf_meta_bitwise(tmp_path):
    """The copied stf_meta: temporal neighbours (padding, negative frames,
    another separator), the meta filters over a directory of metas and the
    road-wetness reader's silent failures."""
    from lidar_snow_sim_tpu.utils import stf_meta as jmeta
    from lidar_snow_sim_tpu_torch.utils import stf_meta as tmeta

    for sid, kw in (("2018-02-06_14-21-12,00002", {}),
                    ("2019-01-01,0099", dict(offsets=range(-3, 3))),
                    ("d_00007", dict(sep="_"))):
        assert tmeta.temporal_neighbors(sid, **kw) == \
            jmeta.temporal_neighbors(sid, **kw)
    ids = []
    for i, (weather, env, day, tunnel) in enumerate([
            ("snow", "urban", "day", False), ("clear", "highway", "night",
                                              True),
            ("snow", "highway", "night", False)]):
        fid = f"2019,{i:05d}"
        ids.append(fid)
        meta = {"weather": {"snow": weather == "snow",
                            "clear": weather == "clear"},
                "daytime": {"day": day == "day", "night": day == "night"},
                "meta": {"environment": {"urban": env == "urban",
                                         "highway": env == "highway"},
                         "infrastructure": {"tunnel": tunnel}}}
        (tmp_path / f"{fid}.json").write_text(json.dumps(meta))
    (tmp_path / "2019,00009.json").write_text(json.dumps({"weather": {}}))
    ids += ["2019,00009", "2019,00404"]
    for kw in (dict(), dict(weather="snow"), dict(environment="highway",
                                                  daytime="night"),
               dict(infrastructure="tunnel"), dict(weather="fog")):
        assert tmeta.select_frames(tmp_path, ids, **kw) == \
            jmeta.select_frames(tmp_path, ids, **kw)
    (tmp_path / "wet.json").write_text(json.dumps(
        {"water_thickness": "0.25", "surface_state_result": "wet"}))
    (tmp_path / "bad.json").write_text("{")
    for name in ("wet.json", "bad.json", "missing.json"):
        assert tmeta.read_road_wetness(tmp_path / name) == \
            jmeta.read_road_wetness(tmp_path / name)


def _write_loader_inputs(tmp_path, rng):
    """One file per container the loaders read, with their arguments."""
    pts = rng.uniform(-30, 30, (50, 6)).astype(np.float32)
    pts[:, 3] = rng.uniform(0, 1.2, 50)
    pts[:5, 3] = [-0.5, 0.0, 1.0, 300.0, 2.0]        # clipped intensities
    pts[:, :4].tofile(tmp_path / "k.bin")
    pts[:, :5].tofile(tmp_path / "d.bin")
    with open(tmp_path / "a.pkl", "wb") as f:
        pickle.dump(pts[:, :4].astype(np.float64), f)
    import gzip

    with gzip.open(tmp_path / "a.pkl.gz", "wb") as f:
        pickle.dump(pts[:, :3], f)
    props = ["x", "y", "z", "intensity", "ring"]
    header = ["ply", None, "element vertex 50",
              *[f"property float {p}" for p in props[:4]],
              "property uchar ring", "end_header"]
    ring = rng.integers(0, 64, 50).astype(np.uint8)
    header[1] = "format ascii 1.0"
    body = "\n".join(" ".join(f"{v:.6f}" for v in row[:4]) + f" {r}"
                     for row, r in zip(pts, ring))
    (tmp_path / "a.ply").write_text("\n".join(header) + "\n" + body + "\n")
    import struct

    for name, fmt, end in (("le.ply", "binary_little_endian", "<"),
                           ("be.ply", "binary_big_endian", ">")):
        header[1] = f"format {fmt} 1.0"
        data = b"".join(struct.pack(end + "ffffB", *row[:4], r)
                        for row, r in zip(pts, ring))
        (tmp_path / name).write_bytes(
            ("\n".join(header) + "\n").encode() + data)
    np.savez(tmp_path / "a.npz", points=pts[:, :3], reflectance=pts[:, 3],
             lidar_id=ring)
    np.savez(tmp_path / "b.npz", points=pts[:, :3])
    return pts


def test_datasets_loaders_bitwise(tmp_path):
    """The copied utils.datasets: every container and dataset entry of
    load_pointcloud, the result.pkl and pcdet data_dict readers."""
    from lidar_snow_sim_tpu.utils import datasets as jds
    from lidar_snow_sim_tpu_torch.utils import datasets as tds

    rng = np.random.default_rng(4)
    pts = _write_loader_inputs(tmp_path, rng)
    assert tds.DATASET_FORMATS == jds.DATASET_FORMATS
    assert tds.PCDET_CLASS_LOOKUP == jds.PCDET_CLASS_LOOKUP
    for arr, scale in ((pts[:, :2], 1.0), (pts[:, :4], 255.0), (pts, 0.5)):
        _equal(tds.normalize_pc(arr, scale), jds.normalize_pc(arr, scale))
    calls = [
        ("load_bin", (tmp_path / "k.bin",), dict(columns=4,
                                                  intensity_scale=255.0)),
        ("load_bin", (tmp_path / "d.bin",), {}),
        ("load_pkl", (tmp_path / "a.pkl",), {}),
        ("load_pkl", (tmp_path / "a.pkl.gz",), {}),
        ("load_ply", (tmp_path / "a.ply",), {}),
        ("load_ply", (tmp_path / "le.ply",), dict(keep_columns=(0, 1, 2))),
        ("load_ply", (tmp_path / "be.ply",), {}),
        ("load_npz", (tmp_path / "a.npz",), {}),
        ("load_npz", (tmp_path / "b.npz",), {}),
        ("load_pointcloud", (tmp_path / "k.bin", "KITTI"), {}),
        ("load_pointcloud", (tmp_path / "d.bin", "DENSE"), {}),
        ("load_pointcloud", (tmp_path / "a.ply", "Argoverse"), {}),
        ("load_pointcloud", (tmp_path / "a.npz", "A2D2"), {}),
        ("load_pointcloud", (tmp_path / "a.pkl", "PandaSet"), {}),
        ("load_pointcloud", (tmp_path / "a.npz", "other"), {}),
    ]
    for name, args, kw in calls:
        _equal(getattr(tds, name)(*args, **kw), getattr(jds, name)(*args,
                                                                    **kw))
    for mod in (tds, jds):
        with pytest.raises(ValueError, match="unsupported"):
            mod.load_pointcloud(tmp_path / "k.txt", "other")
        with pytest.raises(ValueError, match="not a PLY"):
            mod.load_ply(tmp_path / "k.bin")

    result = [dict(frame_id=f"2019,{i:05d}",
                   boxes_lidar=rng.normal(0, 5, (i, 7)),
                   name=np.array(["Car", "Cyclist", "Tram"][:i]),
                   score=rng.uniform(0, 1, i)) for i in (3, 0, 2)]
    with open(tmp_path / "result.pkl", "wb") as f:
        pickle.dump(result[::-1], f)
    got, want = (m.load_result_pkl(tmp_path / "result.pkl")
                 for m in (tds, jds))
    assert [d["frame_id"] for d in got] == [d["frame_id"] for d in want]
    for fid in ("2019,00003", "2019,00000", "2019,00002"):
        _equal(tds.result_predictions(got, fid),
               jds.result_predictions(want, fid))
    with pytest.raises(KeyError):
        tds.result_predictions(got, "2019,00001")

    d = {"points": pts[:, :5], "gt_boxes": rng.normal(0, 3, (4, 8))}
    with open(tmp_path / "dict.pkl", "wb") as f:
        pickle.dump(d, f)
    with open(tmp_path / "nogt.pkl", "wb") as f:
        pickle.dump({"points": pts[:, :4]}, f)
    for name in ("dict.pkl", "nogt.pkl"):
        for a, b in zip(tds.load_pcdet_dict(tmp_path / name),
                        jds.load_pcdet_dict(tmp_path / name)):
            _equal(a, b)


def test_boxes_from_array_bitwise():
    """The copied boxes_from_array: prediction rows (0-based class, score
    column), pcdet gt rows (1-based class) and bare 7-column rows."""
    from lidar_snow_sim_tpu.utils import boxes as jboxes
    from lidar_snow_sim_tpu_torch.utils import boxes as tboxes

    rng = np.random.default_rng(5)
    arr = rng.normal(0, 4, (6, 9)).astype(np.float32)
    arr[:, 7] = [0, 1, 2, 3, -1, 1]
    names = ("Car", "Pedestrian", "Cyclist")
    cases = [(arr, dict(class_names=names)),
             (arr[:, :8], dict(class_names=("",) + names)),
             (arr[:, :7], dict(scores=rng.uniform(0, 1, 6))),
             (arr[:, :7], {}), (arr[:0], dict(class_names=names))]
    for a, kw in cases:
        got = tboxes.boxes_from_array(a, **kw)
        want = jboxes.boxes_from_array(a, **kw)
        assert [dataclasses.astuple(b) for b in got] == \
            [dataclasses.astuple(b) for b in want]
    assert tboxes.DET_COLORS == jboxes.DET_COLORS
    assert tboxes.DET_FALLBACK_COLOR == jboxes.DET_FALLBACK_COLOR


# ---- host utilities: the cases of tests/test_utils_aux.py:80-162

def test_planes_io_bitwise(tmp_path):
    """transform_results_to_camera_extrinsics, save_plane and write_csv:
    the JAX package's cases and a rotated projection, the files equal byte
    for byte."""
    from lidar_snow_sim_tpu.utils import planes_io as jpl
    from lidar_snow_sim_tpu_torch.utils import planes_io as tpl

    rot = np.array([[0.0, -1.0, 0.0, 0.1], [0.0, 0.0, -1.0, -0.2],
                    [1.0, 0.0, 0.0, 0.3], [0.0, 0.0, 0.0, 1.0]])
    for pm in (np.eye(4), rot, rot[:3]):
        got = tpl.transform_results_to_camera_extrinsics(
            pm, [0.01, -0.02, 1.0], -1.55)
        want = jpl.transform_results_to_camera_extrinsics(
            pm, [0.01, -0.02, 1.0], -1.55)
        _equal(got[0], want[0])
        assert got[1] == want[1]
    w, hp = tpl.transform_results_to_camera_extrinsics(
        np.eye(4), [0.0, 0.0, 1.0], -1.55)
    np.testing.assert_allclose(w, [0, 0, 1])
    assert abs(hp - (-1.55)) < 1e-12
    for mod, name in ((tpl, "port"), (jpl, "jax")):
        mod.save_plane(tmp_path / name, "plane.txt", [0, 0, 1], -1.55,
                       np.eye(4))
        mod.save_plane(tmp_path / name, "rot.txt", [0.01, -0.02, 1.0], -1.7,
                       rot)
        mod.write_csv("t", [1, 2], [3.5, 4.5], label_file="lbl",
                      folder=str(tmp_path / name / "stats"))
    for rel in ("plane.txt", "rot.txt", "stats/lbl_t.csv"):
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes()
    lines = (tmp_path / "port" / "plane.txt").read_text().splitlines()
    assert lines[0] == "# Plane"
    np.testing.assert_allclose([float(v) for v in lines[3].split()],
                               [0, 0, 1, -1.55], atol=1e-12)
    csv = (tmp_path / "port" / "stats" / "lbl_t.csv").read_text()
    assert csv.splitlines()[1].split(",") == ["1", "3.5"]


def test_incidence_range_distribution_bitwise():
    from lidar_snow_sim_tpu.sampling import empirical as jemp
    from lidar_snow_sim_tpu_torch.sampling import empirical as temp

    f = temp.incidence_range_empirical_distribution
    g = jemp.incidence_range_empirical_distribution
    one = np.array([[10.0, 0.0, 1.0]])
    ranges, dirs = f(one, R_0=80.0, n_directions=8)
    assert dirs[0] == 0.0 and abs(ranges[0] - 9.0) < 1e-9
    np.testing.assert_allclose(ranges[1:], 80.0)
    field = _sets(tdart, 3)[0]
    cases = [((one, 80.0, 8), {}), ((np.zeros((0, 3)), 50.0, 4), {}),
             ((field, 80.0, 360), {}),
             ((field, 80.0, 100), dict(sample_regular_directions=False))]
    for args, kw in cases:
        got = f(*args, **kw, rng=np.random.default_rng(1))
        want = g(*args, **kw, rng=np.random.default_rng(1))
        for a, b in zip(got, want):
            _equal(a, b)


def test_ground_stats_bitwise():
    """ground_plane_intensity_stats on a synthetic scan (with the port's
    oracle RANSAC inside) and its bail-out (fewer than min_ground_points
    ground points): equal arrays, all None on the bail-out."""
    from lidar_snow_sim_tpu.utils import ground_stats as jgs
    from lidar_snow_sim_tpu_torch.utils import ground_stats as tgs

    pc = tsyn.synthetic_scan(n_azimuth=220, seed=0)
    for kw in ({}, dict(delta=0.2, trajectory_half_width=3.0, seed=2)):
        got = tgs.ground_plane_intensity_stats(pc, **kw)
        want = jgs.ground_plane_intensity_stats(pc, **kw)
        assert got._fields == want._fields
        for a, b in zip(got, want):
            _equal(a, b)
        assert got.cumsum is not None and len(got.filled_idx) > 5
    bail = tgs.ground_plane_intensity_stats(pc[:500])
    assert bail == jgs.ground_plane_intensity_stats(pc[:500])
    assert bail == tgs.GroundIntensityStats(None, None, None, None, None)


def test_splits_bitwise(tmp_path):
    """read_split and reorder_second_half_first equal the JAX package's;
    the precompute CLI's own reference_sample_order is their composition;
    utils exports read_split as the JAX package's utils does."""
    from lidar_snow_sim_tpu.utils import splits as jsp
    from lidar_snow_sim_tpu_torch import utils as tutils
    from lidar_snow_sim_tpu_torch.utils import splits as tsp

    assert tutils.read_split is tsp.read_split
    for n in (0, 1, 4, 7):
        split = tmp_path / f"s{n}.txt"
        split.write_text("".join(
            f"2019-0{i % 3 + 1}-11_18-41-27,{(7 * i) % 13:05d}\n"
            for i in range(n)) + "\n")
        ids = tsp.read_split(split)
        assert ids == jsp.read_split(split)
        assert tsp.reorder_second_half_first(ids) == \
            jsp.reorder_second_half_first(ids)
        assert reference_sample_order(split) == \
            tsp.reorder_second_half_first(ids)


SPLITS = ("test_clear", "test_snow_heavy", "test_snow_light", "train_clear",
          "val_clear")


@pytest.mark.parametrize("name", SPLITS)
def test_split_files_bitwise(name):
    """The port ships the JAX package's STF split files byte for byte, and
    read_split reads the same sample IDs from both."""
    import lidar_snow_sim_tpu
    import lidar_snow_sim_tpu_torch
    from lidar_snow_sim_tpu_torch.utils import splits as tsp

    want = Path(lidar_snow_sim_tpu.__file__).parent / "data" / "splits"
    got = Path(lidar_snow_sim_tpu_torch.__file__).parent / "data" / "splits"
    assert sorted(p.name for p in got.glob("*.txt")) == \
        sorted(p.name for p in want.glob("*.txt"))
    assert (got / f"{name}.txt").read_bytes() == \
        (want / f"{name}.txt").read_bytes()
    assert tsp.read_split(got / f"{name}.txt") == \
        tsp.read_split(want / f"{name}.txt")


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    """device_trace without a card writes a Chrome trace of the CPU's
    activity that holds a span's region."""
    from lidar_snow_sim_tpu_torch.utils.profiling import device_trace, span

    with device_trace(str(tmp_path / "trace")):
        with span("port_region"):
            torch.ones(64).cumsum(0)
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "port_region" for e in events)
