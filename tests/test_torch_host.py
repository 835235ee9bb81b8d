"""The port's own copies of the JAX package's host modules, held bitwise
against the originals, the converters that carry JAX-package objects over,
and the entry points' device rule: the card unless the CPU is asked for.

Both packages build the bank, the calibration, the synthetic scan and the
Mie table from the same seeds; every array must be equal bit for bit.
"""

import dataclasses

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
    from lidar_snow_sim_tpu_torch.tools import infer
    from lidar_snow_sim_tpu_torch.tools import inspect as tinspect
    from lidar_snow_sim_tpu_torch.tools import precompute

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
    }


ENTRY_POINTS = ["api.augment", "api.ground_water_augmentation",
                "SnowfallAugmenter", "WetGroundAugmenter", "LISA",
                "FogAugmenter", "simulate_fog", "StfFogAugmenter",
                "dynamic_radius_outlier_filter", "run_snowfall_datagen",
                "inspect CLI", "precompute CLI", "PointPillars", "detect",
                "infer CLI"]


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
