"""Kernels A1, A2, A3 and C1 on the card against their plain torch
versions.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import no
jax, so they also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports jax for the JAX package's tests).
The scenes here also feed test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu_torch import (
    SnowfallConfig,
    build_bank,
    load_hdl64_calib,
    pad_cloud,
    synthetic_scan,
)
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops.occluders import (
    find_occluders,
    find_occluders_banded,
    find_occluders_routed,
    occluders_banded_plain,
    occluders_plain,
    occluders_routed_plain,
)
from lidar_snow_sim_tpu_torch.ops.pulse import pulse_peaks, pulse_plain

_W = np.array([0.005, -0.003, -1.0])
PLANE = (_W / np.linalg.norm(_W), -1.55)


def _particle_sets(seed, n, spread, r_max, d_min=0.0):
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(64):
        ang = rng.uniform(-spread, spread, n)
        d = np.sqrt(rng.uniform(0.01, 1, n)) * 60 + d_min
        r = rng.uniform(0.005, r_max, n)
        sets.append(np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))
    return sets


# "scene": the test_dense_assembly bank; "dense": many large flakes in the
# scan's FOV with K = 8, so beams overflow and the top-K list is full
CASES = {
    "scene": dict(sets=(5, 300, np.pi, 0.05), wide=64, k=48),
    "dense": dict(sets=(9, 3000, 0.9, 0.15, 2.0), wide=512, k=8),
}


def layout(case, device="cpu", slice_width=256, **cfg_kw):
    """The port's phase-A layout of the small scene for one case; `cfg_kw`
    (route_band, band_width, band_group) selects kernel A2 or A3."""
    spec = CASES[case]
    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=100, seed=2, calib=calib)
    bank = build_bank(_particle_sets(*spec["sets"]), window_size=256,
                      wide_capacity=spec["wide"])
    cfg = SnowfallConfig(
        max_points=8192, window_size=256, wide_capacity=spec["wide"],
        max_occluders=spec["k"], max_bumps=spec["k"], assembly="dense",
        channel_capacity=128, block_points=32, slice_width=slice_width,
        **cfg_kw,
    )
    padded = pad_cloud(pc, cfg.max_points)
    plane = (torch.tensor(PLANE[0], dtype=torch.float32, device=device),
             torch.tensor(PLANE[1], dtype=torch.float32, device=device))
    lay = ts.dense_layout(
        torch.as_tensor(padded.points, device=device),
        torch.as_tensor(padded.mask, device=device),
        ts.bank_to_torch(bank, device),
        torch.as_tensor(np.random.default_rng(3).permutation(64),
                        device=device),
        None, cfg, plane=plane,
    )
    return lay, calib, cfg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case,slice_width", [
    ("dense", 256), ("scene", 256),
    # wider than the bank row (812 columns): the slice is clipped to the
    # row and, with the wide list, spans two shared-memory tiles
    ("scene", 2048),
])
def test_cuda_kernels_match_plain(cuda, case, slice_width):
    """On the card: A1 and C1 equal their plain versions exactly."""
    lay, calib, cfg = layout(case, device=cuda, slice_width=slice_width)
    n0 = find_occluders.launches
    a12d, ovf = find_occluders(*lay.occluder_args, **lay.occluder_kw)
    assert find_occluders.launches == n0 + 1
    a12d_p, ovf_p = occluders_plain(*lay.occluder_args, **lay.occluder_kw)
    k = cfg.max_occluders
    assert torch.equal(ovf, ovf_p)
    assert torch.equal(a12d[2 * k:], a12d_p[2 * k:])
    live = torch.cat([a12d_p[2 * k:] < 1e37] * 2)
    assert torch.equal(a12d[:2 * k][live], a12d_p[:2 * k][live])
    comp = ts.compact_occluded(lay, a12d, ovf, ts.calib_to_torch(calib, cuda),
                               cfg)
    for got, want in zip(pulse_peaks(*comp.pulse_args, **comp.pulse_kw),
                         pulse_plain(*comp.pulse_args, **comp.pulse_kw)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_wrapper_checks_inputs(cuda):
    """A wrapper raises on what its kernel does not take, before launching."""
    lay, _, _ = layout("scene", device=cuda)
    args = list(lay.occluder_args)
    n0 = find_occluders.launches
    args[2] = args[2].long()                          # rows as int64
    with pytest.raises(ValueError, match="rows"):
        find_occluders(*args, **lay.occluder_kw)
    with pytest.raises(ValueError, match="max_occluders"):
        find_occluders(*lay.occluder_args,
                       **dict(lay.occluder_kw, k_occ=1024))
    assert find_occluders.launches == n0
    lay2, _, _ = layout("scene", device=cuda, route_band=128, band_group=8)
    n2 = find_occluders_routed.launches
    with pytest.raises(ValueError, match="band_group"):
        find_occluders_routed(*lay2.occluder_args,
                              **dict(lay2.occluder_kw, group=5))
    args = list(lay2.occluder_args)
    args[4] = args[4][:-1]                            # gloa one short
    with pytest.raises(ValueError, match="gloa"):
        find_occluders_routed(*args, **lay2.occluder_kw)
    assert find_occluders_routed.launches == n2


@pytest.mark.cuda
@pytest.mark.parametrize("route", [128, 96])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_routed_matches_plain(cuda, case, route):
    """On the card: A2 equals its plain version exactly, and A1 on the
    in-channel beams (dist plane and overflow)."""
    lay, _, cfg = layout(case, device=cuda, route_band=route, band_group=8)
    assert lay.kernel == "A2"
    n0 = find_occluders_routed.launches
    a12d, ovf = find_occluders_routed(*lay.occluder_args, **lay.occluder_kw)
    assert find_occluders_routed.launches == n0 + 1
    a12d_p, ovf_p = occluders_routed_plain(*lay.occluder_args,
                                           **lay.occluder_kw)
    k = cfg.max_occluders
    assert torch.equal(ovf, ovf_p)
    assert torch.equal(a12d, a12d_p)
    lay1, _, _ = layout(case, device=cuda)
    a12d_1, ovf_1 = find_occluders(*lay1.occluder_args, **lay1.occluder_kw)
    valid = lay.valid_blk.reshape(-1)
    assert torch.equal(ovf.reshape(-1)[valid], ovf_1.reshape(-1)[valid])
    assert torch.equal(a12d[2 * k:, valid], a12d_1[2 * k:, valid])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_banded_matches_plain(cuda, case):
    """On the card: A3 equals its plain version exactly, coverage plane
    included."""
    lay, _, _ = layout(case, device=cuda, slice_width=384, band_width=256,
                       band_group=8)
    assert lay.kernel == "A3"
    n0 = find_occluders_banded.launches
    got = find_occluders_banded(*lay.occluder_args, **lay.occluder_kw)
    assert find_occluders_banded.launches == n0 + 1
    want = occluders_banded_plain(*lay.occluder_args, **lay.occluder_kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
