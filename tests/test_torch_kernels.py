"""Kernels A1 (phase A) and C1 (phase C) of the port: their plain torch
versions against the JAX package's Pallas kernels run in interpret mode,
on identical inputs. The CUDA kernels are held against the plain versions
in test_torch_cuda.py.

The inputs are the port's own phase-A layout and phase-B compaction of a
small scene, handed as numpy arrays to both packages. A1 agrees exactly;
a1/a2 are compared where dist < 1e37 only (the TPU kernel leaves a retired
column's a1/a2 in empty top-K slots, the port writes 0 there). C1 agrees
exactly in peak bin and touched flag, and within a few ulp in peak value
and remainder (see test_c1_plain_matches_pallas).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.ops.pallas_occluders import make_pallas_occluder_phase
from lidar_snow_sim_tpu.ops.pallas_pulse import make_pallas_pulse_phase
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops.occluders import (
    find_occluders,
    occluders_plain,
)
from lidar_snow_sim_tpu_torch.ops.pulse import pulse_plain
from test_torch_cuda import CASES, layout


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are small: one intra-op thread per test worker keeps
    the workers from oversubscribing the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CASES))
def phase_a(request):
    lay, calib, cfg = layout(request.param)
    a12d, ovf = occluders_plain(*lay.occluder_args, **lay.occluder_kw)
    return lay, calib, cfg, a12d, ovf


def test_a1_plain_matches_pallas(phase_a):
    lay, _, cfg, a12d, ovf = phase_a
    feats, w0b, rows, los, has, counts, data_t, wide_t = (
        np.asarray(a) for a in lay.occluder_args
    )
    kw = lay.occluder_kw
    run = make_pallas_occluder_phase(
        blk=kw["blk"], w_sl=kw["w_sl"], wide_cap=wide_t.shape[2],
        k_occ=kw["k_occ"], beam_rad=cfg.beam_divergence_rad, interpret=True,
    )
    ja, jo = run(
        jnp.asarray(feats.reshape(-1, kw["blk"], feats.shape[1])),
        jnp.asarray(w0b), jnp.asarray(rows), jnp.asarray(los),
        jnp.asarray(counts), jnp.asarray(data_t), jnp.asarray(wide_t),
        has=jnp.asarray(has),
    )
    ja, jo = np.asarray(ja), np.asarray(jo)
    k = kw["k_occ"]
    ta, to = a12d.numpy(), ovf.numpy()
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ta[2 * k:], ja[2 * k:])
    live = np.concatenate([ja[2 * k:] < 1e37] * 2)
    np.testing.assert_array_equal(ta[:2 * k][live], ja[:2 * k][live])
    np.testing.assert_array_equal(ta[:2 * k][~live], 0.0)
    assert live.sum() > 100          # the case exercises real hits
    if k == 8:
        assert to.max() > 0          # ... and the overflow count


def test_c1_plain_matches_pallas(phase_a):
    lay, calib, cfg, a12d, ovf = phase_a
    comp = ts.compact_occluded(lay, a12d, ovf, ts.calib_to_torch(calib, "cpu"),
                               cfg)
    kw = comp.pulse_kw
    run = make_pallas_pulse_phase(
        blk=64, k_occ=cfg.max_occluders, beam_rad=kw["beam_rad"],
        ipm=kw["ipm"], c_tau=kw["c_tau"], xsi_r1=kw["xsi_r1"],
        xsi_r2=kw["xsi_r2"], interpret=True,
    )
    want = [np.asarray(a).reshape(-1) for a in run(
        *(jnp.asarray(np.asarray(a)) for a in comp.pulse_args)
    )]
    peak, idx, touched, remainder = (
        a.numpy() for a in pulse_plain(*comp.pulse_args, **kw)
    )
    np.testing.assert_array_equal(idx, want[1])
    np.testing.assert_array_equal(touched, want[2])
    # XLA's CPU backend contracts a*b+c into FMAs and may divide by a
    # constant through its reciprocal, so peak and remainder can sit up to
    # a few ulp from the port's per-op rounding (measured: 1-2 ulp on ~10%
    # of beams); 5e-7 relative is ~4 ulp
    np.testing.assert_allclose(peak, want[0], rtol=5e-7, atol=0)
    np.testing.assert_allclose(remainder, want[3], rtol=5e-7, atol=0)
    assert touched.sum() > 20          # touched beams exist


def test_cpu_tensors_take_the_plain_versions(phase_a):
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    lay = phase_a[0]
    n0 = find_occluders.launches
    a12d, ovf = find_occluders(*lay.occluder_args, **lay.occluder_kw)
    assert find_occluders.launches == n0
    assert torch.equal(a12d, phase_a[3]) and torch.equal(ovf, phase_a[4])
