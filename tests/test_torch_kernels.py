"""Kernels A1, A2, A3, A4a, A4b (phase A), the folded A1, and C1, C2 (phase
C) of the port: their plain torch versions against the JAX package's Pallas
kernels run in interpret mode, on identical inputs. The CUDA kernels are
held against the plain versions in test_torch_cuda.py.

The inputs are the port's own phase-A layouts and phase-B compaction of a
small scene, handed as numpy arrays to both packages. A1, A2 and A3 agree
exactly, A3's coverage plane included, A4a and A4b on every chunk (they
have no has gate); a1/a2 are compared where dist < 1e37 only (the TPU kernels leave a retired column's a1/a2 in empty top-K
slots, the port writes 0 there). C1 and C2 agree exactly in peak bin and
touched flag, and within a few ulp in peak value and remainder (see
test_c1_plain_matches_pallas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.ops.pallas_occluders import make_pallas_occluder_phase
from lidar_snow_sim_tpu.ops.pallas_pulse import make_pallas_pulse_phase
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops.occluders import (
    find_occluders,
    find_occluders_banded,
    find_occluders_folded,
    find_occluders_pair,
    find_occluders_routed,
    find_occluders_t,
    occluders_banded_plain,
    occluders_plain,
    occluders_routed_plain,
    occluders_ungated_plain,
)
from lidar_snow_sim_tpu_torch.ops.pulse import (
    pulse_peaks_pair,
    pulse_plain,
)
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
    _assert_same_phase_a(a12d, ovf, ja, jo, kw["k_occ"])


def _assert_same_phase_a(a12d, ovf, ja, jo, k):
    """The port's (a12d, ovf) equal the Pallas kernel's exactly, a1/a2
    where dist < 1e37 and zeros elsewhere; the case has real hits and,
    at K = 8, overflowing beams."""
    ja, jo = np.asarray(ja), np.asarray(jo)
    ta, to = a12d.numpy(), ovf.numpy()
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ta[2 * k:], ja[2 * k:])
    live = np.concatenate([ja[2 * k:] < 1e37] * 2)
    np.testing.assert_array_equal(ta[:2 * k][live], ja[:2 * k][live])
    np.testing.assert_array_equal(ta[:2 * k][~live], 0.0)
    assert live.sum() > 100          # the case exercises real hits
    if k == 8:
        assert to.max() > 0          # ... and the overflow count


@pytest.mark.parametrize("route", [128, 256, 96])
@pytest.mark.parametrize("case", sorted(CASES))
def test_a2_plain_matches_pallas(case, route):
    """Kernel A2's plain version against `_kernel_routed`; 96 is a band
    that is not a multiple of 128 (the upper band clamp floors to 128)."""
    lay, _, cfg = layout(case, route_band=route, band_group=8)
    assert lay.kernel == "A2"
    kw = lay.occluder_kw
    a12d, ovf = occluders_routed_plain(*lay.occluder_args, **kw)
    feats, *rest = (np.asarray(a) for a in lay.occluder_args)
    run = make_pallas_occluder_phase(
        blk=kw["blk"], w_sl=kw["w_sl"], wide_cap=rest[-1].shape[2],
        k_occ=kw["k_occ"], beam_rad=cfg.beam_divergence_rad, interpret=True,
        route_band=route, band_group=8, wide_sl=kw["wide_sl"],
    )
    ja, jo = run(jnp.asarray(feats.reshape(-1, kw["blk"], feats.shape[1])),
                 *(jnp.asarray(a) for a in rest))
    _assert_same_phase_a(a12d, ovf, ja, jo, kw["k_occ"])
    modes = np.bincount(rest[4], minlength=3)
    assert modes[2] > 0              # fast chunks exist at every width
    if route == 128 and case == "scene":
        assert modes[1] > 0          # ... and full-slice ones at 128


@pytest.mark.parametrize("case", sorted(CASES))
def test_a3_plain_matches_pallas(case):
    """Kernel A3's plain version against `_kernel_banded` (run_banded),
    coverage plane included; the dense case has uncovered beams."""
    lay, _, cfg = layout(case, slice_width=384, band_width=256,
                         band_group=8)
    assert lay.kernel == "A3"
    kw = lay.occluder_kw
    a12d, ovf, unc = occluders_banded_plain(*lay.occluder_args, **kw)
    feats, w0b, rows, gloa, glob, counts, data_t, wide_t = (
        np.asarray(a) for a in lay.occluder_args
    )
    g_dim = kw["blk"] // 8
    run = make_pallas_occluder_phase(
        blk=kw["blk"], w_sl=384 + 128, wide_cap=wide_t.shape[2],
        k_occ=kw["k_occ"], beam_rad=cfg.beam_divergence_rad, interpret=True,
        band=256, band_group=8, wide_sl=kw["wide_sl"],
    )
    glo_vec = np.stack([gloa.reshape(-1, g_dim), glob.reshape(-1, g_dim)],
                       axis=2)
    ja, jo, ju = run(
        jnp.asarray(feats.reshape(-1, kw["blk"], feats.shape[1])),
        *(jnp.asarray(a) for a in (
            w0b, rows, lay.slice_lo.to(torch.int32).numpy(), gloa, glob,
            glo_vec, counts, data_t, wide_t,
        )),
        kw["delta"],
    )
    _assert_same_phase_a(a12d, ovf, ja, jo, kw["k_occ"])
    np.testing.assert_array_equal(unc.numpy(), np.asarray(ju))
    if case == "dense":
        assert unc.sum() > 0


@pytest.mark.parametrize("kernel", ["A4a", "A4b"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_a4_plain_matches_pallas(case, kernel):
    """Kernels A4a and A4b's plain version (A1's, every chunk live) against
    `_kernel_t` and `_kernel_pair`: exact on every chunk, the dead ones
    (no in-channel beam, which A1 skips) included."""
    knob = "pallas_transposed" if kernel == "A4a" else "pallas_pair"
    lay, _, cfg = layout(case, **{knob: True})
    assert lay.kernel == kernel
    kw = lay.occluder_kw
    run = find_occluders_t if kernel == "A4a" else find_occluders_pair
    a12d, ovf = run(*lay.occluder_args, **kw)
    feats, w0b, rows, los, counts, data_t, wide_t = (
        np.asarray(a) for a in lay.occluder_args
    )
    fb = feats.reshape(-1, kw["blk"], feats.shape[1])
    if kernel == "A4a":
        fb = fb.transpose(0, 2, 1)   # _kernel_t's (blocks, rows, beams)
    jrun = make_pallas_occluder_phase(
        blk=kw["blk"], w_sl=kw["w_sl"], wide_cap=wide_t.shape[2],
        k_occ=kw["k_occ"], beam_rad=cfg.beam_divergence_rad, interpret=True,
        transposed=kernel == "A4a", pair=kernel == "A4b",
    )
    ja, jo = jrun(*(jnp.asarray(a) for a in (fb, w0b, rows, los, counts,
                                             data_t, wide_t)))
    _assert_same_phase_a(a12d, ovf, ja, jo, kw["k_occ"])
    k = kw["k_occ"]
    dead = ~lay.valid_blk.any(dim=1)
    hits = (a12d[2 * k:].reshape(k, -1, kw["blk"]) < 1e37).sum(dim=(0, 2))
    assert dead.any() and hits[dead].sum() > 0   # dead chunks hold real hits


def test_folded_a1_plain_matches_pallas_fold():
    """The folded A1 (one launch over 2 frames, the second with the reversed
    channel order) against the JAX package's batch_fold rule under
    jax.vmap, frame by frame."""
    lays = [layout("scene")[0],
            layout("scene", order=np.random.default_rng(3).permutation(64)
                   [::-1].copy())[0]]
    assert [lay.kernel for lay in lays] == ["A1", "A1"]
    kw = lays[0].occluder_kw
    got = find_occluders_folded([lay.occluder_args for lay in lays], **kw)
    args = [[np.asarray(a) for a in lay.occluder_args] for lay in lays]
    feats, w0b, rows, los, has = (
        np.stack([a[i] for a in args]) for i in range(5)
    )
    counts, data_t, wide_t = (jnp.asarray(a) for a in args[0][5:])
    run = make_pallas_occluder_phase(
        blk=kw["blk"], w_sl=kw["w_sl"], wide_cap=wide_t.shape[2],
        k_occ=kw["k_occ"], beam_rad=0.0, interpret=True, batch_fold=True,
    )
    ja, jo = jax.vmap(
        lambda f, w, r, lo, h: run(f, w, r, lo, counts, data_t, wide_t,
                                   has=h)
    )(*(jnp.asarray(a) for a in (
        feats.reshape(2, -1, kw["blk"], feats.shape[2]), w0b, rows, los, has,
    )))
    assert not np.array_equal(rows[0], rows[1])
    for f, (a12d, ovf) in enumerate(got):
        assert a12d.shape == (3 * kw["k_occ"], rows.shape[1] * kw["blk"])
        _assert_same_phase_a(a12d, ovf, ja[f], jo[f], kw["k_occ"])
        want = occluders_plain(*lays[f].occluder_args, **kw)
        assert torch.equal(a12d, want[0]) and torch.equal(ovf, want[1])


@pytest.mark.parametrize("pair", [False, True])
def test_c1_plain_matches_pallas(phase_a, pair):
    """C1's plain version against `_kernel`, and C2's (`pulse_peaks_pair`
    on CPU tensors: the same plain version) against `_kernel_pair`."""
    lay, calib, cfg, a12d, ovf = phase_a
    comp = ts.compact_occluded(lay, a12d, ovf, ts.calib_to_torch(calib, "cpu"),
                               cfg)
    kw = comp.pulse_kw
    run = make_pallas_pulse_phase(
        blk=64, k_occ=cfg.max_occluders, beam_rad=kw["beam_rad"],
        ipm=kw["ipm"], c_tau=kw["c_tau"], xsi_r1=kw["xsi_r1"],
        xsi_r2=kw["xsi_r2"], interpret=True, pair=pair,
    )
    assert (comp.cap // 64) % 2 == 0
    want = [np.asarray(a).reshape(-1) for a in run(
        *(jnp.asarray(np.asarray(a)) for a in comp.pulse_args)
    )]
    n0 = pulse_peaks_pair.launches
    peak, idx, touched, remainder = (
        a.numpy() for a in (
            pulse_peaks_pair(*comp.pulse_args, blk=64, **kw) if pair
            else pulse_plain(*comp.pulse_args, **kw))
    )
    assert pulse_peaks_pair.launches == n0
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


@pytest.mark.parametrize("kernel", ["A2", "A3", "A4a", "A4b"])
def test_cpu_tensors_take_the_plain_grouped_versions(kernel):
    """Likewise for A2, A3, A4a and A4b."""
    if kernel == "A2":
        lay = layout("scene", route_band=128, band_group=8)[0]
        run, plain = find_occluders_routed, occluders_routed_plain
    elif kernel == "A3":
        lay = layout("scene", slice_width=384, band_width=256,
                     band_group=8)[0]
        run, plain = find_occluders_banded, occluders_banded_plain
    elif kernel == "A4a":
        lay = layout("scene", pallas_transposed=True)[0]
        run, plain = find_occluders_t, occluders_ungated_plain
    else:
        lay = layout("scene", pallas_pair=True)[0]
        run, plain = find_occluders_pair, occluders_ungated_plain
    assert lay.kernel == kernel
    n0 = run.launches
    got = run(*lay.occluder_args, **lay.occluder_kw)
    assert run.launches == n0
    for a, b in zip(got, plain(*lay.occluder_args, **lay.occluder_kw)):
        assert torch.equal(a, b)


def test_a4b_and_c2_reject_odd_counts():
    """A4b needs an even chunk count and C2 an even pulse-block count; the
    layouts never hand them odd ones, and the wrappers raise."""
    lay = layout("scene", pallas_pair=True)[0]
    args = list(lay.occluder_args)
    args[1:4] = (a[:-1] for a in args[1:4])
    with pytest.raises(ValueError, match="even"):
        find_occluders_pair(*args, **lay.occluder_kw)
    k, cap = 4, 3 * 64
    z = torch.zeros
    with pytest.raises(ValueError, match="2 \\* blk"):
        pulse_peaks_pair(z(4, cap), z(k, cap), z(k, cap), z(k, cap),
                         z(k, cap), z(k + 1, cap), z(k + 1, cap), z(8),
                         z(8), blk=64, beam_rad=1.0, ipm=10.0, c_tau=3.0,
                         xsi_r1=0.9, xsi_r2=1.0)
