"""The window assembly's live mask and shared feature rows on the CPU.

Kernels W1 and W2 take the scan's mask as a live mask since their
redesign: a row outside it gets the empty outputs (W1: a1 = a2 = 0, dist =
inf, valid false, overflow 0; W2: peak 0, bin 0, touched false, bump
overflow 0), and both read the feature rows that `window_inputs` makes
once. Here their plain versions (`ops/occluders.occluders_window_plain`,
`ops/pulse.window_pulse_plain`), which the kernels equal on the card
(tests/test_torch_window_cuda.py), are held:
- with a live mask against themselves without one: the live rows equal,
  byte for byte, the dead rows empty;
- on the live rows against the JAX package's `_occluder_phase` and
  `_pulse_phase` (with the decision tail), for the scan's mask (padding
  last) and for an all-live mask, at the tolerances of
  tests/test_torch_window_kernels.py;
- with the feature rows `window_inputs` made against rows made afresh;
- through `window_augment`: the live rows of the planes, keep and every
  counter equal to the same scan with the gate off.
Also the scripts that time W1 and W2: the A/B's calls of both C signatures
and the sweep's source variants.
"""

import ctypes
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.config import SnowfallConfig as JaxSnowfallConfig
from lidar_snow_sim_tpu.models import snowfall as jsnow
from lidar_snow_sim_tpu_torch import _kernels, load_hdl64_calib, pad_cloud
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops import occluders as tocc
from lidar_snow_sim_tpu_torch.ops import pulse as tpulse
from scripts import kernel_ab, window_sweep
from test_torch_snowfall import PLANE
from test_torch_window import _close_angles
from test_torch_window_cuda import _same
from test_torch_window_kernels import _inputs, _jax_occluders, _scene

W1_NAMES = ("a1", "a2", "dist", "valid", "overflow")
W2_NAMES = ("peak", "bin", "touched", "bump_overflow")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(inp, bank_t, cfg, live):
    """The plain W1 and W2 (on W1's rows) with live mask `live`."""
    args, kw = ts.window_occluder_call(inp, bank_t, cfg)
    occ = tocc.occluders_window_plain(*args, **dict(kw, live=live))
    pargs, pkw = ts.window_pulse_call(inp, occ, cfg)
    return occ, tpulse.window_pulse_plain(*pargs, **dict(pkw, live=live))


@pytest.mark.parametrize("starved", [False, True])
@pytest.mark.parametrize("scene", ["seam", "dense"])
def test_live_rows_equal_the_ungated_and_dead_rows_are_empty(scene,
                                                             starved):
    cfg, _, bank_t, inp = _inputs(scene, starved)
    mask = inp.mask
    assert 0 < int(mask.sum()) < mask.numel()
    occ, peaks = _plain(inp, bank_t, cfg, mask)
    occ_u, peaks_u = _plain(inp, bank_t, cfg, None)
    for name, g, u in zip(W1_NAMES + W2_NAMES, (*occ, *peaks),
                          (*occ_u, *peaks_u)):
        assert _same(g[mask], u[mask]), name
    dead = ~mask
    assert not occ[0][dead].any() and not occ[1][dead].any()
    assert torch.isinf(occ[2][dead]).all() and not occ[3][dead].any()
    assert not occ[4][dead].any()
    for v in peaks:
        assert not v[dead].any()


@pytest.mark.parametrize("all_live", [False, True])
@pytest.mark.parametrize("starved", [False, True])
def test_gated_plain_versions_match_jax_on_the_live_rows(all_live,
                                                         starved):
    """The plain W1 and W2 with the scan's mask (padding last) or an
    all-live mask as live mask, against the JAX `_occluder_phase` and
    `_pulse_phase` on the live rows."""
    cfg, bank, bank_t, inp = _inputs("dense", starved)
    live = torch.ones_like(inp.mask) if all_live else inp.mask
    rows = live.numpy()
    occ, (peak, idx, touched, bump_of) = _plain(inp, bank_t, cfg, live)
    want = _jax_occluders(bank, inp, cfg)
    got = [v.numpy()[rows] for v in occ]
    w = [v[rows] for v in want]
    np.testing.assert_array_equal(got[3], w[3])
    np.testing.assert_array_equal(got[2], w[2])
    np.testing.assert_array_equal(got[4], w[4])
    for g, v in zip(got[:2], w[:2]):
        _close_angles(g[w[3]], v[w[3]])
    jcfg = JaxSnowfallConfig(**dataclasses.asdict(cfg))
    jp = [np.asarray(v) for v in jax.jit(
        jsnow._pulse_phase, static_argnames=("cfg",))(
        *(jnp.asarray(t.numpy()) for t in (inp.xyz, inp.intensity,
                                           inp.mask)),
        *(jnp.asarray(v) for v in want[:4]),
        *(jnp.asarray(t.numpy()) for t in (inp.min_int, inp.max_int,
                                           inp.focal_slope,
                                           inp.focal_offset)),
        jnp.asarray(cfg.range_grid()), cfg=jcfg)]
    # W2 on the JAX occluders, as the JAX phase takes them
    pargs, pkw = ts.window_pulse_call(
        inp, [torch.tensor(v) for v in want[:4]], cfg)
    peak, idx, touched, bump_of = tpulse.window_pulse_plain(
        *pargs, **dict(pkw, live=live))
    new_xyz, new_int, label, _ = ts._pulse_tail(
        inp.xyz, inp.intensity, inp.mask, peak, idx, touched, inp.min_int,
        inp.max_int, inp.focal_slope, inp.focal_offset, cfg)
    np.testing.assert_array_equal(label.numpy()[rows], jp[2][rows])
    np.testing.assert_array_equal(new_int.numpy()[rows], jp[1][rows])
    np.testing.assert_allclose(new_xyz.numpy()[rows], jp[0][rows],
                               rtol=1e-6, atol=1e-6)
    assert int(torch.where(inp.mask, bump_of, 0).sum()) == int(jp[4])
    assert (int(jp[4]) > 0) == starved


def test_call_builders_hand_in_the_shared_rows_and_the_mask():
    """W1's and W2's calls read the feature rows `window_inputs` made once
    (feature 8, the window's centre, is the JAX assembly's atan2(y, x))
    with the scan's mask as live mask; W1 and W2 on them equal the same
    calls on rows made afresh from the sorted points."""
    cfg, _, bank_t, inp = _inputs("dense", starved=True)
    assert torch.equal(inp.feats[:, 8], torch.atan2(inp.xyz[:, 1],
                                                    inp.xyz[:, 0]))
    args, kw = ts.window_occluder_call(inp, bank_t, cfg)
    assert (args[0].data_ptr(), kw["live"].data_ptr()) == (
        inp.feats.data_ptr(), inp.mask.data_ptr())
    occ = tocc.find_occluders_window(*args, **kw)
    own = tocc.point_features(inp.xyz[:, 0], inp.xyz[:, 1], inp.xyz[:, 2],
                              cfg.beam_divergence_rad)
    for name, a, b in zip(W1_NAMES, occ, tocc.find_occluders_window(
            own, *args[1:], **kw)):
        assert torch.equal(a, b), name
    pargs, pkw = ts.window_pulse_call(inp, occ, cfg)
    assert (pargs[0].data_ptr(), pkw["live"].data_ptr()) == (
        inp.feats.data_ptr(), inp.mask.data_ptr())
    for name, a, b in zip(W2_NAMES, tpulse.window_pulse_peaks(*pargs, **pkw),
                          tpulse.window_pulse_peaks(own, *pargs[1:], **pkw)):
        assert _same(a, b), name


def test_window_augment_gated_equals_ungated_on_live_rows(monkeypatch):
    """window_augment (the plain path on the CPU) passes the scan's mask as
    the live mask; the live rows of its planes, keep and every counter
    equal the same scan with the gate off."""
    pc, _, cfg, bank = _scene("dense")
    cfg = dataclasses.replace(cfg, max_occluders=2, max_bumps=1)
    padded = pad_cloud(pc, cfg.max_points)
    args = (torch.as_tensor(padded.points), torch.as_tensor(padded.mask),
            ts.bank_to_torch(bank, "cpu"),
            ts.calib_to_torch(load_hdl64_calib(), "cpu"),
            torch.as_tensor(np.random.default_rng(3).permutation(64)), None,
            cfg)
    plane = (torch.tensor(PLANE[0], dtype=torch.float32),
             torch.tensor(PLANE[1], dtype=torch.float32))
    gated = ts.window_augment(*args, plane=plane)
    for name in ("window_occluder_call", "window_pulse_call"):
        call = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda *a, call=call: (
            lambda c: (c[0], dict(c[1], live=None)))(call(*a)))
    ungated = ts.window_augment(*args, plane=plane)
    n = len(pc)
    assert torch.equal(gated.planes[:, :n], ungated.planes[:, :n])
    assert torch.equal(gated.keep, ungated.keep)
    for name in ts.SnowfallResult._fields[2:]:
        assert torch.equal(getattr(gated, name), getattr(ungated, name)), \
            name
    assert int(gated.occluder_overflow) > 0 and int(gated.bump_overflow) > 0


def test_cos_positive_rule_matches_cos_on_a_sample():
    """Kernel W1's half-plane rule (csrc/occluders.cu cos_positive: |x|
    below the first float32 above pi/2 or above the last below 3 pi/2)
    against cos(x) > 0 in float64 and torch.cos on float32 x in [-7, 7];
    chip_smoke.py holds it against the card's torch.cos on every float."""
    src = (_kernels.CSRC / "occluders.cu").read_text()
    assert "0x3fc90fdb" in src and "0x4096cbe3" in src
    lo, hi = (np.frombuffer(np.uint32(b).tobytes(), np.float32)[0]
              for b in (0x3FC90FDB, 0x4096CBE3))
    below = float(np.nextafter(lo, np.float32(0)))
    above = float(np.nextafter(hi, np.float32(9)))
    assert below < np.pi / 2 < float(lo)
    assert float(hi) < 3 * np.pi / 2 < above
    bits = np.arange(0, 0x40E00000, 997, dtype=np.uint32)
    x = bits.view(np.float32)
    x = np.concatenate([x, -x, [lo, hi, np.float32(np.pi / 2)]])
    rule = (np.abs(x) < lo) | (np.abs(x) > hi)
    np.testing.assert_array_equal(rule, np.cos(x.astype(np.float64)) > 0)
    np.testing.assert_array_equal(rule, (torch.cos(torch.as_tensor(x)) > 0
                                         ).numpy())


@pytest.mark.parametrize("with_live", [True, False])
def test_kernel_ab_window_calls_fit_each_signature(monkeypatch, with_live):
    """kernel_ab's W1 and W2 calls hand a checkout's entries as many
    arguments as its C signature takes (this tree's, or the earlier one
    without a live mask), with the point count where it belongs."""
    cfg, _, bank_t, inp = _inputs("fov")
    seen = {}
    lib = types.SimpleNamespace(
        occluders_w1=lambda *a: seen.__setitem__("w1", a) or 0,
        pulse_w2=lambda *a: seen.__setitem__("w2", a) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    n = 100
    outs = kernel_ab.w1_call(lib, with_live, inp, bank_t, cfg, n=n)()
    occ = [torch.zeros((n, cfg.max_occluders)) for _ in range(3)] + [
        torch.zeros((n, cfg.max_occluders), dtype=torch.bool)]
    kernel_ab.w2_call(lib, with_live, inp, occ, cfg, n=n)()
    new = _kernels.SIGNATURES
    sigs = {"w1": new["occluders"]["occluders_w1"],
            "w2": new["pulse"]["pulse_w2"]} if with_live else {
        "w1": kernel_ab.W1_W2_BEFORE_LIVE["occluders_w1"],
        "w2": kernel_ab.W1_W2_BEFORE_LIVE["pulse_w2"]}
    for key, sig in sigs.items():
        a = seen[key]
        assert len(a) == len(sig)
        n_ptr = sig.index(ctypes.c_int)   # the arrays, then n
        assert a[n_ptr] == n
    assert seen["w1"][8] == outs[0].data_ptr()
    assert seen["w1"][3] == (inp.mask.data_ptr() if with_live
                             else seen["w1"][3])


def test_kernel_ab_live_api_reads_each_checkout(tmp_path):
    assert kernel_ab.live_api(_kernels.CSRC.parents[1])
    csrc = tmp_path / "lidar_snow_sim_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "pulse.cu").write_text("extern \"C\" int pulse_w2();\n")
    assert not kernel_ab.live_api(tmp_path)


@pytest.mark.parametrize("i", range(len(window_sweep.VARIANTS)))
def test_window_sweep_variant_sets_each_constant(i):
    variant = window_sweep.VARIANTS[i]
    for name in set(window_sweep.FILES.values()):
        src = window_sweep.variant_source(name, variant)
        for const, v in variant.items():
            if window_sweep.FILES[const] == name:
                assert f"constexpr int k{const} = {v};" in src


def test_window_sweep_knows_w1_shared_memory_assert():
    """window_sweep skips a variant by the message of W1's static_assert
    on its shared memory, which the committed constants pass."""
    src = (_kernels.CSRC / "occluders.cu").read_text()
    assert f'"kernel W1 {window_sweep.SMEM_ASSERT}"' in src
