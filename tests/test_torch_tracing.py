"""The port's tracer (`utils/profiling`): spans recorded only while a torch.profiler session runs, at the snowfall path's layer
boundaries, on the Chrome trace's clock.

On the CPU: nothing is recorded and the CUDA sync debug mode is never
touched without a session; the window augmenter's and the dense packed
step's spans nest as the layers do, share a request id and carry their
frame; self times lie within their spans; each span's record_function
event lies on the span's own clock; a session's buffer holds that session
alone; each growth rerun logs one warning; the idle time between device records is
put down to the innermost span. The last test needs an NVIDIA GPU and nvcc
and skips elsewhere; it imports no jax:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_tracing.py
"""

import json
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidar_snow_sim_tpu_torch import (
    SnowfallConfig,
    build_bank,
    load_hdl64_calib,
    synthetic_scan,
)
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.parallel.batched import datagen_packed_step
from lidar_snow_sim_tpu_torch.utils.profiling import (
    Span,
    idle_by_span,
    recorded,
    self_ns,
    span,
)

torch.set_num_threads(1)

WINDOW_SPANS = ("augmenter.call", "augmenter.pad", "snowfall.window_inputs",
                "snowfall.plane_noise", "snowfall.window_kernels",
                "snowfall.tail", "augmenter.growth_check",
                "augmenter.compact")
DENSE_FRAME_SPANS = ("snowfall.layout", "snowfall.plane_noise",
                     "snowfall.phase_a", "snowfall.compact",
                     "snowfall.phase_c", "snowfall.scatter")
SMALL = dict(max_points=4096, point_chunk=2048, channel_capacity=128,
             block_points=32, slice_width=384)


def _bank(window_size=128):
    rng = np.random.default_rng(5)
    sets = []
    for _ in range(64):
        ang = rng.uniform(-np.pi, np.pi, 300)
        d = np.sqrt(rng.uniform(0.01, 1, 300)) * 20
        r = rng.uniform(0.005, 0.05, 300)
        sets.append(np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))
    return build_bank(sets, window_size=window_size, wide_capacity=64)


@pytest.fixture(scope="module")
def scene():
    calib = load_hdl64_calib()
    return calib, synthetic_scan(n_azimuth=50, seed=3, calib=calib), _bank()


def _session(fn):
    """fn() under a CPU torch.profiler session: (its result, the
    recorded spans, the session)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, recorded(), prof


@pytest.fixture(scope="module")
def window_call(scene, tmp_path_factory):
    """One window augmenter call under a session: its spans and the
    session's Chrome trace."""
    calib, pc, bank = scene
    aug = ts.SnowfallAugmenter(bank, calib, SnowfallConfig(**SMALL),
                               device="cpu")
    order = np.random.default_rng(0).permutation(64)
    aug(pc, order=order)                      # warm
    _session(lambda: aug(pc, order=order))    # warm record_function
    _, rec, prof = _session(lambda: aug(pc, order=order))
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    return rec, json.loads(path.read_text())


def _by_name(rec):
    out = {}
    for s in rec:
        out.setdefault(s.name, []).append(s)
    return out


def _inside(child: Span, parent: Span):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_without_a_session_nothing_is_recorded(scene, monkeypatch):
    """No session: span is the one shared no-op, an augmenter call
    records nothing, and the sync debug mode is never
    read or set."""
    touched = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda *a: touched.append(a))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda *a: touched.append(a))
    calib, pc, bank = scene
    before = recorded()
    assert span("a") is span("b", frame=1)
    with span("a"):
        pass
    ts.SnowfallAugmenter(bank, calib, SnowfallConfig(**SMALL),
                         device="cpu")(pc, shuffle=False)
    assert recorded() == before
    assert touched == []


def test_window_augmenter_spans_nest_under_one_request(window_call):
    rec, _ = window_call
    spans = _by_name(rec)
    assert sorted(spans) == sorted(WINDOW_SPANS)
    assert all(len(v) == 1 for v in spans.values())
    by_id = {s.id: s for s in rec}
    root = spans["augmenter.call"][0]
    assert root.parent is None
    assert {s.request for s in rec} == {root.request}
    for s in rec:
        if s is not root:
            assert _inside(s, by_id[s.parent]), s.name
    assert by_id[spans["snowfall.window_inputs"][0].parent] is root
    assert (spans["snowfall.plane_noise"][0].parent
            == spans["snowfall.window_inputs"][0].id)
    assert all(s.frame is None for s in rec)
    assert all(s.host_syncs == 0 for s in rec)   # no card here


def test_self_times_lie_within_their_spans(window_call):
    """0 <= self <= duration; the self times of a request's spans add up
    to its root's duration (the layers are disjoint)."""
    rec, _ = window_call
    for s in rec:
        assert 0 <= self_ns(s) <= s.end_ns - s.start_ns
    root = _by_name(rec)["augmenter.call"][0]
    assert sum(self_ns(s) for s in rec) == root.end_ns - root.start_ns


def test_spans_sit_on_the_chrome_traces_clock(window_call):
    """Each span's record_function event, at ts + baseTimeNanoseconds /
    1000, lies within 100 us of the span's own time.time_ns() bounds."""
    rec, trace = window_call
    base_us = trace["baseTimeNanoseconds"] / 1000
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    for s in rec:
        ev = events[s.name]
        start = ev["ts"] + base_us
        assert abs(start - s.start_ns / 1000) < 100, s.name
        assert abs(start + ev["dur"] - s.end_ns / 1000) < 100, s.name


def _packed_inputs(calib, pc, frames=2):
    n = SMALL["max_points"]
    pts = np.zeros((frames, n, 4), np.float32)
    chan = np.zeros((frames, n), np.uint8)
    meta = np.zeros((frames, 3 + 64), np.int32)
    for b in range(frames):
        pts[b, :len(pc)] = pc[:, :4]
        chan[b, :len(pc)] = pc[:, 4].astype(np.uint8)
        meta[b, 0] = len(pc)
        meta[b, 2] = 11 + b
        meta[b, 3:] = np.random.default_rng(b).permutation(64)
    return (torch.from_numpy(pts), torch.from_numpy(chan),
            torch.from_numpy(meta))


@pytest.mark.parametrize("batch_fold", [False, True])
def test_dense_packed_step_spans_each_frame(scene, batch_fold):
    """A dense datagen_packed_step of 2 frames: each snowfall.* span once
    a frame, frames 0 and 1, under batched.core, itself under the root
    batched.step beside batched.draws and batched.pack_out; folded, phase
    A is one span with no frame."""
    calib, pc, bank = scene
    cfg = SnowfallConfig(**SMALL, assembly="dense", batch_fold=batch_fold)
    args = (*_packed_inputs(calib, pc), ts.bank_to_torch(bank, "cpu"),
            ts.calib_to_torch(calib, "cpu"), cfg)
    datagen_packed_step(*args)                       # warm
    _, rec, _ = _session(lambda: datagen_packed_step(*args))
    spans = _by_name(rec)
    by_id = {s.id: s for s in rec}
    (root,) = spans["batched.step"]
    (core,) = spans["batched.core"]
    assert root.parent is None and core.parent == root.id
    for name in ("batched.draws", "batched.pack_out"):
        assert [s.parent for s in spans[name]] == [root.id]
    assert {s.request for s in rec} == {root.request}
    for name in DENSE_FRAME_SPANS:
        if name == "snowfall.phase_a" and batch_fold:
            (pa,) = spans[name]
            assert pa.frame is None and pa.parent == core.id
            continue
        assert sorted(s.frame for s in spans[name]) == [0, 1], name
    for s in rec:
        if s.parent is not None:
            assert _inside(s, by_id[s.parent]), s.name
        if s.name in ("snowfall.layout", "snowfall.compact",
                      "snowfall.phase_c", "snowfall.scatter"):
            assert s.parent == core.id


def test_a_session_holds_its_own_spans_alone():
    """The buffer is cleared as a session starts: a session with no span
    reads empty after one with spans."""
    def two_spans():
        with span("outer"):
            with span("inner", frame=2):
                pass

    _, rec, _ = _session(two_spans)
    assert [(s.name, s.frame) for s in rec] == [("outer", None),
                                                ("inner", 2)]
    _, rec, _ = _session(lambda: None)
    assert rec == []


def test_a_torch_without_the_session_hook_fails_the_import(monkeypatch):
    """Without torch's session-start hook the buffer could not be cleared
    between sessions: the tracer's import raises instead."""
    from lidar_snow_sim_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling._autograd_profiler,
                        "_run_on_profiler_start")
    with pytest.raises(ImportError, match="_run_on_profiler_start"):
        profiling._chain_session_start()


def test_growth_reruns_are_counted_and_logged_once_each(scene, caplog):
    """Too small a channel capacity grows and reruns: each rerun runs
    the growth check once more and logs one warning."""
    calib, pc, bank = scene
    cfg = SnowfallConfig(**dict(SMALL, channel_capacity=32), assembly="dense")
    aug = ts.SnowfallAugmenter(bank, calib, cfg, device="cpu")
    with caplog.at_level(logging.WARNING, logger=ts.logger.name):
        _, rec, _ = _session(lambda: aug(pc, shuffle=False))
    reruns = len(_by_name(rec)["augmenter.growth_check"]) - 1
    assert reruns >= 1
    assert aug.cfg.channel_capacity == 32 * 2 ** reruns
    grew = [r for r in caplog.records if "capacities grew" in r.message]
    assert len(grew) == reruns


def _span(i, name, start, end, parent=None):
    return Span(i, name, 0, parent, None, start, end, 0, 0)


def test_idle_time_goes_to_the_innermost_open_span():
    spans = [_span(0, "root", 0, 100), _span(1, "a", 10, 40, 0),
             _span(2, "b", 50, 90, 0), _span(3, "b.inner", 60, 70, 2)]
    # busy 0-20, 30-55, 65-80, 75-120; idle 20-30 (a), 55-65 (b, then
    # b.inner from 60), 80 is covered by the next record
    busy = [(0, 20), (30, 55), (65, 80), (75, 120)]
    assert idle_by_span(busy, spans) == {"a": 10, "b": 5, "b.inner": 5}
    # one long gap: each span's innermost stretches, and past the last
    # span nobody's
    assert idle_by_span([(0, 10), (130, 140)], spans) == {
        "a": 30, "root": 20, "b": 30, "b.inner": 10, "(no span)": 30}
    assert idle_by_span([], spans) == {}


@pytest.mark.cuda
def test_card_syncs_and_the_shared_clock(scene, tmp_path):
    """On the card: a nonzero inside a span counts one host sync there;
    on one window augmenter call under a CPU+CUDA session, W1's launch
    lies inside snowfall.window_kernels and its device record starts after
    that span starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    x = torch.arange(16, device="cuda") % 3
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()

    def one_nonzero():
        with span("syncs"):
            with span("one"):
                x.nonzero()

    _, rec, _ = _session(one_nonzero)
    assert {s.name: s.host_syncs for s in rec} == {"syncs": 0,
                                                         "one": 1}
    assert torch.cuda.get_sync_debug_mode() == mode

    calib, pc, bank = scene
    aug = ts.SnowfallAugmenter(bank, calib, SnowfallConfig(**SMALL),
                               device="cuda")
    aug(pc, shuffle=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        aug(pc, shuffle=False)
        torch.cuda.synchronize()
    rec = recorded()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1000
    (win,) = [s for s in rec if s.name == "snowfall.window_kernels"]
    assert sum(s.host_syncs for s in rec) > 0
    events = trace["traceEvents"]
    (w1,) = [e for e in events
             if e.get("cat") == "kernel" and "w1_kernel" in e["name"]]
    corr = w1["args"]["correlation"]
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") == corr]
    assert launches, "no launch event of W1"
    for e in launches:
        assert win.start_ns / 1000 <= e["ts"] + base_us
        assert e["ts"] + e["dur"] + base_us <= win.end_ns / 1000
    assert w1["ts"] + base_us >= win.start_ns / 1000
