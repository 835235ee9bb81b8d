"""The port's measuring tools on the CPU: `tools/ab.py` against the JAX
package's harness (tests/test_ab.py's cases on fake arms), the chain
runner, `tools/datagen_bench.py` at 4 frames, `tools/dryrun_multichip`
at n = 2, and their refusal to run without a card unless the CPU is
asked for.

The A/B engine's numbers (median-of-reps endpoints, slope, spread,
interleaving order, the overflow gate) are compared exactly with the JAX
package's on the same fake clocks.
"""

import json
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.tools import ab as jab
from lidar_snow_sim_tpu_torch.tools import ab, datagen_bench, profile_bench
from lidar_snow_sim_tpu_torch.tools.dryrun_multichip import dryrun_multichip

SMOKE = runpy.run_path(str(Path(__file__).parents[1] / "chip_smoke.py"),
                       run_name="chip_smoke_gate")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPECS = {
    "snow": ["base", "batch16", "k12=max_occluders:12,batch:4",
             "s=assembly:window", "route256"],
    "dror": ["a=alpha:0.9,window:0", "windowed", "full"],
    "lisa": ["base", "k16", "x=Rr:2.5"],
    "detect": ["base", "f32", "b=batch:2"],
}


@pytest.mark.parametrize("model", sorted(SPECS))
def test_parse_variants_match_jax(model):
    got = ab.parse_variants(model, SPECS[model])
    assert got == jab.parse_variants(model, SPECS[model])
    assert ab.PREDEFINED[model] == jab.PREDEFINED[model]
    for name, ov in got.items():
        for v in ov.values():
            assert type(v) in (int, float, str)


def _fake_arms(module, calls):
    """test_ab.py's clock: arm A 10 ms a step with one congested rep, arm
    B 20 ms a step."""
    def make(name, step_s, outlier_rep=None):
        state = {"rep": 0}

        def run(n):
            calls.append((name, n))
            t = 1.0 + step_s * n
            if outlier_rep is not None and state["rep"] == outlier_rep:
                t += 5.0
            if n == 12:
                state["rep"] += 1
            return t, 0

        return module.Arm(run, batch=8)

    return {"A": make("A", 0.010, outlier_rep=2), "B": make("B", 0.020)}


def test_interleaved_ab_matches_jax():
    calls, jcalls = [], []
    out = ab.interleaved_ab(_fake_arms(ab, calls), short=2, long_=12,
                            reps=5, verbose=False)
    want = jab.interleaved_ab(_fake_arms(jab, jcalls), short=2, long_=12,
                              reps=5, verbose=False)
    assert out == want and calls == jcalls
    assert out["A"]["step_ms"] == pytest.approx(10.0, rel=1e-6)
    assert out["A"]["spread_ms"] == pytest.approx(500.0, rel=1e-6)
    rounds = [calls[4:][i:i + 4] for i in range(0, len(calls) - 4, 4)]
    for rnd in rounds:
        assert [c[0] for c in rnd] == ["A", "A", "B", "B"]
        assert [c[1] for c in rnd] == [2, 12, 2, 12]


def test_interleaved_ab_rejects_overflowing_arm():
    ok = ab.Arm(lambda n: (0.1 * n, 0), batch=4)
    bad = ab.Arm(lambda n: (0.1 * n, 3), batch=4)
    with pytest.raises(ValueError, match="overflowed"):
        ab.interleaved_ab({"ok": ok, "bad": bad}, reps=1, verbose=False)


def test_make_runner_computes_every_step():
    """A chain of n steps runs the step n times, each computing every one
    of its outputs (eager torch has no dead code to eliminate, so the port
    keeps no full_leaf_dep), and sums the overflow counts."""
    outputs = []

    def step():
        x = torch.arange(4.0)
        outputs.append((x * 2, x.sum(), torch.ones(2, dtype=torch.bool)))
        return torch.tensor(1, dtype=torch.int32)

    run = ab.make_runner(step, batch=4, device="cpu")
    seconds, ovf = run(3)
    assert seconds > 0 and ovf == 3 and len(outputs) == 3
    for doubled, total, flags in outputs:
        assert doubled.tolist() == [0.0, 2.0, 4.0, 6.0]
        assert float(total) == 6.0 and bool(flags.all())


@pytest.mark.parametrize("main,argv", [
    (ab.main, ["lisa", "base"]),
    (profile_bench.main, ["--model", "lisa"]),
    (datagen_bench.main, ["--frames", "1"]),
])
def test_tools_refuse_to_run_without_a_card(main, argv):
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv)


def test_profile_bench_reads_the_trace_on_the_spans_clock(tmp_path):
    """profile_bench's device records: the Chrome trace's kernels, copies
    and memsets at baseTimeNanoseconds + 1000 ts, in ns; its span table:
    self ms, calls and host syncs a step, by self time."""
    from lidar_snow_sim_tpu_torch.utils.profiling import Span

    base = 1_790_000_000_000_000_000
    events = [
        {"ph": "X", "cat": "kernel", "name": "w1_kernel", "ts": 10.5,
         "dur": 2.25},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 20,
         "dur": 1},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 9, "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 40},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": base,
                                "traceEvents": events}))
    assert profile_bench.device_records(path) == [
        (base + 10_500, base + 12_750), (base + 20_000, base + 21_000),
        (base + 30_000, base + 30_000)]
    spans = [Span(0, "root", 0, None, None, 0, 10_000_000, 1, 6_000_000),
             Span(1, "leaf", 0, 0, 0, 1_000_000, 4_000_000, 2, 0),
             Span(2, "leaf", 0, 0, 1, 5_000_000, 8_000_000, 3, 0)]
    assert profile_bench.span_table(spans, steps=2) == [
        ("root", 2.0, 0.5, 0.5), ("leaf", 3.0, 1.0, 2.5)][::-1]


def _small_sets(cache_dir, rate_mm_h=2.5, velocity=1.6, seed=42):
    """A light stand-in for the bench bank (64 sets of 150 flakes)."""
    from lidar_snow_sim_tpu_torch import (
        compute_occupancy,
        snowfall_rate_to_rainfall_rate,
    )

    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(64):
        ang = rng.uniform(0, 2 * np.pi, 150)
        d = np.sqrt(rng.uniform(0.01, 1, 150)) * 60
        sets.append(np.column_stack([d * np.cos(ang), d * np.sin(ang),
                                     rng.uniform(0.005, 0.05, 150)]))
    return (sets, snowfall_rate_to_rainfall_rate(rate_mm_h, velocity),
            compute_occupancy(rate_mm_h, velocity))


def test_datagen_bench_on_the_cpu(tmp_path, monkeypatch, capsys):
    """4 frames at batch 2 through the precompute CLI (60-azimuth scans and
    a light bank in place of the bench's, for the CPU's sake): every key
    of the JAX tool's report (chip_smoke's phase-16 gate), 4 frames done,
    the steady rates those of the manifest, a resume pass that skips
    all."""
    import lidar_snow_sim_tpu_torch
    from lidar_snow_sim_tpu_torch.tools import kernel_times

    scan = lidar_snow_sim_tpu_torch.synthetic_scan
    monkeypatch.setattr(kernel_times, "bank_sets", _small_sets)
    monkeypatch.setattr(lidar_snow_sim_tpu_torch, "synthetic_scan",
                        lambda n_azimuth, **kw: scan(n_azimuth=60, **kw))
    assert datagen_bench.main([
        "--frames", "4", "--batch", "2", "--max-points", "4096",
        "--device", "cpu",
        "--root", str(tmp_path), "--out", str(tmp_path / "r.json")]) == 0
    report = SMOKE["_last_json"](capsys.readouterr().out)
    assert SMOKE["_datagen_bench_gate"](report, 4) == []
    assert report["backend"] == "cpu" and report["tunnel"]["put_mb_s"] is None
    stats = report["manifest_stats"]
    assert stats["frames_done"] == 4 and stats["frames_failed"] == 0
    assert report["steady_frames"] == sum(
        b["frames"] for b in stats["batches"] if not b["compiles"])
    assert report["resume_walk_s"] > 0
    assert (tmp_path / "r.json").exists()


def test_dryrun_multichip_on_two_cpu_shards():
    lines = dryrun_multichip(2, ["cpu", "cpu"])
    assert len(lines) == 4 and all(ln.startswith("dryrun_multichip ok")
                                   for ln in lines)
    assert "mesh=(data=2, beam=1)" in lines[0]
    assert "mesh=(data=1, beam=2)" in lines[1]
    assert "data-parallel over 2 ranks" in lines[2]
    assert "detect" in lines[3] and "LISA" in lines[3]
