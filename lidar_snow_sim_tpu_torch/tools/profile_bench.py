"""Per-op device time of a bench-shaped step under torch.profiler
(counterpart of `lidar_snow_sim_tpu/tools/profile_bench.py`).

    python -m lidar_snow_sim_tpu_torch.tools.profile_bench [--model snow]
        [--variant SPEC] [--batch 8] [--iters 3] [--top 25] [--chain 0]
        [--trace-dir DIR]

The step is the `tools/ab.py` arm of the model at `--batch` frames, its
`base` variant or `--variant` in ab's syntax (`win=assembly:window` runs
snow on the window assembly): snow (`batched_step` on the bench scene,
kernels A1 and C1), lisa (LISA's core, kernel L1), dror (the windowed
search) or detector (PointPillars `detect`, bfloat16). It runs 3 times to
warm up, then `--iters` times under torch.profiler (`tools/profile_weather.
profile_case`); with `--chain N` each of those runs is N steps back to
back and the times are divided by N. Printed: the card's name and power
limit, the host wall and device time per step, then the `--top` device
ops by time (ms per step, calls per step, name) and, whatever their rank,
the port's own CUDA kernels among them; then the program's spans
(`utils/profiling`: self ms, calls and host syncs a step, by name) and the
card's idle time a step put down to the innermost span open at each moment
of each gap between device records (the Chrome trace's records and
`baseTimeNanoseconds`, on the spans' clock). `--trace-dir` keeps the
session's Chrome trace (the JAX tool's `--dump-hlo` has no counterpart:
there is no compiled program to dump). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

# the port's hand-written kernels, by the names the profiler records
PORT_KERNELS = ("a1_kernel", "a2_kernel", "a3_kernel", "a4a_kernel",
                "a4b_kernel", "c1_kernel", "c2_kernel", "l1_kernel")
MODELS = {"snow": "snow", "lisa": "lisa", "dror": "dror",
          "detector": "detect"}
BASE_VARIANT = {"snow": "base", "lisa": "base", "dror": "windowed",
                "detect": "base"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_records(trace_path) -> list:
    """[(start, end)] ns of the Chrome trace's kernels, copies and memsets
    on `time.time_ns()`'s clock (`ts` is us after `baseTimeNanoseconds`)."""
    trace = json.loads(Path(trace_path).read_text())
    base = int(trace["baseTimeNanoseconds"])
    return [(base + round(1000 * float(e["ts"])),
             base + round(1000 * (float(e["ts"]) + float(e.get("dur", 0)))))
            for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def span_table(spans, steps: int) -> list:
    """[(name, self ms, calls, host syncs)] a step, by self time."""
    from lidar_snow_sim_tpu_torch.utils.profiling import self_ns

    tot = defaultdict(lambda: [0, 0, 0])
    for s in spans:
        row = tot[s.name]
        row[0] += self_ns(s)
        row[1] += 1
        row[2] += s.host_syncs
    return sorted(((n, ns / 1e6 / steps, c / steps, h / steps)
                   for n, (ns, c, h) in tot.items()), key=lambda r: -r[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="snow", choices=sorted(MODELS))
    ap.add_argument("--variant", default=None,
                    help="a variant in tools/ab.py's syntax (default: the "
                         "model's base variant)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--chain", type=int, default=0,
                    help="steps back to back in each profiled run")
    ap.add_argument("--trace-dir", default=None,
                    help="write the session's Chrome trace here")
    args = ap.parse_args(argv)

    import torch

    from lidar_snow_sim_tpu_torch.device import resolve_device
    from lidar_snow_sim_tpu_torch.tools import ab
    from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line
    from lidar_snow_sim_tpu_torch.tools.profile_weather import profile_case
    from lidar_snow_sim_tpu_torch.utils.profiling import (
        idle_by_span,
        recorded,
    )

    device = resolve_device("cuda")
    print(card_line(), flush=True)
    model = MODELS[args.model]
    spec = args.variant or BASE_VARIANT[model]
    ((name, variant),) = ab.parse_variants(model, [spec]).items()
    variant = dict(variant, batch=args.batch)
    arm = ab.BUILDERS[model]({name: variant}, device)[name]
    chain = max(args.chain, 1)
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        res = profile_case(lambda: arm.run(chain), args.iters, top=args.top,
                           trace_dir=trace_dir)
        trace_path = max(Path(trace_dir).glob("trace_*.json"),
                         key=lambda p: p.stat().st_mtime)
        busy = device_records(trace_path)
    spans = recorded()
    steps = args.iters * chain
    print(f"model {args.model} variant {name} batch {args.batch} steps "
          f"{args.iters * chain} traced: wall "
          f"{res['wall_ms_per_rep'] / chain:.4f} ms a step, device "
          f"{res['device_ms_per_rep'] / chain:.4f} ms a step, busy share "
          f"{res['busy_share']:.4f}"
          + (f"; trace in {args.trace_dir}" if args.trace_dir else ""),
          flush=True)
    print("device ops (ms a step, calls a step, name):", flush=True)
    for op, ms, calls in res["top"]:
        print(f"{ms / chain:9.4f} ms x{calls / chain:<7.1f} {op}",
              flush=True)
    print("port kernels:", flush=True)
    for op, (ms, calls) in res["ops"].items():
        if any(k in op for k in PORT_KERNELS):
            print(f"{ms / chain:9.4f} ms x{calls / chain:<7.1f} {op[:70]}",
                  flush=True)
    print("spans (self ms a step, calls a step, host syncs a step, name):",
          flush=True)
    for span_name, ms, calls, syncs in span_table(spans, steps):
        print(f"{ms:9.4f} ms x{calls:<7.1f} syncs {syncs:<7.1f} {span_name}",
              flush=True)
    idle = idle_by_span(busy, spans)
    print(f"card idle by innermost span (ms a step; "
          f"{sum(idle.values()) / 1e6 / steps:.4f} ms idle a step between "
          f"the first and the last device record):", flush=True)
    for span_name, ns in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"{ns / 1e6 / steps:9.4f} ms {span_name}", flush=True)
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
