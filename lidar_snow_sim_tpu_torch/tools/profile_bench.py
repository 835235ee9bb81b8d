"""Per-op device time of a bench-shaped step under torch.profiler
(counterpart of `lidar_snow_sim_tpu/tools/profile_bench.py`).

    python -m lidar_snow_sim_tpu_torch.tools.profile_bench [--model snow]
        [--batch 8] [--iters 3] [--top 25] [--chain 0] [--trace-dir DIR]

The step is the `tools/ab.py` arm of the model (`base` variant) at
`--batch` frames: snow (`batched_step` on the bench scene, kernels A1 and
C1), lisa (LISA's core, kernel L1), dror (the windowed search) or
detector (PointPillars `detect`, bfloat16). It runs 3 times to warm up,
then `--iters` times under torch.profiler (`tools/profile_weather.
profile_case`); with `--chain N` each of those runs is N steps back to
back and the times are divided by N. Printed: the card's name and power
limit, the host wall and device time per step, then the `--top` device
ops by time (ms per step, calls per step, name) and, whatever their rank,
the port's own CUDA kernels among them. `--trace-dir` keeps the session's
Chrome trace (the JAX tool's `--dump-hlo` has no counterpart: there is no
compiled program to dump). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

# the port's hand-written kernels, by the names the profiler records
PORT_KERNELS = ("a1_kernel", "a2_kernel", "a3_kernel", "a4a_kernel",
                "a4b_kernel", "c1_kernel", "c2_kernel", "l1_kernel")
MODELS = {"snow": "snow", "lisa": "lisa", "dror": "dror",
          "detector": "detect"}
BASE_VARIANT = {"snow": "base", "lisa": "base", "dror": "windowed",
                "detect": "base"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="snow", choices=sorted(MODELS))
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

    device = resolve_device("cuda")
    print(card_line(), flush=True)
    model = MODELS[args.model]
    name = BASE_VARIANT[model]
    variant = dict(ab.parse_variants(model, [name])[name],
                   batch=args.batch)
    arm = ab.BUILDERS[model]({name: variant}, device)[name]
    chain = max(args.chain, 1)
    res = profile_case(lambda: arm.run(chain), args.iters, top=args.top,
                       trace_dir=args.trace_dir)
    print(f"model {args.model} batch {args.batch} steps "
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
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
