"""The benchmark of the PyTorch and CUDA port (`lidar_snow_sim_tpu_torch`).

    python3 -m port_bench.run --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout. Runs one cell of BENCHMARK.json on the
card (`port_bench/harness.py`) and prints its result as the last line of
standard output: one JSON object with "correct", "attempted", "failed",
"metrics", "device", with --trace 1 "breakdown", and last "compared", the
numbers the comparison held against their limits, which also end
standard error. Exits non-zero with no result without a card, when the
checkout lacks the port, or when the process has loaded jax, jaxlib, flax
or the JAX package (`lidar_snow_sim_tpu`, its top-level name compared
whole).
"""

from __future__ import annotations

import os
import sys

# caches inside the checkout, at fixed paths
_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    from port_bench import harness, spec as specs

    t_start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    checkout = specs.CHECKOUT
    if str(checkout) not in sys.path:
        sys.path.insert(0, str(checkout))
    try:
        import lidar_snow_sim_tpu_torch as port
    except ImportError as e:
        harness.log(f"the port is not in this checkout: {e}")
        return 2
    if checkout not in Path(port.__file__).resolve().parents:
        harness.log(f"the port imported from {port.__file__}, not from "
                    f"this checkout {checkout}")
        return 2

    import torch

    spec = specs.load_spec()
    wl = specs.workload(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl[
            "chips"]:
        harness.log(f"needs {wl['chips']} CUDA device(s); "
                    f"available: {torch.cuda.is_available()}")
        return 2
    torch.set_num_threads(1)
    harness.log(f"card {harness._smi('name,power.limit,clocks.max.sm')} "
                f"torch {torch.__version__} cuda {torch.version.cuda} "
                f"cores {len(os.sched_getaffinity(0))}")
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), spec=spec,
        config=specs.config(spec, wl["config"]),
        traffic=specs.traffic(wl["traffic"]), cell=specs.cell(wl["name"]),
        device=torch.device("cuda", 0), t_start=t_start)
    bad = specs.forbidden_modules(sys.modules)
    if bad:
        harness.log(f"forbidden modules loaded: {bad}")
        return 3
    for line in result.pop("_log"):
        harness.log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
