"""The benchmark's cells on the card, briefly: each run ends with a result
line whose outputs are correct. These tests need an NVIDIA GPU and nvcc
and skip elsewhere:

    python -m pytest -p no:cacheprovider \\
        port_bench/tests/test_port_bench_card.py
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from port_bench import spec as specs


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available() or shutil.which("nvcc") is None:
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("workload",
                         [w["name"] for w in specs.load_spec()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", workload,
         "--seed", str(2 ** 32 + 17), "--seconds", "2", "--trace",
         str(trace)], cwd=specs.CHECKOUT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "compared"
    if trace:
        assert result["device"]["busy_s"] > 0
