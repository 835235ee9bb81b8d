"""The port never imports jax.

A subprocess is needed: tests/conftest.py imports jax into this process.
The port's own modules, the ones it reuses from the JAX package, and
chip_smoke.py must all load without it.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODULES = [
    "lidar_snow_sim_tpu_torch",
    "lidar_snow_sim_tpu_torch._kernels",
    "lidar_snow_sim_tpu_torch.api",
    "lidar_snow_sim_tpu_torch.camera",
    "lidar_snow_sim_tpu_torch.models.dror",
    "lidar_snow_sim_tpu_torch.models.fog",
    "lidar_snow_sim_tpu_torch.models.lisa",
    "lidar_snow_sim_tpu_torch.models.snowfall",
    "lidar_snow_sim_tpu_torch.models.stf_fog",
    "lidar_snow_sim_tpu_torch.models.wet_ground",
    "lidar_snow_sim_tpu_torch.ops.fitting",
    "lidar_snow_sim_tpu_torch.ops.fresnel",
    "lidar_snow_sim_tpu_torch.ops.geometry",
    "lidar_snow_sim_tpu_torch.ops.laser",
    "lidar_snow_sim_tpu_torch.ops.lut_lookup",
    "lidar_snow_sim_tpu_torch.ops.occluders",
    "lidar_snow_sim_tpu_torch.ops.pulse",
    "lidar_snow_sim_tpu_torch.parallel.batched",
    "lidar_snow_sim_tpu_torch.parallel.datagen",
    "lidar_snow_sim_tpu_torch.tools.inspect",
    "lidar_snow_sim_tpu_torch.tools.precompute",
    "lidar_snow_sim_tpu_torch.tools.profile_weather",
]


def _jax_free(code: str):
    probe = (
        f"{code}\nimport sys\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_port_modules_import_no_jax():
    _jax_free("import importlib\n" + "\n".join(
        f"importlib.import_module({m!r})" for m in MODULES
    ))


def test_chip_smoke_imports_no_jax():
    _jax_free("import runpy; runpy.run_path('chip_smoke.py', "
              "run_name='not_main')")
