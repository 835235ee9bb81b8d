"""The port never imports jax, nor any module of the JAX package.

A subprocess is needed: tests/conftest.py imports jax and the JAX package
into this process. The port's modules, its own copies of the JAX package's
host modules, and chip_smoke.py must all load without either.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODULES = [
    "lidar_snow_sim_tpu_torch",
    "lidar_snow_sim_tpu_torch._kernels",
    "lidar_snow_sim_tpu_torch.api",
    "lidar_snow_sim_tpu_torch.calib",
    "lidar_snow_sim_tpu_torch.camera",
    "lidar_snow_sim_tpu_torch.config",
    "lidar_snow_sim_tpu_torch.device",
    "lidar_snow_sim_tpu_torch.models.detector_augment",
    "lidar_snow_sim_tpu_torch.models.detector_train",
    "lidar_snow_sim_tpu_torch.models.dror",
    "lidar_snow_sim_tpu_torch.models.fog",
    "lidar_snow_sim_tpu_torch.models.lisa",
    "lidar_snow_sim_tpu_torch.models.pointpillars",
    "lidar_snow_sim_tpu_torch.models.snowfall",
    "lidar_snow_sim_tpu_torch.models.stf_fog",
    "lidar_snow_sim_tpu_torch.models.wet_ground",
    "lidar_snow_sim_tpu_torch.native",
    "lidar_snow_sim_tpu_torch.ops.fitting",
    "lidar_snow_sim_tpu_torch.ops.fresnel",
    "lidar_snow_sim_tpu_torch.ops.geometry",
    "lidar_snow_sim_tpu_torch.ops.laser",
    "lidar_snow_sim_tpu_torch.ops.lut_lookup",
    "lidar_snow_sim_tpu_torch.ops.mie",
    "lidar_snow_sim_tpu_torch.ops.occluders",
    "lidar_snow_sim_tpu_torch.ops.pulse",
    "lidar_snow_sim_tpu_torch.ops.rotated_iou",
    "lidar_snow_sim_tpu_torch.ops.sweep",
    "lidar_snow_sim_tpu_torch.ops.waveform",
    "lidar_snow_sim_tpu_torch.oracle",
    "lidar_snow_sim_tpu_torch.oracle.detector",
    "lidar_snow_sim_tpu_torch.oracle.fitting",
    "lidar_snow_sim_tpu_torch.oracle.parity",
    "lidar_snow_sim_tpu_torch.oracle.snowfall",
    "lidar_snow_sim_tpu_torch.oracle.wet_ground",
    "lidar_snow_sim_tpu_torch.parallel.batched",
    "lidar_snow_sim_tpu_torch.parallel.datagen",
    "lidar_snow_sim_tpu_torch.parallel.distributed",
    "lidar_snow_sim_tpu_torch.parallel.mesh",
    "lidar_snow_sim_tpu_torch.sampling",
    "lidar_snow_sim_tpu_torch.sampling.banks",
    "lidar_snow_sim_tpu_torch.sampling.dart",
    "lidar_snow_sim_tpu_torch.sampling.distributions",
    "lidar_snow_sim_tpu_torch.sampling.empirical",
    "lidar_snow_sim_tpu_torch.tools.ab",
    "lidar_snow_sim_tpu_torch.tools.convert_checkpoint",
    "lidar_snow_sim_tpu_torch.tools.datagen_bench",
    "lidar_snow_sim_tpu_torch.tools.dryrun_multichip",
    "lidar_snow_sim_tpu_torch.tools.evaluate",
    "lidar_snow_sim_tpu_torch.tools.experiment",
    "lidar_snow_sim_tpu_torch.tools.gen_banks",
    "lidar_snow_sim_tpu_torch.tools.infer",
    "lidar_snow_sim_tpu_torch.tools.inspect",
    "lidar_snow_sim_tpu_torch.tools.parity_gpu",
    "lidar_snow_sim_tpu_torch.tools.precompute",
    "lidar_snow_sim_tpu_torch.tools.profile_bench",
    "lidar_snow_sim_tpu_torch.tools.profile_weather",
    "lidar_snow_sim_tpu_torch.tools.serve",
    "lidar_snow_sim_tpu_torch.tools.train",
    "lidar_snow_sim_tpu_torch.tools.viewer",
    "lidar_snow_sim_tpu_torch.utils",
    "lidar_snow_sim_tpu_torch.utils.boxes",
    "lidar_snow_sim_tpu_torch.utils.datasets",
    "lidar_snow_sim_tpu_torch.utils.eval_ap",
    "lidar_snow_sim_tpu_torch.utils.ground_stats",
    "lidar_snow_sim_tpu_torch.utils.planes_io",
    "lidar_snow_sim_tpu_torch.utils.pointcloud",
    "lidar_snow_sim_tpu_torch.utils.profiling",
    "lidar_snow_sim_tpu_torch.utils.render",
    "lidar_snow_sim_tpu_torch.utils.splits",
    "lidar_snow_sim_tpu_torch.utils.stf_labels",
    "lidar_snow_sim_tpu_torch.utils.stf_meta",
    "lidar_snow_sim_tpu_torch.utils.synthetic",
]


def _jax_free(code: str):
    """Run `code` in a fresh interpreter; then no jax module and no module
    of the JAX package (`lidar_snow_sim_tpu`, `lidar_snow_sim_tpu.*`; the
    port's `lidar_snow_sim_tpu_torch*` differ) may be loaded."""
    probe = (
        f"{code}\nimport sys\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "ref = sorted(m for m in sys.modules if m == 'lidar_snow_sim_tpu' "
        "or m.startswith('lidar_snow_sim_tpu.'))\n"
        "assert not ref, ref\n"
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
