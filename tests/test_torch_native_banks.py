"""The port's native binding (`native.py`), bank generator
(`tools/gen_banks.py`) and reference grid (`parallel/datagen.
iter_reference_grid`) against the JAX package's.

Both bindings build the same repo sources (`native/`) with the same flags:
the JAX package's into `native/libsnowsim.so` (its `make`), the port's into
`lidar_snow_sim_tpu_torch/_build/`. The tests that load both stay in this one
file, so that `--dist loadfile` keeps both builds in one worker. The bank
run is tiny: one (rate, velocity) pair, one mode, two lines, two workers.
"""

import numpy as np
import pytest

from lidar_snow_sim_tpu import native as jnative
from lidar_snow_sim_tpu.parallel.datagen import (
    iter_reference_grid as jax_grid,
)
from lidar_snow_sim_tpu.tools import gen_banks as jgen
from lidar_snow_sim_tpu.utils.pointcloud import load_velodyne_bin
from lidar_snow_sim_tpu_torch import native as tnative
from lidar_snow_sim_tpu_torch.parallel.datagen import iter_reference_grid
from lidar_snow_sim_tpu_torch.sampling.distributions import (
    compute_occupancy,
    diameter_rate_parameter,
    snowfall_rate_to_rainfall_rate,
)
from lidar_snow_sim_tpu_torch.tools import gen_banks as tgen


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mode,rate,vel,seed", [
    ("gunn", 2.5, 1.6, 43), ("sekhon", 0.5, 2.0, 1000), ("gunn", 1.5, 0.6, 7),
])
def test_native_dart_throw_bitwise(mode, rate, vel, seed):
    rr = snowfall_rate_to_rainfall_rate(rate, vel)
    occ = compute_occupancy(rate, vel)
    lam = diameter_rate_parameter(mode, rr)
    got = tnative.native_dart_throw(occ, lam, 80.0, seed=seed)
    want = jnative.native_dart_throw(occ, lam, 80.0, seed=seed)
    assert want is not None   # the JAX binding built its library
    _equal(got, want)
    assert got.shape[1] == 3 and len(got) > 1000


def test_port_library_lives_in_its_build_dir():
    lib = tnative.build()
    assert lib == tnative.library_path()
    assert lib.parent == tnative.BUILD_DIR and lib.exists()
    assert lib.name.startswith("libsnowsim_")


def test_native_sampler_cap_raises():
    with pytest.raises(RuntimeError, match="cap"):
        tnative.native_dart_throw(1e-3, 5.0, 80.0, seed=1, cap=10)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A library that cannot be built raises; nothing is returned."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "CXX", "false")
    tnative.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native library"):
            tnative.native_dart_throw(1e-4, 5.0, 80.0, seed=1)
        monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-cxx"))
        with pytest.raises(RuntimeError, match="native library"):
            tnative.ScanIOPool(2)
    finally:
        tnative.load.cache_clear()
    assert list(tmp_path.iterdir()) == []   # no temporary file left


def test_scan_io_pool_round_trip(tmp_path):
    """Load and compact-write through the port's pool; the files and
    buffers equal load_velodyne_bin's reading and the JAX pool's."""
    rng = np.random.default_rng(0)
    scans = [rng.normal(0, 10, (n, 5)).astype(np.float32)
             for n in (100, 777, 0)]
    paths = []
    for i, s in enumerate(scans):
        paths.append(tmp_path / f"s{i}.bin")
        s.tofile(paths[-1])
    pools = {"port": tnative.ScanIOPool(2), "jax": jnative.ScanIOPool(2)}
    loaded = {}
    for name, pool in pools.items():
        loaded[name] = [pool.load_async(p, 1024) for p in paths]
        pool.wait()
    for i, s in enumerate(scans):
        buf, n = loaded["port"][i]
        assert int(n[0]) == len(s)
        _equal(buf[:len(s)], load_velodyne_bin(paths[i]))
        _equal(buf, loaded["jax"][i][0])
    keep = rng.uniform(0, 1, len(scans[1])) > 0.4
    for name, pool in pools.items():
        n_out = pool.write_compact_async(tmp_path / f"{name}.bin", scans[1],
                                         keep)
        pool.wait()
        assert int(n_out[0]) == keep.sum()
        _equal(load_velodyne_bin(tmp_path / f"{name}.bin"), scans[1][keep])
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    for pool in pools.values():
        pool.close()


def test_gen_banks_files_equal_the_jax_tools(tmp_path, capsys):
    # both libraries built before the tools' worker processes start, so
    # no two workers run the JAX package's make at once
    assert jnative.native_available()
    tnative.build()
    argv = ["--rates", "2.5", "--velocities", "1.6", "--modes", "gunn",
            "--lines", "2", "--workers", "2"]
    assert tgen.main(["--out-dir", str(tmp_path / "port"), *argv]) == 0
    out = capsys.readouterr().out
    assert "by the native sampler, 0 numpy-fallback files" in out
    assert jgen.main(["--out-dir", str(tmp_path / "jax"), *argv]) == 0
    got = sorted(p.name for p in (tmp_path / "port").iterdir())
    want = sorted(p.name for p in (tmp_path / "jax").iterdir())
    rr = snowfall_rate_to_rainfall_rate(2.5, 1.6)
    occ = compute_occupancy(2.5, 1.6)
    assert got == want == [f"gunn_{rr}_{occ}_{i}.npy" for i in (1, 2)]
    for name in got:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    # a rerun skips every file
    assert tgen.main(["--out-dir", str(tmp_path / "port"), *argv]) == 0
    assert "0 sampled" in capsys.readouterr().out


def test_gen_banks_schedule_equals_the_jax_tools():
    args = ("d", (0.5, 1.0, 2.5), (0.6, 2.0), ("gunn", "sekhon"),
            range(1, 4), 80.0, 42)
    assert tgen.build_tasks(*args) == jgen.build_tasks(*args)
    assert tgen.build_tasks(*args, plot=True) == jgen.build_tasks(
        *args, plot=True)


def test_gen_banks_fallback_is_reported(tmp_path, monkeypatch):
    """Where the native sampler fails, a file is sampled by numpy's
    dart_throwing_fast (the JAX tool's fallback) and named as such."""
    from lidar_snow_sim_tpu_torch.sampling import dart_throwing_fast

    def broken(*a, **k):
        raise RuntimeError("no native library")

    monkeypatch.setattr(tnative, "native_dart_throw", broken)
    task = (str(tmp_path), "gunn", 0.9, 1e-5, 1, 80.0, 43, False)
    status, path, n, _, sampler = tgen._sample_one(task)
    assert (status, sampler) == ("done", "numpy")
    want = dart_throwing_fast(1e-5, 0.9, 80.0, np.random.default_rng(43),
                              "gunn")
    _equal(np.load(path), want)
    assert n == len(want)
    assert tgen._sample_one(task)[0] == "skip"


def test_iter_reference_grid_equals_the_jax_grid():
    assert list(iter_reference_grid()) == list(jax_grid())
    kw = dict(modes=("sekhon",), snowfall_rates=(1.0,),
              terminal_velocities=(0.6,))
    assert list(iter_reference_grid(**kw)) == list(jax_grid(**kw))
    assert len(list(iter_reference_grid())) == 10
