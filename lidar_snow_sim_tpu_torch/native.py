"""ctypes bindings to the repo's native C++ runtime (counterpart of
`lidar_snow_sim_tpu/native.py`).

Components:
- `native_dart_throw`: the C++ spatial-hash dart-throwing sampler
  (`native/snow_sampler.cpp`) that writes the particle banks;
- `ScanIOPool`: the threaded .bin scan loader/writer (`native/scan_io.cpp`).

The library is the port's own build of those two sources, made at first use
with the flags of `native/Makefile` into
`lidar_snow_sim_tpu_torch/_build/libsnowsim_<hash>.so` (the hash covers the
sources and the flags, so an edited source is rebuilt). `native/`, which the
JAX package's `make` owns, is only read. Where the library cannot be built
the binding raises; it never returns None.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import subprocess
import tempfile
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("snow_sampler.cpp", "scan_io.cpp")
# native/Makefile: $(CXX) $(CXXFLAGS) -shared -o $@ $(SRCS) -lpthread
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-Wextra")


def library_path() -> Path:
    digest = hashlib.sha256(
        b"".join((NATIVE_DIR / s).read_bytes() for s in SOURCES)
        + shlex.join((CXX, *CXXFLAGS)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libsnowsim_{digest}.so"


def build() -> Path:
    """Compile native/{snow_sampler,scan_io}.cpp unless the library for
    these sources exists. The build writes a temporary name and moves it
    into place, so concurrent builds (test workers) never load half a
    file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                [CXX, *CXXFLAGS, "-shared", "-o", tmp,
                 *(str(NATIVE_DIR / s) for s in SOURCES), "-lpthread"],
                capture_output=True, text=True, timeout=300,
            )
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(
                f"building the native library failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native library failed:\n{proc.stdout}"
                f"{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library, built on first use; the ctypes signatures are
    those of `lidar_snow_sim_tpu/native.py`."""
    lib = ctypes.CDLL(str(build()))
    lib.snow_dart_throw.restype = ctypes.c_int64
    lib.snow_dart_throw.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
        ctypes.c_double, ctypes.c_int64,
        np.ctypeslib.ndpointer(dtype=np.float64, ndim=2, flags="C"),
    ]
    lib.scan_pool_create.restype = ctypes.c_void_p
    lib.scan_pool_create.argtypes = [ctypes.c_int]
    lib.scan_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.scan_pool_load.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(dtype=np.float32, ndim=2, flags="C,WRITEABLE"),
        np.ctypeslib.ndpointer(dtype=np.int64, ndim=1, flags="C,WRITEABLE"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
    ]
    lib.scan_pool_write_compact.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(dtype=np.float32, ndim=2, flags="C"),
        np.ctypeslib.ndpointer(dtype=np.uint8, ndim=1, flags="C"),
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(dtype=np.int64, ndim=1, flags="C,WRITEABLE"),
    ]
    lib.scan_pool_wait.argtypes = [ctypes.c_void_p]
    return lib


def native_dart_throw(
    occupancy_ratio: float,
    rate_param_per_cm: float,
    r0: float,
    seed: int,
    max_diameter_mm: float = 20.0,
    cap: int = 1 << 23,
) -> np.ndarray:
    """The C++ sampler: (N, 3) float64 rows [x, y, r]."""
    out = np.empty((cap, 3), dtype=np.float64)
    n = load().snow_dart_throw(
        occupancy_ratio, rate_param_per_cm, r0, seed, max_diameter_mm, cap,
        out,
    )
    if n < 0:
        raise RuntimeError(f"native sampler exceeded cap {cap}")
    return out[:n].copy()


class ScanIOPool:
    """Threaded native .bin loader/writer with pad-to-capacity."""

    def __init__(self, n_threads: int = 8):
        self._lib = load()
        self._pool = self._lib.scan_pool_create(n_threads)
        self._refs: list = []  # keep buffers alive until wait()

    def load_async(self, path, capacity: int, cols: int = 5,
                   pad_x: float = 1e6):
        """Start an async load; returns (buffer (capacity, cols), n_out (1,))
        valid after wait()."""
        buf = np.empty((capacity, cols), dtype=np.float32)
        n_out = np.empty(1, dtype=np.int64)
        self._refs.append((buf, n_out))
        self._lib.scan_pool_load(
            self._pool, str(path).encode(), buf, n_out, capacity, cols,
            np.float32(pad_x),
        )
        return buf, n_out

    def write_compact_async(self, path, data: np.ndarray, keep: np.ndarray):
        data = np.ascontiguousarray(data, dtype=np.float32)
        keep = np.ascontiguousarray(keep, dtype=np.uint8)
        n_out = np.empty(1, dtype=np.int64)
        self._refs.append((data, keep, n_out))
        self._lib.scan_pool_write_compact(
            self._pool, str(path).encode(), data, keep,
            data.shape[0], data.shape[1], n_out,
        )
        return n_out

    def wait(self):
        self._lib.scan_pool_wait(self._pool)
        self._refs.clear()

    def close(self):
        if self._pool:
            self._lib.scan_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
