"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` file exposes a plain C interface and is compiled by
`nvcc` for Hopper (sm_90a) into `_build/lib<name>_<hash>.so`, then loaded
with ctypes. The build happens at first use; the file name carries a hash
of the source and the flags, so an edited source is rebuilt. Without
`nvcc` on PATH or under CUDA_HOME the load raises: there is no fallback.

`-fmad=false` keeps every product rounded on its own. The kernels' hit
tests and pulse sums are decision boundaries, and a contracted FMA rounds
differently from the plain torch versions they are held against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each exported C function (pointers and the stream as
# void*, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "occluders": {
        "occluders_a1": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,   # arrays, see .cu
            _I, _I, _I, _I, _I, _I,                    # sizes
            _P,                                        # stream
        ],
        "occluders_a2": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I, _I, _I, _I,
            _P,
        ],
        "occluders_a3": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I, _I, _I,
            _F,                                        # delta
            _P,
        ],
        "occluders_a4a": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P,       # arrays, no has
            _I, _I, _I, _I, _I, _I,
            _P,
        ],
        "occluders_a4b": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I,
            _P,
        ],
        "occluders_w1": [
            _P, _P, _P, _P, _P, _P, _P, _P,           # inputs (live may
            _P, _P, _P, _P, _P,                       # be null); outputs
            _I, _I, _I, _I, _I, _I,                   # n, k_ext, wc, n_wide,
            _F,                                       # window, K; delta
            _P,                                       # stream
        ],
    },
    "pulse": {
        "pulse_c1": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P,        # inputs
            _P, _P, _P, _P,                            # outputs
            _I, _I, _I,                                # cap, K, M
            _F, _F, _F, _F, _F,                        # scalars
            _P,                                        # stream
        ],
        "pulse_c2": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _P, _P, _P, _P,
            _I, _I, _I, _I,                            # cap, K, M, blk
            _F, _F, _F, _F, _F,
            _P,
        ],
        "pulse_w2": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P,        # inputs (live may
            _P, _P, _P, _P,                            # be null); outputs
            _I, _I, _I, _I,                            # n, K, M, max_bumps
            _F, _F, _F, _F, _F, _F,                    # ..., phase
            _P,
        ],
        "pulse_trig_table": [
            _I, _I, _I, _F,                            # first, count,
                                                       # step, phase
            _P, _P,                                    # cos, sin
            _P,
        ],
    },
    "lut_lookup": {
        "lut_lookup_l1": [
            _P, _P, _P,                                # p, table, out
            ctypes.c_longlong, _I,                     # n, g1
            _P,                                        # stream
        ],
    },
}


def find_nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
            exe = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if exe is None:
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
            "kernels cannot be built"
        )
    return exe


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source exists;
    the compiler's report (registers, shared memory, spills) goes to
    _build/<name>.log."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True,
        )
        (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def check_input(name: str, t, dtype, shape) -> None:
    """Raise unless tensor `t` is a contiguous CUDA tensor of `dtype` and
    `shape`, which is all a kernel's raw pointer can take."""
    if t.dtype != dtype or not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(
            f"{name}: need a contiguous {dtype} CUDA tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def launch(device, entry, *args) -> int:
    """Call the C entry point `entry` with `device` current: its `<<<>>>`
    launch and `cudaFuncSetAttribute` act on the calling thread's current
    device, which on a second card need not be the tensors' own. Returns
    the entry's cudaError_t."""
    import torch

    with torch.cuda.device(device):
        return entry(*args)
