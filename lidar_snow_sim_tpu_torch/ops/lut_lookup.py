"""Piecewise-linear lookup in a small knot-pair table (counterpart of
`lidar_snow_sim_tpu/ops/lut_lookup.py`), LISA's Mie backscatter lookup.

`lut_lookup_pairs` launches kernel L1 (`csrc/lut_lookup.cu`) on CUDA
tensors and runs `lut_lookup_plain`, the same function in plain torch, on
CPU tensors. Both follow the TPU kernel `_lookup_kernel`
(lut_lookup.py:68) and the XLA pairs path it replaces: for a position p in
[0, g1], cell = min(int(p), g1 - 1), f = p - cell, and
out = lo * (1 - f) + hi * f with (lo, hi) row `cell` of a (g1, 2) f32
table. The TPU kernel's bf16x4 parts table exists only for its matrix
unit and rebuilds these f32 knots exactly, so the port reads them directly;
its 128-cell cap is the width of its one-hot, so the port's cap is the
kernel's shared-memory table instead (`MAX_CELLS`), on every device.
"""

from __future__ import annotations

import torch

from lidar_snow_sim_tpu_torch import _kernels

MAX_CELLS = 6144  # kernel L1's table: 48 KB of f32 pairs in shared memory


def _check_table(pairs: torch.Tensor) -> int:
    if pairs.dim() != 2 or pairs.shape[1] != 2:
        raise ValueError(f"knot-pair table must be (g1, 2), got "
                         f"{tuple(pairs.shape)}")
    g1 = int(pairs.shape[0])
    if not 1 <= g1 <= MAX_CELLS:
        raise ValueError(f"knot-pair table has {g1} cells; the lookup takes "
                         f"1 to {MAX_CELLS}")
    return g1


def lut_lookup_plain(p: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """Plain torch version of kernel L1: index, gather, lerp."""
    g1 = _check_table(pairs)
    i = p.to(torch.int32).clamp(0, g1 - 1)
    f = p - i.to(torch.float32)
    rows = pairs[i.long()]
    return rows[..., 0] * (1.0 - f) + rows[..., 1] * f


def lut_lookup_pairs(p: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """Lerp a knot-pair table of at most MAX_CELLS rows at f32 positions
    `p` (any shape, values in [0, g1]): kernel L1 on CUDA tensors, its
    plain version on CPU tensors. Returns f32 of p's shape."""
    if p.device.type == "cpu":
        return lut_lookup_plain(p, pairs)
    g1 = _check_table(pairs)
    flat = p.contiguous().reshape(-1)
    _kernels.check_input("p", flat, torch.float32, (flat.numel(),))
    _kernels.check_input("pairs", pairs, torch.float32, (g1, 2))
    if pairs.device != p.device:
        raise ValueError(f"pairs on {pairs.device}, p on {p.device}")
    out = torch.empty_like(flat)
    lib = _kernels.load("lut_lookup")
    err = _kernels.launch(
        p.device, lib.lut_lookup_l1,
        flat.data_ptr(), pairs.data_ptr(), out.data_ptr(), flat.numel(), g1,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    _kernels.check(err, "kernel L1 (lut_lookup_l1)")
    lut_lookup_pairs.launches += 1
    return out.reshape(p.shape)


lut_lookup_pairs.launches = 0
