"""The development scripts' host logic on the CPU: the phase-A sweep's
source variants and the output comparisons that kernel_ab and the sweep
share."""

import re

import pytest
import torch

from lidar_snow_sim_tpu_torch import _kernels
from scripts.kernel_ab import outputs_equal, phase_a_equal
from scripts.phase_a_sweep import (
    CONSTS,
    LAUNCH_BOUNDS,
    VARIANTS,
    variant_source,
)

_ALL = re.compile(r"constexpr int k(" + "|".join(
    name for names in CONSTS.values() for name in names
    if name not in LAUNCH_BOUNDS) + r") = \d+;|__launch_bounds__\([^)]*\)")


@pytest.mark.parametrize("i", [0, 1, 11, 12, 20], ids=[
    "a4a0-a4b0", "a4a1-a4b1", "a2-a3-11", "a2-a3-12", "a2-a3-20"])
def test_sweep_variant_sets_each_constant(i):
    """A variant's source differs from csrc/occluders.cu only in the split
    constants it names (A4a's and A4b's, or A2's and A3's, with the CTAs
    an SM their launch bounds ask for), each set once."""
    src = (_kernels.CSRC / "occluders.cu").read_text()
    got = variant_source(VARIANTS[i])
    for kernel, vals in VARIANTS[i].items():
        for name, v in zip(CONSTS[kernel], vals, strict=True):
            if name in LAUNCH_BOUNDS:
                bounds = LAUNCH_BOUNDS[name]
                want = f"{bounds}, {v}" if v else bounds
                assert got.count(f"__launch_bounds__({want})") == 1
                continue
            assert re.findall(rf"constexpr int k{name} = (\d+);",
                              got) == [str(v)]
    assert _ALL.sub("", got) == _ALL.sub("", src)
    others = [n for k, names in CONSTS.items() if k not in VARIANTS[i]
              for n in names if n not in LAUNCH_BOUNDS]
    for name in others:                     # the rest keep their values
        pat = rf"constexpr int k{name} = \d+;"
        assert re.findall(pat, got) == re.findall(pat, src)


def test_every_split_constant_is_in_the_source():
    """Each constant the sweep can set is defined once in the source, and
    each variant gives every constant of each kernel it names."""
    src = (_kernels.CSRC / "occluders.cu").read_text()
    for names in CONSTS.values():
        for name in names:
            if name in LAUNCH_BOUNDS:
                assert src.count(f"__launch_bounds__({LAUNCH_BOUNDS[name]})"
                                 ) == 1
                continue
            assert len(re.findall(rf"constexpr int k{name} = \d+;",
                                  src)) == 1
    for v in VARIANTS:
        assert all(len(vals) == len(CONSTS[k]) for k, vals in v.items())


def test_phase_a_equal_masks_empty_slots():
    """Two phase-A outputs agree when ovf and the dist plane are equal and
    a1/a2 are equal where dist < 1e37; a1/a2 in an empty slot may differ."""
    k = 2
    a12d = torch.tensor([[0.1, 0.0], [0.2, 0.0],      # a1
                         [0.3, 0.0], [0.4, 0.0],      # a2
                         [5.0, 3e38], [6.0, 3e38]])   # dist
    ovf = torch.zeros((1, 2), dtype=torch.int32)
    other = a12d.clone()
    other[0, 1] = 9.0                                 # an empty slot's a1
    assert phase_a_equal((other, ovf), (a12d, ovf), k)
    other[0, 0] = 9.0                                 # a kept slot's a1
    assert not phase_a_equal((other, ovf), (a12d, ovf), k)
    assert not phase_a_equal((a12d, ovf + 1), (a12d, ovf), k)


def test_outputs_equal_holds_a2_a3_in_full():
    """A1 and A4 compare as phase_a_equal; A2 and A3 in full, an empty
    slot's a1 and A3's coverage plane included."""
    k = 1
    a12d = torch.tensor([[0.1, 0.0], [0.3, 0.0], [5.0, 3e38]])
    ovf = torch.zeros((1, 2), dtype=torch.int32)
    other = a12d.clone()
    other[0, 1] = 9.0                                 # an empty slot's a1
    for name in ("A1", "A1 folded 16 frames", "A4a", "A4b"):
        assert outputs_equal(name, (other, ovf), (a12d, ovf), k)
    assert not outputs_equal("A2", (other, ovf), (a12d, ovf), k)
    assert outputs_equal("A2", (a12d, ovf), (a12d.clone(), ovf), k)
    unc = torch.zeros((1, 2), dtype=torch.int32)
    assert not outputs_equal("A3", (a12d, ovf, unc), (a12d, ovf, unc + 1),
                             k)
