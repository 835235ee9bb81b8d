"""The development scripts' host logic on the CPU: the A4 sweep's source
variants and the phase-A comparison that kernel_ab and the sweep share."""

import re

import pytest
import torch

from lidar_snow_sim_tpu_torch import _kernels
from scripts.a4_sweep import VARIANTS, variant_source
from scripts.kernel_ab import phase_a_equal


@pytest.mark.parametrize("a4a,a4b", VARIANTS[:2])
def test_sweep_variant_sets_each_constant(a4a, a4b):
    """A variant's source differs from csrc/occluders.cu only in A4a's and
    A4b's lane, beam and tile constants, each set once."""
    src = (_kernels.CSRC / "occluders.cu").read_text()
    got = variant_source(a4a, a4b)
    for kernel, vals in (("A4a", a4a), ("A4b", a4b)):
        for what, v in zip(("Lanes", "Beams", "Tile"), vals):
            assert re.findall(rf"constexpr int k{what}{kernel} = (\d+);",
                              got) == [str(v)]
    strip = re.compile(r"constexpr int k(Lanes|Beams|Tile)A4[ab] = \d+;")
    assert strip.sub("", got) == strip.sub("", src)


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
