"""The development scripts' host logic on the CPU: the phase-A and
phase-C sweeps' source variants, kernel_ab's phase-C calls and the output
comparisons that kernel_ab and the sweeps share."""

import ctypes
import re
import types

import pytest
import torch

from lidar_snow_sim_tpu_torch import _kernels
from scripts import kernel_ab, phase_c_sweep
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


def _pulse_outputs(cap, touched):
    return (torch.zeros(cap), torch.zeros(cap, dtype=torch.int32), touched,
            torch.zeros(cap))


def test_outputs_equal_holds_phase_c_touched_as_0_1():
    """C1 and C2 compare in full, touched as 0/1 whether a build wrote it
    as int32 (before it became one byte a beam) or as torch.bool."""
    bools = torch.tensor([True, False, False])
    ints = bools.to(torch.int32)
    for name in ("C1", "C2"):
        assert outputs_equal(name, _pulse_outputs(3, bools),
                             _pulse_outputs(3, ints), 0)
        assert not outputs_equal(name, _pulse_outputs(3, bools),
                                 _pulse_outputs(3, ints.flip(0)), 0)
        assert not outputs_equal(name, _pulse_outputs(3, bools),
                                 _pulse_outputs(3, 2 * ints), 0)


def test_touched_bytes_reads_each_checkout(tmp_path):
    """This tree's phase C writes touched as one byte a beam; a checkout
    whose C entries take `int* touched` writes four."""
    assert kernel_ab.touched_bytes(_kernels.CSRC.parents[1]) == 1
    csrc = tmp_path / "lidar_snow_sim_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "pulse.cu").write_text(
        _kernels.CSRC.joinpath("pulse.cu").read_text().replace(
            "unsigned char* touched,", "int* touched,"))
    assert kernel_ab.touched_bytes(tmp_path) == 4


@pytest.mark.parametrize("kernel,width", [("C1", 1), ("C1", 4), ("C2", 1),
                                          ("C2", 4)])
def test_kernel_ab_pulse_calls_fit_each_width(monkeypatch, kernel, width):
    """kernel_ab's C1 and C2 calls hand their entry (C2 with pulse block
    512) a touched buffer of the build's width: an int32 parent build
    writes 4 bytes a beam into it without overrunning, and the result
    equals this tree's bool as 0/1."""
    cap, k, m = 2048, 3, 5
    args = [torch.zeros(4, cap)] + [torch.zeros(k, cap)] * 4 + \
        [torch.zeros(k + 1, cap)] * 2 + [torch.zeros(m)] * 2
    kw = dict(beam_rad=1.0, ipm=10.0, c_tau=3.0, xsi_r1=0.0, xsi_r2=1.0)
    seen = {}

    def entry(*a):
        seen["args"] = a
        # the build writes zeros, and touched[p] = p % 2 in its own width
        for ptr in (a[9], a[10], a[12]):
            ctypes.memset(ptr, 0, 4 * cap)
        ctype = ctypes.c_int32 if width == 4 else ctypes.c_uint8
        flags = (ctype * cap)(*[p % 2 for p in range(cap)])
        ctypes.memmove(a[11], flags, ctypes.sizeof(flags))
        return 0

    name = {"C1": "pulse_c1", "C2": "pulse_c2"}[kernel]
    lib = types.SimpleNamespace(**{name: entry})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    call = kernel_ab._c1_call if kernel == "C1" else kernel_ab._c2_call
    outs = call(lib, args, kw, width)()
    a = seen["args"]
    assert a[11] == outs[2].data_ptr()
    assert outs[2].numel() * outs[2].element_size() == width * cap
    assert a[13:16] == (cap, k, m)
    if kernel == "C2":
        assert a[16] == kernel_ab.C2_BLOCK == 512
    want = torch.arange(cap) % 2 == 1
    assert outputs_equal(kernel, outs, _pulse_outputs(cap, want), k)


def test_phase_c_sweep_variants():
    """Each phase-C variant's source differs from csrc/pulse.cu only in
    kLanesC2, set once to a split that keeps a pair in one warp; the
    interleaved one also gets its kernel and C entry appended."""
    src = (_kernels.CSRC / "pulse.cu").read_text()
    pat = r"constexpr int kLanesC2 = (\d+);"
    assert len(re.findall(pat, src)) == 1
    for v in phase_c_sweep.VARIANTS:
        got = phase_c_sweep.variant_source(v)
        assert re.findall(pat, got) == [str(v["lanes"])]
        assert 32 % (2 * v["lanes"]) == 0
        base = re.sub(pat, "", got)
        if v.get("interleaved"):
            assert base == re.sub(pat, "", src) + phase_c_sweep.INTERLEAVED
            assert phase_c_sweep.entry(v) == ("pulse_c2i", "c2i_kernel")
        else:
            assert base == re.sub(pat, "", src)
            assert phase_c_sweep.entry(v) == ("pulse_c2", "c2_kernel")
    assert {v["lanes"] for v in phase_c_sweep.VARIANTS} >= {8, 16}
    # blk 1: C1's own map, the pairing's cost apart from the code
    assert {v.get("blk", kernel_ab.C2_BLOCK)
            for v in phase_c_sweep.VARIANTS} >= {1, 512}


def test_pair_spread_counts_pairs_and_neighbours():
    """pair_spread compares the valid counts of beam j of blocks 2i and
    2i + 1 (C2's warp) and of beams 2j and 2j + 1 (C1's)."""
    valid = torch.zeros(3, 8)
    valid[:, :2] = 1.0     # beams 0, 1: 3 occluders each
    valid[0, 4] = 1.0      # beam 4: 1
    got = phase_c_sweep.pair_spread(valid, 2)
    # pairs (0, 2), (1, 3), (4, 6), (5, 7): differences 3, 3, 1, 0
    assert got["C2 pairs"] == {"mean_abs_diff": 1.75,
                               "share_differing": 0.75, "max_abs_diff": 3}
    # neighbours (0, 1), (2, 3), (4, 5), (6, 7): 0, 0, 1, 0
    assert got["C1 neighbours"] == {"mean_abs_diff": 0.25,
                                    "share_differing": 0.25,
                                    "max_abs_diff": 1}
