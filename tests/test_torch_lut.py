"""Kernel L1 of the port (`ops/lut_lookup.py`): its plain torch version
against the JAX package's Pallas kernel in interpret mode and against the
XLA knot-pair formula it replaces, on identical inputs. The CUDA kernel is
held against the plain version in test_torch_cuda.py.

Tolerance: 1 ulp. XLA's CPU backend contracts lo * (1 - f) + hi * f into a
fused multiply-add, which rounds once where the port rounds twice; at a knot
(f = 0) and at p == g1 (f = 1) both are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.ops.lut_lookup import bake_parts_table
from lidar_snow_sim_tpu.ops.lut_lookup import (
    lut_lookup_pairs as jax_lookup,
)
from lidar_snow_sim_tpu_torch.models.lisa import _knot_lerp
from lidar_snow_sim_tpu_torch.ops.lut_lookup import (
    MAX_CELLS,
    lut_lookup_pairs,
    lut_lookup_plain,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(g, seed):
    """g positive knots -> (g - 1, 2) f32 pairs, as LISA's Qback table."""
    qb = np.random.default_rng(seed).uniform(0.2, 36.7, g).astype(np.float32)
    return qb, np.stack([qb[:-1], qb[1:]], axis=1)


def _xla_pairs(pairs, p, g1):
    """The XLA pairs formula the TPU kernel replaces (models/lisa.py)."""
    p = jnp.asarray(p)
    i = jnp.minimum(p.astype(jnp.int32), g1 - 1)
    f = p - i.astype(jnp.float32)
    rows = jnp.asarray(pairs)[i]
    return np.asarray(rows[..., 0] * (1.0 - f) + rows[..., 1] * f)


def _ulps(a, b):
    """Distance in ulps of two arrays of positive f32 values."""
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("g", [2, 64, 128, 129])
@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 11, 13), (8193,)])
def test_l1_plain_matches_pallas_and_xla(g, shape):
    """Random and knot-exact positions, p == g1, ragged lengths: within one
    ulp of the Pallas kernel (interpret mode) and of the XLA pairs path; the
    knots themselves and p == g1 exactly."""
    qb, pairs = _table(g, seed=g)
    g1 = g - 1
    rng = np.random.default_rng(len(shape) * 1000 + g)
    p = rng.uniform(0, g1, shape).astype(np.float32)
    flat = p.reshape(-1)
    flat[: min(g1 + 1, flat.size)] = np.arange(min(g1 + 1, flat.size))
    flat[-1] = g1
    got = lut_lookup_plain(torch.as_tensor(p), torch.as_tensor(pairs)).numpy()
    assert got.shape == shape and got.dtype == np.float32
    pallas = np.asarray(jax_lookup(jnp.asarray(p), bake_parts_table(pairs),
                                   g1, interpret=True))
    assert _ulps(got, pallas).max() <= 1
    assert _ulps(got, _xla_pairs(pairs, p, g1)).max() <= 1
    knots = np.arange(g1, dtype=np.float32)
    np.testing.assert_array_equal(
        lut_lookup_plain(torch.as_tensor(knots), torch.as_tensor(pairs)),
        qb[:-1])
    assert got.reshape(-1)[-1] == qb[-1]           # p == g1: f = 1, hi knot


@pytest.mark.parametrize("g", [200, MAX_CELLS + 1])
def test_l1_plain_wide_tables_match_xla(g):
    """Tables wider than the JAX kernel's 128 cells, up to MAX_CELLS (LISA
    with dsd_points > 128 takes XLA's gather in the JAX package and L1 in
    the port): within one ulp of the XLA pairs path, the knots exactly."""
    qb, pairs = _table(g, seed=g)
    g1 = g - 1
    p = np.random.default_rng(g).uniform(0, g1, (3, 4001)).astype(np.float32)
    p.reshape(-1)[:g1 + 1] = np.arange(g1 + 1)
    got = lut_lookup_pairs(torch.as_tensor(p), torch.as_tensor(pairs))
    assert _ulps(got.numpy(), _xla_pairs(pairs, p, g1)).max() <= 1
    np.testing.assert_array_equal(got.reshape(-1)[:g1 + 1].numpy(), qb)


def test_l1_equals_lisa_plain_gather():
    """The wrapper (on a CPU tensor) and LISA's knot-pair gather of its
    multi-column tables (`_knot_lerp`, the residual bound's lookup) give the
    same bits on one column: both lookups of LISA share one formula."""
    _, pairs = _table(128, seed=3)
    p = torch.as_tensor(np.random.default_rng(1).uniform(0, 127, (500, 64)),
                        dtype=torch.float32)
    pairs_t = torch.as_tensor(pairs)
    n0 = lut_lookup_pairs.launches
    got = lut_lookup_pairs(p, pairs_t)
    assert lut_lookup_pairs.launches == n0      # CPU: no kernel launch
    assert torch.equal(got, _knot_lerp(pairs_t, p, 127)[..., 0])
    assert torch.equal(got, lut_lookup_plain(p, pairs_t))


@pytest.mark.parametrize("shape", [(MAX_CELLS + 1, 2), (0, 2), (16, 3), (16,)])
def test_l1_rejects_bad_tables(shape):
    """A table wider than MAX_CELLS (kernel L1's shared-memory table; the
    JAX kernel's own limit, 128 cells, is an `assert` there) or of the
    wrong shape raises ValueError."""
    with pytest.raises(ValueError):
        lut_lookup_pairs(torch.zeros(4), torch.zeros(shape))
