"""The port's data-parallel PointPillars training on the CPU: two gloo
ranks (`parallel/distributed.spawn_ranks`) against one process and
against the JAX package's train step, at the JAX dryrun's tiny detector
(`tools/dryrun_multichip.det_config`, `__graft_entry__.py:236-255`), and
the train CLI's `--dp-devices`.

Tolerances:
- two ranks against one process, one SGD step at 1e-3 (the JAX dryrun's
  optimizer and bounds, `__graft_entry__.py:280-297`): loss 2e-5
  relative, every parameter 1e-5 absolute, every averaged gradient 1e-5
  of its largest value;
- the two-rank step against the JAX package's (its targets assigned op by
  op, tests/test_torch_train.py explains why): loss 1e-5 relative, every
  parameter 1e-5 absolute;
- train-mode BN on the reduced sums (`reduce`) against its plain path:
  outputs 1e-6 of their largest value, running stats 1e-6 absolute;
- the CLI: --resume of a two-rank run byte for byte; its first logged
  loss (4 decimals) within 1e-4 relative of the one-process run's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lidar_snow_sim_tpu.models import detector_train as jdt
from lidar_snow_sim_tpu.models import pointpillars as jpp
from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
from lidar_snow_sim_tpu_torch.tools import dryrun_multichip as dry
from lidar_snow_sim_tpu_torch.tools import train as ttrain
from tests.test_torch_train import eager_assign_patch
from tests.test_train_cli import TINY_YAML

CPU2 = [torch.device("cpu")] * 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks():
    """(one-process result, two-rank result) of `dry.train_step` on
    det_batch(2): (metrics, state dict, gradients) each."""
    one = dry.train_step(0, torch.device("cpu"), 1, 2)
    from lidar_snow_sim_tpu_torch.parallel.distributed import spawn_ranks

    two = spawn_ranks(dry.train_step, CPU2, 2, 2)
    assert two[1] is None
    return one, two[0]


def test_two_ranks_equal_one_process(two_ranks):
    (m1, sd1, g1), (m2, sd2, g2) = two_ranks
    assert m1["num_pos"] >= 1.0
    for k in ("loss", "loss_cls", "loss_loc", "loss_dir", "num_pos"):
        np.testing.assert_allclose(m2[k], m1[k], rtol=2e-5, err_msg=k)
    for k, v in sd1.items():
        np.testing.assert_allclose(sd2[k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
    for k, g in g1.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        assert float(np.abs(g2[k] - g).max()) / scale <= 1e-5, k


def test_two_ranks_match_the_jax_step(two_ranks):
    """The JAX package's make_train_step with optax.sgd(1e-3) on the same
    batch and weights: the loss and the updated parameters."""
    cfg = dry.det_config()
    jcfg = jpp.PointPillarsConfig(**{f: getattr(cfg, f)
                                     for f in cfg.__dataclass_fields__})
    params = tpp.init_params(cfg, torch.Generator().manual_seed(7))
    pts, valid, gts = dry.det_batch(cfg, 2)
    step, init = jdt.make_train_step(jcfg, jpp.generate_anchors(jcfg),
                                     optax.sgd(1e-3))
    with pytest.MonkeyPatch.context() as mp:
        eager_assign_patch(mp)
        state, m = jax.jit(step)(
            init({k: jnp.asarray(v.numpy()) for k, v in params.items()}),
            jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(gts))
    got_m, got_sd, _ = two_ranks[1]
    np.testing.assert_allclose(got_m["loss"], float(m["loss"]), rtol=1e-5)
    for k, v in state.params.items():
        np.testing.assert_allclose(got_sd[k], np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_bn_on_reduced_sums_equals_plain(masked):
    """`_bn_train(reduce=...)` (data parallelism's path: sums, sums of
    squares and counts reduced before the moments) against the plain
    path, with one rank's reduction (the identity)."""
    rng = np.random.default_rng(int(masked))
    norm = torch.nn.BatchNorm1d(6)
    with torch.no_grad():
        norm.weight.copy_(torch.as_tensor(rng.normal(1, 0.1, 6)))
        norm.bias.copy_(torch.as_tensor(rng.normal(0, 0.1, 6)))
        norm.running_mean.copy_(torch.as_tensor(rng.normal(0, 1, 6)))
        norm.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2, 6)))
    x = torch.as_tensor(rng.normal(0.3, 2.0, (3, 40, 6)), dtype=torch.float32)
    mask = (torch.as_tensor(rng.uniform(size=(3, 40, 1))) > 0.3
            if masked else None)
    want = tpp._bn_train(x, norm, -1, mask)
    got = tpp._bn_train(x, norm, -1, mask, reduce=lambda t: t)
    scale = float(want[0].detach().abs().max())
    assert float((got[0] - want[0]).abs().max()) <= 1e-6 * scale
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-6


def _cli(tmp_path, out, capfd, *extra):
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(TINY_YAML)
    argv = ["--synthetic", "4", "--steps", "2", "--batch", "2",
            "--max-points", "512", "--max-gt", "8", "--config", str(yaml),
            "--out", str(tmp_path / out), "--save-every", "1",
            "--dtype", "float32", "--log-every", "1", "--seed", "3",
            "--device", "cpu", *extra]
    assert ttrain.main(argv) == 0
    return capfd.readouterr().err


def _loss(err: str, step: int) -> float:
    return float(re.search(rf"step {step}/\d+ loss=([0-9.]+)", err)[1])


def test_train_cli_dp_devices(tmp_path, capfd):
    """--dp-devices 2 trains on two ranks (stderr says so), its first loss
    is the one-process run's, and a two-rank --resume replays the straight
    two-rank run byte for byte; a rank count that does not divide the
    batch runs one process and says why."""
    one = _cli(tmp_path, "one", capfd)
    assert "not data-parallel (one rank)" in one
    dp = _cli(tmp_path, "dp", capfd, "--dp-devices", "2")
    assert "data-parallel over 2 ranks (gloo" in dp
    np.testing.assert_allclose(_loss(dp, 1), _loss(one, 1), rtol=1e-4)
    _cli(tmp_path, "part", capfd, "--dp-devices", "2", "--limit-steps", "1")
    res = _cli(tmp_path, "part", capfd, "--dp-devices", "2", "--resume")
    assert "resumed" in res and "step 2/2" in res and "step 1/2" not in res
    with np.load(tmp_path / "dp" / "ckpt_0000002.npz") as a, \
            np.load(tmp_path / "part" / "ckpt_0000002.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    odd = _cli(tmp_path, "odd", capfd, "--dp-devices", "3", "--steps", "1")
    assert "not data-parallel (batch 2 does not divide over 3 ranks)" in odd
