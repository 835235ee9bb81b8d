"""The port's detector training pieces (`lidar_snow_sim_tpu_torch.models.
{pointpillars,detector_train,detector_augment}`) against the JAX package
on the CPU, at tests/test_pointpillars.TINY (2 classes, 16-channel PFN,
1/1/1 layers, 128 pillars, 1,024 anchors).

Inputs and weights come from numpy seeds or `jax.random` keys and reach
both packages as numpy arrays. The JAX package's `assign_targets` runs op
by op (`jax.disable_jit()`): under jax.jit on XLA's CPU backend its
rotated IoU departs from the float64 oracle, and the labels with it
(`test_jax_jitted_assignment_departs`). Everything else of the JAX side is
jitted, with the targets handed in.

Tolerances:
- assignment: labels and weights equal, except anchors whose decision
  lies within 1e-6 of its threshold (chip_smoke.py's `_near_assignment`:
  the two packages' IoUs differ by up to ~1e-7, so a near-tie force-match
  may go either way), regression targets within 1e-6 absolute where the
  labels agree (log rounds differently);
- each loss and the total: 1e-6 relative;
- train-mode BN: outputs within 1e-6 of their largest value (float32;
  4 bf16 ulps of it in bfloat16), running stats within 1e-6 absolute;
- train_forward's maps and BN stats, and each gradient, float32: 1e-5
  relative to the largest value of the map or gradient; bfloat16 maps: 4
  bf16 ulps of the largest value;
- one (two) Adam steps: 1e-6 relative;
- the LR schedule: 1e-6 of the peak LR (optax computes it in float32);
- world_augment on JAX's draws: 1e-5 absolute (cos and sin round
  differently);
- GTSampleDB.build and sample_into: byte for byte.
"""

import dataclasses
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lidar_snow_sim_tpu.models import detector_augment as jaug
from lidar_snow_sim_tpu.models import detector_train as jdt
from lidar_snow_sim_tpu.models import pointpillars as jpp
from lidar_snow_sim_tpu.utils import eval_ap as jeval
from lidar_snow_sim_tpu_torch.models import detector_augment as taug
from lidar_snow_sim_tpu_torch.models import detector_train as tdt
from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
from lidar_snow_sim_tpu_torch.tools import train as ttrain
from lidar_snow_sim_tpu_torch.utils import eval_ap as teval
from tests.test_pointpillars import TINY as JTINY

TTINY = tpp.PointPillarsConfig(**{f.name: getattr(JTINY, f.name)
                                  for f in dataclasses.fields(JTINY)})
ANCHORS = jpp.generate_anchors(JTINY).reshape(-1, 7)
SMOKE = runpy.run_path(str(Path(__file__).parents[1] / "chip_smoke.py"),
                       run_name="chip_smoke_gate")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_assign_eager(anchors, gt, cfg):
    """The JAX package's assign_targets op by op, as numpy arrays."""
    with jax.disable_jit():
        out = jdt.assign_targets(jnp.asarray(anchors), jnp.asarray(gt), cfg)
    return tuple(np.asarray(x) for x in out)


def eager_assign_patch(monkeypatch):
    """Replace the JAX package's assign_targets by a host callback that
    runs it op by op, so a jitted JAX train step (the JAX CLI's) assigns
    as the op-by-op reference does."""
    orig = jdt.assign_targets

    def host(anchors, gt, cfg):
        n = anchors.shape[0]
        shapes = (jax.ShapeDtypeStruct((n,), jnp.int32),
                  jax.ShapeDtypeStruct((n, 7), jnp.float32),
                  jax.ShapeDtypeStruct((n,), jnp.float32))

        def cb(a, g):
            with jax.disable_jit():
                return tuple(np.asarray(x) for x in orig(
                    jnp.asarray(a), jnp.asarray(g), cfg))

        return jax.pure_callback(cb, shapes, anchors, gt,
                                 vmap_method="sequential")

    monkeypatch.setattr(jdt, "assign_targets", host)


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _cloud(rng, n):
    return np.column_stack([
        rng.uniform(-2, 18, n), rng.uniform(-10, 10, n),
        rng.uniform(-4, 2, n), rng.uniform(0, 1, n),
    ]).astype(np.float32)


def _random_gt(rng, g=8):
    """(g, 8) gt rows: 1..g boxes of random class, the rest padding."""
    gt = np.zeros((g, 8), np.float32)
    k = int(rng.integers(1, g + 1))
    gt[:k, 0] = rng.uniform(0, 16, k)
    gt[:k, 1] = rng.uniform(-8, 8, k)
    gt[:k, 2] = rng.uniform(-2, 0, k)
    gt[:k, 3] = rng.uniform(0.5, 5, k)
    gt[:k, 4] = rng.uniform(0.4, 2, k)
    gt[:k, 5] = rng.uniform(1, 2, k)
    gt[:k, 6] = rng.uniform(-np.pi, np.pi, k)
    gt[:k, 7] = rng.integers(1, 3, k)
    return gt


def _crafted_gt():
    """Force-matches and ties: a gt equal to a car anchor (IoU 1), the same
    gt twice (each anchor tied between two gts), a tiny pedestrian between
    cells (best IoU under the threshold, force-matched), a car-class box
    on pedestrian anchors only, a gt outside the range (gt_max 0: no force
    match), and padding rows."""
    gt = np.zeros((8, 8), np.float32)
    gt[0, :7], gt[0, 7] = ANCHORS[400], 1
    gt[1] = gt[2] = [8.0, -3.0, -1.0, 4.0, 1.8, 1.6, 0.7, 1]
    gt[3] = [5.27, 1.13, -0.5, 0.4, 0.3, 1.0, 0.3, 2]
    gt[4] = [12.0, 5.0, -0.5, 0.8, 0.6, 1.7, 0.0, 1]
    gt[5] = [40.0, 30.0, -1.0, 4.0, 1.8, 1.6, 0.0, 1]
    return gt


def _hold_assignment(got, want, gt):
    """Labels and weights equal off the decision boundaries, targets within
    1e-6 where the labels agree; returns the boundary flips."""
    near = SMOKE["_near_assignment"](_t(ANCHORS), _t(gt), TTINY, tol=1e-6)
    flips, unexplained = SMOKE["_label_flips"](got[0], _t(want[0]), near)
    assert unexplained == 0, (flips, unexplained)
    same = got[0].numpy() == want[0]
    np.testing.assert_array_equal(got[2].numpy()[same], want[2][same])
    np.testing.assert_allclose(got[1].numpy()[same], want[1][same], rtol=0,
                               atol=1e-6)
    return flips


@pytest.mark.parametrize("case", ["crafted", "empty", *range(8)])
def test_assign_targets_matches_jax(case):
    if case == "crafted":
        gt = _crafted_gt()
    elif case == "empty":
        gt = np.zeros((8, 8), np.float32)
    else:
        gt = _random_gt(np.random.default_rng(case))
    want = jax_assign_eager(ANCHORS, gt, JTINY)
    got = tdt.assign_targets(_t(ANCHORS), _t(gt), TTINY)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.float32
    flips = _hold_assignment(got, want, gt)
    # seed 6 holds a force-match tie whose IoUs differ by 2 ulps between
    # the packages (0.15768492 vs 0.1576849): one anchor flips there
    assert flips == (1 if case == 6 else 0)
    labels = got[0].numpy()
    if case == "crafted":
        assert labels[400] == 1 and (labels == 2).sum() >= 1
        assert (labels == -1).sum() > 0
    if case == "empty":
        assert (labels == 0).all()


def test_assign_batch_stacks_frames():
    rng = np.random.default_rng(9)
    gts = np.stack([_random_gt(rng), _crafted_gt()])
    labels, reg_t, reg_w = tdt.assign_batch(_t(ANCHORS), _t(gts), TTINY)
    assert labels.shape == (2, len(ANCHORS)) and reg_t.shape[-1] == 7
    for b in range(2):
        one = tdt.assign_targets(_t(ANCHORS), _t(gts[b]), TTINY)
        for x, y in zip((labels[b], reg_t[b], reg_w[b]), one):
            assert torch.equal(x, y)


def test_jax_jitted_assignment_departs():
    """The reference fault on this slice's paths: jitted on XLA's CPU
    backend, the JAX package's assign_targets and eval_ap._pair_overlaps
    meet its rotated IoU's departure from the float64 oracle. On these
    seeded boxes, jitted against op by op, some labels and some overlaps
    past a KITTI threshold differ (jax 0.9.0; 28 labels over 20 frames and
    8 threshold flips in a wider sweep), while the port equals the op-by-op
    values. Should this test fail because jit agrees, the reference may
    run jitted again."""
    jitted = jax.jit(lambda g: jdt.assign_targets(jnp.asarray(ANCHORS), g,
                                                  JTINY))
    label_diffs = 0
    for seed in range(8):
        gt = _random_gt(np.random.default_rng(seed))
        eager = jax_assign_eager(ANCHORS, gt, JTINY)
        label_diffs += int((np.asarray(jitted(jnp.asarray(gt))[0])
                            != eager[0]).sum())
        _hold_assignment(tdt.assign_targets(_t(ANCHORS), _t(gt), TTINY),
                         eager, gt)
    assert label_diffs > 0

    flips = 0
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        n, m = 10, 30
        gtb = np.column_stack([
            rng.uniform(0, 40, n), rng.uniform(-10, 10, n),
            rng.uniform(-1, 1, n), rng.uniform(3, 5, n),
            rng.uniform(1.5, 2, n), rng.uniform(1.4, 1.8, n),
            rng.uniform(-np.pi, np.pi, n)])
        dtb = gtb[rng.integers(0, n, m)] + np.column_stack([
            rng.normal(0, 0.5, (m, 2)), rng.normal(0, 0.1, (m, 1)),
            rng.normal(0, 0.2, (m, 3)), rng.normal(0, 0.2, (m, 1))])
        for metric in ("bev", "3d"):
            jit_ov = jeval._pair_overlaps(gtb, dtb, metric)
            with jax.disable_jit():
                eager = jeval._pair_overlaps(gtb, dtb, metric)
            port = teval._pair_overlaps(gtb, dtb, metric, "cpu")
            np.testing.assert_allclose(port, eager, rtol=0, atol=1e-5)
            for t in (0.5, 0.7):
                flips += int(((jit_ov > t) != (eager > t)).sum())
                assert ((port > t) == (eager > t)).all()
    assert flips > 0


# ---------------------------------------------------------------------------
# losses


def _loss_inputs(seed, b=2, n=1024):
    rng = np.random.default_rng(seed)
    cls = rng.normal(0, 2, (b, n, 2)).astype(np.float32)
    box = rng.normal(0, 0.5, (b, n, 7)).astype(np.float32)
    dir_ = rng.normal(0, 1, (b, n, 2)).astype(np.float32)
    labels = rng.choice([-1, 0, 0, 0, 1, 2], (b, n)).astype(np.int32)
    pos = (labels > 0).astype(np.float32)
    reg_t = (rng.normal(0, 0.5, (b, n, 7)) * pos[..., None]).astype(
        np.float32)
    return cls, box, dir_, labels, reg_t, pos


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(seed):
    cls, box, dir_, labels, reg_t, pos = _loss_inputs(seed)
    want_loss, want = jax.jit(lambda *a: jdt.detection_loss(
        *a, jnp.asarray(ANCHORS), JTINY))(cls, box, dir_, labels, reg_t, pos)
    got_loss, got = tdt.detection_loss(
        *map(_t, (cls, box, dir_, labels, reg_t, pos)), _t(ANCHORS), TTINY)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    # the pieces
    one_hot = np.eye(3, dtype=np.float32)[np.clip(labels, 0, None)][..., 1:]
    w = np.random.default_rng(seed).uniform(0, 1, labels.shape).astype(
        np.float32)
    np.testing.assert_allclose(
        tdt.sigmoid_focal_loss(_t(cls), _t(one_hot), _t(w)).numpy(),
        np.asarray(jdt.sigmoid_focal_loss(cls, one_hot, w)),
        rtol=1e-6, atol=1e-7)
    diff = box - reg_t
    np.testing.assert_allclose(tdt.smooth_l1(_t(diff)).numpy(),
                               np.asarray(jdt.smooth_l1(diff)),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# train-mode batch norm, train forward, gradients


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_bn_matches_jax(masked, dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, (2, 40, 8, 16)).astype(np.float32)
    mask = (rng.uniform(size=(2, 40)) < 0.6)[..., None, None] if masked \
        else None
    p = {"n.weight": rng.uniform(0.5, 1.5, 16).astype(np.float32),
         "n.bias": rng.normal(0, 0.1, 16).astype(np.float32),
         "n.running_mean": rng.normal(0, 0.1, 16).astype(np.float32),
         "n.running_var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    stats = {}
    want = jpp._bn(jnp.asarray(x, jd), {k: jnp.asarray(v) for k, v in
                                        p.items()}, "n", train=True,
                   stats=stats, mask=None if mask is None
                   else jnp.asarray(mask))
    norm = torch.nn.BatchNorm1d(16, eps=1e-3, momentum=0.01)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(norm, k).copy_(_t(p[f"n.{k}"]))
    y, rm, rv = tpp._bn_train(_t(x).to(td), norm, dim=-1,
                              mask=None if mask is None else _t(mask))
    assert y.dtype == td
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    atol = (1e-6 if dtype == "float32" else 4 * 2.0**-7) * scale
    np.testing.assert_allclose(y.float().detach().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(rm.numpy(), np.asarray(
        stats["n.running_mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rv.numpy(), np.asarray(
        stats["n.running_var"]), rtol=0, atol=1e-6)
    assert torch.equal(norm.running_mean, _t(p["n.running_mean"]))


def _batch(seed, b=2, n=600):
    rng = np.random.default_rng(seed)
    pts = np.stack([_cloud(rng, n) for _ in range(b)])
    valid = rng.uniform(size=(b, n)) > 0.05
    gt = np.stack([_crafted_gt(), _random_gt(rng)])[:b]
    return pts, valid, gt


@pytest.fixture(scope="module")
def params():
    return {k: np.array(v) for k, v in jax.jit(
        lambda key: jpp.init_params(JTINY, key))(
        jax.random.PRNGKey(0)).items()}


def _jax_value_and_grad(params, pts, valid, gt, cfg):
    """The JAX package's loss, maps, stats and gradients: the targets op by
    op, the rest jitted."""
    targets = [jax_assign_eager(ANCHORS, g, cfg) for g in gt]
    labels, reg_t, reg_w = (np.stack(t) for t in zip(*targets))

    def loss_fn(p):
        cls, box, dir_, stats = jdt.train_forward(pts, valid, p, cfg)
        loss, _ = jdt.detection_loss(cls, box, dir_, labels, reg_t, reg_w,
                                     jnp.asarray(ANCHORS), cfg)
        return loss, (cls, box, dir_, stats)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()})


def _close(got, want, rel, name):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{name}: {err} of {scale}"


@pytest.mark.parametrize("seed", [0, 1])
def test_train_forward_and_gradients_match_jax(params, seed):
    pts, valid, gt = _batch(seed)
    (want_loss, (jcls, jbox, jdir, jstats)), jgrads = _jax_value_and_grad(
        params, pts, valid, gt, JTINY)
    net = tpp.PointPillars(TTINY, params, device="cpu")
    with tpp._true_float32():
        cls, box, dir_, stats = tpp.train_forward(pts, valid, net, "cpu")
        labels, reg_t, reg_w = tdt.assign_batch(_t(ANCHORS), _t(gt), TTINY)
        loss, _ = tdt.detection_loss(cls, box, dir_, labels, reg_t, reg_w,
                                     _t(ANCHORS), TTINY)
        loss.backward()
    assert cls.shape == (2, len(ANCHORS), 2) and box.shape[-1] == 7
    for name, got, want in (("cls", cls, jcls), ("box", box, jbox),
                            ("dir", dir_, jdir)):
        _close(got.detach().numpy(), want, 1e-5, name)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        _close(stats[k].numpy(), v, 1e-5, k)
    learn = dict(net.named_parameters())
    for k, g in jgrads.items():
        if k in learn:
            _close(learn[k].grad.numpy(), g, 1e-5, k)
        else:   # the running stats: no gradient in either package
            assert float(jnp.abs(g).max()) == 0.0, k
    assert set(learn) | set(stats) == set(jgrads)
    # the stats are returned, not written
    for k in stats:
        assert np.array_equal(net.get_buffer(k).numpy(), params[k])


def test_train_forward_bfloat16_matches_jax(params):
    jcfg = dataclasses.replace(JTINY, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(TTINY, compute_dtype="bfloat16")
    pts, valid, _ = _batch(2)
    want = jax.jit(lambda p, v: jdt.train_forward(
        p, v, {k: jnp.asarray(x) for k, x in params.items()}, jcfg))(
        pts, valid)
    net = tpp.PointPillars(tcfg, params, device="cpu")
    with torch.no_grad():
        got = tpp.train_forward(pts, valid, net, "cpu")
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float32
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=4 * 2.0**-7 * float(np.abs(w).max()))
    for k, v in want[3].items():   # float32 statistics of bf16 activations
        _close(got[3][k].numpy(), v, 2.0**-7, k)


def test_train_step_commits_stats_and_steps_adam(params):
    """make_train_step: forward, loss, backward, Adam at schedule(step),
    then the running stats; the JAX package's step from the same state
    gives the same loss, parameters and stats."""
    pts, valid, gt = _batch(4)
    lrs = []
    step, init = tdt.make_train_step(
        TTINY, ANCHORS, lambda it: lrs.append(it) or 1e-3 * (it + 1))
    state = init(tpp.PointPillars(TTINY, params, device="cpu"))
    lrs.clear()
    state, m = step(state, _t(pts), _t(valid), _t(gt))
    state, m2 = step(state, _t(pts), _t(valid), _t(gt))
    assert state.step == 2 and lrs == [0, 1]
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(2e-3)

    def sched(count):
        return 1e-3 * (count + 1)

    jstep, jinit = jdt.make_train_step(JTINY, jpp.generate_anchors(JTINY),
                                       optax.adam(sched))
    eager_pts = [jnp.asarray(x) for x in (pts, valid, gt)]
    with pytest.MonkeyPatch.context() as mp:
        eager_assign_patch(mp)
        jstate = jinit({k: jnp.asarray(v) for k, v in params.items()})
        jstep = jax.jit(jstep)
        jstate, jm = jstep(jstate, *eager_pts)
        jstate, jm2 = jstep(jstate, *eager_pts)
    for k in ("loss", "loss_cls", "loss_loc", "loss_dir", "num_pos"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
        np.testing.assert_allclose(float(m2[k]), float(jm2[k]), rtol=1e-4)
    sd = state.net.state_dict()
    for k, v in jstate.params.items():
        _close(sd[k].numpy(), v, 1e-4, k)


def test_adam_step_matches_optax():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(0, 1, (5, 3)).astype(np.float32),
          "b": rng.normal(0, 1, 7).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(2)]
    opt = optax.adam(2e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(jp)
    for g in grads:
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                             jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    net = torch.nn.Module()
    for k, v in tp.items():
        net.register_parameter(k, v)
    topt = tdt.make_adam(net, 2e-3)
    for g in grads:
        for k, v in tp.items():
            v.grad = _t(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    mu, nu = st[0].mu, st[0].nu
    for k in p0:
        s = topt.state[tp[k]]
        assert int(s["step"]) == int(st[0].count) == 2
        np.testing.assert_allclose(s["exp_avg"].numpy(), np.asarray(mu[k]),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(s["exp_avg_sq"].numpy(),
                                   np.asarray(nu[k]), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("total,peak", [(100, 3e-3), (4, 3e-3), (37, 1e-2)])
def test_onecycle_schedule_matches_optax(total, peak):
    step = jax.jit(optax.cosine_onecycle_schedule(
        transition_steps=total, peak_value=peak, pct_start=0.4,
        div_factor=10.0, final_div_factor=1000.0))
    got = ttrain.make_schedule(total, peak)
    for it in range(total + 3):
        # as a Python int and as the int32 count optax.adam passes inside
        # its jitted update; both are computed in float32
        for count in (it, jnp.int32(it)):
            np.testing.assert_allclose(got(it), float(step(count)), rtol=0,
                                       atol=1e-6 * peak)
    assert got(0) == pytest.approx(peak / 10)
    assert got(int(0.4 * total)) == pytest.approx(peak)


def test_schedule_below_four_steps_is_constant():
    for total in (1, 2, 3):
        got = ttrain.make_schedule(total, 3e-3)
        want = optax.constant_schedule(3e-3)
        assert [got(i) for i in range(total)] == [
            pytest.approx(float(want(i))) for i in range(total)]


# ---------------------------------------------------------------------------
# augmentor


def test_world_augment_on_jax_draws():
    rng = np.random.default_rng(1)
    pts = np.stack([_cloud(rng, 300) for _ in range(4)])
    gt = np.stack([_random_gt(rng) for _ in range(4)])
    cfg = jaug.WorldAugmentConfig()
    key = jax.random.PRNGKey(7)
    want_p, want_g = jax.jit(jaug.world_augment)(key, pts, gt)
    # the JAX package's own draws (world_augment's first lines)
    kf, kr, ks = jax.random.split(key, 3)
    flip = jax.random.bernoulli(kf, 0.5, (4,))
    angle = jax.random.uniform(kr, (4,), minval=-cfg.rot_range,
                               maxval=cfg.rot_range)
    scale = jax.random.uniform(ks, (4,), minval=cfg.scale_min,
                               maxval=cfg.scale_max)
    got_p, got_g = taug.world_augment(_t(pts), _t(gt), _t(flip), _t(angle),
                                      _t(scale))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5)
    assert (got_g[..., 7] == _t(gt)[..., 7]).all()


def test_world_draws_are_seeded_and_in_range():
    cfg = taug.WorldAugmentConfig()
    a = taug.world_draws(torch.Generator().manual_seed(5), 256, cfg)
    b = taug.world_draws(torch.Generator().manual_seed(5), 256, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    flip, angle, scale = a
    assert flip.dtype == torch.bool and 0 < int(flip.sum()) < 256
    assert float(angle.abs().max()) <= cfg.rot_range
    assert cfg.scale_min <= float(scale.min()) <= float(scale.max()) <= \
        cfg.scale_max
    no_flip = taug.world_draws(torch.Generator().manual_seed(5), 8,
                               taug.WorldAugmentConfig(flip_x=False))[0]
    assert not no_flip.any()
    assert ttrain.step_seed(0, 3) == ttrain.step_seed(0, 3) != \
        ttrain.step_seed(0, 4)


def _db_corpus(tmp_path):
    from lidar_snow_sim_tpu_torch.utils.pointcloud import save_velodyne_bin

    scans, labels = tmp_path / "scans", tmp_path / "labels"
    scans.mkdir()
    labels.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        pc = np.zeros((500, 5), np.float32)
        pc[:, 0] = rng.uniform(0, 16, 500)
        pc[:, 1] = rng.uniform(-8, 8, 500)
        pc[:, 2] = rng.uniform(-3, 1, 500)
        pc[:, 3] = rng.uniform(0, 255, 500)
        cx = 3.0 + 3.0 * i
        pc[:80, 0] = rng.uniform(cx - 1.5, cx + 1.5, 80)
        pc[:80, 1] = rng.uniform(-0.7, 0.7, 80)
        pc[:80, 2] = rng.uniform(-1.9, -0.5, 80)
        pc[80:100, 0] = rng.uniform(cx - 0.3, cx + 0.3, 20)
        pc[80:100, 1] = rng.uniform(4.7, 5.3, 20)
        pc[80:100, 2] = rng.uniform(-1.5, 0.0, 20)
        save_velodyne_bin(pc, scans / f"{i:06d}.bin")
        (labels / f"{i:06d}.txt").write_text(
            f"Car 0 0 0 0 0 50 50 1.56 1.6 3.9 {cx} 0.0 -1.9 0.0\n"
            f"Pedestrian 0 0 0 0 0 50 50 1.7 0.6 0.8 {cx} 5.0 -1.6 0.3\n"
            "Tram 0 0 0 0 0 50 50 2.0 2.0 8.0 4.0 2.0 -1.9 0.0\n"
        )
    return scans, labels


def test_gt_sample_db_byte_for_byte(tmp_path):
    scans, labels = _db_corpus(tmp_path)
    classes = ("Car", "Pedestrian")
    want = jaug.GTSampleDB.build(scans, labels, classes, min_points=5)
    got = taug.GTSampleDB.build(scans, labels, classes, min_points=5)
    assert got.stats() == want.stats() and sum(got.stats().values()) > 0
    for name, entries in want.entries.items():
        for (wb, wp), (gb, gp) in zip(entries, got.entries[name]):
            assert wb.tobytes() == gb.tobytes() and wp.tobytes() == gp.tobytes()
    name_to_id = {"Car": 1, "Pedestrian": 2}
    rng = np.random.default_rng(3)
    for frame in range(3):
        pts = _cloud(rng, 256)
        pts[200:, :3] = 1e3
        gt = np.zeros((6, 8), np.float32)
        gt[0] = [9.0, 0.0, -1.1, 3.9, 1.6, 1.56, 0.0, 1]
        groups = taug.parse_sample_groups("Car:3, Pedestrian:2")
        assert groups == jaug.parse_sample_groups("Car:3, Pedestrian:2")
        w = want.sample_into(np.random.default_rng((1, frame)), pts, gt,
                             groups, name_to_id)
        g = got.sample_into(np.random.default_rng((1, frame)), pts, gt,
                            groups, name_to_id)
        assert w[2] == g[2] and g[2] > 0
        assert w[0].tobytes() == g[0].tobytes()
        assert w[1].tobytes() == g[1].tobytes()
