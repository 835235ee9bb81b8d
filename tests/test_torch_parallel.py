"""The port's multi-device layer (`lidar_snow_sim_tpu_torch.parallel.
{mesh,batched,datagen,distributed}`, `tools/precompute.py --mesh`) against
the JAX package's `parallel` on the CPU: meshes over ["cpu", "cpu"] in the
port, tests/conftest.py's virtual CPU devices in JAX.

Tolerances:
- the port's sharded steps and mesh datagen against its unsharded ones:
  byte for byte (each frame runs the same code on one device);
- the port's sharded step against the JAX package's `make_sharded_step`:
  as tests/test_torch_snowfall.py holds the batched steps, labels, keep
  flags and all five counters equal frame by frame, on the JAX draws;
- `DatagenStats`' steady rates, the mesh errors and `all_hosts_stats`:
  exact; the JAX version's float32 sum is pinned where it rounds.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.models.snowfall import calib_device_arrays
from lidar_snow_sim_tpu.parallel import datagen as jdatagen
from lidar_snow_sim_tpu.parallel import mesh as jmesh
from lidar_snow_sim_tpu.sampling.banks import ParticleBank as JaxParticleBank
from lidar_snow_sim_tpu_torch import (
    SnowfallConfig,
    build_bank,
    load_hdl64_calib,
    synthetic_scan,
)
from lidar_snow_sim_tpu_torch import _kernels
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.parallel import batched as tbatched
from lidar_snow_sim_tpu_torch.parallel import distributed as tdist
from lidar_snow_sim_tpu_torch.parallel import mesh as tmesh
from lidar_snow_sim_tpu_torch.parallel.datagen import (
    DatagenStats,
    run_snowfall_datagen,
)
from lidar_snow_sim_tpu_torch.tools import precompute
from tests import _torch_dist_worker as worker
from tests.test_torch_snowfall import COUNTERS, _batch, _jax_cfg

CPU2 = ["cpu", "cpu"]
SMALL = SnowfallConfig(
    max_points=4096, window_size=128, wide_capacity=32, max_occluders=16,
    max_bumps=8, point_chunk=512, ransac_trials=16, assembly="dense",
    channel_capacity=128, block_points=32, slice_width=256,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fov_batch():
    return _batch("fov")


@pytest.fixture(scope="module")
def small_bank():
    rng = np.random.default_rng(7)
    sets = []
    for _ in range(64):
        ang = rng.uniform(0, 2 * np.pi, 200)
        d = np.sqrt(rng.uniform(0.01, 1, 200)) * 60
        r = rng.uniform(0.005, 0.05, 200)
        sets.append(np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))
    return build_bank(sets, window_size=128, wide_capacity=32)


@pytest.fixture(scope="module")
def scans():
    calib = load_hdl64_calib()
    return {f"f{i}": synthetic_scan(n_azimuth=60, seed=i, calib=calib)[:4096]
            for i in range(4)}


# ---- mesh -------------------------------------------------------------------


def test_make_mesh_shapes_and_errors():
    """make_mesh's shape dict and its too-few-devices error are the JAX
    package's; an explicit device list may repeat a device."""
    want = jmesh.make_mesh(data=4, beam=2)
    got = tmesh.make_mesh(data=4, beam=2, devices=["cpu"] * 8)
    assert got.shape == dict(want.shape) == {"data": 4, "beam": 2}
    assert got.axis_names == want.axis_names
    assert got.flat == [torch.device("cpu")] * 8
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(data=16, beam=2)
    with pytest.raises(ValueError) as terr:
        tmesh.make_mesh(data=16, beam=2, devices=["cpu"] * 8)
    assert str(terr.value) == str(jerr.value)
    # the default takes the cards, and there are none here
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        tmesh.make_mesh()


@pytest.mark.parametrize("batch,shards,want", [
    (4, 2, [(0, 2), (2, 4)]),
    (5, 2, [(0, 3), (3, 5)]),
    (2, 4, [(0, 1), (1, 2)]),     # devices without a frame are left out
])
def test_shard_and_gather_frames(batch, shards, want):
    mesh = tmesh.make_mesh(shards, 1, devices=["cpu"] * shards)
    parts = tmesh.shard_frames(mesh, batch)
    assert [(f.start, f.stop) for _, f in parts] == want
    x = torch.arange(batch * 3).reshape(batch, 3)
    res = ts.CalibTensors(*([x] * 5))
    got = tmesh.gather_frames(
        [ts.CalibTensors(*([x[f]] * 5)) for _, f in parts], "cpu")
    assert type(got) is ts.CalibTensors
    assert all(torch.equal(a, b) for a, b in zip(got, res))
    assert torch.equal(tmesh.gather_frames([(x[f],) for _, f in parts],
                                           "cpu")[0], x)


def test_run_shards_in_order_with_the_device_current(monkeypatch):
    """Shards run in frame order from the calling thread, each inside
    torch.cuda.device(its card) (no context for the CPU); a shard's
    exception reaches the caller."""
    entered = []

    class FakeDevice:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(str(self.dev))

        def __exit__(self, *exc):
            entered.append("exit")

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    mesh = tmesh.make_mesh(1, 3, devices=["cpu", "cuda:1", "cuda:0"])
    seen = []

    def fn(dev, f):
        seen.append((str(dev), f.start, threading.get_ident()))
        return f.start

    assert tmesh.run_shards(mesh, 5, fn) == [0, 2, 4]
    assert [(d, f) for d, f, _ in seen] == [("cpu", 0), ("cuda:1", 2),
                                            ("cuda:0", 4)]
    assert {t for _, _, t in seen} == {threading.get_ident()}
    assert entered == ["cuda:1", "exit", "cuda:0", "exit"]

    def bad(dev, f):
        raise KeyError(f.start)

    with pytest.raises(KeyError):
        tmesh.run_shards(mesh, 5, bad)


# ---- sharded steps ----------------------------------------------------------


def _port_args(batch):
    pc, sets, base, points, mask, orders, _, draws = batch
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    return (torch.as_tensor(points), torch.as_tensor(mask),
            ts.bank_to_torch(bank, "cpu"),
            ts.calib_to_torch(load_hdl64_calib(), "cpu"),
            torch.as_tensor(orders), (torch.as_tensor(draws), None))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_sharded_step_equals_unsharded(fov_batch, shape):
    cfg = SnowfallConfig(**fov_batch[2])
    args = _port_args(fov_batch)
    want, _ = tbatched.batched_step(*args, cfg)
    mesh = tmesh.make_mesh(*shape, devices=CPU2)
    got, wet = tbatched.make_sharded_step(mesh, cfg)(*args)
    assert wet is None
    for name in ts.SnowfallResult._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_sharded_step_matches_jax(fov_batch):
    """The port's sharded step against the JAX package's make_sharded_step
    on a (2, 1) mesh of virtual CPU devices, on the JAX draws."""
    from lidar_snow_sim_tpu.parallel.batched import make_sharded_step

    pc, sets, base, points, mask, orders, keys, _ = fov_batch
    cfg = SnowfallConfig(**base)
    got, _ = tbatched.make_sharded_step(
        tmesh.make_mesh(2, 1, devices=CPU2), cfg)(*_port_args(fov_batch))
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    want = jax.device_get(make_sharded_step(
        jmesh.make_mesh(2, 1), _jax_cfg(cfg))(
        jnp.asarray(points), jnp.asarray(mask),
        jax.device_put(JaxParticleBank(*bank)),
        calib_device_arrays(load_hdl64_calib()),
        jnp.asarray(orders, jnp.int32), keys)[0])
    n = len(pc)
    for f in range(2):
        for name in COUNTERS:
            assert int(getattr(got, name)[f]) == \
                int(getattr(want, name)[f]) == 0, (f, name)
        np.testing.assert_array_equal(got.planes[f, 4, :n].numpy(),
                                      np.asarray(want.planes)[f, 4, :n])
        np.testing.assert_array_equal(got.keep[f, :n].numpy(),
                                      np.asarray(want.keep)[f, :n])


def test_sharded_packed_step_equals_unsharded(fov_batch, monkeypatch):
    """make_sharded_packed_step gives datagen_packed_step's planes and
    meta byte for byte, and copies the bank to each device once."""
    pc, sets, base, points, _, orders, _, _ = fov_batch
    cfg = SnowfallConfig(**base)
    bank = ts.bank_to_torch(build_bank(sets, window_size=256,
                                       wide_capacity=64), "cpu")
    calib = ts.calib_to_torch(load_hdl64_calib(), "cpu")
    n = len(pc)
    meta = torch.zeros((3, 3 + 64), dtype=torch.int32)
    meta[:, 0] = torch.tensor([n, n, 0])
    meta[:, 2] = torch.tensor([5, 6, 7])
    meta[:, 3:] = torch.as_tensor(np.stack([orders[0], orders[1],
                                            orders[0]]))
    pts = torch.as_tensor(np.stack([points[0]] * 3)[..., :4]).contiguous()
    chan = torch.as_tensor(np.stack([points[0]] * 3)[..., 4]).to(
        torch.uint8)
    want = tbatched.datagen_packed_step(pts, chan, meta, bank, calib, cfg,
                                        out_points=4096)
    copies = []
    orig = ts.BankTensors.to
    monkeypatch.setattr(ts.BankTensors, "to", lambda self, d: copies.append(
        str(d)) or orig(self, d))
    step = tbatched.make_sharded_packed_step(
        tmesh.make_mesh(2, 1, devices=CPU2), cfg, out_points=4096)
    for _ in range(2):
        got = step(pts, chan, meta, bank, calib)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert copies == ["cpu"]   # one (bank, device) pair, copied once


# ---- datagen ----------------------------------------------------------------


def test_mesh_datagen_matches_unsharded(tmp_path, small_bank, scans):
    calib = load_hdl64_calib()
    kw = dict(batch=4, seed=0, shuffle_channels=False)
    s1 = run_snowfall_datagen(sorted(scans), scans.__getitem__,
                              tmp_path / "plain", small_bank, calib, SMALL,
                              device="cpu", **kw)
    mesh = tmesh.make_mesh(2, 1, devices=CPU2)
    s2 = run_snowfall_datagen(sorted(scans), scans.__getitem__,
                              tmp_path / "mesh", small_bank, calib, SMALL,
                              mesh=mesh, **kw)
    assert s1.frames_done == s2.frames_done == 4
    assert s1.attenuated == s2.attenuated
    for sid in scans:
        assert (tmp_path / "plain" / f"{sid}.bin").read_bytes() == \
            (tmp_path / "mesh" / f"{sid}.bin").read_bytes(), sid
    import json

    m1 = json.loads((tmp_path / "plain" / "_manifest.json").read_text())
    m2 = json.loads((tmp_path / "mesh" / "_manifest.json").read_text())
    assert "mesh" not in m1 and m2["mesh"] == {"data": 2, "beam": 1}
    assert set(m2) - set(m1) == {"mesh"}
    s3 = run_snowfall_datagen(sorted(scans), scans.__getitem__,
                              tmp_path / "mesh", small_bank, calib, SMALL,
                              mesh=mesh, **kw)
    assert s3.frames_skipped == 4 and s3.frames_done == 0


def test_mesh_datagen_batch_mismatch(tmp_path, small_bank):
    """The JAX package's error, word for word, before any work."""
    from lidar_snow_sim_tpu.calib import load_hdl64_calib as jax_calib
    from lidar_snow_sim_tpu.config import SnowfallConfig as JaxConfig

    with pytest.raises(ValueError) as jerr:
        jdatagen.run_snowfall_datagen(
            ["a"], lambda s: np.zeros((10, 5), np.float32), tmp_path / "j",
            JaxParticleBank(*small_bank), jax_calib(),
            JaxConfig(max_points=4096), batch=3, mesh=jmesh.make_mesh(4, 2))
    with pytest.raises(ValueError) as terr:
        run_snowfall_datagen(
            ["a"], lambda s: np.zeros((10, 5), np.float32), tmp_path / "t",
            small_bank, load_hdl64_calib(), SMALL, batch=3,
            mesh=tmesh.make_mesh(4, 2, devices=["cpu"] * 8))
    assert str(terr.value) == str(jerr.value)
    assert "not divisible" in str(terr.value)


def test_datagen_loads_the_next_batch_on_its_io_thread(tmp_path, small_bank,
                                                       scans, monkeypatch):
    """Loads run on one IO thread, and batch i + 1's loads start before
    batch i's step returns."""
    calib = load_hdl64_calib()
    events = []
    main = threading.get_ident()

    def load(sid):
        events.append(("load", sid, threading.get_ident() != main))
        return scans[sid]

    from lidar_snow_sim_tpu_torch.parallel import datagen as tdatagen

    step = tdatagen.datagen_packed_step

    def slow_step(*a, **k):
        events.append(("step",))
        import time
        time.sleep(0.3)   # the IO thread loads meanwhile
        return step(*a, **k)

    monkeypatch.setattr(tdatagen, "datagen_packed_step", slow_step)
    run_snowfall_datagen(sorted(scans), load, tmp_path, small_bank, calib,
                         SMALL, batch=2, shuffle_channels=False,
                         device="cpu")
    loads = [e for e in events if e[0] == "load"]
    assert len(loads) == 4 and all(e[2] for e in loads)
    first_step = events.index(("step",))
    assert events.index(("load", "f2", True)) < first_step + 2


def _jax_stats(batches):
    return jdatagen.DatagenStats(batches=batches)


@pytest.mark.parametrize("batches", [
    [{"frames": 4, "s": 2.0, "compiles": 1},
     {"frames": 4, "s": 0.5, "compiles": 0},
     {"frames": 2, "s": 0.4, "compiles": 0},
     {"frames": 4, "s": 3.0, "compiles": 2},
     {"frames": 4, "s": 0.25, "compiles": 0}],
    [{"frames": 4, "s": 1.0, "compiles": 1}],       # every batch set up
    [{"frames": 4, "s": 0.0, "compiles": 0},        # a zero-time batch
     {"frames": 3, "s": 0.6, "compiles": 0}],
    [],
])
def test_steady_rates_match_jax(batches):
    got, want = DatagenStats(batches=batches), _jax_stats(batches)
    assert got.steady_scans_per_sec() == want.steady_scans_per_sec()
    assert got.steady_median_scans_per_sec() == \
        want.steady_median_scans_per_sec()


# ---- distributed ------------------------------------------------------------


def test_all_hosts_stats_two_gloo_processes():
    """Two spawned ranks on the CPU (gloo): each merges its made-up
    counters into the sums, exactly, above 2^24, and keeps its wall time."""
    big = 2**24 + 1
    got = tdist.spawn_ranks(worker.stats_rank, CPU2, big)
    for rank, (merged, primary) in enumerate(got):
        assert merged["points_in"] == 3 * big         # big * 1 + big * 2
        assert merged["frames_done"] == 3 and merged["removed"] == 3 * 7
        assert merged["wall_s"] == float(rank)
        assert primary == (rank == 0)


def test_jax_float32_sum_rounds_where_int64_does_not():
    """The JAX all_hosts_stats sums the counters as float32
    (lidar_snow_sim_tpu/parallel/distributed.py:71-74): above 2^24 a
    point count rounds. One STF split is ~34,690 scans x ~50,000 points.
    The port sums int64 tensors (`all_hosts_stats`)."""
    per_host = [34_690 * 50_000 + 1, 34_690 * 50_001 + 3]
    exact = sum(per_host)
    f32 = jnp.asarray([float(v) for v in per_host], jnp.float32).sum()
    assert int(round(float(f32))) != exact
    i64 = torch.tensor(per_host, dtype=torch.int64).sum()
    assert int(i64) == exact


def test_initialize_joins_two_processes():
    """initialize("host:port", 2, rank) in two spawned processes: True,
    and the group merges their stats."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    mp.start_processes(worker.initialize_rank,
                       args=(tdist.free_port(), results), nprocs=2,
                       join=True, start_method="spawn")
    got = sorted(results.get() for _ in range(2))
    assert got == [(0, True, 3, True), (1, True, 3, False)]


def test_one_process_needs_no_group():
    s = DatagenStats(frames_done=3)
    assert tdist.initialize() is False
    assert tdist.is_primary_host()
    assert tdist.all_hosts_stats(s) is s


@pytest.mark.parametrize("devices,want", [
    (["cpu", "cpu"], "gloo"),
    (["cuda:0", "cuda:0"], "gloo"),     # ranks share a card
    (["cuda:0", "cuda:1"], "nccl"),     # a card each
])
def test_backend_rule(devices, want):
    assert tdist.backend_for(devices) == want


def test_all_reduce_sum_carries_the_other_ranks_gradient():
    got = tdist.spawn_ranks(worker.grad_rank, CPU2)
    # each rank's loss is (rank + 1) * sum over ranks of x_r ** 2, so rank
    # r's gradient is 2 x_r * (1 + 2)
    assert got == [[6.0, 0.0], [12.0, 0.0]]


# ---- the launch guard -------------------------------------------------------


def test_every_launch_makes_its_device_current(monkeypatch):
    """Each wrapper's C call runs inside torch.cuda.device(tensor's device):
    the wrappers are driven to their launch with meta tensors standing in
    for a second card's, the entry points and checks faked."""
    from lidar_snow_sim_tpu_torch.ops import lut_lookup, occluders, pulse

    current = []
    calls = []

    class FakeDevice:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            current.append(self.dev)

        def __exit__(self, *exc):
            current.pop()

    class Stream:
        cuda_stream = 0

    class Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append((name, list(current))) or 0

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream)
    monkeypatch.setattr(_kernels, "load", lambda name: Lib())
    monkeypatch.setattr(_kernels, "check_input", lambda *a, **k: None)
    monkeypatch.setattr(occluders, "_check_args", lambda *a, **k: None)
    monkeypatch.setattr(lut_lookup, "_check_table", lambda pairs: 4)
    meta = torch.device("meta")

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    i32 = dict(dtype=torch.int32)
    base = (t(256, 9), t(2, **i32), t(2, **i32), t(2, **i32))
    bank = (t(64, **i32), t(64, 8, 300), t(64, 8, 16))
    kw = dict(blk=128, w_sl=128, k_occ=8)
    occluders.find_occluders(*base, t(2, **i32), *bank, **kw)
    occluders.find_occluders_routed(
        *base, t(16, **i32), t(2, **i32), *bank, band=128, group=16,
        wide_sl=0, **kw)
    occluders.find_occluders_banded(
        base[0], base[1], base[2], t(16, **i32), t(16, **i32), *bank,
        blk=128, k_occ=8, band=128, group=16, wide_sl=0, delta=0.1)
    occluders.find_occluders_t(*base, *bank, **kw)
    occluders.find_occluders_pair(*base, *bank, **kw)
    pulse_args = (t(4, 64), t(8, 64), t(8, 64), t(8, 64), t(8, 64),
                  t(9, 64), t(9, 64), t(1230), t(1230))
    pkw = dict(beam_rad=0.1, ipm=0.1, c_tau=0.1, xsi_r1=0.1, xsi_r2=0.2)
    pulse.pulse_peaks(*pulse_args, **pkw)
    pulse.pulse_peaks_pair(*pulse_args, blk=32, **pkw)
    lut_lookup.lut_lookup_pairs(t(100), t(4, 2))
    assert [c[0] for c in calls] == [
        "occluders_a1", "occluders_a2", "occluders_a3", "occluders_a4a",
        "occluders_a4b", "pulse_c1", "pulse_c2", "lut_lookup_l1"]
    assert all(c[1] == [meta] for c in calls), calls


# ---- precompute --mesh ------------------------------------------------------


def test_precompute_mesh_flag(tmp_path, scans, small_bank):
    """`precompute --mesh 2x1 --device cpu` writes the files of a run
    without --mesh; --batch must divide by DATA."""
    from lidar_snow_sim_tpu_torch.utils.pointcloud import save_velodyne_bin

    lidar = tmp_path / "lidar_hdl64_strongest"
    lidar.mkdir()
    ids = ["2020-01-01_00000", "2020-01-01_00001"]
    for sid, pc in zip(ids, scans.values()):
        save_velodyne_bin(pc, lidar / f"{sid}.bin")
    (tmp_path / "split.txt").write_text(
        "\n".join(s.replace("_", ",") for s in ids) + "\n")
    banks = tmp_path / "banks"
    banks.mkdir()
    from lidar_snow_sim_tpu_torch.sampling.distributions import (
        compute_occupancy,
        snowfall_rate_to_rainfall_rate,
    )

    rr = snowfall_rate_to_rainfall_rate(2.5, 1.6)
    occ = compute_occupancy(2.5, 1.6)
    rng = np.random.default_rng(3)
    for line in range(1, 65):
        ang = rng.uniform(0, 2 * np.pi, 100)
        d = np.sqrt(rng.uniform(0.01, 1, 100)) * 60
        np.save(banks / f"gunn_{rr}_{occ}_{line}.npy", np.column_stack(
            [d * np.cos(ang), d * np.sin(ang), rng.uniform(0.005, 0.05,
                                                           100)]))
    base = ["--split", str(tmp_path / "split.txt"), "--lidar-dir",
            str(lidar), "--bank-dir", str(banks), "--modes", "gunn",
            "--rates", "2.5", "--velocities", "1.6", "--batch", "2",
            "--max-points", "4096", "--no-fov-filter", "--device", "cpu"]
    out = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh", "2x1"])):
        assert precompute.main(base + ["--out-root", str(tmp_path / name)]
                               + extra) == 0
        out[name] = sorted((tmp_path / name).rglob("*.bin"))
    assert len(out["plain"]) == 2
    for a, b in zip(out["plain"], out["mesh"]):
        assert a.name == b.name and a.read_bytes() == b.read_bytes()
    with pytest.raises(ValueError, match="not divisible"):
        precompute.main(base + ["--out-root", str(tmp_path / "x"),
                                "--mesh", "4x1", "--overwrite"])
