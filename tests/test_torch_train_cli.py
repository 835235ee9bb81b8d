"""The port's train CLI (`lidar_snow_sim_tpu_torch.tools.train`) against
the JAX package's on the CPU, at tests/test_train_cli.TINY_YAML.

Both CLIs start from one `--init-params` npz. The JAX CLI's jitted step
assigns targets through a host callback that runs the JAX package's
`assign_targets` op by op (tests/test_torch_train.py explains why).

Tolerances:
- frames (synthetic and file-backed): byte for byte;
- per-step losses, read from the CLIs' logs (4 decimals): 1e-4 relative;
- checkpoints: a checkpoint loaded and saved again by the other package
  equals the file byte for byte; a resumed run's losses follow the
  writer's straight run within 1e-4 relative;
- the port's own --resume: byte for byte.
"""

import re
import shutil

import numpy as np
import pytest
import torch

import jax

from lidar_snow_sim_tpu.models import pointpillars as jpp
from lidar_snow_sim_tpu.tools import train as jtrain
from lidar_snow_sim_tpu_torch.models import detector_train as tdt
from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
from lidar_snow_sim_tpu_torch.tools import train as ttrain
from lidar_snow_sim_tpu_torch.utils.pointcloud import save_velodyne_bin
from tests.test_torch_train import eager_assign_patch
from tests.test_train_cli import TINY_YAML


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tiny(tmp_path):
    """(yaml path, init-params npz from the JAX package's init)."""
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(TINY_YAML)
    cfg = jpp.config_from_openpcdet_yaml(yaml)
    p = jax.jit(lambda k: jpp.init_params(cfg, k))(jax.random.PRNGKey(1))
    init = tmp_path / "init.npz"
    np.savez(init, **{k: np.asarray(v) for k, v in p.items()})
    return str(yaml), str(init)


def _argv(tiny, out, steps=4, extra=()):
    return ["--synthetic", "4", "--steps", str(steps), "--batch", "2",
            "--max-points", "512", "--max-gt", "8", "--config", tiny[0],
            "--out", str(out), "--save-every", "2", "--dtype", "float32",
            "--log-every", "1", "--seed", "3", "--init-params", tiny[1],
            *extra]


def _losses(err: str) -> dict:
    """{step: loss} from a CLI's log."""
    return {int(a): float(b) for a, b in
            re.findall(r"step (\d+)/\d+ loss=([-\d.]+)", err)}


def _jax(argv, capsys, monkeypatch):
    with monkeypatch.context() as m:
        eager_assign_patch(m)
        jtrain.main(argv)
    return _losses(capsys.readouterr().err)


def _port(argv, capsys):
    assert ttrain.main([*argv, "--device", "cpu"]) == 0
    return _losses(capsys.readouterr().err)


def _close_losses(got, want):
    assert got and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_losses_match_the_jax_cli(tmp_path, tiny, capsys, monkeypatch):
    want = _jax(_argv(tiny, tmp_path / "jax"), capsys, monkeypatch)
    got = _port(_argv(tiny, tmp_path / "port"), capsys)
    assert len(want) == 4
    _close_losses(got, want)
    a, b = (np.load(tmp_path / d / "params_tpu.npz") for d in ("jax",
                                                               "port"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        scale = max(float(np.abs(a[k]).max()), 1e-30)
        assert float(np.abs(a[k] - b[k]).max()) <= 1e-4 * scale, k


def _roundtrip(path, tmp_path):
    """The checkpoint loaded by the port and saved again."""
    cfg = tpp.config_from_openpcdet_yaml(tmp_path / "tiny.yaml")
    _, init = tdt.make_train_step(cfg, tpp.generate_anchors(cfg))
    state = ttrain.load_checkpoint(path, init, cfg, "cpu")
    again = tmp_path / "again.npz"
    ttrain.save_checkpoint(again, state)
    return again


def _same_npz(a, b):
    a, b = np.load(a), np.load(b)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_checkpoints_cross_between_the_packages(tmp_path, tiny, capsys,
                                                monkeypatch):
    # a JAX checkpoint, resumed by the port
    jax_full = _jax(_argv(tiny, tmp_path / "jax"), capsys, monkeypatch)
    _jax(_argv(tiny, tmp_path / "j2p", extra=("--limit-steps", "2")),
         capsys, monkeypatch)
    ckpt = tmp_path / "j2p" / "ckpt_0000002.npz"
    _same_npz(_roundtrip(ckpt, tmp_path), ckpt)
    got = _port(_argv(tiny, tmp_path / "j2p", extra=("--resume",)), capsys)
    _close_losses(got, {k: jax_full[k] for k in (3, 4)})

    # a port checkpoint, resumed by the JAX CLI
    port_full = _port(_argv(tiny, tmp_path / "port"), capsys)
    _port(_argv(tiny, tmp_path / "p2j", extra=("--limit-steps", "2")),
          capsys)
    ckpt = tmp_path / "p2j" / "ckpt_0000002.npz"
    z = np.load(ckpt)
    assert int(z["step"]) == int(z["count"]) == 2
    assert z["step"].dtype == z["count"].dtype == np.int32
    # the running stats carry zero moments, as in the JAX file
    assert not z["mu/vfe.pfn_layers.0.norm.running_var"].any()
    _same_npz(_roundtrip(ckpt, tmp_path), ckpt)
    got = _jax(_argv(tiny, tmp_path / "p2j", extra=("--resume",)), capsys,
               monkeypatch)
    _close_losses(got, {k: port_full[k] for k in (3, 4)})


@pytest.mark.parametrize("extra", [(), ("--augment",)])
def test_resume_is_bit_exact(tmp_path, tiny, capsys, extra):
    _port(_argv(tiny, tmp_path / "full", extra=extra), capsys)
    _port(_argv(tiny, tmp_path / "part", extra=(*extra, "--limit-steps",
                                                "2")), capsys)
    assert sorted(p.name for p in (tmp_path / "part").glob("*.npz")) == [
        "ckpt_0000002.npz", "params_tpu.npz"]
    _port(_argv(tiny, tmp_path / "part", extra=(*extra, "--resume")), capsys)
    for name in ("ckpt_0000004.npz", "params_tpu.npz"):
        _same_npz(tmp_path / "full" / name, tmp_path / "part" / name)


def test_params_hand_over_to_infer(tmp_path, tiny, capsys):
    """params_tpu.npz loads into the infer CLI (--params) and into the JAX
    package's parameter contract."""
    import json

    from lidar_snow_sim_tpu.tools.convert_checkpoint import load_params
    from lidar_snow_sim_tpu_torch.tools import infer

    _port(_argv(tiny, tmp_path / "run", steps=2), capsys)
    params = tmp_path / "run" / "params_tpu.npz"
    cfg = jpp.config_from_openpcdet_yaml(tiny[0])
    assert {k: v.shape for k, v in load_params(params).items()} == \
        jpp.param_shapes(cfg)
    rng = np.random.default_rng(0)
    scan = np.column_stack([
        rng.uniform(1, 15, 800), rng.uniform(-7, 7, 800),
        rng.uniform(-2.5, 0.5, 800), rng.uniform(0, 255, 800),
        rng.integers(0, 64, 800)]).astype(np.float32)
    save_velodyne_bin(scan, tmp_path / "scan.bin")
    assert infer.main([str(tmp_path / "scan.bin"), "--config", tiny[0],
                       "--params", str(params), "--device", "cpu",
                       "--predictions", str(tmp_path / "p.npy")]) == 0
    report = json.loads(capsys.readouterr().out)["inference"]
    arr = np.load(tmp_path / "p.npy")
    assert report["num_predictions"] == len(arr) and np.isfinite(arr).all()


def _corpus(tmp_path):
    scans, labels = tmp_path / "scans", tmp_path / "labels"
    scans.mkdir()
    labels.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        n = 400 if i else 700        # one scan over --max-points
        pc = np.zeros((n, 5), np.float32)
        pc[:, 0] = rng.uniform(0, 16, n)
        pc[:, 1] = rng.uniform(-8, 8, n)
        pc[:, 2] = rng.uniform(-3, 1, n)
        pc[:, 3] = rng.uniform(0, 255, n)
        cx = 4.0 + 3.0 * i
        pc[:60, 0] = rng.uniform(cx - 1.5, cx + 1.5, 60)
        pc[:60, 1] = rng.uniform(-0.7, 0.7, 60)
        pc[:60, 2] = rng.uniform(-1.9, -0.5, 60)
        save_velodyne_bin(pc, scans / f"{i:06d}.bin")
        (labels / f"{i:06d}.txt").write_text(
            f"Car 0 0 0 0 0 50 50 1.56 1.6 3.9 {cx} 0.0 -1.9 0.0\n"
            "Tram 0 0 0 0 0 50 50 2.0 2.0 8.0 4.0 2.0 -1.9 0.0\n"
        )
    return scans, labels


def test_frames_equal_the_jax_clis(tmp_path, tiny):
    """_collect_frames: synthetic frames and a file corpus (a scan
    subsampled, one padded, foreign classes dropped), byte for byte."""
    scans, labels = _corpus(tmp_path)
    cfg = jpp.config_from_openpcdet_yaml(tiny[0])

    class Args:
        synthetic = 3
        scans = labels = None
        seed = 5
        max_points = 512
        max_gt = 4
        intensity_scale = 1.0 / 255.0
        columns = 5

    files = Args()
    files.synthetic, files.scans, files.labels = 0, str(scans), str(labels)
    for args in (Args(), files):
        want = jtrain._collect_frames(args, cfg)
        got = ttrain._collect_frames(args, cfg)
        assert len(got) == len(want) == 3
        for (wp, wg), (gp, gg) in zip(want, got):
            assert wp.tobytes() == gp.tobytes() and wg.tobytes() == gg.tobytes()


def test_gt_sampling_flags(tmp_path, tiny, capsys, monkeypatch):
    """--gt-sampling: the same per-(seed, step) pastes as the JAX CLI (the
    losses follow it), --augment with it is deterministic, and the flags'
    errors are the JAX CLI's."""
    scans, labels = _corpus(tmp_path)

    def argv(out, *extra):
        return ["--scans", str(scans), "--labels", str(labels), "--steps",
                "2", "--batch", "2", "--max-points", "512", "--max-gt", "8",
                "--config", tiny[0], "--init-params", tiny[1], "--out",
                str(tmp_path / out), "--dtype", "float32", "--log-every",
                "1", "--seed", "11", "--gt-sampling", "Car:4,Pedestrian:2",
                "--gt-db-min-points", "5", *extra]

    want = _jax(argv("jax"), capsys, monkeypatch)
    _close_losses(_port(argv("port"), capsys), want)
    _port(argv("a", "--augment"), capsys)
    _port(argv("b", "--augment"), capsys)
    _same_npz(tmp_path / "a" / "params_tpu.npz",
              tmp_path / "b" / "params_tpu.npz")
    shutil.rmtree(tmp_path / "a")
    base = ["--synthetic", "2", "--steps", "1", "--batch", "1",
            "--max-points", "128", "--max-gt", "4", "--config", tiny[0],
            "--out", str(tmp_path / "x"), "--device", "cpu"]
    for bad, match in (
            (["--gt-sampling", "Car:4"], "requires --scans"),
            (["--scans", str(scans), "--labels", str(labels),
              "--gt-sampling", "Van:4"], "not in config")):
        with pytest.raises(SystemExit, match=match):
            ttrain.main([*(base[2:] if bad[0] == "--scans" else base),
                         *bad])
    # --dp-devices is ported: a rank count that does not divide the batch
    # trains on one process, as the JAX CLI does, and says so
    capsys.readouterr()
    assert ttrain.main([*base, "--dp-devices", "2"]) == 0
    assert "not data-parallel (batch 1 does not divide over 2 ranks)" in \
        capsys.readouterr().err
