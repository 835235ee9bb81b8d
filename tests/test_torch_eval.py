"""The port's KITTI-protocol evaluator (`lidar_snow_sim_tpu_torch.utils.
eval_ap`, `.tools.evaluate`), its STF label reader (`.utils.stf_labels`)
and its experiment tool (`.tools.experiment`) against the JAX package on
the CPU.

The JAX package's pairwise IoUs run op by op (`jax.disable_jit()`): jitted
on XLA's CPU backend they depart from the float64 oracle, and overlaps
past a KITTI threshold with them (tests/test_torch_train.py::
test_jax_jitted_assignment_departs).

Tolerances: the overlap matrices 1e-5 absolute; AP tables, the evaluate
CLIs' reports and everything stf_labels returns equal (the labels' arrays
byte for byte).
"""

import json

import numpy as np
import pytest
import torch

import jax

from lidar_snow_sim_tpu.tools import evaluate as jevaluate
from lidar_snow_sim_tpu.utils import eval_ap as jeval
from lidar_snow_sim_tpu.utils import stf_labels as jstf
from lidar_snow_sim_tpu_torch.tools import evaluate as tevaluate
from lidar_snow_sim_tpu_torch.tools import experiment as texperiment
from lidar_snow_sim_tpu_torch.tools.infer import predictions_to_label_lines
from lidar_snow_sim_tpu_torch.utils import eval_ap as teval
from lidar_snow_sim_tpu_torch.utils import stf_labels as tstf

CLASSES = ("Car", "Pedestrian", "Cyclist")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, n_frames=4):
    """Seeded gt and det frames: gts of three classes (plus Van and
    DontCare) with difficulty inputs; dets jittered off the gts (some
    relabelled, some dropped) plus false positives."""
    rng = np.random.default_rng(seed)
    names_all = np.array(["Car", "Car", "Car", "Pedestrian", "Cyclist",
                          "Van", "DontCare"])
    dims = {"Car": (4.0, 1.7, 1.5), "Pedestrian": (0.8, 0.6, 1.7),
            "Cyclist": (1.8, 0.6, 1.7), "Van": (5.0, 2.0, 2.2),
            "DontCare": (1.0, 1.0, 1.0)}
    gts, dets = [], []
    for _ in range(n_frames):
        n = int(rng.integers(10, 16))
        names = list(rng.choice(names_all, n))
        boxes = np.zeros((n, 7))
        for i, name in enumerate(names):
            boxes[i] = [(i % 4) * 12 + rng.uniform(-2, 2),
                        (i // 4) * 10 + rng.uniform(-2, 2),
                        rng.uniform(-1, 0), *dims[name],
                        rng.uniform(-np.pi, np.pi)]
        gts.append(jeval.gt_frame(
            boxes, names, truncated=rng.uniform(0, 0.6, n),
            occluded=rng.integers(0, 3, n),
            bbox_height=rng.uniform(15, 80, n)))
        keep = rng.uniform(size=n) < 0.85
        db = boxes[keep] + np.column_stack([
            rng.normal(0, 0.25, (keep.sum(), 2)),
            rng.normal(0, 0.1, (keep.sum(), 1)),
            rng.normal(0, 0.1, (keep.sum(), 3)),
            rng.normal(0, 0.1, (keep.sum(), 1))])
        dn = [nm if rng.uniform() > 0.1 else "Car"
              for nm, k in zip(names, keep) if k]
        fp = int(rng.integers(2, 6))
        fb = np.column_stack([rng.uniform(0, 48, fp), rng.uniform(0, 40, fp),
                              rng.uniform(-1, 0, fp),
                              np.tile([4.0, 1.7, 1.5], (fp, 1)),
                              rng.uniform(-np.pi, np.pi, fp)])
        dets.append(jeval.det_frame(
            np.concatenate([db, fb]), dn + ["Car"] * fp,
            rng.uniform(0.05, 1.0, len(dn) + fp)))
    return gts, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_tables_equal_the_jax_packages(seed):
    gts, dets = _scene(seed)
    for metric in ("3d", "bev"):
        for g, d in zip(gts, dets):
            with jax.disable_jit():
                want = jeval._pair_overlaps(g["boxes"], d["boxes"], metric)
            got = teval._pair_overlaps(g["boxes"], d["boxes"], metric, "cpu")
            assert got.dtype == np.float64 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for mode in ("R40", "R11"):
        with jax.disable_jit():
            want = jeval.evaluate(gts, dets, CLASSES, recall_mode=mode)
        got = teval.evaluate(gts, dets, CLASSES, recall_mode=mode,
                             device="cpu")
        assert json.dumps(got) == json.dumps(want)
    values = [v for c in got.values() for m in c.values() for v in m.values()]
    assert any(0 < v < 1 for v in values)


def _calib_root(tmp_path):
    """tests/test_boxes.py::test_stf_label_surface's TF tree and camera."""
    tf_tree = [
        {"header": {"frame_id": "base"},
         "child_frame_id": "lidar_hdl64_s3_roof",
         "transform": {"translation": {"x": 0.0, "y": 0.0, "z": 1.9},
                       "rotation": {"x": 0.0, "y": 0.0, "z": 0.0,
                                    "w": 1.0}}},
        {"header": {"frame_id": "base"}, "child_frame_id": "cam_mount",
         "transform": {"translation": {"x": 1.0, "y": 0.0, "z": 1.5},
                       "rotation": {"x": 0.0, "y": 0.0, "z": 0.0,
                                    "w": 1.0}}},
        {"header": {"frame_id": "cam_mount"},
         "child_frame_id": "cam_stereo_left_optical",
         "transform": {"translation": {"x": 0.0, "y": 0.0, "z": 0.0},
                       "rotation": {"x": 0.5, "y": -0.5, "z": 0.5,
                                    "w": -0.5}}},
    ]
    (tmp_path / "calib_tf_tree_full.json").write_text(json.dumps(tf_tree))
    (tmp_path / "calib_cam_stereo_left.json").write_text(json.dumps({
        "frame_id": "cam_stereo_left_optical",
        "P": [2355.0, 0, 988.0, 0, 0, 2355.0, 508.0, 0, 0, 0, 1.0, 0],
    }))
    return tmp_path


def _dense_labels(tmp_path, seed, n_frames=2):
    """Camera-frame DENSE label files (and DontCare rows)."""
    rng = np.random.default_rng(seed)
    labels = tmp_path / "gt_labels"
    labels.mkdir(exist_ok=True)
    for f in range(n_frames):
        rows = []
        for _ in range(int(rng.integers(3, 7))):
            name = rng.choice(["PassengerCar", "Pedestrian", "DontCare"])
            rows.append(
                f"{name} {rng.uniform(0, 0.3):.2f} {rng.integers(0, 3)} 0 "
                f"100 {rng.uniform(50, 100):.1f} 200 "
                f"{rng.uniform(130, 200):.1f} 1.5 1.8 4.0 "
                f"{rng.uniform(-5, 5):.3f} -0.4 {rng.uniform(5, 40):.3f} "
                f"{rng.uniform(-np.pi, np.pi):.4f} 0.9")
        (labels / f"frame_{f:03d}.txt").write_text("\n".join(rows) + "\n")
    return labels


def test_stf_labels_bitwise(tmp_path):
    root = _calib_root(tmp_path)
    labels = _dense_labels(tmp_path, 0)
    want = jstf.load_calib_data(root, "calib_cam_stereo_left.json",
                                "calib_tf_tree_full.json",
                                velodyne_name="lidar_hdl64_s3_roof")
    got = tstf.load_calib_data(root, "calib_cam_stereo_left.json",
                               "calib_tf_tree_full.json",
                               velodyne_name="lidar_hdl64_s3_roof")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    c2v = want[1]
    for f in sorted(labels.glob("*.txt")):
        stem = labels / f.stem
        w = jstf.read_label(stem, labels, camera_to_velodyne=c2v)
        g = tstf.read_label(stem, labels, camera_to_velodyne=c2v)
        assert repr(g) == repr(w) and len(g) > 0
        wb = jstf.dense_boxes(stem, labels, camera_to_velodyne=c2v)
        gb = tstf.dense_boxes(stem, labels, camera_to_velodyne=c2v)
        assert [vars(b) for b in gb] == [vars(b) for b in wb]
        assert type(gb[0]).__module__ == "lidar_snow_sim_tpu_torch.utils.boxes"
    assert tstf.DENSE_CLASSES == jstf.DENSE_CLASSES


def _pred_files(tmp_path, gts, dets, stems, classes):
    preds = tmp_path / "preds"
    preds.mkdir(exist_ok=True)
    for stem, d in zip(stems, dets):
        arr = np.concatenate([
            d["boxes"],
            np.array([[classes.index(n) + 1 if n in classes else 0]
                      for n in d["names"]], float).reshape(-1, 1),
            d["scores"][:, None]], axis=1)
        (preds / f"{stem}.txt").write_text(
            "\n".join(predictions_to_label_lines(arr, classes)) + "\n")
    return preds


def _both_clis(argv, capsys):
    with jax.disable_jit():
        jevaluate.main(argv)
    want = json.loads(capsys.readouterr().out)
    tevaluate.main([*argv, "--device", "cpu"])
    return json.loads(capsys.readouterr().out), want


def test_evaluate_cli_kitti_layout(tmp_path, capsys):
    gts, dets = _scene(3, n_frames=3)
    stems = [f"{i:06d}" for i in range(3)]
    labels = tmp_path / "labels"
    labels.mkdir()
    for stem, g in zip(stems, gts):
        arr = np.concatenate([g["boxes"], np.ones((len(g["boxes"]), 2))], 1)
        lines = predictions_to_label_lines(arr, ("Car",))
        # the KITTI layout's names, truncation, occlusion and 2D box
        lines = [
            f"{n} {t:.2f} {int(o)} 0 0 0 0 {h:.2f} " + " ".join(
                ln.split()[8:15])
            for ln, n, t, o, h in zip(lines, g["names"], g["truncated"],
                                      g["occluded"], g["bbox_height"])]
        (labels / f"{stem}.txt").write_text("\n".join(lines) + "\n")
    preds = _pred_files(tmp_path, gts, dets, stems, CLASSES)
    got, want = _both_clis(["--predictions", str(preds), "--labels",
                            str(labels), "--recall", "R11", "--iou",
                            "Car=0.5,Pedestrian=0.3"], capsys)
    assert got == want and got["frames"] == 3 and got["gt_boxes"] > 0
    # one file each
    got, want = _both_clis(["--predictions", str(preds / "000000.txt"),
                            "--labels", str(labels / "000000.txt")], capsys)
    assert got == want
    with pytest.raises(SystemExit, match="no same-named"):
        tevaluate.main(["--predictions", str(preds), "--labels",
                        str(tmp_path), "--device", "cpu"])


def test_evaluate_cli_dense_layout(tmp_path, capsys):
    root = _calib_root(tmp_path)
    labels = _dense_labels(tmp_path, 1, n_frames=3)
    c2v = tstf.load_calib_data(root, "calib_cam_stereo_left.json",
                               "calib_tf_tree_full.json")[1]
    stems = [f.stem for f in sorted(labels.glob("*.txt"))]
    classes = ("PassengerCar", "Pedestrian")
    rng = np.random.default_rng(4)
    dets = []
    for stem in stems:
        boxes = tstf.dense_boxes(labels / stem, labels,
                                 camera_to_velodyne=c2v)
        b7 = np.array([[b.x, b.y, b.z, b.length, b.width, b.height, b.yaw]
                       for b in boxes]).reshape(-1, 7)
        b7 += rng.normal(0, 0.2, b7.shape)
        dets.append(jeval.det_frame(b7, [b.identity for b in boxes],
                                    rng.uniform(0.1, 1, len(boxes))))
    preds = _pred_files(tmp_path, None, dets, stems, classes)
    argv = ["--predictions", str(preds), "--labels", str(labels),
            "--format", "dense", "--dataset-root", str(root), "--classes",
            ",".join(classes), "--iou", "PassengerCar=0.5"]
    got, want = _both_clis(argv, capsys)
    assert got == want and got["gt_boxes"] > 0
    with pytest.raises(SystemExit, match="dataset-root"):
        tevaluate.main(argv[:6] + ["--device", "cpu"])


def test_experiment_pipeline_smoke(tmp_path):
    """tests/test_experiment.py's smoke run of the port's tool on the CPU:
    corpus -> datagen -> train -> infer -> KITTI AP, with the JAX tool's
    artifact keys."""
    out = tmp_path / "exp.json"
    rc = texperiment.main([
        "--out", str(out), "--work", str(tmp_path / "work"),
        "--train-frames", "2", "--eval-frames", "1",
        "--steps", "1", "--finetune-steps", "1", "--batch", "2",
        "--n-azimuth", "60", "--max-points", "4096", "--device", "cpu",
    ])
    art = json.loads(out.read_text())
    assert set(art) == {"what", "config", "datagen", "ap_R40_moderate",
                        "assertions", "wall_seconds", "platform"}
    assert art["platform"] == "cpu"
    aps = art["ap_R40_moderate"]
    assert set(aps) == {
        "init_on_clear", "clear_trained_on_clear", "clear_trained_on_snow",
        "snow_finetuned_on_snow", "snow_finetuned_on_clear",
    }
    for v in aps.values():
        assert np.isfinite(v["Car"]["3d"]) and 0.0 <= v["Car"]["3d"] <= 1.0
    assert art["datagen"]["train"]["frames"] == 2
    assert art["datagen"]["train"]["removed"] > 0   # snow did real work
    assert set(art["assertions"]) == {
        "trained_strictly_beats_init", "snow_degrades_clear_model",
        "finetune_improves_on_snow",
    }
    assert rc in (0, 1)
    # the corpus is the JAX tool's, byte for byte
    from lidar_snow_sim_tpu.calib import load_hdl64_calib
    from lidar_snow_sim_tpu.tools import experiment as jexperiment

    jexperiment.build_corpus(tmp_path / "jax", 1, 777, load_hdl64_calib(),
                             n_azimuth=60)
    for sub, ext in (("scans", "bin"), ("labels", "txt")):
        a = (tmp_path / "jax" / sub / f"000000.{ext}").read_bytes()
        b = (tmp_path / "work" / "clear_eval" / sub /
             f"000000.{ext}").read_bytes()
        assert a == b
