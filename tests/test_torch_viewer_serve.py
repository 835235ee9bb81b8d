"""The port's viewer (`lidar_snow_sim_tpu_torch.tools.viewer`) and its live
server (`.tools.serve`) against the JAX package's on the CPU.

The page is deterministic where the cloud is: `render_page` on the same
frames, and the static CLI on `--augment none --dror --fov` (on the scene of
tests/test_torch_inspect.py, which sits off the DROR boundary), with
`--neighbors`, `--results` and `--pcdet-dict`, write the JAX tool's HTML
byte for byte. The server mirrors tests/test_viewer_serve.py's five tests on
`--device cpu`, and holds:
- `augment: none` payloads equal to the JAX server's;
- snow payloads to the JAX server's keys and invariants (the two packages
  draw RANSAC planes from different generators), and byte for byte to the
  port's own `run_pipeline` with numpy's global seed set the same; with the
  JAX package's draws handed to the port (tests/test_torch_inspect.py's
  `jax_draws`) and the seed set before each server's request, to the JAX
  server's values: the frames' xyz and labels, in the JAX order, under the
  parity contract, and the stats equal where no point differs;
- `/infer`, with weights carried over in an experiment's params_tpu.npz, to
  the port's `detect` on the displayed cloud exactly, and that `detect` to
  the JAX package's `detect` run op by op (`jax.disable_jit()`: jitted on
  XLA's CPU backend its rotated IoU is off the float64 oracle, see
  tests/test_torch_detector.py) up to chip_smoke's `_flips` gate: a flip
  only where a decision lies within 1e-5 of its threshold.
"""

import argparse
import base64
import contextlib
import io
import json
import pickle
import runpy
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.models import pointpillars as jpp
from lidar_snow_sim_tpu.tools import serve as jserve
from lidar_snow_sim_tpu.tools import viewer as jviewer
from lidar_snow_sim_tpu.utils.boxes import Box3D as JaxBox3D
from lidar_snow_sim_tpu_torch import (
    compute_occupancy,
    snowfall_rate_to_rainfall_rate,
    synthetic_scan,
)
from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
from lidar_snow_sim_tpu_torch.models.snowfall import OVERFLOW_COUNTERS
from lidar_snow_sim_tpu_torch.tools import inspect as tinspect
from lidar_snow_sim_tpu_torch.tools import serve as tserve
from lidar_snow_sim_tpu_torch.tools import viewer as tviewer
from lidar_snow_sim_tpu_torch.utils.boxes import Box3D
from test_torch_detector import SMALL_YAML
from test_torch_inspect import (  # noqa: F401
    _boundary_gap,
    assert_rows_parity,
    jax_draws,
    scene,
)
from test_viewer_serve import TINY_YAML

SMOKE = runpy.run_path(str(Path(__file__).parents[1] / "chip_smoke.py"),
                       run_name="chip_smoke_gate")
SNOW_RATE, SNOW_VEL = 0.5, 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _html(main, argv, out):
    """Run a viewer CLI quietly; returns (its JSON report, the HTML)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main([*argv, "--out", str(out)]) == 0
    return json.loads(buf.getvalue()), Path(out).read_text()


def _frames(box_cls):
    rng = np.random.default_rng(0)
    pc = np.column_stack([rng.uniform(-40, 40, (900, 3)),
                          rng.uniform(0, 255, 900),
                          rng.integers(0, 64, 900)]).astype(np.float32)
    pc[::7, 4] = 2.0
    boxes = [box_cls(x=5.0, y=1.0, z=-1.0, length=3.9, width=1.6, height=1.5,
                     yaw=0.3, identity="Car")]
    preds = [box_cls(x=9.0, y=-2.0, z=-0.8, length=0.8, width=0.6,
                     height=1.7, yaw=1.1, identity=name, score=s)
             for name, s in (("Pedestrian", 0.71234567), ("Tram", 0.2))]
    return [("a", pc, boxes, preds), ("b", pc[::3], [])]


@pytest.mark.parametrize("serve", [False, True])
def test_render_page_matches_jax(serve):
    """Two frames (GT boxes, thresholded predictions, one unknown class),
    decimation, stats needing escapes, and the live panel."""
    kw = dict(title="scan <1>", stats={"log": "a&b", "snow": {"x": 1}},
              center_index=1, max_points=500, pred_threshold=30,
              serve_defaults=(dict(augment="fog", rate=2.5, dror=True)
                              if serve else None))
    got = tviewer.render_page(_frames(Box3D), **kw)
    assert got == jviewer.render_page(_frames(JaxBox3D), **kw)
    assert ('id="inferbtn"' in got) == serve


def test_static_viewer_matches_jax(scene, tmp_path):  # noqa: F811
    """`--augment none --dror --fov`: the same HTML as the JAX tool."""
    pc, scan, _ = scene
    assert _boundary_gap(pc).min() >= 1e-3
    argv = [str(scan), "--augment", "none", "--dror", "--fov"]
    want_rep, want = _html(jviewer.main, argv, tmp_path / "jax.html")
    got_rep, got = _html(tviewer.main, [*argv, "--device", "cpu"],
                         tmp_path / "port.html")
    assert got == want
    for rep in (want_rep, got_rep):
        rep.pop("viewer_html")
    assert got_rep == want_rep
    assert want_rep["dror"]["removed"] > 0


def _stf_scans(tmp_path):
    """Three STF-named sweeps of one drive, and a camera frame for the
    middle one in the DENSE layout (lidar/../cam_stereo_left_lut)."""
    lidar = tmp_path / "lidar_hdl64_strongest"
    lidar.mkdir()
    cam = tmp_path / "cam_stereo_left_lut"
    cam.mkdir()
    for i, frame in enumerate(("00006", "00007", "00008")):
        synthetic_scan(n_azimuth=30, seed=i).tofile(
            lidar / f"2019-01-01_{frame}.bin")
    (cam / "2019-01-01_00007.png").write_bytes(b"\x89PNG fake")
    return lidar / "2019-01-01_00007.bin"


def test_viewer_neighbors_and_results_match_jax(tmp_path):
    """--neighbors=-1:2 (the 00009 sweep is missing) with a result.pkl
    whose frames are named `date,frame` and `date_frame`."""
    scan = _stf_scans(tmp_path)
    result = [
        dict(frame_id="2019-01-01,00007",
             boxes_lidar=np.array([[8, 1, -1, 3.9, 1.6, 1.5, 0.2],
                                   [12, -3, -1, 0.8, 0.6, 1.7, 1.0]]),
             name=np.array(["Car", "Bus"]), score=np.array([0.9, 0.4])),
        dict(frame_id="2019-01-01_00006", boxes_lidar=np.zeros((0, 7)),
             name=np.array([]), score=np.array([])),
    ]
    with open(tmp_path / "result.pkl", "wb") as f:
        pickle.dump(result, f)
    argv = [str(scan), "--neighbors=-1:2", "--results",
            str(tmp_path / "result.pkl"), "--pred-threshold", "20"]
    want_rep, want = _html(jviewer.main, argv, tmp_path / "jax.html")
    got_rep, got = _html(tviewer.main, [*argv, "--device", "cpu"],
                         tmp_path / "port.html")
    assert got == want
    assert got_rep["frames_embedded"] == want_rep["frames_embedded"] == [
        "2019-01-01_00006", "2019-01-01_00007", "2019-01-01_00008"]
    assert "data:image/png;base64," in got


def test_viewer_pcdet_dict_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    d = {"points": rng.uniform(-20, 20, (700, 4)).astype(np.float32),
         "gt_boxes": np.array([[5, 1, -1, 3.9, 1.6, 1.5, 0.1, 1],
                               [9, -2, -1, 0.8, 0.6, 1.7, 0.0, 2]],
                              np.float32)}
    with open(tmp_path / "frame.pkl", "wb") as f:
        pickle.dump(d, f)
    argv = [str(tmp_path / "missing.bin"), "--pcdet-dict",
            str(tmp_path / "frame.pkl")]
    want_rep, want = _html(jviewer.main, argv, tmp_path / "jax.html")
    got_rep, got = _html(tviewer.main, [*argv, "--device", "cpu"],
                         tmp_path / "port.html")
    assert got == want
    assert got_rep["gt_boxes"] == want_rep["gt_boxes"] == 2


# ---------------------------------------------------------------------------
# the live server


@pytest.fixture(scope="module")
def served(tmp_path_factory, calib, small_particle_sets):
    """The port's server (--device cpu) and the JAX package's, on the scan,
    particle files and tiny detector yaml of tests/test_viewer_serve.py;
    yields (port URL, JAX URL, the port's args, its parser)."""
    root = tmp_path_factory.mktemp("serve")
    pc = synthetic_scan(n_azimuth=120, seed=0, calib=calib)
    scan = root / "2019-01-01_00007.bin"
    pc.astype(np.float32).tofile(scan)
    banks = root / "snowflakes"
    banks.mkdir()
    rr = snowfall_rate_to_rainfall_rate(SNOW_RATE, SNOW_VEL)
    occ = compute_occupancy(SNOW_RATE, SNOW_VEL)
    for i, s in enumerate(small_particle_sets):
        np.save(banks / f"gunn_{rr}_{occ}_{i + 1}.npy", s)
    (root / "pointpillar.yaml").write_text(TINY_YAML)
    common = [str(scan), "--serve", "--host", "127.0.0.1", "--port", "0",
              "--bank-dir", str(banks), "--rate", str(SNOW_RATE),
              "--velocity", str(SNOW_VEL), "--config",
              str(root / "pointpillar.yaml"), "--random-params",
              "--max-points", "5000"]
    servers, urls = [], []
    for module, argv in ((tviewer, [*common, "--device", "cpu"]),
                         (jviewer, common)):
        ap = module.build_parser()
        args = ap.parse_args(argv)
        srv = (tserve if module is tviewer else jserve).make_server(args, ap)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        servers.append((srv, t))
        host, port = srv.server_address[:2]
        urls.append(f"http://{host}:{port}")
        if module is tviewer:
            port_args, port_ap = args, ap
    yield urls[0], urls[1], port_args, port_ap
    for srv, t in servers:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.status, r.read().decode()


def _post(url, body: dict):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_page_has_live_controls(served):
    status, page = _get(served[0] + "/")
    assert status == 200
    for needle in ('id="aug"', 'id="rate"', 'id="inferbtn"', "reaugment",
                   "/augment", "/infer", "const FRAMES"):
        assert needle in page, needle
    js = page[page.index("<script>"):]
    assert js.count("{") == js.count("}")
    assert _get(served[1] + "/")[1] == page   # augment none: the JAX page


def test_augment_endpoint_reaugments_without_restart(served):
    s1, j1 = _post(served[0] + "/augment", {"augment": "fog",
                                            "fog_alpha": 0.01})
    s2, j2 = _post(served[0] + "/augment", {"augment": "fog",
                                            "fog_alpha": 0.1})
    assert s1 == s2 == 200
    for j in (j1, j2):
        assert j["frame"]["n"] > 0
        assert set(j["frame"]["colors"]) == {
            "label", "intensity", "height", "channel", "depth"}
        assert "fog" in j["stats"]
    assert (j2["stats"]["fog"]["num_scattered"]
            > j1["stats"]["fog"]["num_scattered"])
    s3, j3 = _post(served[0] + "/augment", {"augment": "fog",
                                            "fog_alpha": 0.1})
    assert s3 == 200 and j3 == j2


def _labels(frame):
    return np.frombuffer(base64.b64decode(frame["colors"]["label"]),
                         np.uint8)


def test_augment_endpoint_snow_chain(served):
    status, j = _post(served[0] + "/augment", {
        "augment": "snow", "rate": SNOW_RATE, "velocity": SNOW_VEL,
        "mode": "gunn"})
    assert status == 200
    snow = j["stats"]["snow"]
    assert snow["num_removed"] >= 0 and snow["num_attenuated"] >= 0
    assert j["frame"]["n"] > 0
    assert set(np.unique(_labels(j["frame"]))) <= {0, 1, 2}


def test_augment_endpoint_validates(served):
    status, j = _post(served[0] + "/augment", {"augment": "blizzard"})
    assert status == 400 and "augment" in j["error"]
    status, j = _post(served[0] + "/augment", {"bogus": 1})
    assert status == 400 and "bogus" in j["error"]


def test_infer_runs_on_displayed_cloud(served):
    status, j = _post(served[0] + "/infer", {"augment": "fog",
                                             "fog_alpha": 0.01})
    assert status == 200
    inf = j["stats"]["inference"]
    assert inf["input_points"] > 0
    assert inf["num_predictions"] == len(j["boxes"])
    for b in j["boxes"]:
        assert len(b["c"]) == 8 and b["s"] >= 0
    status2, j2 = _post(served[0] + "/infer", {"augment": "none"})
    assert status2 == 200
    assert j2["stats"]["inference"]["input_points"] >= inf["input_points"]
    assert {"nms_pre_overflow", "topk_block_miss"} <= set(
        j2["stats"]["inference"])


def test_augment_none_payload_matches_jax_server(served):
    body = {"augment": "none", "dror": True}
    s1, got = _post(served[0] + "/augment", body)
    s2, want = _post(served[1] + "/augment", body)
    assert s1 == s2 == 200
    assert got == want
    assert got["stats"]["dror"]["removed"] > 0


def test_snow_payload_matches_jax_keys_and_run_pipeline(served):
    """Snow on a slider position no other test asks for: the JAX server's
    keys and invariants, and byte for byte the port's run_pipeline with
    numpy's global seed (the channel order's generator) set the same."""
    body = {"augment": "snow", "seed": 4}
    np.random.seed(11)
    s1, got = _post(served[0] + "/augment", body)
    s2, want = _post(served[1] + "/augment", body)
    assert s1 == s2 == 200
    assert set(got) == set(want) and set(got["frame"]) == set(want["frame"])
    assert set(got["stats"]) == set(want["stats"])
    assert set(got["stats"]["snow"]) == set(want["stats"]["snow"])
    for j in (got, want):
        labels = _labels(j["frame"])
        assert set(np.unique(labels)) <= {0, 1, 2}
        assert sum(j["stats"]["labels"].values()) == j["stats"][
            "after_masks"]
    assert got["stats"]["after_masks"] == want["stats"]["after_masks"]

    _, _, args, ap = served
    fargs = argparse.Namespace(**vars(args))
    fargs.augment, fargs.seed = "snow", 4
    np.random.seed(11)
    pc, report, boxes = tinspect.run_pipeline(fargs, ap)
    assert got["frame"] == json.loads(json.dumps(
        tviewer._frame_payload(pc, boxes, args.max_points)))
    assert got["stats"]["snow"] == report["snow"]
    snow = next(a for k, a in tinspect._AUGMENTER_CACHE.items()
                if k[0] == "snow" and k[4] == 4)
    assert {n: int(getattr(snow.last_result, n))
            for n in OVERFLOW_COUNTERS} == dict.fromkeys(OVERFLOW_COUNTERS, 0)


def _frame_rows(frame):
    """(n, 4) xyz and label of a frame payload."""
    cols = [np.frombuffer(base64.b64decode(frame[k]), np.float32)
            for k in ("xs", "ys", "zs")]
    return np.column_stack([*cols, _labels(frame).astype(np.float32)])


def test_snow_payload_matches_jax_server_values(served, monkeypatch):
    """Snow at a seed no other test asks for, with the JAX package's
    RANSAC draws in the port's snowfall and wet ground, and numpy's global
    seed set before each server's request: the frame's rows (xyz, label) in
    the JAX server's order under the parity contract, and the stats equal
    where no point differs."""
    from lidar_snow_sim_tpu_torch.models import snowfall as tsnow
    from lidar_snow_sim_tpu_torch.models import wet_ground as twet

    monkeypatch.setattr(tsnow, "ransac_draws", jax_draws)
    monkeypatch.setattr(twet, "ransac_draws", jax_draws)
    body = {"augment": "snow", "seed": 6}
    np.random.seed(17)
    s1, got = _post(served[0] + "/augment", body)
    np.random.seed(17)
    s2, want = _post(served[1] + "/augment", body)
    assert s1 == s2 == 200
    assert got["frame"]["n"] == want["frame"]["n"]
    rows = _frame_rows(got["frame"])
    assert (rows[:, 3] > 0).sum() > 0
    differ = assert_rows_parity(rows, _frame_rows(want["frame"]))
    if not differ:
        assert got["stats"] == want["stats"]


def test_infer_matches_jax_detect(served, tmp_path):
    """/infer with JAX-initialised weights in an experiment's
    params_tpu.npz: the boxes of the port's detect on the displayed cloud,
    and that detect against the JAX package's, run op by op, up to the
    _flips gate."""
    url, _, args, ap = served
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "pointpillar.yaml").write_text(SMALL_YAML)
    jcfg = jpp.config_from_openpcdet_yaml(exp / "pointpillar.yaml")
    params = {k: np.array(v) for k, v in jax.jit(
        lambda key: jpp.init_params(jcfg, key))(jax.random.PRNGKey(0)).items()}
    params["dense_head.conv_cls.bias"][:] = 0.0   # about half pass
    np.savez(exp / "params_tpu.npz", **params)

    fargs = argparse.Namespace(**vars(args))
    fargs.config, fargs.random_params = None, False
    fargs.experiment = str(exp)
    app = tserve.ViewerApp(fargs, ap)
    out = app.infer({"augment": "none"})

    pc, _, _ = app._pipeline(app._clean({"augment": "none"}))
    pts = np.asarray(pc[:, :4], np.float32).copy()
    pts[:, 3] *= args.intensity_scale
    cfg, net = app._get_engine()
    got = tpp.detect(pts, None, net, device="cpu")
    arr = tpp.predictions_array(got)
    assert out["stats"]["inference"]["num_predictions"] == len(arr) > 0
    assert [b["s"] for b in out["boxes"]] == [round(float(s), 4)
                                             for s in arr[:, 8]]

    with jax.disable_jit():
        want = jpp.detect(jnp.asarray(pts), jnp.ones(len(pts), bool),
                          params, jnp.asarray(jpp.generate_anchors(jcfg)),
                          jcfg)
    want_t = tpp.Predictions(
        boxes=torch.as_tensor(np.array(want.boxes)),
        scores=torch.as_tensor(np.array(want.scores)),
        labels=torch.as_tensor(np.array(want.labels)),
        count=torch.as_tensor(np.array(want.count)))
    cls = tpp.forward_features(torch.as_tensor(pts),
                               torch.ones(len(pts), dtype=torch.bool),
                               net)[0]
    flips, near, unexplained = SMOKE["_flips"](
        got, want_t, torch.sigmoid(cls.amax(-1)), cfg)
    assert unexplained == 0, (flips, near)
    assert int(got.nms_pre_overflow) + int(got.topk_block_miss) == int(
        want.nms_pre_overflow)
    assert out["stats"]["inference"]["nms_pre_overflow"] == int(
        got.nms_pre_overflow)
