"""Live viewer server on PyTorch (counterpart of
`lidar_snow_sim_tpu/tools/serve.py`): the reference Qt viewer's interactive
loop, no Qt.

`python -m lidar_snow_sim_tpu_torch.tools.viewer scan.bin --serve` starts a
local HTTP server (stdlib only) behind the tools/viewer.py page:

- moving a control re-runs the port's inspect pipeline on the base scan
  and sends the new frame payload, as the reference's `snowfall_change`
  (`pointcloud_viewer.py:1635`) re-augments the displayed cloud at every
  slider move; snow runs kernels W1 and W2 on the card, LISA kernel L1;
- the "run inference" button runs the port's PointPillars `detect` on the
  displayed (augmented and masked) cloud and overlays the predicted boxes,
  as the reference's `run_inference` (`pointcloud_viewer.py:2388-2436`)
  feeds `self.current_pc` to its detector.

Endpoints (one thread on purpose: requests run one after another on the
server's thread, and the page shows a busy marker):

  GET  /         the interactive page (initial frame and parameter panel)
  POST /augment  JSON params -> {"frame": payload, "stats": {...}}
  POST /infer    JSON params -> {"boxes": [...], "stats": {...}}

Augmenters (the inspect pipeline's cache) and pipeline results (a bounded
cache here) are kept, so a repeated slider position and the augment ->
infer sequence reuse loaded banks and computed clouds. Everything runs on
--device (default cuda: the server raises at start without a card); the
detector is built there at the first /infer.
"""

from __future__ import annotations

import copy
import http.server
import json
from pathlib import Path

import numpy as np

from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.models.pointpillars import (
    detect,
    predictions_array,
)
from lidar_snow_sim_tpu_torch.tools.infer import (
    class_counts,
    load_engine,
    prediction_boxes,
)
from lidar_snow_sim_tpu_torch.tools.inspect import run_pipeline
from lidar_snow_sim_tpu_torch.tools.viewer import (
    _AUG_CHOICES,
    _box_entries,
    _frame_payload,
    render_page,
)

# the knobs a client may override per request (everything else — scan path,
# bank dir, detector weights — is pinned by the CLI invocation)
_PARAM_TYPES = {
    "augment": str,
    "rate": float,
    "velocity": float,
    "mode": str,
    "rain_rate": float,
    "fog_alpha": float,
    "beta": float,
    "dror": bool,
    "seed": int,
}


class ViewerApp:
    """Server-side state: the base CLI args, caches, and the lazy engine."""

    def __init__(self, args, ap):
        self.args = args
        self.ap = ap
        self.device = resolve_device(args.device)
        self._results: dict = {}     # param-key -> (pc, report, boxes)
        self._order: list = []       # insertion order for cache bounding
        self._engine = None          # (cfg, PointPillars on self.device)

    # ---- parameter handling ----

    def _clean(self, params: dict) -> dict:
        out = {}
        for k, v in (params or {}).items():
            if k not in _PARAM_TYPES:
                raise ValueError(f"unknown parameter {k!r}")
            try:
                out[k] = _PARAM_TYPES[k](v)
            except (TypeError, ValueError):
                raise ValueError(f"bad value for {k!r}: {v!r}")
        aug = out.get("augment", self.args.augment)
        if aug not in _AUG_CHOICES:
            raise ValueError(f"unknown augment {aug!r}")
        if aug in ("snow", "snow+wet") and not self.args.bank_dir:
            raise ValueError(
                "snow augmentation needs --bank-dir on the serve command"
            )
        if out.get("mode", self.args.mode) not in ("gunn", "sekhon"):
            raise ValueError("mode must be gunn or sekhon")
        return out

    def _pipeline(self, clean: dict):
        key = json.dumps(clean, sort_keys=True)
        if key not in self._results:
            fargs = copy.copy(self.args)
            for k, v in clean.items():
                setattr(fargs, k, v)
            self._results[key] = run_pipeline(fargs, self.ap)
            self._order.append(key)
            if len(self._order) > 32:
                self._results.pop(self._order.pop(0), None)
        return self._results[key]

    @staticmethod
    def _stats(report: dict) -> dict:
        stats = {"log": report.get("log", "")}
        for key in ("after_masks", "snow", "wet", "lisa", "fog", "stf_fog",
                    "dror", "labels", "inference"):
            if key in report:
                stats[key] = report[key]
        return stats

    # ---- endpoints ----

    def page(self) -> str:
        pc, report, boxes = self._pipeline(self._clean({}))
        scan = Path(self.args.scan)
        defaults = {
            "augment": self.args.augment,
            "rate": self.args.rate,
            "velocity": self.args.velocity,
            "mode": self.args.mode,
            "rain_rate": self.args.rain_rate,
            "fog_alpha": self.args.fog_alpha,
            "beta": self.args.beta,
            "dror": self.args.dror,
        }
        return render_page(
            [(scan.stem, pc, boxes)],
            title=f"{scan.name} [live]",
            stats=self._stats(report),
            max_points=self.args.max_points,
            pred_threshold=self.args.pred_threshold,
            serve_defaults=defaults,
        )

    def augment(self, params: dict) -> dict:
        pc, report, boxes = self._pipeline(self._clean(params))
        return {
            "frame": _frame_payload(pc, boxes, self.args.max_points),
            "stats": self._stats(report),
        }

    def _get_engine(self):
        if self._engine is None:
            self._engine = load_engine(self.args, self.device)
        return self._engine

    def infer(self, params: dict) -> dict:
        """The detector on the displayed cloud (run_inference,
        pointcloud_viewer.py:2388-2436), as the infer CLI calls it."""
        pc, report, _boxes = self._pipeline(self._clean(params))
        if len(pc) == 0:
            raise ValueError("There are no points to process.")  # :2412
        cfg, net = self._get_engine()
        pts = np.asarray(pc[:, :4], np.float32).copy()
        pts[:, 3] *= self.args.intensity_scale
        preds = detect(pts, None, net, device=self.device)
        arr = predictions_array(preds)
        stats = self._stats(report)
        stats["inference"] = {
            "input_points": len(pts),
            "num_predictions": int(preds.count),
            "nms_pre_overflow": int(preds.nms_pre_overflow),
            # the JAX package's nms_pre_overflow is the sum of the two
            "topk_block_miss": int(preds.topk_block_miss),
            "classes": class_counts(arr, cfg.class_names),
        }
        return {"boxes": _box_entries(None, prediction_boxes(
            arr, cfg.class_names)), "stats": stats}


class _Handler(http.server.BaseHTTPRequestHandler):
    app: ViewerApp  # bound by make_server

    def log_message(self, *a):  # quiet by default
        pass

    def _send(self, code: int, body: str, ctype="application/json"):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            self._send(200, self.app.page(), "text/html; charset=utf-8")
        else:
            self._send(404, json.dumps({"error": "not found"}))

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        try:
            params = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(params, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            return self._send(400, json.dumps({"error": str(e)}))
        try:
            if self.path == "/augment":
                out = self.app.augment(params)
            elif self.path == "/infer":
                out = self.app.infer(params)
            else:
                return self._send(404, json.dumps({"error": "not found"}))
        except ValueError as e:
            return self._send(400, json.dumps({"error": str(e)}))
        except Exception as e:  # noqa: BLE001 — surface, don't kill the loop
            return self._send(
                500, json.dumps({"error": f"{type(e).__name__}: {e}"})
            )
        self._send(200, json.dumps(out))


def make_server(args, ap) -> http.server.HTTPServer:
    """HTTPServer bound to (args.host, args.port); port 0 = ephemeral
    (tests). Single-threaded: augmentation/inference requests serialize.
    Raises where args.device is the card and there is none."""
    app = ViewerApp(args, ap)
    handler = type("BoundHandler", (_Handler,), {"app": app})
    return http.server.HTTPServer((args.host, args.port), handler)


def serve_viewer(args, ap) -> int:
    srv = make_server(args, ap)
    host, port = srv.server_address[:2]
    print(f"serving viewer on http://{host}:{port}/  (ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0
