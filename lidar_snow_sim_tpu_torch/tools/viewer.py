"""Interactive browser point-cloud viewer on PyTorch (counterpart of
`lidar_snow_sim_tpu/tools/viewer.py`): the Qt viewer without Qt.

Runs the port's inspect pipeline (`tools/inspect.run_pipeline`: DROR ->
FOV -> masks -> augmentation, on --device) and writes ONE self-contained
HTML file with an orbitable 3-D point rendering: no Qt, no OpenGL, no
network (all JS inline, the points embedded as base64 Float32Array). The
page is the JAX tool's, byte for byte on the same cloud:

- drag to orbit, wheel to zoom, shift-drag to pan;
- color modes label / intensity / height / channel / depth
  (`pointcloud_viewer.py:3155-3231`; labels 0 unchanged, 1 attenuated or
  modified, 2 scattered);
- temporal frames: `--neighbors=-6:4` embeds the STF sample's past and
  future sweeps (utils.stf_meta.temporal_neighbors naming), each run
  through the same pipeline; arrow keys or the frame selector switch;
- box wireframes: KITTI labels (`--labels`), a saved OpenPCDet result.pkl
  (`--results`, with a live score-threshold slider) or a pickled pcdet
  data_dict (`--pcdet-dict`, `pointcloud_viewer.py:1388-1478,2500-2556`);
- the synchronized camera frame (`--image`, or the DENSE
  `cam_stereo_left_lut` sibling);
- the augmentation stat labels and log string of the Qt viewer.

Same flags as the JAX tool; --device (default cuda; without a card it
raises, and the CPU must be asked for with --device cpu). Example:

  python -m lidar_snow_sim_tpu_torch.tools.viewer scan.bin --augment snow \
      --bank-dir banks --rate 2.5 --velocity 1.6 --out scan.html

Live mode (`--serve`, tools/serve.py) re-runs the augmentation on the
server at every control change and runs the PointPillars detector on the
displayed cloud at the "run inference" button:

  python -m lidar_snow_sim_tpu_torch.tools.viewer scan.bin --serve \
      --bank-dir banks --experiment exp/   # then open http://127.0.0.1:8008
"""

from __future__ import annotations

import argparse
import base64
import copy
import html
import json
import sys
from pathlib import Path

import numpy as np

# Colors as JS expressions over normalized v in [0, 1] are computed in
# Python instead: each mode bakes an (N,) palette index into a u8 array and
# ships a 256-entry RGB palette — 1 byte/point/mode instead of 3.
_LABEL_RGB = np.array(
    [
        [200, 200, 200],   # 0 unchanged (the viewer's neutral gray)
        [66, 135, 245],    # 1 attenuated / modified ground (blue)
        [235, 64, 52],     # 2 scattered by snow (red)
    ],
    np.uint8,
)


def _turbo256() -> np.ndarray:
    """256-entry turbo-ish palette (matches utils.render._turbo_ish)."""
    from lidar_snow_sim_tpu_torch.utils.render import _turbo_ish

    v = np.linspace(0.0, 1.0, 256, dtype=np.float32)
    return (_turbo_ish(v) * 255).astype(np.uint8)


def _norm_idx(v: np.ndarray, lo=None, hi=None) -> np.ndarray:
    lo = np.min(v) if lo is None else lo
    hi = np.max(v) if hi is None else hi
    if hi <= lo:
        return np.zeros(len(v), np.uint8)
    return np.clip((v - lo) / (hi - lo) * 255, 0, 255).astype(np.uint8)


def color_planes(pc: np.ndarray) -> dict:
    """u8 palette-index planes for every color mode (get_colors parity:
    label, intensity [0,255], height, channel, depth)."""
    dist = np.linalg.norm(pc[:, :3], axis=1)
    return {
        "label": np.clip(pc[:, 4], 0, 2).astype(np.uint8),
        "intensity": _norm_idx(pc[:, 3], 0.0, 255.0),
        "height": _norm_idx(pc[:, 2], -2.5, 2.5),
        "channel": _norm_idx(pc[:, 4], 0.0, 63.0),
        "depth": _norm_idx(dist, 0.0, max(80.0, float(dist.max(initial=1)))),
    }


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


MODES = ("label", "intensity", "height", "channel", "depth")

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>lidar_snow_sim_tpu viewer</title>
<style>
 body {{ margin:0; background:#101014; color:#ddd;
        font:13px/1.4 system-ui, sans-serif; }}
 #hud {{ position:fixed; top:8px; left:8px; background:rgba(16,16,20,.85);
        padding:8px 10px; border-radius:6px; max-width:380px; }}
 #hud b {{ color:#fff; }}
 canvas {{ display:block; cursor:grab; }}
 select,input {{ background:#222; color:#ddd; border:1px solid #444; }}
 .stat {{ margin:1px 0; white-space:pre-wrap; }}
</style></head><body>
<canvas id="c"></canvas>
<img id="cam" style="position:fixed;top:8px;right:8px;max-width:38vw;
 max-height:30vh;border:1px solid #333;border-radius:4px;display:none">
<div id="hud">
 <div><b>{title}</b></div>
 <div>frame <select id="frame">{frame_options}</select>
  color <select id="mode">{mode_options}</select></div>
 <div>size <input id="psz" type="range" min="1" max="4" value="1"
   style="width:70px">
  boxes <input id="bx" type="checkbox" checked>
  pred&ge; <input id="thr" type="range" min="0" max="100" value="{pred_threshold}"
   style="width:70px"><span id="thrv">{pred_threshold}</span></div>
{serve_html}
 <div id="stats">{stats_html}</div>
 <div class="stat" style="color:#888">drag orbit / wheel zoom /
 shift-drag pan / arrow keys switch frame</div>
</div>
<script>
"use strict";
const FRAMES = {frames_json};
const MODES = {modes_json};
const PALETTES = {palettes_json};
function f32(b64) {{
  const s = atob(b64); const a = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) a[i] = s.charCodeAt(i);
  return new Float32Array(a.buffer);
}}
function u8(b64) {{
  const s = atob(b64); const a = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) a[i] = s.charCodeAt(i);
  return a;
}}
const cache = {{}};
function frame(fi) {{
  if (!(fi in cache)) {{
    const fr = FRAMES[fi];
    cache[fi] = {{
      n: fr.n,
      X: f32(fr.xs), Y: f32(fr.ys), Z: f32(fr.zs),
      idx: Object.fromEntries(MODES.map(m => [m, u8(fr.colors[m])])),
      boxes: fr.boxes,
    }};
  }}
  return cache[fi];
}}

const cv = document.getElementById("c");
const ctx = cv.getContext("2d");
let yaw = -2.2, pitch = 0.9, zoom = 9.0, panx = 0, pany = 0;
let fi = {center_index};
let mode = MODES[0], psz = 1, showBoxes = true;
let predThr = {pred_threshold};

function resize() {{
  cv.width = innerWidth; cv.height = innerHeight; draw();
}}
addEventListener("resize", resize);

function draw() {{
  const fr = frame(fi);
  const w = cv.width, h = cv.height;
  const img = ctx.createImageData(w, h);
  const d = img.data;
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const f = Math.min(w, h) * zoom / 100.0;
  const cxp = w / 2 + panx, cyp = h / 2 + pany;
  const idx = fr.idx[mode]; const pal = PALETTES[mode];
  for (let i = 0; i < fr.n; i++) {{
    const x0 = fr.X[i], y0 = fr.Y[i], z0 = fr.Z[i];
    const x1 = cy * x0 + sy * y0;
    const y1 = -sy * x0 + cy * y0;
    const z2 = cp * z0 - sp * y1;
    const y2 = sp * z0 + cp * y1 + 120;       // camera distance
    if (y2 <= 1) continue;
    const px = (cxp + f * x1 / y2 * 50) | 0;
    const py = (cyp - f * z2 / y2 * 50) | 0;
    if (px < 0 || py < 0 || px >= w || py >= h) continue;
    const ci = idx[i] * 3;
    for (let dy = 0; dy < psz; dy++) for (let dx = 0; dx < psz; dx++) {{
      const qx = px + dx, qy = py + dy;
      if (qx >= w || qy >= h) continue;
      const o = (qy * w + qx) * 4;
      d[o] = pal[ci]; d[o + 1] = pal[ci + 1]; d[o + 2] = pal[ci + 2];
      d[o + 3] = 255;
    }}
  }}
  ctx.putImageData(img, 0, 0);
  if (showBoxes && fr.boxes.length) {{
    ctx.lineWidth = 1.2;
    const E = [[0,1],[1,2],[2,3],[3,0],[4,5],[5,6],[6,7],[7,4],
               [0,4],[1,5],[2,6],[3,7]];
    for (const entry of fr.boxes) {{
      if (entry.s >= 0 && entry.s * 100 <= predThr) continue;
      ctx.strokeStyle = entry.col;
      const pts = entry.c.map(([x0, y0, z0]) => {{
        const x1 = cy * x0 + sy * y0;
        const y1 = -sy * x0 + cy * y0;
        const z2 = cp * z0 - sp * y1;
        const y2 = sp * z0 + cp * y1 + 120;
        return y2 > 1 ? [cxp + f * x1 / y2 * 50, cyp - f * z2 / y2 * 50]
                      : null;
      }});
      ctx.beginPath();
      for (const [a, b] of E) {{
        if (!pts[a] || !pts[b]) continue;
        ctx.moveTo(pts[a][0], pts[a][1]);
        ctx.lineTo(pts[b][0], pts[b][1]);
      }}
      ctx.stroke();
    }}
  }}
}}

let drag = null;
cv.addEventListener("mousedown", e => {{
  drag = [e.clientX, e.clientY, e.shiftKey]; cv.style.cursor = "grabbing";
}});
addEventListener("mouseup", () => {{ drag = null; cv.style.cursor="grab"; }});
addEventListener("mousemove", e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ panx += dx; pany += dy; }}
  else {{
    yaw += dx * 0.008;
    pitch = Math.max(0.05, Math.min(1.55, pitch + dy * 0.008));
  }}
  drag = [e.clientX, e.clientY, drag[2]];
  requestAnimationFrame(draw);
}});
cv.addEventListener("wheel", e => {{
  zoom = Math.max(1.0, Math.min(120, zoom * (e.deltaY < 0 ? 1.12 : 0.89)));
  e.preventDefault(); requestAnimationFrame(draw);
}}, {{ passive: false }});
const frameSel = document.getElementById("frame");
const camImg = document.getElementById("cam");
function setFrame(j) {{
  fi = Math.max(0, Math.min(FRAMES.length - 1, j));
  frameSel.value = fi;
  const im = FRAMES[fi].img;
  camImg.style.display = im ? "block" : "none";
  if (im) camImg.src = im;
  draw();
}}
setFrame(fi);
frameSel.addEventListener("change", e => setFrame(+e.target.value));
addEventListener("keydown", e => {{
  if (e.key === "ArrowRight") setFrame(fi + 1);
  if (e.key === "ArrowLeft") setFrame(fi - 1);
}});
document.getElementById("mode").addEventListener("change", e => {{
  mode = e.target.value; draw();
}});
document.getElementById("psz").addEventListener("input", e => {{
  psz = +e.target.value; draw();
}});
document.getElementById("bx").addEventListener("change", e => {{
  showBoxes = e.target.checked; draw();
}});
document.getElementById("thr").addEventListener("input", e => {{
  predThr = +e.target.value;
  document.getElementById("thrv").textContent = e.target.value;
  draw();
}});
{serve_js}
resize();
</script></body></html>
"""

# ---- live-serve additions (tools/serve.py; the Qt viewer's interactive
# loop: parameter change -> re-augment (`snowfall_change`,
# pointcloud_viewer.py:1635); button -> inference on the displayed cloud
# (`run_inference`, :2388-2436)) --------------------------------------------

_SERVE_HTML = """
 <div style="border-top:1px solid #333;margin-top:4px;padding-top:4px">
  <div>aug <select id="aug">{aug_options}</select>
   dror <input id="dror" type="checkbox"{dror_checked}>
   <button id="inferbtn">run inference</button> <span id="busy"
    style="color:#e8a33d"></span></div>
  <div id="p_snow">rate <input id="rate" type="range" min="0.5" max="2.5"
    step="0.5" value="{rate}" style="width:70px"><span id="ratev">{rate}</span>
   vel <input id="vel" type="range" min="0.6" max="2.0" step="0.2"
    value="{velocity}" style="width:70px"><span id="velv">{velocity}</span>
   <select id="dist">{dist_options}</select></div>
  <div id="p_lisa">rain mm/h <input id="rain" type="range" min="1" max="100"
    step="1" value="{rain_rate}" style="width:90px">
   <span id="rainv">{rain_rate}</span></div>
  <div id="p_fog">alpha <input id="foga" type="range" min="0.005" max="0.12"
    step="0.005" value="{fog_alpha}" style="width:90px">
   <span id="fogav">{fog_alpha}</span></div>
  <div id="p_stf">beta <input id="beta" type="range" min="0.01" max="0.2"
    step="0.002" value="{beta}" style="width:90px">
   <span id="betav">{beta}</span></div>
 </div>"""

# literal JS (inserted after .format(), so braces are safe here)
_SERVE_JS = """
const $id = (i) => document.getElementById(i);
const statsDiv = $id("stats");
function setStats(st) {
  statsDiv.innerHTML = Object.entries(st).map(([k, v]) =>
    '<div class="stat">' + k + ": " +
    (typeof v === "object" ? JSON.stringify(v) : v) + "</div>").join("");
}
function serveParams() {
  return {augment: $id("aug").value, rate: +$id("rate").value,
          velocity: +$id("vel").value, mode: $id("dist").value,
          rain_rate: +$id("rain").value, fog_alpha: +$id("foga").value,
          beta: +$id("beta").value, dror: $id("dror").checked};
}
function showPanels() {
  const a = $id("aug").value;
  $id("p_snow").style.display = a.includes("snow") ? "" : "none";
  $id("p_lisa").style.display = a === "lisa" ? "" : "none";
  $id("p_fog").style.display = a === "fog" ? "" : "none";
  $id("p_stf").style.display = a === "stf_fog" ? "" : "none";
}
async function servePost(path) {
  $id("busy").textContent = "working…";
  try {
    const r = await fetch(path, {method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify(serveParams())});
    const j = await r.json();
    if (j.error) { $id("busy").textContent = "error: " + j.error; return null; }
    $id("busy").textContent = "";
    return j;
  } catch (e) { $id("busy").textContent = "error: " + e; return null; }
}
async function reaugment() {
  const j = await servePost("/augment");
  if (!j) return;
  FRAMES[fi] = j.frame;
  delete cache[fi];
  if (j.stats) setStats(j.stats);
  draw();
}
async function runInference() {
  const j = await servePost("/infer");
  if (!j) return;
  const fr = frame(fi);
  fr.boxes = fr.boxes.filter(b => b.s < 0).concat(j.boxes);
  FRAMES[fi].boxes = fr.boxes;
  if (j.stats) setStats(j.stats);
  draw();
}
for (const cid of ["aug","rate","vel","dist","rain","foga","beta","dror"])
  $id(cid).addEventListener("change", () => {
    showPanels();
    for (const [i, o] of [["rate","ratev"],["vel","velv"],["rain","rainv"],
                          ["foga","fogav"],["beta","betav"]])
      $id(o).textContent = $id(i).value;
    reaugment();
  });
$id("inferbtn").addEventListener("click", runInference);
showPanels();
"""

_AUG_CHOICES = ("none", "snow", "wet", "snow+wet", "lisa", "fog", "stf_fog")


def _serve_panel(defaults: dict) -> str:
    """The parameter panel HTML for serve mode, pre-set to the CLI args."""
    aug = defaults.get("augment", "none")
    mode = defaults.get("mode", "gunn")
    return _SERVE_HTML.format(
        aug_options="".join(
            f'<option{" selected" if a == aug else ""}>{a}</option>'
            for a in _AUG_CHOICES
        ),
        dist_options="".join(
            f'<option{" selected" if m == mode else ""}>{m}</option>'
            for m in ("gunn", "sekhon")
        ),
        dror_checked=" checked" if defaults.get("dror") else "",
        rate=defaults.get("rate", 0.5),
        velocity=defaults.get("velocity", 2.0),
        rain_rate=defaults.get("rain_rate", 10.0),
        fog_alpha=defaults.get("fog_alpha", 0.02),
        beta=defaults.get("beta", 0.046),
    )


def _box_entries(boxes, preds) -> list:
    """GT boxes (always shown, class-colored) + prediction boxes (score-
    thresholded in the page, the Qt viewer's prediction_threshold_slider —
    `pointcloud_viewer.py:1476-1478`; DET_COLORS per class)."""
    from lidar_snow_sim_tpu_torch.utils.boxes import (
        BOX_COLORS,
        DET_COLORS,
        DET_FALLBACK_COLOR,
    )

    def css(rgb):
        return "#%02x%02x%02x" % tuple(rgb)

    out = []
    for b in boxes or []:
        out.append({
            "c": np.round(b.corners(), 3).tolist(),
            "col": css(BOX_COLORS.get(b.identity, (60, 240, 108))),
            "s": -1.0,
        })
    for b in preds or []:
        try:
            col = DET_COLORS[
                ("Car", "Pedestrian", "Cyclist").index(b.identity)
            ]
        except ValueError:
            col = DET_FALLBACK_COLOR
        out.append({
            "c": np.round(b.corners(), 3).tolist(),
            "col": css(col),
            "s": round(float(b.score), 4),
        })
    return out


def _image_data_url(path) -> str | None:
    """Base64 data URL of the synchronized camera frame (populate_image,
    `pointcloud_viewer.py:3053-3065`) — embedded so the HTML stays
    self-contained."""
    if not path:
        return None
    p = Path(path)
    if not p.exists():
        return None
    mime = {".png": "image/png", ".jpg": "image/jpeg",
            ".jpeg": "image/jpeg"}.get(p.suffix.lower(), "image/png")
    return f"data:{mime};base64," + base64.b64encode(p.read_bytes()).decode()


def _frame_payload(pc: np.ndarray, boxes, max_points: int,
                   preds=None, image=None) -> dict:
    if len(pc) > max_points:
        # deterministic stride decimation keeps the spatial distribution
        step = -(-len(pc) // max_points)
        pc = pc[::step]
    planes = color_planes(pc)
    return {
        "n": len(pc),
        "xs": _b64(pc[:, 0].astype(np.float32)),
        "ys": _b64(pc[:, 1].astype(np.float32)),
        "zs": _b64(pc[:, 2].astype(np.float32)),
        "colors": {m: _b64(planes[m]) for m in MODES},
        "boxes": _box_entries(boxes, preds),
        "img": _image_data_url(image),
    }


def render_page(
    frames,
    *,
    title: str = "scan",
    stats: dict | None = None,
    center_index: int = 0,
    max_points: int = 200_000,
    pred_threshold: int = 50,
    serve_defaults: dict | None = None,
) -> str:
    """Render frames [(name, (N, 5) points, boxes[, preds[, image]])] to
    one self-contained interactive HTML page string; `center_index` selects
    the initially shown frame (the non-neighbor sample). `preds` are Box3D
    predictions gated live by the score-threshold slider (initially
    `pred_threshold` %); `image` embeds the synchronized camera frame.
    `serve_defaults` (tools/serve.py) adds the live parameter panel +
    fetch JS wired to the /augment and /infer endpoints."""
    payloads = []
    names = []
    for entry in frames:
        name, pc, boxes = entry[0], entry[1], entry[2]
        preds = entry[3] if len(entry) > 3 else None
        image = entry[4] if len(entry) > 4 else None
        names.append(name)
        d = _frame_payload(pc, boxes, max_points, preds=preds, image=image)
        d["name"] = name
        payloads.append(d)
    turbo = _turbo256()
    palettes = {
        "label": _LABEL_RGB.tolist(),
        "intensity": turbo.tolist(),
        "height": turbo.tolist(),
        "channel": turbo.tolist(),
        "depth": turbo.tolist(),
    }
    stats = stats or {}
    stats_html = "".join(
        f'<div class="stat">{html.escape(str(k))}: '
        f"{html.escape(str(v))}</div>"
        for k, v in stats.items()
    )
    page = _PAGE.format(
        title=html.escape(title),
        frames_json=json.dumps(payloads),
        modes_json=json.dumps(list(MODES)),
        palettes_json=json.dumps(palettes),
        center_index=center_index,
        frame_options="".join(
            f'<option value="{i}"{" selected" if i == center_index else ""}>'
            f"{html.escape(nm)}</option>"
            for i, nm in enumerate(names)
        ),
        mode_options="".join(
            f'<option value="{m}">{m}</option>' for m in MODES
        ),
        stats_html=stats_html,
        pred_threshold=int(pred_threshold),
        serve_html=(
            _serve_panel(serve_defaults) if serve_defaults is not None else ""
        ),
        serve_js=_SERVE_JS if serve_defaults is not None else "",
    )
    return page


def write_viewer_html(frames, out_path: str | Path, **kwargs) -> Path:
    """render_page() written to `out_path` (the static one-shot CLI mode)."""
    out_path = Path(out_path)
    out_path.write_text(render_page(frames, **kwargs))
    return out_path


def _neighbor_paths(scan: Path, lo: int, hi: int) -> list[Path]:
    """Sibling sweep files of an STF-style `date_frame.bin` (the Qt
    viewer's temporal range; utils.stf_meta.temporal_neighbors naming)."""
    from lidar_snow_sim_tpu_torch.utils.stf_meta import temporal_neighbors

    stem = scan.stem
    if "_" not in stem:
        return [scan]
    date, frame = stem.rsplit("_", 1)
    if not frame.isdigit():
        return [scan]
    out = []
    for nid in temporal_neighbors(
        f"{date},{frame}", offsets=range(lo, hi + 1)
    ):
        p = scan.with_name(nid.replace(",", "_") + scan.suffix)
        if p.exists():
            out.append(p)
    return out or [scan]


def build_parser() -> argparse.ArgumentParser:
    from lidar_snow_sim_tpu_torch.tools.inspect import add_pipeline_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_pipeline_args(ap)
    ap.add_argument("--out", default="viewer.html",
                    help="output HTML file")
    ap.add_argument("--max-points", type=int, default=200_000,
                    help="decimate above this many points (per frame)")
    ap.add_argument("--results",
                    help="OpenPCDet result.pkl: render the matching "
                         "frame's predictions (viewer load_results/"
                         "visualize_predictions surface)")
    ap.add_argument("--pred-threshold", type=int, default=50,
                    help="initial prediction score-threshold slider "
                         "position (percent)")
    ap.add_argument("--pcdet-dict", dest="pcdet_dict",
                    help="render a pickled pcdet data_dict (points + "
                         "gt_boxes) instead of running the pipeline "
                         "(show_pcdet_dict surface)")
    ap.add_argument("--image",
                    help="camera image to embed (default: auto-discover "
                         "the DENSE cam_stereo_left_lut sibling)")
    ap.add_argument("--neighbors", default="0:0",
                    help="temporal frame range LO:HI around the sample "
                         "(the Qt viewer browses -6:4; pass as "
                         "--neighbors=-6:4 so argparse accepts the dash); "
                         "each neighbor runs the same mask+augmentation "
                         "pipeline")
    srv = ap.add_argument_group(
        "live serve mode (the Qt viewer's interactive loop: sliders "
        "re-augment, a button runs inference — pointcloud_viewer.py:1635,"
        ":2388-2436)"
    )
    srv.add_argument("--serve", action="store_true",
                     help="serve the viewer live instead of writing HTML")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8008)
    srv.add_argument("--experiment", default=None,
                     help="OpenPCDet experiment dir for the inference "
                          "button (.yaml + .pth / params_tpu.npz)")
    srv.add_argument("--config", default=None,
                     help="explicit detector config yaml")
    srv.add_argument("--params", default=None,
                     help="explicit detector params .npz")
    srv.add_argument("--random-params", action="store_true",
                     help="random detector weights (smoke test)")
    srv.add_argument("--max-pillars", type=int, default=0,
                     help="override detector pillar capacity")
    srv.add_argument("--intensity-scale", type=float, default=1.0 / 255.0,
                     help="intensity prescale before the detector")
    return ap


def main(argv=None):
    from lidar_snow_sim_tpu_torch.tools.inspect import run_pipeline

    ap = build_parser()
    args = ap.parse_args(argv)

    if args.serve:
        from lidar_snow_sim_tpu_torch.tools.serve import serve_viewer

        return serve_viewer(args, ap)

    from lidar_snow_sim_tpu_torch.utils.boxes import boxes_from_array
    from lidar_snow_sim_tpu_torch.utils.datasets import (
        find_camera_image,
        load_pcdet_dict,
        load_result_pkl,
        result_predictions,
    )

    if args.pcdet_dict:
        # show_pcdet_dict path: the pickled dict IS the frame
        pc, gt = load_pcdet_dict(args.pcdet_dict)
        boxes = boxes_from_array(
            gt, class_names=("",) + ("Car", "Pedestrian", "Cyclist")
        )  # pcdet gt_boxes carry 1-based class ids
        name = Path(args.pcdet_dict).stem
        out = write_viewer_html(
            [(name, pc, boxes, None, args.image)], args.out,
            title=f"{name} [pcdet dict]",
            stats={"points": len(pc), "gt_boxes": len(boxes)},
            max_points=args.max_points,
            pred_threshold=args.pred_threshold,
        )
        print(json.dumps({"viewer_html": str(out.resolve()),
                          "points": len(pc), "gt_boxes": len(boxes)},
                         indent=2))
        return 0

    result = load_result_pkl(args.results) if args.results else None

    lo, hi = (int(v) for v in args.neighbors.split(":"))
    scan = Path(args.scan)
    paths = _neighbor_paths(scan, lo, hi)

    frames = []
    center_index = 0
    report = None
    n_preds = 0
    for p in paths:
        fargs = copy.copy(args)
        fargs.scan = str(p)
        pc, rep, boxes = run_pipeline(fargs, ap)
        preds = None
        if result is not None:
            # STF frame ids are `date,frame`; files are `date_frame.bin`
            fid = p.stem
            try:
                arr = result_predictions(result, fid)
            except KeyError:
                try:
                    arr = result_predictions(
                        result, fid.replace("_", ",", 1)
                    ) if "_" in fid else None
                except KeyError:
                    arr = None
            if arr is not None:
                preds = boxes_from_array(
                    arr, class_names=("Car", "Pedestrian", "Cyclist")
                )
                n_preds += len(preds)
        image = args.image if p.resolve() == scan.resolve() else None
        image = image or find_camera_image(p)
        if p.resolve() == scan.resolve():
            center_index = len(frames)
            report = rep
        frames.append((p.stem, pc, boxes, preds, image))

    report = report or {}
    stats = {"frames": len(frames), "log": report.get("log", "")}
    for key in ("snow", "wet", "lisa", "fog", "stf_fog", "dror", "labels"):
        if key in report:
            stats[key] = report[key]
    if result is not None:
        stats["predictions"] = n_preds
    out = write_viewer_html(
        frames,
        args.out,
        title=f"{scan.name} [{args.augment}]",
        stats=stats,
        center_index=center_index,
        max_points=args.max_points,
        pred_threshold=args.pred_threshold,
    )
    report["viewer_html"] = str(out.resolve())
    report["frames_embedded"] = [entry[0] for entry in frames]
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
