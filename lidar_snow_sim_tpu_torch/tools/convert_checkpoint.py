"""OpenPCDet ``.pth`` checkpoints for the port's detector (counterpart of
`lidar_snow_sim_tpu/tools/convert_checkpoint.py`).

pcdet checkpoints carry the torch state dict under
``checkpoint['model_state']`` (`pointcloud_viewer.py:2478-2494`). The
port's `PointPillars` module uses the same state-dict names, so loading is
a key map: keep the names `param_shapes` declares, check their shapes, and
load them into the module. Writing the JAX package's ``params_tpu.npz`` is
still offered, so the two packages share weights.

CLI:
    python -m lidar_snow_sim_tpu_torch.tools.convert_checkpoint \
        --experiment /path/to/exp_dir [--out params.npz]

finds the yaml and pth inside the experiment directory as the viewer's
`init_config` / `init_model` do (`pointcloud_viewer.py:2443-2486`: the
last ``*.yaml`` / ``*.pth`` in listing order).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.models.pointpillars import (
    PointPillarsConfig,
    config_from_openpcdet_yaml,
    param_shapes,
)


def state_dict_to_params(
    state: dict, cfg: PointPillarsConfig, *, strict: bool = True
) -> dict:
    """Map a pcdet state dict (name -> tensor/ndarray) onto the engine's
    flat {name: float32 ndarray} parameters.

    Ignores pcdet's other entries (``global_step``,
    ``*.num_batches_tracked``, cached anchors). With strict=True, missing
    or shape-mismatched engine parameters raise ValueError.
    """
    params: dict = {}
    problems: list = []
    for name, shape in param_shapes(cfg).items():
        if name not in state:
            problems.append(f"missing: {name} {shape}")
            continue
        v = state[name]
        arr = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                         else v, np.float32)
        if arr.shape != tuple(shape):
            problems.append(
                f"shape mismatch: {name} ckpt {arr.shape} != engine {shape}")
            continue
        params[name] = arr
    if problems and strict:
        raise ValueError("checkpoint does not match the engine config:\n  "
                         + "\n  ".join(problems))
    return params


def find_experiment_files(exp_dir) -> tuple:
    """(yaml_path, pth_path) with the viewer's pick-last-in-listing rule."""
    exp_dir = Path(exp_dir)
    yaml_path = pth_path = None
    for f in os.listdir(exp_dir):
        if f.endswith(".yaml"):
            yaml_path = exp_dir / f
        if f.endswith(".pth"):
            pth_path = exp_dir / f
    return yaml_path, pth_path


def load_checkpoint(pth_path, cfg: PointPillarsConfig) -> dict:
    """The engine's parameters from a pcdet ``.pth`` (read on the CPU)."""
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    state = ckpt.get("model_state", ckpt) if isinstance(ckpt, dict) else ckpt
    return state_dict_to_params(state, cfg)


def convert_checkpoint(pth_path, cfg: PointPillarsConfig, out_path) -> dict:
    """Load a .pth, convert it, save the .npz; returns the params."""
    params = load_checkpoint(pth_path, cfg)
    np.savez(out_path, **params)
    return params


def load_params(npz_path) -> dict:
    """A converted params .npz (either package's) as a flat dict."""
    with np.load(npz_path) as z:
        return {k: z[k] for k in z.files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--experiment", required=True,
                    help="OpenPCDet experiment dir (contains .yaml + .pth)")
    ap.add_argument("--out", default=None,
                    help="output .npz (default: <exp_dir>/params_tpu.npz)")
    args = ap.parse_args(argv)

    yaml_path, pth_path = find_experiment_files(args.experiment)
    if yaml_path is None or pth_path is None:
        raise SystemExit(
            f"experiment dir {args.experiment} needs a .yaml and a .pth "
            f"(found yaml={yaml_path}, pth={pth_path})"
        )
    cfg = config_from_openpcdet_yaml(yaml_path)
    out = args.out or str(Path(args.experiment) / "params_tpu.npz")
    params = convert_checkpoint(pth_path, cfg, out)
    print(
        f"converted {pth_path} -> {out}: {len(params)} arrays, "
        f"{sum(int(np.prod(v.shape)) for v in params.values()):,} parameters"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
