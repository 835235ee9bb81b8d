"""How far the full-width train step's gradients move under rounding, on
one CUDA device and its host's CPU.

    python -m scripts.grad_noise [--draws 3]

Run from the repository root. One float32 `forward_backward` at batch 1
(frame 0 of the train CLI's `--synthetic 8` frames, seed 0) of
`PointPillarsConfig()` with seeded random weights, on the CPU and on the
card; then the same step again on each, on the CPU without oneDNN, and
with the weights (and, on the CPU, the points' x, y, z) multiplied by
1 + 1e-7 N(0, 1) (`--draws` seeds). Prints the card's name and power
limit, then one JSON line a pair of runs: the largest gradient error
relative to the gradient's largest value (chip_smoke's `_rel_err`), its
parameter, how many of the 66 gradients are past 1e-3, and the error of
`backbone_2d.deblocks.2.0.weight`. Then, alone, the stride-4 transposed
convolution's weight gradient (that parameter's layer) on random inputs
against float64 on the CPU, on the CPU and on the card in true float32.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.nn import functional as F

from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
from lidar_snow_sim_tpu_torch.models.detector_train import forward_backward
from lidar_snow_sim_tpu_torch.tools.kernel_times import card_line
from lidar_snow_sim_tpu_torch.tools.train import _collect_frames

DEBLOCK = "backbone_2d.deblocks.2.0.weight"


def step_grads(cfg, params, points, gt, anchors, device) -> dict:
    """{name: float64 CPU gradient} of one batch-1 `forward_backward`."""
    net = tpp.PointPillars(cfg, params, device=device)
    valid = torch.ones(1, len(points), dtype=torch.bool)
    forward_backward(net, points[None], valid, gt[None].to(device),
                     anchors.to(device))
    return {n: p.grad.double().cpu() for n, p in net.named_parameters()}


def spread(a: dict, b: dict) -> dict:
    """Each gradient's max |a - b| over max |b|, and a summary."""
    err = {k: float((a[k] - b[k]).abs().max() / b[k].abs().max())
           if float(b[k].abs().max()) else float((a[k] - b[k]).abs().max())
           for k in b}
    worst = max(err, key=err.get)
    return {"max_rel_err": err[worst], "worst": worst,
            "over_1e-3": sum(e > 1e-3 for e in err.values()),
            "of": len(err), DEBLOCK: err.get(DEBLOCK)}


def perturbed(tensors: dict, seed: int, eps: float = 1e-7) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {k: v * (1 + eps * torch.randn(v.shape, generator=gen))
            for k, v in tensors.items()}


def deconv_wgrad_errors() -> dict:
    """The stride-4 ConvTranspose2d (256 -> 128, k 4) weight gradient at
    full width on random inputs, against float64 on the CPU."""
    from lidar_snow_sim_tpu_torch.models.pointpillars import _true_float32

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 256, 62, 54, generator=gen)
    w = 0.05 * torch.randn(256, 128, 4, 4, generator=gen)
    dy = torch.randn(1, 128, 248, 216, generator=gen)

    def wgrad(device, dtype):
        ww = w.to(device, dtype).clone().requires_grad_()   # a fresh leaf
        y = F.conv_transpose2d(x.to(device, dtype), ww, stride=4)
        (y * dy.to(device, dtype)).sum().backward()
        return ww.grad.double().cpu()

    ref = wgrad("cpu", torch.float64)
    out = {"cpu": wgrad("cpu", torch.float32)}
    with _true_float32():
        out["card"] = wgrad("cuda", torch.float32)
    return {k: float((v - ref).abs().max() / ref.abs().max())
            for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(card_line(), flush=True)
    cfg = tpp.PointPillarsConfig()

    class Frames:   # the train CLI's arguments that _collect_frames reads
        synthetic, seed, max_points, max_gt = 8, 0, 65536, 64

    pts, gt = (torch.as_tensor(v) for v in _collect_frames(Frames, cfg)[0])
    anchors = torch.as_tensor(tpp.generate_anchors(cfg)).reshape(-1, 7)
    params = tpp.init_params(cfg, torch.Generator().manual_seed(0))

    def run(device, prm=params, points=pts):
        return step_grads(cfg, prm, points, gt, anchors, device)

    runs = {"cpu": run("cpu"), "cpu_again": run("cpu"),
            "card": run("cuda"), "card_again": run("cuda")}
    with torch.backends.mkldnn.flags(enabled=False):
        runs["cpu_no_onednn"] = run("cpu")
    pairs = [("cpu_again", "cpu"), ("card_again", "card"), ("card", "cpu"),
             ("cpu_no_onednn", "cpu")]
    for seed in range(1, args.draws + 1):
        moved = perturbed(params, seed)
        runs[f"cpu_w{seed}"] = run("cpu", moved)
        runs[f"card_w{seed}"] = run("cuda", moved)
        xyz = perturbed({"p": pts[:, :3]}, 100 + seed)["p"]
        runs[f"cpu_p{seed}"] = run("cpu", points=torch.cat(
            [xyz, pts[:, 3:]], 1))
        pairs += [(f"cpu_w{seed}", "cpu"), (f"card_w{seed}", "card"),
                  (f"card_w{seed}", f"cpu_w{seed}"), (f"cpu_p{seed}", "cpu")]
    for a, b in pairs:
        print(json.dumps({"runs": f"{a} vs {b}", **spread(runs[a], runs[b])}),
              flush=True)
    print(json.dumps({"deconv_wgrad_vs_float64": deconv_wgrad_errors()}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
