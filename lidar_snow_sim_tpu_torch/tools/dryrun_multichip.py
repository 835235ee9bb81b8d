"""The multi-device check (counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`): sharded results must equal unsharded
ones, with distinct seeded data on every shard.

    python -m lidar_snow_sim_tpu_torch.tools.dryrun_multichip [--n 2]
        [--device cuda]

With n devices (distinct cards where there are n, else the one `--device`
n times; the CPU tests pass `devices=["cpu"] * n`):

1. snow plus wet ground through `parallel/batched.make_sharded_step` on
   the mesh shapes (n, 1), (n/2, 2) and (n/4, 4), one distinct scan a
   frame (the JAX check's seeds and tiny configuration), equal to the
   unsharded `batched_step` byte for byte, field by field; the snow
   attenuates and the wet path modifies most frames;
2. one data-parallel PointPillars train step over n ranks (the JAX
   check's tiny detector, one distinct scene a rank), against the
   one-process step on the whole batch: loss within 2e-5 relative, every
   parameter within 1e-5 absolute, the averaged gradients within 1e-5 of
   each one's largest value;
3. detect (with the trained parameters), LISA and DROR over frame shards,
   equal to the unsharded runs byte for byte.

The port shards frames over every device of the mesh, 'beam' axis
included (`parallel/mesh.py`), so each frame runs the same code as
unsharded and the check is exact where the JAX one needs a tolerance on
the wet intensities.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# the JAX check's scenes whose post-snow ground keeps the wet path busy
GOOD_SEEDS = [100, 101, 105, 106, 108, 109, 110, 112, 113, 115, 116,
              117, 118, 119, 120, 121, 122, 123]


def _tiny_scan(cfg, calib, n_azimuth, seed):
    """One padded synthetic scan, uniformly subsampled to capacity (a head
    cut would drop the close-range bottom lasers and the ground with
    them)."""
    from lidar_snow_sim_tpu_torch import pad_cloud, synthetic_scan

    pc = synthetic_scan(n_azimuth=n_azimuth, seed=seed, calib=calib)
    rng = np.random.default_rng(seed)
    if len(pc) > cfg.max_points:
        pc = pc[np.sort(rng.choice(len(pc), cfg.max_points, replace=False))]
    return pad_cloud(pc, cfg.max_points)


def tiny_setup(seed=0, n_particles=400):
    """The JAX check's tiny snowfall configuration and its particle bank
    (`__graft_entry__._tiny_setup`): (cfg, calib, bank)."""
    from lidar_snow_sim_tpu_torch import (
        SnowfallConfig,
        build_bank,
        load_hdl64_calib,
    )

    cfg = SnowfallConfig(
        max_points=2048, window_size=64, wide_capacity=32, max_occluders=16,
        max_bumps=8, point_chunk=256, ransac_trials=16, assembly="dense",
        channel_capacity=64, block_points=16, slice_width=128,
        chunk_group=16,
    )
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(64):
        ang = rng.uniform(0, 2 * np.pi, n_particles)
        d = np.sqrt(rng.uniform(0.01, 1, n_particles)) * 60
        r = rng.uniform(0.0005, 0.003, n_particles)   # mm-scale flakes
        sets.append(np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))
    bank = build_bank(sets, window_size=cfg.window_size,
                      wide_threshold=cfg.wide_threshold,
                      wide_capacity=cfg.wide_capacity)
    return cfg, load_hdl64_calib(), bank


def det_config():
    """The JAX check's tiny detector (`__graft_entry__.py:236-255`)."""
    from lidar_snow_sim_tpu_torch.models.pointpillars import (
        PointPillarsConfig,
    )

    return PointPillarsConfig(
        class_names=("Car", "Pedestrian"),
        point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
        voxel_size=(0.5, 0.5, 4.0), max_points_per_pillar=8,
        max_pillars=128, pfn_filters=(16,), layer_nums=(1, 1, 1),
        layer_strides=(2, 2, 2), num_filters=(16, 32, 64),
        upsample_strides=(1, 2, 4), num_upsample_filters=(16, 16, 16),
        anchor_sizes=((3.9, 1.6, 1.56), (0.8, 0.6, 1.73)),
        anchor_bottom_heights=(-1.78, -0.6),
        anchor_match_thresholds=(0.6, 0.5),
        anchor_unmatch_thresholds=(0.45, 0.35),
        nms_pre_max=64, nms_post_max=16,
    )


def det_batch(cfg, n_frames: int):
    """The JAX check's detector scenes: 512 uniform points a frame and one
    gt box a frame on an anchor of its class; (points, valid, gts)."""
    from lidar_snow_sim_tpu_torch.models.pointpillars import generate_anchors

    flat = generate_anchors(cfg).reshape(-1, 7)
    rng = np.random.default_rng(0)
    pts = np.stack([np.column_stack([
        rng.uniform(0, 16, 512), rng.uniform(-8, 8, 512),
        rng.uniform(-3, 1, 512), rng.uniform(0, 1, 512),
    ]).astype(np.float32) for _ in range(n_frames)])
    gts = np.zeros((n_frames, 8, 8), np.float32)
    for i in range(n_frames):
        a_i = (101 + 53 * i) % len(flat)
        gts[i, 0, :7] = flat[a_i]
        gts[i, 0, 7] = (a_i % cfg.num_anchors_per_loc) // 2 + 1
    return pts, np.ones(pts.shape[:2], bool), gts


def train_step(rank, device, world: int, n_frames: int, lr: float = 1e-3,
               seed: int = 7):
    """One SGD step (`lr`, as the JAX check's optax.sgd(1e-3): Adam's
    first step, lr * g / (|g| + eps), turns rounding-level differences of
    near-zero gradients into differences of up to lr) of the tiny detector
    on `device`, as
    rank `rank` of `world` (data-parallel when world > 1) on its
    contiguous share of `det_batch(n_frames)`. Returns rank 0's (metrics,
    state dict, gradients) as numpy, None on the other ranks."""
    from lidar_snow_sim_tpu_torch.models import detector_train as dtr
    from lidar_snow_sim_tpu_torch.models import pointpillars as tpp

    cfg = det_config()
    pts, valid, gts = det_batch(cfg, n_frames)
    per = n_frames // world
    share = slice(rank * per, (rank + 1) * per)
    step, init = dtr.make_train_step(
        cfg, tpp.generate_anchors(cfg), lambda it: lr,
        data_parallel=world > 1,
        make_optimizer=lambda net, lr0: torch.optim.SGD(net.parameters(),
                                                        lr=lr0))
    net = tpp.PointPillars(
        cfg, tpp.init_params(cfg, torch.Generator().manual_seed(seed)),
        device=device)
    state, metrics = step(init(net), *(
        torch.as_tensor(x[share], device=device) for x in (pts, valid, gts)))
    if rank != 0:
        return None
    sd = state.net.state_dict()
    return ({k: float(v) for k, v in metrics.items()},
            {k: sd[k].detach().cpu().numpy() for k in tpp.param_shapes(cfg)},
            {k: p.grad.detach().cpu().numpy()
             for k, p in state.net.named_parameters()})


def _equal(got, want, what: str) -> None:
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, torch.Tensor) and not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{what}: {name} differs from unsharded")


def snow_wet_check(n: int, devices) -> list:
    """Check 1; returns one report line a mesh shape."""
    from lidar_snow_sim_tpu_torch import WetGroundConfig
    from lidar_snow_sim_tpu_torch.models.snowfall import (
        bank_to_torch,
        calib_to_torch,
    )
    from lidar_snow_sim_tpu_torch.parallel.batched import (
        batched_step,
        frame_draws,
        make_sharded_step,
    )
    from lidar_snow_sim_tpu_torch.parallel.mesh import make_mesh

    cfg, calib, bank = tiny_setup()
    # poly power estimator: on the tiny scene the linear fit's threshold
    # sits above most post-snow ground intensities
    wet_cfg = WetGroundConfig(min_ground_points=50,
                              estimation_method="poly")
    b = max(n, 2)
    seeds = (GOOD_SEEDS + [200 + i for i in range(b)])[:b]
    scans = [_tiny_scan(cfg, calib, 64, s) for s in seeds]
    home = torch.device(devices[0])
    points = torch.as_tensor(np.stack([s.points for s in scans]), device=home)
    mask = torch.as_tensor(np.stack([s.mask for s in scans]), device=home)
    orders = torch.as_tensor(np.stack(
        [np.random.default_rng(s).permutation(64) for s in seeds]),
        device=home)
    draws = [frame_draws(s, cfg, wet_cfg) for s in seeds]
    draws = (torch.stack([d[0] for d in draws]).to(home),
             torch.stack([d[1] for d in draws]).to(home))
    bank_t, calib_t = bank_to_torch(bank, home), calib_to_torch(calib, home)
    if len({tuple(s.points[:8, 0].tolist()) for s in scans}) != b:
        raise AssertionError("the scans are not distinct")
    ref_snow, ref_wet = batched_step(points, mask, bank_t, calib_t, orders,
                                     draws, cfg, wet_cfg)

    shapes = [(n, 1)] + [(n // k, k) for k in (2, 4) if n % k == 0]
    lines = []
    for data, beam in shapes:
        mesh = make_mesh(data, beam, devices=devices)
        snow, wet = make_sharded_step(mesh, cfg, wet_cfg)(
            points, mask, bank_t, calib_t, orders, draws)
        if snow.planes.shape != (b, 5, cfg.max_points):
            raise AssertionError(f"snow planes {tuple(snow.planes.shape)}")
        _equal(snow, ref_snow, f"mesh ({data},{beam}) snow")
        _equal(wet, ref_wet, f"mesh ({data},{beam}) wet")
        modified = wet.num_modified.cpu()
        if int(snow.num_attenuated.sum()) <= 0:
            raise AssertionError("the snow attenuated nothing")
        if int((modified > 0).sum()) < (b + 1) // 2:
            raise AssertionError(f"wet path idle: {modified.tolist()}")
        lines.append(
            f"dryrun_multichip ok: mesh=(data={data}, beam={beam}), "
            f"batch={b}, attenuated={snow.num_attenuated.tolist()}, "
            f"wet_modified={modified.tolist()} (sharded == unsharded)")
    return lines


def train_check(n: int, devices) -> tuple:
    """Check 2: (report line, the one-process step's trained state
    dict)."""
    from lidar_snow_sim_tpu_torch.parallel.distributed import spawn_ranks

    ref_m, ref_sd, ref_g = train_step(0, devices[0], 1, n)
    sh_m, sh_sd, sh_g = spawn_ranks(train_step, devices, n, n)[0]
    if ref_m["num_pos"] < 1.0:
        raise AssertionError("no positive anchors in the dryrun")
    if abs(sh_m["loss"] - ref_m["loss"]) > 2e-5 * abs(ref_m["loss"]):
        raise AssertionError(f"loss {sh_m['loss']} vs {ref_m['loss']}")
    err_p = {k: float(np.abs(sh_sd[k] - v).max()) for k, v in ref_sd.items()}
    if max(err_p.values()) > 1e-5:
        raise AssertionError(f"params differ: {_over(err_p, 1e-5)}")
    err_g = {k: float(np.abs(sh_g[k] - g).max())
             / max(float(np.abs(g).max()), 1e-30) for k, g in ref_g.items()}
    if max(err_g.values()) > 1e-5:
        raise AssertionError(f"gradients differ: {_over(err_g, 1e-5)}")
    return (f"dryrun_multichip ok: detector train step data-parallel over "
            f"{n} ranks (loss={sh_m['loss']:.6f}, num_pos="
            f"{sh_m['num_pos']:.1f}, params max abs err "
            f"{max(err_p.values()):.3g}, gradients max rel err "
            f"{max(err_g.values()):.3g}) == one-process update", ref_sd)


def _over(errs: dict, tol: float) -> dict:
    return {k: e for k, e in errs.items() if e > tol}


def infer_weather_check(n: int, devices, trained: dict) -> str:
    """Check 3: detect, LISA and DROR over frame shards."""
    import math

    from lidar_snow_sim_tpu_torch.models import lisa as tlisa
    from lidar_snow_sim_tpu_torch.models import pointpillars as tpp
    from lidar_snow_sim_tpu_torch.models.dror import dror_windowed
    from lidar_snow_sim_tpu_torch.parallel.mesh import (
        gather_frames,
        make_mesh,
        run_shards,
    )

    mesh = make_mesh(n, 1, devices=devices)
    home = torch.device(devices[0])
    b = max(n, 2)

    def sharded(fn, *batched):
        """fn(device, frame tensors) frame by frame on each shard, against
        the same on the first device alone."""
        def shard(dev, f):
            return [fn(dev, *(t[i].to(dev) for t in batched))
                    for i in range(f.start, f.stop)]

        got = [r for part in run_shards(mesh, b, shard) for r in part]
        want = [fn(home, *(t[i].to(home) for t in batched))
                for i in range(b)]
        return gather_frames([_stack1(g) for g in got], "cpu"), \
            gather_frames([_stack1(w) for w in want], "cpu")

    cfg = det_config()
    pts, valid, _ = (torch.as_tensor(x) for x in det_batch(cfg, b))
    nets = {}

    def detect(dev, p, v):
        key = str(dev)
        if key not in nets:
            nets[key] = tpp.PointPillars(cfg, trained, device=dev)
        preds = tpp.detect(p, v, nets[key], device=dev)
        return tuple(torch.as_tensor(getattr(preds, f))
                     for f in ("boxes", "scores", "labels", "count",
                               "points_dropped", "pillars_dropped",
                               "nms_pre_overflow"))

    got, want = sharded(detect, pts, valid)
    for name, a, w in zip(("boxes", "scores", "labels", "count"), got,
                          want):
        if not torch.equal(a, w):
            raise AssertionError(f"detect over shards: {name} differs")
    counts = want[3].reshape(-1).tolist()

    snow_cfg, calib, _ = tiny_setup()
    seeds = (GOOD_SEEDS + [200 + i for i in range(b)])[:b]
    scans = [_tiny_scan(snow_cfg, calib, 64, s) for s in seeds]
    points = torch.as_tensor(np.stack([s.points for s in scans]))
    mask = torch.as_tensor(np.stack([s.mask for s in scans]))
    lisa = tlisa.LISA(max_droplets=8, tail_droplets=4, dsd_points=64,
                      device="cpu")
    tables = lisa._dsd_tables(10.0)
    alpha = float(lisa.alpha(10.0))
    density = float(lisa.droplet_density(10.0))
    core = lisa.core_config()
    lisa_pts = points.clone()
    lisa_pts[..., 3] /= 255.0
    n_pts = points.shape[1]
    draws = [tlisa.lisa_draws(n_pts, 8, 4,
                              torch.Generator().manual_seed(1000 + s))
             for s in seeds]
    lisa_draws = [torch.stack([d[k] for d in draws]) for k in range(5)]

    def lisa_frame(dev, p, m, *d):
        res = tlisa.lisa_augment_core(
            p, m, d, torch.tensor(alpha, device=dev),
            torch.tensor(density, device=dev),
            tlisa.lisa_tables_to_torch(tables, dev), core)
        return tuple(res)

    got, want = sharded(lisa_frame, lisa_pts, mask, *lisa_draws)
    for a, w in zip(got, want):
        if not torch.equal(a, w):
            raise AssertionError("LISA over shards differs from unsharded")
    scattered = want[3].reshape(-1).tolist()
    if sum(scattered) <= 0:
        raise AssertionError("LISA scattered nothing")

    coef = float(np.float32(3.0) * np.float32(math.radians(0.45)))

    def dror_frame(dev, p, m):
        return dror_windowed(p[:, :3], m, coef, 3, 0.04, block=64,
                             window=256, margin=128)

    got, want = sharded(dror_frame, points, mask)
    for a, w in zip(got, want):
        if not torch.equal(a, w):
            raise AssertionError("DROR over shards differs from unsharded")
    dropped = (mask.sum(1) - want[0].sum(1)).tolist()
    return (f"dryrun_multichip ok: over {n} frame shards, detect "
            f"(detections a frame {counts}), LISA (scattered {scattered})"
            f" and DROR (dropped {dropped}, overflows "
            f"{want[1].reshape(-1).tolist()}) == unsharded")


def _stack1(result):
    """A per-frame result with a leading frame axis of 1."""
    return tuple(torch.as_tensor(t).unsqueeze(0) for t in result)


def dryrun_multichip(n_devices: int, devices=None) -> list:
    """Run the three checks over `devices` (default: n distinct cards, or
    the one card n times); raise on a mismatch, return the report lines."""
    if devices is None:
        from lidar_snow_sim_tpu_torch.device import resolve_device
        from lidar_snow_sim_tpu_torch.parallel.distributed import (
            rank_devices,
        )

        devices = rank_devices(resolve_device("cuda"), n_devices)
    devices = [torch.device(d) for d in devices][:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    lines = snow_wet_check(n_devices, devices)
    line, trained = train_check(n_devices, devices)
    lines.append(line)
    lines.append(infer_weather_check(n_devices, devices, trained))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2, help="devices (shards)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every shard where there are "
                         "fewer cards than --n (default cuda)")
    args = ap.parse_args(argv)
    from lidar_snow_sim_tpu_torch.device import resolve_device
    from lidar_snow_sim_tpu_torch.parallel.distributed import rank_devices

    devices = rank_devices(resolve_device(args.device), args.n)
    for line in dryrun_multichip(args.n, devices):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
