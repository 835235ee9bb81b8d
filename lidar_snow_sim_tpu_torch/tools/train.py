"""Train / fine-tune the PointPillars detector on a directory of scans, on
PyTorch (counterpart of `lidar_snow_sim_tpu/tools/train.py`).

The CVPR'22 paper precomputes snow-augmented datasets (`tools/precompute.py`
/ `parallel/datagen.py` here) and then trains OpenPCDet detectors on them;
the viewer consumes the resulting checkpoints (`pointcloud_viewer.py:
2478-2494`). This CLI is that training step, built on
`models/detector_train.py` (pcdet's target-assignment and loss contract)
and the engine in `models/pointpillars.py`.

Data layout: a directory of KITTI-style `.bin` clouds (x y z intensity
f32, what `parallel.datagen` emits) plus a labels directory of same-stem
`.txt` files in the KITTI-LiDAR layout `tools/infer.py` writes and
`tools/evaluate.py` reads. Boxes whose class is not in the config's
CLASS_NAMES are dropped (pcdet's dataset filtering). Frames are assembled
by the JAX CLI's numpy code, so both CLIs train on the same bytes.

Augmentation (pcdet's DataAugmentor pipeline, `models/detector_augment.py`):
`--gt-sampling 'Car:15,...'` builds a gt database from the labels dir and
pastes collision-free samples per frame on the host; `--augment` applies
world flip/rotation/scaling on the device per step, with draws from a
torch.Generator seeded by (seed, step). The batch choice and the gt
sampling are the JAX CLI's per-(seed, step) numpy streams.

Optimizer: torch.optim.Adam under a one-cycle schedule
(`optax.cosine_onecycle_schedule` with pcdet's pointpillar defaults: LR
0.003, DIV_FACTOR 10, PCT_START 0.4; a constant LR below 4 steps), as the
JAX CLI. pcdet also cycles Adam's beta1; neither CLI does.

Checkpoints are the JAX CLI's `.npz` layout: `step`, `count` (Adam's step
count), `params/*`, and Adam's `mu/*` and `nu/*` for every parameter (zero
for the BN running stats, which Adam does not update). Each CLI resumes
the other's checkpoints. They are saved every `--save-every` steps and at
the end; `--resume` restarts from the latest one and replays the rest of
the run bit for bit: the run uses deterministic algorithms (cuBLAS
workspace config, no cuDNN benchmark). The final params, `params_tpu.npz`,
load straight into `tools/infer.py --params`.

Same flags as the JAX CLI, plus --device (default cuda; without a card it
raises, and the CPU must be asked for with --device cpu).

Data parallelism: --dp-devices N (default: every visible card, 1 on the
CPU) trains on N ranks when N > 1 divides --batch, as the JAX CLI shards
its batch over N devices, and else on one; stderr says which. Each rank
is a spawned process with a card of its own (NCCL) or, where there are
fewer cards than ranks or --device cpu, the ranks share the device (gloo);
`parallel/distributed.spawn_ranks`. Every rank draws the step's whole
seeded batch and takes its contiguous slice; train-mode BN takes its
statistics over all ranks and the gradients are averaged
(`models/detector_train.make_train_step(..., data_parallel=True)`), so
the step is the one-process step up to the order of its sums. Rank 0
writes the log, the checkpoints and the final params; --resume replays a
data-parallel run bit for bit at the same rank count.

Example (synthetic smoke run):
  python -m lidar_snow_sim_tpu_torch.tools.train --synthetic 8 --steps 4 \\
      --batch 2 --max-points 4096 --out ckpt_dir/
Real run on datagen output:
  python -m lidar_snow_sim_tpu_torch.tools.train --scans out_snow/ \\
      --labels labels/ --epochs 80 --batch 4 --out ckpt_dir/
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _stem_key(stem: str) -> int:
    """Deterministic per-scan RNG word from the file stem (crc32 is stable
    across processes, unlike hash())."""
    import zlib

    return zlib.crc32(stem.encode())


def _collect_frames(args, cfg):
    """[(points (N,4) f32, gt (G,8) f32)] with fixed shapes."""
    name_to_id = {n: i + 1 for i, n in enumerate(cfg.class_names)}
    frames = []
    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        r = cfg.point_cloud_range
        for _ in range(args.synthetic):
            n = args.max_points
            pts = rng.uniform(
                [r[0], r[1], r[2], 0.0], [r[3], r[4], r[5], 1.0], (n, 4)
            ).astype(np.float32)
            g = min(8, args.max_gt)
            gt = np.zeros((args.max_gt, 8), np.float32)
            gt[:g, 0] = rng.uniform(r[0] + 5, r[3] - 5, g)
            gt[:g, 1] = rng.uniform(r[1] + 5, r[4] - 5, g)
            gt[:g, 2] = rng.uniform(-1.8, 0.0, g)
            gt[:g, 3:6] = [4.0, 1.8, 1.6]
            gt[:g, 6] = rng.uniform(-np.pi, np.pi, g)
            gt[:g, 7] = rng.integers(1, len(cfg.class_names) + 1, g)
            frames.append((pts, gt))
        return frames

    from lidar_snow_sim_tpu_torch.utils.boxes import read_label_file
    from lidar_snow_sim_tpu_torch.utils.pointcloud import load_velodyne_bin

    scan_dir = Path(args.scans)
    label_dir = Path(args.labels) if args.labels else None
    bins = sorted(scan_dir.glob("*.bin"))
    if not bins:
        raise SystemExit(f"no .bin scans in {scan_dir}")
    dropped_points = dropped_gt = 0
    for b in bins:
        pc = load_velodyne_bin(b, columns=args.columns)[:, :4]
        pc = pc.astype(np.float32)
        pc[:, 3] *= args.intensity_scale
        if len(pc) > args.max_points:
            # random subsample, not head-truncation (the head of an STF
            # scan is the bottom lasers, a biased crop); one (seed, stem)
            # stream a scan, so the subsampling is not correlated across
            # the corpus
            sel = np.random.default_rng([args.seed, _stem_key(b.stem)]).choice(
                len(pc), args.max_points, replace=False
            )
            pc = pc[sel]
            dropped_points += 1
        elif len(pc) < args.max_points:
            pad = np.zeros((args.max_points - len(pc), 4), np.float32)
            pad[:, :3] = 1e3  # outside point_cloud_range -> dead pillars
            pc = np.concatenate([pc, pad], axis=0)
        gt = np.zeros((args.max_gt, 8), np.float32)
        if label_dir is not None:
            lf = label_dir / (b.stem + ".txt")
            rows = [
                bx
                for bx in read_label_file(lf, classes=None)
                if bx.identity in name_to_id
            ] if lf.exists() else []
            if len(rows) > args.max_gt:
                rows = rows[: args.max_gt]
                dropped_gt += 1
            for i, bx in enumerate(rows):
                gt[i] = [
                    bx.x, bx.y, bx.z, bx.length, bx.width, bx.height,
                    bx.yaw, name_to_id[bx.identity],
                ]
        frames.append((pc, gt))
    if dropped_points or dropped_gt:
        print(
            f"WARNING: subsampled {dropped_points} oversized scans "
            f"(max_points={args.max_points}) and truncated gt in "
            f"{dropped_gt} frames (max_gt={args.max_gt})",
            file=sys.stderr,
        )
    return frames


def step_seed(seed: int, step: int) -> int:
    """The torch.Generator seed of step `step`'s world-augmentation draws:
    a function of (seed, step) alone, so --resume replays them."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def save_checkpoint(path, state):
    """TrainState -> flat npz in the JAX CLI's layout: step, count,
    params/*, and Adam's mu/* and nu/* for every parameter name (zeros
    for the running stats and for parameters Adam has not stepped)."""
    from lidar_snow_sim_tpu_torch.models.pointpillars import param_shapes

    net, opt = state.net, state.optimizer
    names = param_shapes(net.cfg)
    sd = net.state_dict()
    learn = dict(net.named_parameters())
    count = 0
    arrs = {}
    for k in names:
        v = sd[k].detach().cpu().numpy()
        arrs[f"params/{k}"] = v
        st = opt.state.get(learn[k], {}) if k in learn else {}
        if st:
            count = int(st["step"])
        for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            arrs[f"{slot}/{k}"] = (st[key].detach().cpu().numpy() if st
                                   else np.zeros_like(v))
    arrs["step"] = np.asarray(state.step, np.int32)
    arrs["count"] = np.asarray(count, np.int32)
    np.savez(path, **arrs)


def load_checkpoint(path, init_state, cfg, device="cuda"):
    """npz (either CLI's) -> TrainState on `device`, with Adam's moments
    and step count restored."""
    from lidar_snow_sim_tpu_torch.models.pointpillars import PointPillars

    with np.load(path) as z:
        params = {k[len("params/"):]: z[k] for k in z.files
                  if k.startswith("params/")}
        moments = {k: z[k] for k in z.files if k.startswith(("mu/", "nu/"))}
        count, step = int(z["count"]), int(z["step"])
    state = init_state(PointPillars(cfg, params, device=device))
    if count:
        for name, p in state.net.named_parameters():
            state.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.as_tensor(moments[f"mu/{name}"]).to(p),
                "exp_avg_sq": torch.as_tensor(moments[f"nu/{name}"]).to(p),
            }
    state.step = step
    return state


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the duration of the call, so --resume
    replays a run bit for bit on the card: torch's deterministic mode,
    cuDNN's deterministic algorithms without benchmarking, and a fixed
    cuBLAS workspace. torch reads CUBLAS_WORKSPACE_CONFIG once, at the
    process's first cuBLAS call, and then raises in deterministic mode
    unless it was set: a process that uses cuBLAS before training sets it
    first (as the experiment tool does)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cudnn = torch.backends.cudnn
    old = (torch.are_deterministic_algorithms_enabled(), cudnn.benchmark,
           cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0])
        cudnn.benchmark, cudnn.deterministic = old[1], old[2]


def make_schedule(total_steps: int, lr: float):
    """The JAX CLI's LR schedule: the one-cycle from 4 steps on, else a
    constant (a one-cycle over fewer steps has a zero-width warm-up, which
    optax turns into a NaN LR)."""
    from lidar_snow_sim_tpu_torch.models.detector_train import (
        onecycle_schedule,
    )

    if total_steps >= 4:
        return onecycle_schedule(total_steps, lr, pct_start=0.4,
                                 div_factor=10.0, final_div_factor=1000.0)
    return lambda it: lr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", help="directory of .bin clouds")
    ap.add_argument("--labels", help="directory of KITTI-LiDAR label .txt")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train on N synthetic frames (smoke test)")
    ap.add_argument("--experiment", help="OpenPCDet experiment dir (yaml)")
    ap.add_argument("--config", help="explicit pcdet yaml")
    ap.add_argument("--init-params",
                    help="warm-start params .npz (e.g. a converted "
                         "checkpoint, for fine-tuning on augmented data)")
    ap.add_argument("--out", required=True, help="checkpoint directory")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --out")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=0,
                    help="explicit total steps (overrides --epochs)")
    ap.add_argument("--limit-steps", type=int, default=0,
                    help="stop after this many steps THIS invocation; the "
                         "LR schedule still spans the full run, so "
                         "--resume continues bit-exactly")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.003,
                    help="one-cycle peak LR (pcdet pointpillar default)")
    ap.add_argument("--max-points", type=int, default=65536)
    ap.add_argument("--max-gt", type=int, default=64)
    ap.add_argument("--intensity-scale", type=float, default=1.0 / 255.0,
                    help="DENSE .bin intensity is 0-255; pcdet trains 0-1")
    ap.add_argument("--columns", type=int, default=5,
                    help=".bin column count (STF/datagen scans are 5-wide)")
    ap.add_argument("--augment", action="store_true",
                    help="pcdet world augmentations (flip along x, "
                         "rotation U[-pi/4,pi/4], scaling U[0.95,1.05]) "
                         "applied on the device per step")
    ap.add_argument("--gt-sampling", default="",
                    help="pcdet gt-sampling SAMPLE_GROUPS, e.g. "
                         "'PassengerCar:15,Pedestrian:10': paste database "
                         "samples until each class reaches the target "
                         "count (requires --scans/--labels)")
    ap.add_argument("--gt-db-min-points", type=int, default=5,
                    help="gt database: min interior points per box "
                         "(pcdet filter_by_min_points)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--dp-devices", type=int, default=0,
                    help="data-parallel ranks (default: every visible "
                         "card; 1 on the CPU); used when it divides "
                         "--batch")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the "
                         "CPU)")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.scans:
        raise SystemExit("need --scans (or --synthetic N)")

    from lidar_snow_sim_tpu_torch.device import resolve_device
    from lidar_snow_sim_tpu_torch.parallel import distributed

    device = resolve_device(args.device)
    world = args.dp_devices or (torch.cuda.device_count()
                                if device.type == "cuda" else 1)
    if world > 1 and args.batch % world == 0:
        devices = distributed.rank_devices(device, world)
        print(f"data-parallel over {world} ranks "
              f"({distributed.backend_for(devices)}, devices "
              f"{[str(d) for d in devices]}), {args.batch // world} frames "
              "a rank", file=sys.stderr)
        distributed.spawn_ranks(_train, devices, args, world)
        return 0
    why = (f"batch {args.batch} does not divide over {world} ranks"
           if world > 1 else "one rank")
    print(f"not data-parallel ({why}): one process on {device}",
          file=sys.stderr)
    return _train(0, device, args, 1)


def _train(rank: int, device, args, world: int) -> int:
    """The training run of rank `rank` of `world` on `device`: its
    contiguous share of each step's batch; rank 0 logs and writes."""
    import dataclasses

    from lidar_snow_sim_tpu_torch.models import detector_train as dtr
    from lidar_snow_sim_tpu_torch.models.pointpillars import (
        PointPillars,
        PointPillarsConfig,
        config_from_openpcdet_yaml,
        generate_anchors,
        init_params,
    )

    def say(msg):
        if rank == 0:
            print(msg, file=sys.stderr)

    yaml_path = args.config
    if args.experiment and not yaml_path:
        from lidar_snow_sim_tpu_torch.tools.convert_checkpoint import (
            find_experiment_files,
        )

        yaml_path, _ = find_experiment_files(args.experiment)
    cfg = (
        config_from_openpcdet_yaml(yaml_path)
        if yaml_path else PointPillarsConfig()
    )
    cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)

    frames = _collect_frames(args, cfg)
    steps_per_epoch = max(len(frames) // args.batch, 1)
    total_steps = args.steps or steps_per_epoch * args.epochs

    name_to_id = {n: i + 1 for i, n in enumerate(cfg.class_names)}
    gt_db = gt_groups = None
    if args.gt_sampling:
        if not (args.scans and args.labels):
            raise SystemExit("--gt-sampling requires --scans and --labels")
        from lidar_snow_sim_tpu_torch.models.detector_augment import (
            GTSampleDB,
            parse_sample_groups,
        )

        gt_groups = parse_sample_groups(args.gt_sampling)
        unknown = set(gt_groups) - set(cfg.class_names)
        if unknown:
            raise SystemExit(f"--gt-sampling classes not in config: {unknown}")
        gt_db = GTSampleDB.build(
            args.scans, args.labels, cfg.class_names,
            columns=args.columns, intensity_scale=args.intensity_scale,
            min_points=args.gt_db_min_points,
        )
        say(f"gt-sampling database: {gt_db.stats()}")

    if args.augment:
        from lidar_snow_sim_tpu_torch.models.detector_augment import (
            world_augment,
            world_draws,
        )

    schedule = make_schedule(total_steps, args.lr)
    anchors = generate_anchors(cfg)
    step_fn, init_state = dtr.make_train_step(cfg, anchors, schedule,
                                              data_parallel=world > 1)
    per_rank = args.batch // world
    share = slice(rank * per_rank, (rank + 1) * per_rank)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with deterministic():
        ckpts = sorted(out_dir.glob("ckpt_*.npz"))
        if args.resume and ckpts:
            state = load_checkpoint(ckpts[-1], init_state, cfg, device)
            say(f"resumed {ckpts[-1]} at step {state.step}")
        else:
            if args.init_params:
                from lidar_snow_sim_tpu_torch.tools.convert_checkpoint \
                    import load_params

                params = load_params(args.init_params)
                say(f"warm-started from {args.init_params}")
            else:
                params = init_params(
                    cfg, torch.Generator().manual_seed(args.seed))
            state = init_state(PointPillars(cfg, params, device=device))

        t0 = time.time()
        start = state.step
        for it in range(start, total_steps):
            # batch composition depends only on (seed, step), so --resume
            # replays the exact remaining stream
            idx = np.random.default_rng((args.seed, it)).choice(
                len(frames), args.batch, replace=len(frames) < args.batch
            )
            batch = [frames[i] for i in idx]
            if gt_db is not None:
                batch = [
                    gt_db.sample_into(
                        np.random.default_rng((args.seed, it, bi)),
                        p, g, gt_groups, name_to_id,
                    )[:2]
                    for bi, (p, g) in enumerate(batch)
                ]
            # the whole batch's frames and draws, then this rank's share
            pts = torch.as_tensor(np.stack([p for p, _g in batch[share]]),
                                  device=device)
            gts = torch.as_tensor(np.stack([g for _p, g in batch[share]]),
                                  device=device)
            if args.augment:
                gen = torch.Generator().manual_seed(step_seed(args.seed, it))
                draws = world_draws(gen, args.batch)
                pts, gts = world_augment(pts, gts,
                                         *(d[share] for d in draws))
            valid = torch.ones(pts.shape[:2], dtype=torch.bool,
                               device=device)
            state, metrics = step_fn(state, pts, valid, gts)
            if (it + 1) % args.log_every == 0 or it + 1 == total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                rate = (it + 1 - start) / max(time.time() - t0, 1e-9)
                say(
                    f"step {it + 1}/{total_steps} loss={m['loss']:.4f} "
                    f"(cls {m['loss_cls']:.4f} loc {m['loss_loc']:.4f} "
                    f"dir {m['loss_dir']:.4f}) pos={m['num_pos']:.1f} "
                    f"lr={float(schedule(it)):.2e} {rate:.2f} steps/s"
                )
            if rank == 0 and ((it + 1) % args.save_every == 0
                              or it + 1 == total_steps):
                path = out_dir / f"ckpt_{it + 1:07d}.npz"
                save_checkpoint(path, state)
                say(f"saved {path}")
            if args.limit_steps and it + 1 - start >= args.limit_steps:
                break

    if rank != 0:
        return 0
    # make the stop point resumable even off the save-every grid
    path = out_dir / f"ckpt_{state.step:07d}.npz"
    if state.step > start and not path.exists():
        save_checkpoint(path, state)
        say(f"saved {path}")

    # inference-ready params for tools/infer.py --params
    from lidar_snow_sim_tpu_torch.models.pointpillars import param_shapes

    sd = state.net.state_dict()
    final = out_dir / "params_tpu.npz"
    np.savez(final, **{k: sd[k].detach().cpu().numpy()
                       for k in param_shapes(cfg)})
    say(f"wrote {final}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
