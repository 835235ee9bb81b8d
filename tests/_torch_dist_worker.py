"""Rank functions for the port's multi-process CPU tests, run by
`lidar_snow_sim_tpu_torch.parallel.distributed.spawn_ranks` in spawned
processes (they import this module by name, so it imports neither jax nor
the JAX package)."""

import dataclasses

import torch


def stats_rank(rank, device, big: int):
    """all_hosts_stats over the ranks of made-up counters: points_in =
    big * (rank + 1). Returns (merged counters, is_primary_host())."""
    from lidar_snow_sim_tpu_torch.parallel import distributed
    from lidar_snow_sim_tpu_torch.parallel.datagen import DatagenStats

    local = DatagenStats(frames_done=rank + 1, points_in=big * (rank + 1),
                         removed=7 * (rank + 1), wall_s=float(rank))
    merged = distributed.all_hosts_stats(local)
    return dataclasses.asdict(merged), distributed.is_primary_host()


def grad_rank(rank, device):
    """The gradient of (rank + 1) * all_reduce_sum(x ** 2)[0] at
    x = [rank + 1, 2]."""
    from lidar_snow_sim_tpu_torch.parallel import distributed

    x = torch.tensor([1.0 + rank, 2.0], requires_grad=True)
    y = distributed.all_reduce_sum(x * x)
    (y[0] * (rank + 1)).backward()
    return x.grad.tolist()


def initialize_rank(rank, port: int, results):
    """`distributed.initialize` from explicit arguments, then a stats
    merge; puts (rank, returned flag, merged frames_done, primary?)."""
    import torch.distributed as dist

    from lidar_snow_sim_tpu_torch.parallel import distributed
    from lidar_snow_sim_tpu_torch.parallel.datagen import DatagenStats

    ok = distributed.initialize(f"localhost:{port}", 2, rank)
    try:
        merged = distributed.all_hosts_stats(
            DatagenStats(frames_done=rank + 1))
        results.put((rank, ok, merged.frames_done,
                     distributed.is_primary_host()))
    finally:
        dist.destroy_process_group()
