"""Several processes on `torch.distributed` (counterpart of
`lidar_snow_sim_tpu/parallel/distributed.py`).

Datagen scales over hosts as in the JAX package: share-nothing shards
(`tools/precompute.py --shard i/n` on each host; the skip-if-exists
manifest makes overlap harmless), then `all_hosts_stats` merges each
host's DatagenStats, the only communication the workload needs.
`initialize` joins the processes into one group, from torchrun's
environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT) or from its
arguments.

The counters are summed in int64. The JAX version sums them in float32
(`distributed.py:71-74` there), which rounds any total above 2^24: one STF
split is ~34,690 scans of ~50,000 points, ~1.7e9 points.

Data-parallel training (`models/detector_train.make_train_step(...,
data_parallel=True)`, `tools/train.py --dp-devices N`) runs one process a
rank, started by `spawn_ranks`: NCCL where each rank has a card of its
own, gloo where ranks share a card or run on the CPU (gloo reduces CUDA
tensors too; NCCL refuses two ranks on one card). `all_reduce_sum` is the
autograd-aware sum that train-mode BN reduces its statistics with, and
`average_gradients` the update's gradient mean.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

_SUMMED_FIELDS = (
    "frames_done", "frames_skipped", "frames_failed",
    "points_in", "points_out", "attenuated", "removed",
)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join this process to a gloo process group when there are several;
    a no-op for one. The arguments default to torchrun's WORLD_SIZE and
    RANK, and the rendezvous to MASTER_ADDR:MASTER_PORT
    (`coordinator_address` "host:port" in its place). Returns True when a
    group was initialized. The only collective here, `all_hosts_stats`,
    reduces host counters, so the backend is gloo."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "0")) or None
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


def is_primary_host() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def all_hosts_stats(local):
    """Global DatagenStats: each counter summed over every process in
    int64 (one all_reduce), the local wall time kept, as the JAX version
    keeps it. One process: `local` itself."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    # NCCL reduces card tensors only
    where = "cuda" if dist.get_backend() == "nccl" else "cpu"
    vals = torch.tensor([int(getattr(local, f)) for f in _SUMMED_FIELDS],
                        dtype=torch.int64, device=where)
    dist.all_reduce(vals)
    return dataclasses.replace(
        local, **{f: int(v) for f, v in zip(_SUMMED_FIELDS, vals)})


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum over the ranks of the
    incoming gradients: every rank's loss depends on every rank's term."""

    @staticmethod
    def forward(ctx, t):
        out = t.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the default group's ranks, differentiable: a plain
    `dist.all_reduce` would drop the gradient that flows through the other
    ranks' terms."""
    return _AllReduceSum.apply(t)


def average_gradients(params) -> None:
    """Replace each parameter's .grad by its mean over the ranks, in one
    all_reduce of the flattened gradients."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def mean_over_ranks(values: dict) -> dict:
    """{name: 0-dim tensor} averaged over the ranks, in one all_reduce."""
    names = sorted(values)
    flat = torch.stack([values[k].detach().float() for k in names])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    return dict(zip(names, flat.unbind()))


def backend_for(devices) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    devices = [torch.device(d) for d in devices]
    own_cards = (all(d.type == "cuda" for d in devices)
                 and len({str(d) for d in devices}) == len(devices))
    return "nccl" if own_cards else "gloo"


def rank_devices(device, world: int) -> list:
    """The device of each of `world` ranks: distinct cards where there are
    that many and `device` is a card, else `device` for every rank."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world > 1:
        return [torch.device("cuda", i) for i in range(world)]
    return [device] * world


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, devices, init, args, results):
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(devices), init_method=init,
                            world_size=len(devices), rank=rank)
    try:
        results.put((rank, fn(rank, dev, *args)))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, devices, *args) -> list:
    """Run fn(rank, device, *args) in one spawned process per entry of
    `devices`, joined into one process group (`backend_for`) over a
    localhost port; returns the ranks' results in rank order. fn must be
    a module-level function and its arguments and result picklable. A
    rank that raises raises here."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    init = f"tcp://localhost:{free_port()}"
    procs = mp.start_processes(
        _rank_main, args=(fn, [str(d) for d in devices], init, args,
                          results),
        nprocs=len(devices), join=False, start_method="spawn")
    got = {}
    while not procs.join(timeout=0.2):   # raises if a rank failed
        while not results.empty():
            rank, value = results.get()
            got[rank] = value
    while not results.empty():
        rank, value = results.get()
        got[rank] = value
    missing = sorted(set(range(len(devices))) - set(got))
    if missing:
        raise RuntimeError(f"ranks {missing} returned no result")
    return [got[r] for r in range(len(devices))]
