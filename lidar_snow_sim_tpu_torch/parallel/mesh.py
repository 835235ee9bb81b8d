"""Device mesh and frame sharding (counterpart of
`lidar_snow_sim_tpu/parallel/mesh.py`).

The JAX mesh has two axes: 'data' shards frames, and 'beam' shards the
points of one scan through GSPMD, which inserts the collectives of the
global reductions (plane fit, noise floor, statistics) and turns the
Pallas kernels off (`parallel/batched.py:170-175` there). Torch has no
such partitioner, and splitting one 65,536-point scan over cards would
cost more in communication than it saves. So here frames are sharded over
all data x beam devices, whole scans to each, and the kernels stay on: a
sharded step returns what the unsharded one returns, byte for byte, and
the mesh's shape only sets how many shards there are. The JAX check that
a batch divides by the 'data' axis is kept (`run_snowfall_datagen`).

`shard_frames` cuts a batch's leading frame axis into contiguous,
near-equal pieces, one for each device of the mesh in row-major order;
`run_shards` runs a function on each piece with the piece's device
current; `gather_frames` puts the pieces' results back in frame order.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, beam) grid of torch devices. `shape` is a dict, as JAX's
    `Mesh.shape`: mesh.shape["data"]. A device may appear more than once
    (two shards on one card, or on the CPU)."""

    devices: tuple            # data rows of beam torch.devices each
    axis_names: tuple = ("data", "beam")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "beam": len(self.devices[0])}

    @property
    def flat(self) -> list:
        """The devices in row-major order, one per shard."""
        return [d for row in self.devices for d in row]


def make_mesh(data: int = 1, beam: int = 1, devices=None) -> Mesh:
    """A (data, beam) mesh over the first data x beam of `devices`
    (default: every visible CUDA device, none where there is no card)."""
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    devices = [torch.device(d) for d in devices]
    n = data * beam
    if n > len(devices):
        raise ValueError(
            f"mesh {data}x{beam} needs {n} devices, have {len(devices)}")
    return Mesh(tuple(tuple(devices[i * beam:(i + 1) * beam])
                      for i in range(data)))


def shard_frames(mesh: Mesh, batch: int) -> list:
    """[(device, slice of frames)] for a batch of `batch` frames: contiguous
    pieces in frame order, the first ones a frame longer where the batch
    does not divide; devices that get no frame are left out."""
    bounds = torch.arange(batch).tensor_split(len(mesh.flat))
    return [(dev, slice(int(b[0]), int(b[-1]) + 1))
            for dev, b in zip(mesh.flat, bounds) if len(b)]


def gather_frames(parts: list, device):
    """The shards' results, each a tensor or a tuple (NamedTuple) of
    tensors with a leading frame axis, concatenated in frame order on
    `device`."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    fields = [gather_frames(list(f), device) for f in zip(*parts)]
    return type(first)(*fields) if hasattr(first, "_fields") else \
        tuple(fields)


def _current(device):
    """`device` current for the calling thread where it is a card."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_shards(mesh: Mesh, batch: int, fn) -> list:
    """fn(device, frames) for each shard of `batch` frames
    (`shard_frames`; frames is a slice), in order, from the calling
    thread, each with its device current; the results in frame order.
    Launches are asynchronous, so cards still overlap their work. One host
    thread per card ran the bench batch of 4 at 19.8 against 42.0 scans/s
    unsharded on two H100s (the frame loop is host-bound, and the threads
    contend for the interpreter lock; `_true_float32`'s process-wide
    backend flags race between them too). Spreading host work over cards
    takes processes: `tools/precompute.py --shard i/n`, one a card, or the
    data-parallel ranks of `parallel/distributed.spawn_ranks`."""
    out = []
    for dev, frames in shard_frames(mesh, batch):
        with _current(dev):
            out.append(fn(dev, frames))
    return out
