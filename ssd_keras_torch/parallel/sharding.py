"""Data parallelism over ``torch.distributed`` ranks.

Port of ``ssd_keras_tpu/parallel/sharding.py``. The JAX package jits its
train step over *global* arrays on a 1-D ``('data',)`` mesh and lets XLA
insert the collectives. Here each rank runs the step on its own rows of the
global batch, and the collectives that keep every quantity global are
explicit (``loss.py``, ``models/layers.py:BatchNorm``, ``train.py``):

* a 1-D ``DeviceMesh`` named ``"data"`` (:func:`make_mesh`); rank ``r`` of
  ``n`` holds rows ``[r * B / n, (r + 1) * B / n)`` of every global batch
  and of a resident dataset;
* parameters and buffers are equal on every rank: :func:`replicate`
  broadcasts them from the mesh's first rank;
* :func:`exchange_rows` gathers rows of a global index out of a
  row-sharded resident dataset: a rank's rows may live on another rank's
  shard (the JAX package's ``jnp.take`` on a sharded array), so the rows
  move with one ``all_to_all`` per tensor;
* :func:`global_batch_from_local` all-gathers rank-local rows into the
  global batch in rank order.

Nothing falls back: a missing backend, a misconfigured launch or a collective
that the backend lacks raises. Every process group gets a timeout.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DEFAULT_TIMEOUT",
    "initialize_distributed",
    "make_mesh",
    "mesh_group",
    "shard_rows",
    "shard_batch",
    "upload_sharded",
    "replicate",
    "exchange_rows",
    "global_batch_from_local",
]

DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)
# Rows of a resident dataset that one host-to-device copy of
# ``upload_sharded`` carries.
UPLOAD_CHUNK_ROWS = 256


def initialize_distributed(backend: str, world_size: int, rank: int,
                           init_method: Optional[str] = None, store=None):
    """Join the default process group (``torch.distributed.init_process_group``)
    with a timeout of ``DEFAULT_TIMEOUT`` on every collective.

    Idempotent: a repeated call with the same backend, world size and rank
    returns. Any other mismatch with the group already joined, an unknown or
    unavailable backend, or a failed rendezvous raises: a misconfigured
    launch must not go on as a smaller or single-process run.
    """
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("torch.distributed has no NCCL backend in this build")
    if backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("torch.distributed has no gloo backend in this build")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_world_size(), dist.get_rank())
        if have != (backend, world_size, rank):
            raise RuntimeError(
                f"torch.distributed is already initialized as (backend, world, rank) = "
                f"{have}, not {(backend, world_size, rank)}")
        return
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world_size, rank=rank, timeout=DEFAULT_TIMEOUT)


def make_mesh(device_type: str = "cuda"):
    """A 1-D ``DeviceMesh`` named ``"data"`` over every rank of the default
    group. On CUDA, choose each rank's device first
    (``torch.cuda.set_device``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(initialize_distributed)")
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=("data",))


def mesh_group(mesh):
    """The process group of the mesh's ``"data"`` dimension."""
    return mesh.get_group("data")


def _rank_and_size(mesh):
    return mesh.get_local_rank("data"), mesh.size()


def shard_rows(n_rows: int, mesh) -> slice:
    """The rank's rows of ``n_rows`` global rows; they must divide evenly."""
    rank, n = _rank_and_size(mesh)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not divide over the {n}-rank mesh")
    per = n_rows // n
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch, mesh, device=None):
    """The rank's rows of a global batch (one array or tensor, or a tuple
    of them), as tensors on ``device`` (default: where they are)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh, device) for b in batch)
    t = torch.as_tensor(batch)
    t = t[shard_rows(t.shape[0], mesh)]
    return t if device is None else t.to(device)


def upload_sharded(arr, mesh, device) -> torch.Tensor:
    """The rank's rows of a host dataset, uploaded to ``device`` in pieces
    of ``UPLOAD_CHUNK_ROWS`` rows (the host never stages a whole-shard
    transfer). Each rank holds ``len(arr) / n`` rows; they must divide
    evenly."""
    arr = np.asarray(arr)
    local = arr[shard_rows(arr.shape[0], mesh)]
    out = torch.empty(local.shape, dtype=torch.from_numpy(local[:0]).dtype, device=device)
    for i in range(0, len(local), UPLOAD_CHUNK_ROWS):
        piece = torch.from_numpy(np.ascontiguousarray(local[i:i + UPLOAD_CHUNK_ROWS]))
        if out.device.type == "cuda":
            piece = piece.pin_memory()
        out[i:i + UPLOAD_CHUNK_ROWS].copy_(piece, non_blocking=True)
    return out


def replicate(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Make every parameter and buffer of ``module`` equal to the mesh's
    first rank's (a broadcast of each, in place). Returns ``module``."""
    group = mesh_group(mesh)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


def exchange_rows(shards: Sequence[torch.Tensor], index, mesh):
    """Rows ``index[rank rows]`` of a dataset sharded by rows over the mesh.

    ``shards``: each rank's row shards of one or more datasets (equal row
    counts, rank ``r`` holding rows ``[r * n, (r + 1) * n)``); ``index``:
    the global batch's row numbers, a host array that every rank holds
    equal. Returns, for each dataset, this rank's rows of
    ``dataset[index]`` in order. Which rank sends what is known on the
    host, so the rows move with one ``all_to_all`` per dataset and no
    device value is read.
    """
    group = mesh_group(mesh)
    rank, world = _rank_and_size(mesh)
    n_local = int(shards[0].shape[0])
    index = np.asarray(index, dtype=np.int64)
    per = len(index) // world
    if per * world != len(index):
        raise ValueError(f"a batch of {len(index)} rows does not divide over {world} ranks")
    if index.min(initial=0) < 0 or index.max(initial=0) >= n_local * world:
        raise ValueError("index outside the sharded dataset")
    owner = index // n_local
    segments = index.reshape(world, per)
    owners = owner.reshape(world, per)

    # What this rank sends to each rank d: its own rows that d needs, in d's order.
    send_rows = [segments[d][owners[d] == rank] - rank * n_local for d in range(world)]
    send_sizes = [len(r) for r in send_rows]
    # What it receives from each source s: its segment's rows that s owns, in order.
    recv_sizes = [int((owners[rank] == s).sum()) for s in range(world)]
    arrival = np.argsort(owners[rank], kind="stable")  # segment position of each arrival
    placement = np.empty(per, np.int64)
    placement[arrival] = np.arange(per)  # arrival index of each segment position

    device = shards[0].device
    send_index = torch.from_numpy(np.concatenate(send_rows)).to(device, non_blocking=True)
    place_index = torch.from_numpy(placement).to(device, non_blocking=True)
    out = []
    for shard in shards:
        send = shard.index_select(0, send_index)
        recv = shard.new_empty((per,) + tuple(shard.shape[1:]))
        dist.all_to_all_single(recv, send, recv_sizes, send_sizes, group=group)
        out.append(recv.index_select(0, place_index))
    return tuple(out)


def global_batch_from_local(local: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch of rank-local rows, in rank order (an all-gather;
    every rank must hold as many rows)."""
    group = mesh_group(mesh)
    _, world = _rank_and_size(mesh)
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=0)

