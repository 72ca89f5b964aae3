"""Process group, rank mesh and batch sharding for data-parallel training
and sharded evaluation (PyTorch counterpart of deepim_tpu/parallel/mesh.py).

The JAX package builds a 1-D `jax.sharding.Mesh` over every chip, lays the
batch out along its 'dp' axis and lets XLA insert the gradient all-reduce.
Here the mesh is the `torch.distributed` world: one process (rank) per
card, started by `python -m torch.distributed.run`, with NCCL between
cards and gloo on the CPU.  A rank computes on the rows it holds, so where
the JAX helpers annotate a global array with a sharding, these return the
rank's rows (shard_pytree_batch), rank 0's value (replicate_pytree) or the
rows of every rank (gather_batch).

`batch_sharding`, `replicated`, `batch_specs_like` and
`replicated_specs_like` have no counterpart: they build JAX
`NamedSharding`/`PartitionSpec` annotations, which PyTorch does not have.
Their rule (a leaf whose leading dim divides over the mesh is split along
it, any other leaf is whole on every rank) lives in shard_pytree_batch.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from deepim_tpu_torch.device import resolve_device

# What torch.distributed.run sets for every rank.
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_distributed(backend: str | None = None, device="cuda") -> bool:
    """Join the process group a launcher describes; a no-op (False) when
    the launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR, set by
    `python -m torch.distributed.run`) is absent or the group exists
    already, as JAX's initialize_distributed is without its coordinator.

    `backend` defaults to NCCL on CUDA and gloo on the CPU.  On CUDA the
    rank's card, LOCAL_RANK, becomes the current device before any tensor
    is made (resolve_device then returns it).  NCCL needs a card of its own
    for every rank on the host: it raises when LOCAL_WORLD_SIZE exceeds the
    cards, and never switches backend.  gloo may share cards (rank
    LOCAL_RANK on card LOCAL_RANK mod the cards).  Returns True when it
    created the group (the caller then calls shutdown_distributed)."""
    if not all(k in os.environ for k in _LAUNCHER_ENV) or dist.is_initialized():
        return False
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"initialize_distributed: device={device!r} but torch.cuda.is_available() is False")
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend == "nccl" and kind != "cuda":
        raise RuntimeError(f"initialize_distributed: the nccl backend needs CUDA, got device={device!r}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_world > cards:
            raise RuntimeError(
                f"initialize_distributed: {local_world} ranks on this host but {cards} CUDA device(s); "
                "NCCL needs one card per rank (start fewer ranks, or ask for backend='gloo')")
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return True


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel mesh seen from one rank: its rank, the number of
    ranks, its device and the process group (None: the default group, or
    no group when size is 1 in a single process)."""

    rank: int
    size: int
    device: torch.device
    group: Any = None

    def barrier(self) -> None:
        """Wait for every rank (a no-op without a process group)."""
        if not dist.is_initialized():
            return
        if dist.get_backend(self.group) == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The 1-D mesh over every rank of the process group (JAX's
    make_mesh over jax.devices()).  Without a process group it is this
    process alone: rank 0 of 1.  `n_devices`, when given, must be the
    world size (one device per rank; a mesh of fewer ranks is not
    built)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has {size} rank(s), one device each")
    return Mesh(rank, size, dev)


def _map(fn, tree):
    """Apply fn to every leaf of a pytree of NamedTuples, tuples, lists and
    dicts (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def _as_tensor(x, device):
    if isinstance(x, np.ndarray) or torch.is_tensor(x):
        return torch.as_tensor(x).to(device)
    return x


def shard_pytree_batch(tree: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global-batch pytree (a TrainBatch, an
    Observation, MeshBuffers or a tensor; numpy leaves become tensors), on
    the mesh's device.  A leaf is split along its leading dim, rank r
    keeping rows [r n / size, (r + 1) n / size), when that dim is the
    batch's (the first array leaf's) and divides by the mesh size; any
    other leaf, and a rank-0 leaf, is whole on every rank: the rule of
    deepim_tpu/parallel/mesh.py:shard_pytree_batch and batch_specs_like.
    JAX splits any divisible leading dim, but there a sharding is only a
    layout and the program still sees the global (3, 3) intrinsics; here
    a rank computes on what it holds, so the intrinsics (the field `k` of
    a TrainBatch or an Observation) and a leaf whose leading dim is not
    the batch's stay whole even where that dim divides."""
    arrays = [x for x in _leaves(tree) if getattr(x, "ndim", 0) >= 1]
    batch = arrays[0].shape[0] if arrays else None

    def rows(x):
        x = _as_tensor(x, mesh.device)
        if not torch.is_tensor(x) or x.dim() < 1 or x.shape[0] != batch or batch % mesh.size:
            return x
        n = batch // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n]

    if isinstance(tree, tuple) and "k" in getattr(tree, "_fields", ()):
        # The intrinsics: one (3, 3) matrix for the whole batch.
        return type(tree)(*(_as_tensor(v, mesh.device) if f == "k" else _map(rows, v)
                            for f, v in zip(tree._fields, tree)))
    return _map(rows, tree)


def replicate_pytree(tree: Any, mesh: Mesh) -> Any:
    """Every tensor (or numpy) leaf as rank 0 holds it, on the mesh's
    device of every rank (a broadcast from rank 0; a copy on a mesh of
    one).  Leaves must have the same shape and dtype on every rank."""
    def bcast(x):
        x = _as_tensor(x, mesh.device)
        if not torch.is_tensor(x) or mesh.size == 1:
            return x
        x = x.clone().contiguous()
        dist.broadcast(x, src=0, group=mesh.group)
        return x

    return _map(bcast, tree)


def gather_batch(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's rows of x concatenated along `dim` in rank order (an
    all_gather: dim 0 for (B, ...) tensors, dim 1 for (T, B, ...) poses),
    on every rank.  It stays on the device: nothing waits for the host."""
    if mesh.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)
