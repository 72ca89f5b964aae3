"""Data-parallel training step and batched refinement over the rank mesh
(PyTorch counterpart of deepim_tpu/parallel/dp.py).

Where the JAX package jits the step with the batch sharded over 'dp' and
lets XLA insert the gradient mean, each rank here runs the step on its own
rows through a DistributedDataParallel replica of the network, whose
backward all-reduces the gradients (NCCL on the cards, gloo on the CPU).
The losses divide by the rank's batch, so DDP's mean over ranks is the
global batch's mean gradient, and every rank applies the same update.
The network at 480x640 has 57,746,092 parameters: each inner update
all-reduces 231 MB of fp32 gradients.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from deepim_tpu_torch.config import Config
from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, Observation, refine
from deepim_tpu_torch.engine.train import TrainState
from deepim_tpu_torch.parallel.mesh import Mesh, gather_batch, shard_pytree_batch


class _Replica(DistributedDataParallel):
    """DDP whose attribute reads fall through to the network, so the
    engine's getattr(model, "num_regressors") sees the wrapped one."""

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name == "module":
                raise
            return getattr(self.module, name)


def find_unused_parameters(cfg: Config) -> bool:
    """Whether a training step of `cfg` can leave a parameter without a
    gradient, which DistributedDataParallel must then look for (a graph
    walk every backward): a flow head with LW_FLOW 0, a mask head with
    LW_MASK 0, or neither SE(3) loss (the rot/trans heads and fc6/fc7
    unused).  Per-class heads (REGRESSOR_NUM > 1) are not among them: each
    head is one Linear whose outputs group_pick gathers, so every group
    gets a gradient, zero for a class the batch lacks.  The shipped
    recipes (experiments/deepim/cfgs/lm6d_*_iter4_8epoch.yaml) use both
    heads and point matching: False."""
    net, ti = cfg.network, cfg.train_iter
    return bool((net.PRED_FLOW and ti.LW_FLOW <= 0) or (net.PRED_MASK and ti.LW_MASK <= 0)
                or not (ti.SE3_PM_LOSS or ti.SE3_DIST_LOSS))


def _mean_metrics(metrics: dict, mesh: Mesh) -> dict:
    """The step's metrics over every rank, with one all_reduce on the
    device: the losses (means over a rank's rows) averaged, raster_dropped
    summed."""
    names = sorted(metrics)
    stacked = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(stacked, group=mesh.group)
    return {k: (row if k == "raster_dropped" else row / mesh.size).to(metrics[k].dtype)
            for k, row in zip(names, stacked)}


def train_step_dp(step_fn, mesh: Mesh, state: TrainState, find_unused_parameters: bool = False):
    """Wrap a make_train_step step for the mesh (JAX's jit_train_step_dp).

    Returns dp_step(state, batch, bank_arrays) -> (state, metrics,
    pose_final) with `batch` this rank's rows (TrainLoader assembles
    them).  The step's forward passes run through a DistributedDataParallel
    replica of state.model, built here (which broadcasts rank 0's
    parameters); the returned state keeps the bare network, so checkpoints
    hold its keys.  `metrics` are every rank's (loss means averaged,
    raster_dropped summed: the global batch's, on every rank, as JAX's
    replicated metrics), reduced on the device; pose_final is the rank's
    rows.  On a mesh of one the step is returned as it is."""
    if mesh.size == 1:
        return step_fn
    replica = _Replica(state.model, device_ids=[mesh.device.index] if mesh.device.type == "cuda" else None,
                       process_group=mesh.group, find_unused_parameters=find_unused_parameters)

    def dp_step(state: TrainState, batch, bank_arrays):
        out, metrics, pose = step_fn(dataclasses.replace(state, model=replica), batch, bank_arrays)
        return dataclasses.replace(out, model=state.model), _mean_metrics(metrics, mesh), pose

    return dp_step


def refine_dp(model, obs: Observation, meshes: MeshBuffers, pose0, ecfg: EngineConfig, mesh: Mesh,
              num_iters: int | None = None):
    """Batched refinement with the batch split over the ranks (JAX's
    jit_refine_dp): each rank refines its rows of the global obs, meshes
    and pose0 (shard_pytree_batch) with its copy of `model`, which must be
    the same on every rank (one seed or one checkpoint; or
    replicate_pytree(model.state_dict(), mesh)).  Returns (pose_final (B,
    3, 4), poses (iters, B, 3, 4)) of the whole batch on every rank."""
    b = torch.as_tensor(pose0).shape[0]
    if b % mesh.size:
        raise ValueError(f"refine_dp: batch {b} does not split over {mesh.size} ranks")
    pose_final, poses = refine(model, shard_pytree_batch(obs, mesh), shard_pytree_batch(meshes, mesh),
                               shard_pytree_batch(pose0, mesh), ecfg, num_iters, device=mesh.device)
    return gather_batch(pose_final, mesh), gather_batch(poses, mesh, dim=1)
