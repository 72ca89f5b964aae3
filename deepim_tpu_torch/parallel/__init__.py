"""Data parallelism over `torch.distributed` ranks (counterpart of
deepim_tpu/parallel/): the process group and rank mesh, batch sharding,
the DDP training step and batched refinement."""
from deepim_tpu_torch.parallel.dp import find_unused_parameters, refine_dp, train_step_dp
from deepim_tpu_torch.parallel.mesh import (
    Mesh,
    gather_batch,
    initialize_distributed,
    make_mesh,
    replicate_pytree,
    shard_pytree_batch,
    shutdown_distributed,
)

__all__ = [
    "find_unused_parameters", "refine_dp", "train_step_dp",
    "Mesh", "gather_batch", "initialize_distributed", "make_mesh", "replicate_pytree",
    "shard_pytree_batch", "shutdown_distributed",
]
