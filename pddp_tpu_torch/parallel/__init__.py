"""Batched solves and multi-device scaling on ``torch.distributed`` (port
of ``pddp_tpu/parallel``).

``batched_solve`` runs B independent solves as one batch of lanes, and
with a mesh shards the lanes over its ranks. ``dp_train_step`` is one
data-parallel optimizer step. ``particle_sharded_solve`` and
``particle_sharded_batched_solve`` shard one solve's BNN ensemble over
ranks, and ``shard_over_horizon`` splits the parallel Riccati over the
horizon. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(``make_mesh``); the caller starts the process group.
"""

from .batch import batched_solve, dp_train_step, make_mesh, replicate
from .horizon import shard_over_horizon
from .particles import (particle_partition_specs,
                        particle_sharded_batched_solve,
                        particle_sharded_solve)

__all__ = [
    "batched_solve",
    "dp_train_step",
    "make_mesh",
    "replicate",
    "particle_partition_specs",
    "particle_sharded_solve",
    "particle_sharded_batched_solve",
    "shard_over_horizon",
]
