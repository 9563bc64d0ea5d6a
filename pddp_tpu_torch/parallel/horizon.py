"""Horizon-axis (sequence-parallel) sharding of the Riccati backward
(port of ``pddp_tpu/parallel/horizon.py``).

The associative-scan Riccati (``ops.riccati.parallel_backward``) is
O(log N) depth of batched matrix algebra over the time axis. Sharding the
local model's time-major arrays over ranks splits it: each rank scans its
block of the steps, one all-gather exchanges the blocks' composite
elements, and each rank closes its block with the later blocks'. XLA's
partitioner does this for ``pddp_tpu``; here ``parallel_backward`` does it
when it is given the group (its ``group`` keyword).
"""

from __future__ import annotations

from . import collectives
from .batch import _block

__all__ = ["shard_over_horizon"]


def shard_over_horizon(derivs, mesh, axis_name: str = "sp"):
    """This rank's part of a local model sharded over the mesh's
    ``axis_name`` ranks.

    ``derivs`` is the (Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu) tuple
    of ``controllers.ilqr.forward``/``local_model`` (leading axis N or
    N+1). Leaves whose leading dim divides by the axis size come back as
    this rank's contiguous block of it; the others (the (N+1)-long value
    arrays when N divides) whole. Feed the result to
    ``ops.riccati.parallel_backward(*blocks,
    group=mesh.get_group(axis_name))``.
    """
    group = mesh.get_group(axis_name)
    size = collectives.group_size(group)
    return tuple(_block(x, group) if x.dim() >= 1 and x.shape[0] % size == 0
                 else x for x in derivs)
