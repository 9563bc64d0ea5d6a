"""Batched solves (port of ``pddp_tpu/parallel/batch.py:batched_solve``).

``pddp_tpu`` vmaps its whole solve over the batch and shards the batch
over a device mesh. Here the batch is a lane axis of one solve loop
(``controllers.ilqr.solve_lanes``): every lane keeps its own status
machine, and each evaluation runs the backward and the line search of all
lanes at once, so the kernels (K1 with a reg per solve, K2(a)-(c)) take
the batch as their grid.
"""

from __future__ import annotations

import torch

from ..controllers.ilqr import ILQROptions, ILQRResult, solve_lanes
from ..encoding import StateEncoding

__all__ = ["batched_solve"]


def batched_solve(model, cost, z0s, U0s, opts: ILQROptions,
                  encoding: StateEncoding = StateEncoding.DEFAULT,
                  mesh=None, axis_name="dp", chunk=None) -> ILQRResult:
    """B independent iLQR solves.

    z0s: (B, nz), U0s: (B, N, nu). Returns an ``ILQRResult`` with a
    leading batch axis on every field (tensors on the inputs' device,
    ``state`` the ``iLQRState`` codes as int32), each lane the result of
    its own ``solve``.

    ``chunk`` bounds peak memory: the batch runs as ``B // chunk``
    sequential chunks whose results are concatenated (a BNN's local model
    over 256 lanes of 25 steps and 100 particles sweeps its MLP with the
    inputs' tangents over 640 000 rows). B must be divisible by ``chunk``.

    ``mesh`` and ``axis_name`` keep ``pddp_tpu``'s signature; sharding the
    batch over several cards is not ported yet (ROADMAP.md, queue A item
    7, multi-GPU), so a mesh raises ``NotImplementedError``.
    """
    del axis_name
    if mesh is not None:
        raise NotImplementedError(
            "batched_solve over a device mesh is not ported yet "
            "(ROADMAP.md queue A item 7, multi-GPU)")
    B = z0s.shape[0]
    chunked = chunk is not None and chunk < B
    if chunked and B % chunk:
        raise ValueError(f"batch {B} not divisible by chunk {chunk}")
    if not chunked:
        return solve_lanes(model, cost, z0s, U0s, opts, encoding=encoding)
    outs = [solve_lanes(model, cost, z0s[i:i + chunk], U0s[i:i + chunk],
                        opts, encoding=encoding)
            for i in range(0, B, chunk)]
    return ILQRResult(**{
        f: torch.cat([getattr(r, f) for r in outs])
        for f in ("Z", "U", "K", "J_opt", "state", "mu", "delta",
                  "iterations", "evals")})
