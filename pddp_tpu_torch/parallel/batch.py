"""Batched solves and data-parallel training (port of
``pddp_tpu/parallel/batch.py``).

``pddp_tpu`` vmaps its whole solve over the batch and shards the batch
over a device mesh. Here the batch is a lane axis of one solve loop
(``controllers.ilqr.solve_lanes``): every lane keeps its own status
machine, and each evaluation runs the backward and the line search of all
lanes at once, so the kernels (K1 with a reg per solve, K2(a)-(c)) take
the batch as their grid.

A mesh is ``torch.distributed``'s ``DeviceMesh`` over an initialized
process group, one process (rank) a device: ``make_mesh`` builds a 1-D
one, and a 2-D ``dp`` x ``pp`` mesh is ``init_device_mesh(type, (a, b),
mesh_dim_names=("dp", "pp"))``. The caller starts the process group and
picks its backend (``nccl`` on cards, ``gloo`` on the CPU). With a mesh,
each rank solves its contiguous block of the lanes and every rank returns
the whole batch, gathered; ``dp_train_step`` sums the gradients over the
ranks.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..controllers.ilqr import ILQROptions, ILQRResult, solve_lanes
from ..device import resolve_device
from ..encoding import StateEncoding
from ..utils.optim import apply_updates
from . import collectives

__all__ = ["make_mesh", "batched_solve", "dp_train_step", "replicate"]

_RESULT_FIELDS = ("Z", "U", "K", "J_opt", "state", "mu", "delta",
                  "iterations", "evals")


def make_mesh(axis_name="dp", devices=None):
    """A 1-D mesh named ``axis_name`` over every rank of the initialized
    process group, on ``cuda`` unless ``devices`` names another device
    type (``"cpu"``); a ``cuda`` mesh without a card raises."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = resolve_device(devices).type
    return init_device_mesh(
        device_type, (torch.distributed.get_world_size(),),
        mesh_dim_names=(axis_name,))


def replicate(tree, mesh):
    """``tree`` (a tensor or a nest of lists, tuples and dicts) with every
    tensor leaf a copy of the mesh's first rank's; other leaves as they
    are. The mesh spans the process group's ranks."""
    src = int(mesh.mesh.flatten()[0])
    return tree_map(lambda x: collectives.broadcast(x, src)
                    if isinstance(x, torch.Tensor) else x, tree)


def _block(x, group):
    """This rank's contiguous block of ``x``'s dim 0."""
    n = x.shape[0] // collectives.group_size(group)
    rank = collectives.group_rank(group)
    return x[rank * n:(rank + 1) * n]


def _cat_results(outs):
    return ILQRResult(**{f: torch.cat([getattr(r, f) for r in outs])
                         for f in _RESULT_FIELDS})


def _gather_results(r, group):
    """The ranks' ``ILQRResult`` blocks of a batch, whole, in rank
    order."""
    return ILQRResult(**{f: collectives.all_gather(getattr(r, f), group)
                         for f in _RESULT_FIELDS})


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

    ``mesh``: the lanes shard over its ``axis_name`` ranks, each rank
    solving its contiguous B / size lanes (in chunks of chunk / size, as
    ``chunk`` counts global problems), and every rank returns the whole
    batch. B, and ``chunk``, must be divisible by the axis size. Every
    rank passes the whole batch.
    """
    B = z0s.shape[0]
    chunked = chunk is not None and chunk < B
    if chunked and B % chunk:
        raise ValueError(f"batch {B} not divisible by chunk {chunk}")
    group = None
    if mesh is not None:
        group = mesh.get_group(axis_name)
        size = collectives.group_size(group)
        if B % size:
            raise ValueError(f"batch {B} not divisible by mesh axis "
                             f"{axis_name!r} of size {size}")
        if chunked and chunk % size:
            raise ValueError(
                f"chunk {chunk} not divisible by mesh size {size}")
        z0s, U0s = _block(z0s, group), _block(U0s, group)
        if chunked:
            chunk //= size
    n = z0s.shape[0]
    if not chunked:
        out = solve_lanes(model, cost, z0s, U0s, opts, encoding=encoding)
    else:
        out = _cat_results([
            solve_lanes(model, cost, z0s[i:i + chunk], U0s[i:i + chunk],
                        opts, encoding=encoding)
            for i in range(0, n, chunk)])
    return out if group is None else _gather_results(out, group)


def dp_train_step(loss_fn, params, opt, opt_state, batch, mesh,
                  axis_name="dp"):
    """One data-parallel optimizer step: each rank's gradient on its share
    of the batch, summed over the ranks.

    Args:
        loss_fn: (params, batch_shard) -> scalar loss (the mean over the
            shard).
        params, opt_state: the same on every rank; ``params`` a tensor or
            a nest of them.
        opt: an optimizer of ``utils.optim`` (``init``/``update``).
        batch: a nest of tensors, each with a leading batch dim divisible
            by the axis size; every rank passes the whole batch and takes
            its contiguous block.

    Returns:
        (params, opt_state, loss), the same on every rank: the gradient
        and the loss are the means over the ranks' shards.
    """
    group = mesh.get_group(axis_name)
    size = collectives.group_size(group)
    shard = tree_map(lambda x: _block(x, group)
                     if isinstance(x, torch.Tensor) else x, batch)
    leaves, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(leaves, spec), shard)
        grads = torch.autograd.grad(loss, leaves)
    grads = tree_unflatten(
        [collectives.all_reduce_sum(g, group) / size for g in grads], spec)
    loss = collectives.all_reduce_sum(loss.detach(), group) / size
    updates, opt_state = opt.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss
