"""The collectives of the sharded solves, on ``torch.distributed``.

This is the one module of the port that calls ``torch.distributed`` on a
solve path. Every rank of a group calls the same collectives in the same
order, on tensors of the same shapes: the sharded solves take every branch
on values that are the same on all ranks (the all-reduced statistics and
what follows from them), never on a rank's own data.

``all_reduce_sum`` is an ``autograd.Function`` with a forward-mode rule
and a batching rule, so that it runs under ``torch.func.jvp`` and
``torch.func.vmap`` (the BNN's structured Jacobians push tangents through
the moment match with ``vmap(jvp(...))``) and under reverse mode: the
tangent and the gradient of a sum over ranks are the sums over ranks of
the tangents and the gradients, and a batch of tensors is summed entry by
entry.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "any_rank", "all_gather", "broadcast",
           "group_rank", "group_size"]


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def jvp(ctx, x_t, _):
        return _AllReduceSum.apply(x_t, ctx.group)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _AllReduceSum.apply(x, group), in_dims[0]


def all_reduce_sum(x, group):
    """The sum of ``x`` over the ranks of ``group``, on every rank."""
    return _AllReduceSum.apply(x, group)


def any_rank(flag, group):
    """Whether ``flag`` (a 0/1 tensor, any shape) is set on any rank of
    ``group``, entry by entry, in ``flag``'s dtype."""
    return (all_reduce_sum(flag, group) > 0).to(flag.dtype)


def all_gather(x, group):
    """The ``x`` of every rank of ``group``, concatenated along dim 0 in
    rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def broadcast(x, src, group=None):
    """A copy of global rank ``src``'s ``x`` on every rank of ``group``."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=src, group=group)
    return out


def group_rank(group):
    """This process's rank within ``group``."""
    return dist.get_rank(group)


def group_size(group):
    return dist.get_world_size(group)
