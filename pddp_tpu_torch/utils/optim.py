"""Gradient transforms with optax's interface (``pddp_tpu`` takes them from
optax).

An optimizer is a pair of functions: ``init(params)`` gives its state and
``update(grads, state, params)`` gives ``(updates, state)``;
``apply_updates(params, updates)`` adds the updates. ``params``, ``grads``
and ``updates`` are a tensor or a nest of them (lists, tuples, dicts). Each
update runs as one foreach op a term, each term rounded as optax's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["Optimizer", "AmsgradState", "sgd", "amsgrad", "apply_updates"]

#: optax.amsgrad's defaults (b1, b2, eps; eps_root is 0).
AMSGRAD = (0.9, 0.999, 1e-8)


@dataclass(frozen=True)
class Optimizer:
    init: object
    update: object


@dataclass(frozen=True)
class AmsgradState:
    """The step count, the first and second moments and the running
    maximum of the bias-corrected second moment, a list each over the
    parameters' leaves."""

    count: int
    mu: list
    nu: list
    nu_max: list


def _scaled(leaves, tree, learning_rate):
    return tree_unflatten(torch._foreach_mul(leaves, -learning_rate), tree)


def sgd(learning_rate):
    """Plain gradient descent, ``optax.sgd(learning_rate)``: the update is
    -learning_rate times the gradient."""

    def init(params):
        return ()

    def update(grads, state, params=None):
        leaves, tree = tree_flatten(grads)
        return _scaled(list(leaves), tree, learning_rate), state

    return Optimizer(init, update)


def amsgrad(learning_rate, b1=AMSGRAD[0], b2=AMSGRAD[1], eps=AMSGRAD[2]):
    """``optax.amsgrad``: Adam with the maximum taken of the bias-corrected
    second moment (``torch.optim.Adam(amsgrad=True)`` keeps that of the
    raw one)."""

    def init(params):
        leaves, _ = tree_flatten(params)
        zeros = [[torch.zeros_like(p) for p in leaves] for _ in range(3)]
        return AmsgradState(0, *zeros)

    def update(grads, state, params=None):
        g, tree = tree_flatten(grads)
        g = list(g)
        t = state.count + 1
        c1, c2 = 1.0 - b1**t, 1.0 - b2**t
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1),
                                torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_add(torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - b2),
            torch._foreach_mul(state.nu, b2))
        nu_max = torch._foreach_maximum(state.nu_max,
                                        torch._foreach_div(nu, c2))
        # (mu / c1) / (sqrt(nu_max) + eps), times -learning_rate
        step = torch._foreach_div(torch._foreach_div(mu, c1),
                                  torch._foreach_add(
                                      torch._foreach_sqrt(nu_max), eps))
        return (_scaled(step, tree, learning_rate),
                AmsgradState(t, mu, nu, nu_max))

    return Optimizer(init, update)


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, detached from any graph."""
    p, tree = tree_flatten(params)
    u, _ = tree_flatten(updates)
    return tree_unflatten(
        torch._foreach_add([t.detach() for t in p], list(u)), tree)
