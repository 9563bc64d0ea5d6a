"""The four known-dynamics examples as the line-search kernels carry them
(``csrc/examples.cuh``): each exact model type's index there and its
parameters' names, ``constrain_model``'s subclasses of them, and the
parameter buffer a kernel reads. K2(a)-(c) (``ops/fused_rollout.py``)
step a candidate's mean state with them, K2(e)
(``ops/fused_particle_rollout.py``) each particle of a candidate.
"""

from __future__ import annotations

import torch

from ..examples import cartpole, double_cartpole, pendulum, rendezvous
from ..examples.cartpole import CartpoleDynamicsModel
from ..examples.double_cartpole import DoubleCartpoleDynamicsModel
from ..examples.pendulum import PendulumDynamicsModel
from ..examples.rendezvous import RendezvousDynamicsModel

__all__ = ["MODELS", "PARAM_NAMES", "example_of", "param_buffer"]

#: the kernels' model index of each example.
MODELS = {CartpoleDynamicsModel: 0, PendulumDynamicsModel: 1,
          DoubleCartpoleDynamicsModel: 2, RendezvousDynamicsModel: 3}
#: each example's parameters, in the order the kernels read them.
PARAM_NAMES = {
    CartpoleDynamicsModel: cartpole.model.PARAM_NAMES,
    PendulumDynamicsModel: pendulum.model.PARAM_NAMES,
    DoubleCartpoleDynamicsModel: double_cartpole.model.PARAM_NAMES,
    RendezvousDynamicsModel: rendezvous.model.PARAM_NAMES,
}


def example_of(model):
    """(example type, constrained) of ``model``: its exact type where that
    is one of MODELS, or the example that ``constrain_model`` subclassed
    (the class it built carries ``_constrain_base``, a subclass of that
    class does not); (None, False) for anything else, whose arithmetic
    the kernels do not carry."""
    t = type(model)
    base = t.__dict__.get("_constrain_base")
    if base is not None:
        return (base, True) if base in MODELS else (None, False)
    return (t, False) if t in MODELS else (None, False)


def param_buffer(model, cost, dtype, device, cost_size=None):
    """A kernel's parameter buffer: the example's parameters (in the order
    of its module's ``PARAM_NAMES``); then, where the kernel carries the
    cost, its Q (ny x ny), R (nu x nu), Q_term (ny x ny), x_goal (ny) and
    u_goal (nu), ny = ``cost_size``; then, for a ``constrain_model``
    subclass, its lower and its upper bounds (nu each)."""
    base, constrained = example_of(model)
    parts = [getattr(model, name).reshape(1) for name in PARAM_NAMES[base]]
    nu = model.action_size
    if cost is not None:
        ny = cost_size
        parts += [cost.Q.reshape(ny * ny), cost.R.reshape(nu * nu),
                  cost.Q_term.reshape(ny * ny),
                  cost.x_goal.reshape(-1).expand(ny),
                  cost.u_goal.reshape(-1).expand(nu)]
    if constrained:
        parts += [torch.as_tensor(b, dtype=dtype, device=device)
                  .reshape(-1).expand(nu) for b in model._constrain_bounds]
    return torch.cat([p.to(dtype=dtype, device=device) for p in parts])
