"""Carry a problem's parameters across as numpy arrays.

The port never imports JAX: a caller that holds ``pddp_tpu`` objects
reads their fields as numpy arrays (``np.asarray(jax_model.dt)``) and
hands them here, and the port builds its own objects from them on the
device and dtype asked for.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .examples import cartpole as _cp
from .examples import double_cartpole as _dcp
from .examples import pendulum as _pend
from .examples import rendezvous as _rdv
from .examples.cartpole.model import PARAM_NAMES
from .models.bnn import bnn_dynamics_model_factory, trainable_mask

__all__ = ["BNN_BUFFERS", "CARTPOLE_COST_FIELDS", "CARTPOLE_MODEL_FIELDS",
           "COST_FIELDS", "bnn", "cartpole", "double_cartpole",
           "controller_state", "golden_U0", "golden_cartpole_U0",
           "pendulum", "rendezvous"]

_DATA = Path(__file__).resolve().parent / "data"

#: model fields carried across, in the order of the model's constructor.
CARTPOLE_MODEL_FIELDS = PARAM_NAMES

#: cost fields carried across (every example's cost is a QRCost).
COST_FIELDS = ("Q", "R", "Q_term", "x_goal", "u_goal")
CARTPOLE_COST_FIELDS = COST_FIELDS

#: BNN model arrays carried across beside the net's leaves.
BNN_BUFFERS = ("X_mean", "X_std", "dX_mean", "dX_std", "eps_in", "eps_out")


def _check_numpy(items):
    for name, v in items:
        if not isinstance(v, (np.ndarray, np.generic, float, int)):
            raise TypeError("parameter {} is a {}, expected a numpy array"
                            .format(name, type(v).__name__))


def _example(example, model_cls, cost_cls, model_params, cost_params,
             device, dtype):
    _check_numpy(list(model_params.items()) + list(cost_params.items()))
    model = model_cls(*(np.array(model_params[n])
                        for n in example.model.PARAM_NAMES),
                      device=device, dtype=dtype)
    cost = cost_cls(**{n: np.array(cost_params[n]) for n in COST_FIELDS},
                    device=device, dtype=dtype)
    return model, cost


def cartpole(model_params, cost_params, *, device=None,
             dtype=torch.float32):
    """(CartpoleDynamicsModel, CartpoleCost) from numpy parameters.

    Args:
        model_params: mapping with the keys of ``CARTPOLE_MODEL_FIELDS``
            (the model module's ``PARAM_NAMES``).
        cost_params: mapping with the keys of ``COST_FIELDS``.
        device: defaults to ``cuda`` (see ``device.resolve_device``).
    """
    return _example(_cp, _cp.CartpoleDynamicsModel, _cp.CartpoleCost,
                    model_params, cost_params, device, dtype)


def pendulum(model_params, cost_params, *, device=None,
             dtype=torch.float32):
    """(PendulumDynamicsModel, PendulumCost) from numpy parameters, keyed
    as ``cartpole``'s (``examples.pendulum.model.PARAM_NAMES``)."""
    return _example(_pend, _pend.PendulumDynamicsModel, _pend.PendulumCost,
                    model_params, cost_params, device, dtype)


def double_cartpole(model_params, cost_params, *, device=None,
                    dtype=torch.float32):
    """(DoubleCartpoleDynamicsModel, DoubleCartpoleCost) from numpy
    parameters (``examples.double_cartpole.model.PARAM_NAMES``)."""
    return _example(_dcp, _dcp.DoubleCartpoleDynamicsModel,
                    _dcp.DoubleCartpoleCost, model_params, cost_params, device, dtype)


def rendezvous(model_params, cost_params, *, device=None,
               dtype=torch.float32):
    """(RendezvousDynamicsModel, RendezvousCost) from numpy parameters
    (``examples.rendezvous.model.PARAM_NAMES``)."""
    return _example(_rdv, _rdv.RendezvousDynamicsModel, _rdv.RendezvousCost,
                    model_params, cost_params, device, dtype)


def bnn(net_leaves, buffers, state_size, action_size, hidden_features, *,
        angular_indices=None, non_angular_indices=None, constrain_min=None,
        constrain_max=None, device=None, dtype=torch.float32,
        requires_grad=False, particles=False, **init_kwargs):
    """A ``BNNDynamicsModel`` (a ``ParticlesBNNDynamicsModel`` with
    ``particles``) from numpy arrays.

    Args:
        net_leaves: the net's arrays in the JAX package's flatten order
            (``jax.tree_util.tree_leaves(jax_model.net)``: each layer's W
            and b, then each dropout's fields, its noise last).
        buffers: mapping with the keys of ``BNN_BUFFERS`` (without
            ``eps_in`` for ``particles``).
        state_size, action_size, hidden_features, angular_indices,
        non_angular_indices, constrain_min, constrain_max: the factory's
            configuration (``bnn_dynamics_model_factory``).
        init_kwargs: ``n_particles``, ``horizon``, ``use_predicted_std``
            and the other options of the factory's ``init``.
        device: defaults to ``cuda`` (see ``device.resolve_device``).
        requires_grad: set ``requires_grad`` on the net's trainable leaves
            (``models.bnn.trainable_mask``), for a caller's own autograd;
            ``fit_bnn`` trains the same leaves either way.
    """
    _check_numpy([("net_{}".format(i), v) for i, v in enumerate(net_leaves)]
                 + list(buffers.items()))
    cls = bnn_dynamics_model_factory(
        state_size, action_size, hidden_features,
        angular_indices=angular_indices,
        non_angular_indices=non_angular_indices,
        constrain_min=constrain_min, constrain_max=constrain_max,
        particles=particles)
    model = cls.init(dtype=dtype, device=device, **init_kwargs)
    old = model.net.leaves()
    if len(net_leaves) != len(old):
        raise ValueError("expected {} net leaves, got {}".format(
            len(old), len(net_leaves)))
    leaves = []
    for i, (a, ref, train) in enumerate(zip(net_leaves, old,
                                            trainable_mask(model.net))):
        if tuple(np.shape(a)) != tuple(ref.shape):
            raise ValueError("net leaf {} has shape {}, expected {}".format(
                i, np.shape(a), tuple(ref.shape)))
        leaves.append(torch.as_tensor(np.array(a), dtype=dtype,
                                      device=ref.device).requires_grad_(
                                          requires_grad and train))
    fields = {k: torch.as_tensor(np.array(buffers[k]), dtype=dtype,
                                 device=ref.device) for k in BNN_BUFFERS
              if not (particles and k == "eps_in")}
    for k, v in fields.items():
        if tuple(v.shape) != tuple(getattr(model, k).shape):
            raise ValueError("{} has shape {}, expected {}".format(
                k, tuple(v.shape), tuple(getattr(model, k).shape)))
    return model.replace(net=model.net.with_leaves(leaves), **fields)


def controller_state(state, *, device=None, dtype=None):
    """What ``iLQRController.load_state_dict`` takes, from ``pddp_tpu``'s
    ``iLQRController.state_dict()`` read as numpy arrays.

    Args:
        state: mapping with ``Z_nominal``, ``U_nominal``, ``K`` (numpy
            arrays or None) and ``mu``, ``delta`` (numpy scalars).
        device: defaults to ``cuda`` (see ``device.resolve_device``).
        dtype: of the tensors; the arrays' own by default.
    """
    device = resolve_device(device)
    _check_numpy([(k, v) for k, v in state.items() if v is not None])
    out = {}
    for k in ("Z_nominal", "U_nominal", "K"):
        v = state.get(k)
        out[k] = None if v is None else torch.as_tensor(
            np.array(v), dtype=dtype, device=device)
    for k in ("mu", "delta"):
        if k in state:
            out[k] = float(np.asarray(state[k]))
    return out


def golden_cartpole_U0():
    """The initial actions (60, 1) float64 of the golden ``cartpole``
    solve, as numpy: 0.1 times a standard normal draw from JAX's
    ``PRNGKey(42)``, stored in the package because the port cannot draw
    JAX's random bits."""
    return np.load(_DATA / "golden_cartpole_U0.npy")


def golden_U0(name):
    """The initial actions (N, nu) float64 of golden case ``name`` of
    ``tests/golden/cases.py``, as numpy: JAX's ``PRNGKey(42)`` draw, made
    by ``tests/golden/golden_u0.py``."""
    with np.load(_DATA / "golden_U0.npz") as data:
        return data[name]
