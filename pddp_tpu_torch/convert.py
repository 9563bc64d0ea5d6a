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

from .examples.cartpole.cost import CartpoleCost
from .examples.cartpole.model import PARAM_NAMES, CartpoleDynamicsModel

__all__ = ["CARTPOLE_COST_FIELDS", "CARTPOLE_MODEL_FIELDS", "cartpole",
           "golden_cartpole_U0"]

#: model fields carried across, in the order of the model's constructor.
CARTPOLE_MODEL_FIELDS = PARAM_NAMES

#: cost fields carried across.
CARTPOLE_COST_FIELDS = ("Q", "R", "Q_term", "x_goal", "u_goal")


def cartpole(model_params, cost_params, *, device=None,
             dtype=torch.float32):
    """(CartpoleDynamicsModel, CartpoleCost) from numpy parameters.

    Args:
        model_params: mapping with the keys of ``CARTPOLE_MODEL_FIELDS``.
        cost_params: mapping with the keys of ``CARTPOLE_COST_FIELDS``.
        device: defaults to ``cuda`` (see ``device.resolve_device``).
    """
    for name, v in list(model_params.items()) + list(cost_params.items()):
        if not isinstance(v, (np.ndarray, np.generic, float, int)):
            raise TypeError("parameter {} is a {}, expected a numpy array"
                            .format(name, type(v).__name__))
    model = CartpoleDynamicsModel(
        *(np.array(model_params[n]) for n in CARTPOLE_MODEL_FIELDS),
        device=device, dtype=dtype)
    cost = CartpoleCost(
        **{n: np.array(cost_params[n]) for n in CARTPOLE_COST_FIELDS},
        device=device, dtype=dtype)
    return model, cost


def golden_cartpole_U0():
    """The initial actions (60, 1) float64 of the golden ``cartpole``
    solve, as numpy: 0.1 times a standard normal draw from JAX's
    ``PRNGKey(42)``, stored in the package because the port cannot draw
    JAX's random bits."""
    return np.load(Path(__file__).resolve().parent / "data"
                   / "golden_cartpole_U0.npy")
