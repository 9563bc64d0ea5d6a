"""Cartpole cost (port of ``pddp_tpu/examples/cartpole/cost.py``).

Pole-tip distance on the augmented state [x, x', theta', sin(theta),
cos(theta)]; Q_term = I, R = 0.1 I, goal = augment([0, 0, pi, 0]).
"""

from __future__ import annotations

import numpy as np
import torch

from ...costs.quadratic import QRCost
from ...encoding import StateEncoding
from ...utils.angular import (augment_encoded_state, augment_state,
                              infer_augmented_state_size)
from .model import CartpoleDynamicsModel

__all__ = ["CartpoleCost"]


def _build(pole_length=0.5):
    """(Q, R, Q_term, x_goal) as float64 numpy arrays."""
    model = CartpoleDynamicsModel
    n_aug = infer_augmented_state_size(model.angular_indices,
                                       model.non_angular_indices)
    Q = np.zeros((n_aug, n_aug))
    Q[0, 0] = 1.0
    Q[0, 3] = Q[3, 0] = pole_length
    Q[3, 3] = Q[4, 4] = pole_length**2
    Q_term = np.eye(n_aug)
    R = 0.1 * np.eye(model.action_size)
    x_goal = augment_state(
        torch.tensor([0.0, 0.0, np.pi, 0.0], dtype=torch.float64),
        model.angular_indices, model.non_angular_indices).numpy()
    return Q, R, Q_term, x_goal


class CartpoleCost(QRCost):
    """Pole-tip distance cost on the augmented cartpole state.

    With no arguments the weights are the example's own; ``convert.py``
    passes weights carried over from elsewhere.
    """

    # __call__ is exactly augment -> QRCost: the closed form applies.
    call_is_augmented_qr = True
    aug_angular_indices = CartpoleDynamicsModel.angular_indices
    aug_non_angular_indices = CartpoleDynamicsModel.non_angular_indices

    def __init__(self, Q=None, R=None, Q_term=None, x_goal=None, u_goal=0.0,
                 *, device=None, dtype=torch.float32):
        Q0, R0, Q_term0, x_goal0 = _build()
        super().__init__(
            Q0 if Q is None else Q, R0 if R is None else R,
            Q_term0 if Q_term is None else Q_term,
            x_goal0 if x_goal is None else x_goal, u_goal,
            device=device, dtype=dtype)

    def __call__(self, z, u, i, terminal=False,
                 encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        model = CartpoleDynamicsModel
        z = augment_encoded_state(z, model.angular_indices,
                                  model.non_angular_indices, encoding,
                                  model.state_size)
        return super().__call__(z, u, i, terminal, encoding, **kwargs)
