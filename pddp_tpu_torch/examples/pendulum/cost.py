"""Pendulum cost (port of ``pddp_tpu/examples/pendulum/cost.py``).

Tip distance on the augmented state [theta', sin(theta), cos(theta)];
Q_term = 100 I, R = 0.1 I, goal = augment([pi, 0]).
"""

from __future__ import annotations

import numpy as np
import torch

from ...costs.quadratic import QRCost
from ...encoding import StateEncoding
from ...utils.angular import (augment_encoded_state, augment_state,
                              infer_augmented_state_size)
from .model import PendulumDynamicsModel

__all__ = ["PendulumCost"]


def _build(pendulum_length=0.5):
    """(Q, R, Q_term, x_goal) as float64 numpy arrays."""
    model = PendulumDynamicsModel
    n_aug = infer_augmented_state_size(model.angular_indices,
                                       model.non_angular_indices)
    Q = np.zeros((n_aug, n_aug))
    Q[0, 0] = 1.0
    Q[0, 1] = Q[1, 0] = pendulum_length
    Q[1, 1] = Q[2, 2] = pendulum_length**2
    Q_term = 100.0 * np.eye(n_aug)
    R = 0.1 * np.eye(model.action_size)
    x_goal = augment_state(
        torch.tensor([np.pi, 0.0], dtype=torch.float64),
        model.angular_indices, model.non_angular_indices).numpy()
    return Q, R, Q_term, x_goal


class PendulumCost(QRCost):
    """Tip-distance cost on the augmented pendulum state; with no
    arguments the example's own weights."""

    # __call__ is exactly augment -> QRCost: the closed form applies.
    call_is_augmented_qr = True
    aug_angular_indices = PendulumDynamicsModel.angular_indices
    aug_non_angular_indices = PendulumDynamicsModel.non_angular_indices

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
        model = PendulumDynamicsModel
        z = augment_encoded_state(z, model.angular_indices,
                                  model.non_angular_indices, encoding,
                                  model.state_size)
        return super().__call__(z, u, i, terminal, encoding, **kwargs)
