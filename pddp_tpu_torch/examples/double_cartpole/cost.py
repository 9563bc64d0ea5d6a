"""Double cartpole cost (port of
``pddp_tpu/examples/double_cartpole/cost.py``).

Two-pole tip distance on the augmented state [x, x', th1', th2', sin th1,
cos th1, sin th2, cos th2]: Q = C^T C on [x, sin th1, cos th1, sin th2,
cos th2], Q_term = 100 I, R = 0.1 I, goal = augment(0).
"""

from __future__ import annotations

import numpy as np
import torch

from ...costs.quadratic import QRCost
from ...encoding import StateEncoding
from ...utils.angular import (augment_encoded_state, augment_state,
                              infer_augmented_state_size)
from .model import DoubleCartpoleDynamicsModel

__all__ = ["DoubleCartpoleCost"]


def _build(pole1_length=0.6, pole2_length=0.6):
    """(Q, R, Q_term, x_goal) as float64 numpy arrays."""
    model = DoubleCartpoleDynamicsModel
    n_aug = infer_augmented_state_size(model.angular_indices,
                                       model.non_angular_indices)
    Q_term = 100.0 * np.eye(n_aug)
    Q = np.zeros((n_aug, n_aug))
    cost_dims = np.hstack([
        0, np.arange(n_aug - 2 * len(model.angular_indices), n_aug)])[:, None]
    C = np.array([[1.0, -pole1_length, 0.0, -pole2_length, 0.0],
                  [0.0, 0.0, pole1_length, 0.0, pole2_length]])
    Q[cost_dims, cost_dims.T] = C.T @ C
    R = 0.1 * np.eye(model.action_size)
    x_goal = augment_state(
        torch.zeros(model.state_size, dtype=torch.float64),
        model.angular_indices, model.non_angular_indices).numpy()
    return Q, R, Q_term, x_goal


class DoubleCartpoleCost(QRCost):
    """Two-pole tip distance cost on the augmented state; with no
    arguments the example's own weights."""

    # __call__ is exactly augment -> QRCost: the closed form applies.
    call_is_augmented_qr = True
    aug_angular_indices = DoubleCartpoleDynamicsModel.angular_indices
    aug_non_angular_indices = DoubleCartpoleDynamicsModel.non_angular_indices

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
        model = DoubleCartpoleDynamicsModel
        z = augment_encoded_state(z, model.angular_indices,
                                  model.non_angular_indices, encoding,
                                  model.state_size)
        return super().__call__(z, u, i, terminal, encoding, **kwargs)
