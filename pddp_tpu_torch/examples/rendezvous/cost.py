"""Rendezvous cost (port of ``pddp_tpu/examples/rendezvous/cost.py``).

A plain ``QRCost`` with no augmentation: Q couples the two vehicles'
positions (it penalizes ||p_0 - p_1||^2) and the velocities; R = 0.1 I.
"""

from __future__ import annotations

import numpy as np
import torch

from ...costs.quadratic import QRCost
from .model import RendezvousDynamicsModel

__all__ = ["RendezvousCost"]


def _build():
    """(Q, R) as float64 numpy arrays."""
    model = RendezvousDynamicsModel
    Q = np.eye(model.state_size)
    Q[0, 2] = Q[2, 0] = -1.0
    Q[1, 3] = Q[3, 1] = -1.0
    R = 0.1 * np.eye(model.action_size)
    return Q, R


class RendezvousCost(QRCost):
    """Vehicle-coupling quadratic cost; with no arguments the example's
    own weights (Q_term = Q, zero goals)."""

    def __init__(self, Q=None, R=None, Q_term=None, x_goal=0.0, u_goal=0.0,
                 *, device=None, dtype=torch.float32):
        Q0, R0 = _build()
        super().__init__(Q0 if Q is None else Q, R0 if R is None else R,
                         Q_term, x_goal, u_goal, device=device, dtype=dtype)
