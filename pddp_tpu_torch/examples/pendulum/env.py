"""Pendulum environment (port of
``pddp_tpu/examples/pendulum/env.py``): a simulator whose ground truth is
the analytic model, reset at [0, 0] + 1e-2 N(0, I).
"""

from __future__ import annotations

import torch

from ...envs.base import SimEnv
from .model import PendulumDynamicsModel

__all__ = ["PendulumEnv"]


class PendulumEnv(SimEnv):
    """Pendulum swing-up environment.

    Without ``model`` it builds one with ``dt`` on ``device`` (default
    ``cuda``) in ``dtype``.
    """

    def __init__(self, model=None, dt=0.1, seed=0, render=False, *,
                 device=None, dtype=torch.float32):
        if model is None:
            model = PendulumDynamicsModel(dt=dt, device=device, dtype=dtype)
        del render  # rendering is not supported
        super().__init__(model, dt=dt, seed=seed)
