"""Double cartpole environment (port of
``pddp_tpu/examples/double_cartpole/env.py``): a simulator whose ground truth is
the analytic model, reset at zeros + 1e-2 N(0, I).
"""

from __future__ import annotations

import torch

from ...envs.base import SimEnv
from .model import DoubleCartpoleDynamicsModel

__all__ = ["DoubleCartpoleEnv"]


class DoubleCartpoleEnv(SimEnv):
    """Double cartpole swing-up environment.

    Without ``model`` it builds one with ``dt`` on ``device`` (default
    ``cuda``) in ``dtype``.
    """

    def __init__(self, model=None, dt=0.05, seed=0, render=False, *,
                 device=None, dtype=torch.float32):
        if model is None:
            model = DoubleCartpoleDynamicsModel(dt=dt, device=device, dtype=dtype)
        del render  # rendering is not supported
        super().__init__(model, dt=dt, seed=seed)
