"""Multi-vehicle rendezvous environment (port of
``pddp_tpu/examples/rendezvous/env.py``): a simulator whose ground truth is
the analytic model, reset at [-10, -10, 10, 10, 0, -5, 5, 0] + 1e-2 N(0, I).
"""

from __future__ import annotations

import torch

from ...envs.base import SimEnv
from .model import RendezvousDynamicsModel

__all__ = ["RendezvousEnv"]


class RendezvousEnv(SimEnv):
    """Two-vehicle rendezvous environment.

    Without ``model`` it builds one with ``dt`` on ``device`` (default
    ``cuda``) in ``dtype``.
    """

    def __init__(self, model=None, dt=0.1, seed=0, render=False, *,
                 device=None, dtype=torch.float32):
        if model is None:
            model = RendezvousDynamicsModel(dt=dt, device=device, dtype=dtype)
        del render  # rendering is not supported
        super().__init__(model, dt=dt, seed=seed)

    @property
    def reset_mean(self):
        return torch.tensor([-10.0, -10.0, 10.0, 10.0, 0.0, -5.0, 5.0, 0.0],
                            dtype=self.dtype, device=self.device)
