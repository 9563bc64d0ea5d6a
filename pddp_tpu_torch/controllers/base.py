"""Base controller contract (port of ``pddp_tpu/controllers/base.py``).

``fit`` performs trajectory optimization; ``forward`` is the per-step
policy. ``training`` gates the PDDP episodic loop.
"""

from __future__ import annotations

from ..encoding import StateEncoding

__all__ = ["Controller"]


class Controller:
    """Base trajectory-optimizing controller."""

    def __init__(self):
        self.training = True

    def train(self, mode=True):
        """Sets the controller in training mode."""
        self.training = mode
        return self

    def eval(self):
        """Sets the controller in evaluation mode."""
        return self.train(False)

    def fit(self, U, encoding: StateEncoding = StateEncoding.DEFAULT,
            quiet=False, **kwargs):
        """Determines the optimal path to minimize the cost."""
        raise NotImplementedError

    def forward(self, z, i, encoding: StateEncoding = StateEncoding.DEFAULT,
                **kwargs):
        """Determines the optimal single-step control to minimize the cost."""
        raise NotImplementedError

    def __call__(self, z, i, encoding: StateEncoding = StateEncoding.DEFAULT,
                 *args, **kwargs):
        return self.forward(z, i, encoding, *args, **kwargs)
