"""Environment contracts (port of ``pddp_tpu/envs/base.py``).

 * ``Env``: the stateful contract (apply / get_state / reset / close,
   context-manager support).
 * ``SimEnv``: a simulator whose ground truth is a dynamics model, with a
   pure core (``initial_state`` / ``step_fn``) under the stateful API.

The reset noise comes from a ``torch.Generator`` seeded by ``seed``, on
the CPU, so a seed gives the same start state on every device; it is not
``pddp_tpu``'s draw from the same seed.
"""

from __future__ import annotations

import abc

import torch

from ..device import resolve_device
from ..encoding import StateEncoding
from ..gaussian_variable import GaussianVariable

__all__ = ["Env", "SimEnv"]


class Env(abc.ABC):
    """Base stateful environment."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, value, traceback):
        self.close()

    @property
    @abc.abstractmethod
    def action_size(self):
        """Action size (int)."""

    @property
    @abc.abstractmethod
    def state_size(self):
        """State size (int)."""

    @abc.abstractmethod
    def apply(self, u):
        """Applies an action to the environment."""

    @abc.abstractmethod
    def get_state(self, var=1e-2) -> GaussianVariable:
        """Current state as a Gaussian with observation-noise prior `var`."""

    @abc.abstractmethod
    def reset(self):
        """Resets the environment."""

    def close(self):
        """Stops the current environment session."""


class SimEnv(Env):
    """Simulator environment wrapping a ground-truth dynamics model.

    Subclasses define ``reset_mean`` (and may override ``step_fn``). The
    state lives on the model's device in the model's dtype.
    """

    #: per-reset Gaussian init noise std
    reset_noise: float = 1e-2

    def __init__(self, model, dt=None, seed=0):
        self.model = model
        self.dt = dt if dt is not None else getattr(model, "dt", None)
        probe = next((v for v in vars(model).values()
                      if isinstance(v, torch.Tensor)
                      and v.is_floating_point()), None)
        self.device = (probe.device if probe is not None
                       else resolve_device(None))
        self.dtype = probe.dtype if probe is not None else torch.float32
        self._generator = torch.Generator().manual_seed(seed)
        self.reset()

    # -- pure core -----------------------------------------------------------

    @property
    def reset_mean(self):
        """Mean initial state (Tensor<state_size>)."""
        return torch.zeros(self.model.state_size, dtype=self.dtype,
                           device=self.device)

    def initial_state(self, generator):
        """Reset: an initial state sample with noise from ``generator``."""
        mean = self.reset_mean
        noise = torch.randn(mean.shape, generator=generator,
                            dtype=torch.float64)
        return mean + self.reset_noise * noise.to(mean.dtype).to(mean.device)

    def step_fn(self, x, u):
        """Pure step: the ground-truth next state (mean dynamics)."""
        return self.model(x, u, 0, encoding=StateEncoding.IGNORE_UNCERTAINTY)

    # -- stateful Env API ----------------------------------------------------

    @property
    def action_size(self):
        return self.model.action_size

    @property
    def state_size(self):
        return self.model.state_size

    def apply(self, u):
        self._x = self.step_fn(self._x, torch.as_tensor(
            u, dtype=self._x.dtype, device=self._x.device))

    def get_state(self, var=1e-2) -> GaussianVariable:
        return GaussianVariable(self._x,
                                _var=var * torch.ones_like(self._x))

    def set_state(self, x):
        """Sets the current (mean) state."""
        self._x = torch.as_tensor(x, dtype=self.dtype,
                                  device=self.device).clone()

    def reset(self):
        self._x = self.initial_state(self._generator)

    def close(self):
        pass
