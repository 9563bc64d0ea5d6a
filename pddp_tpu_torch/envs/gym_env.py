"""Gym adapter (port of ``pddp_tpu/envs/gym_env.py``).

Wraps a gym or gymnasium env object behind the ``Env`` contract. The env
is a host object: actions go to it as numpy arrays, reshaped to the
action space, clamped to its bounds and cast to its dtype; observations
come back as flat tensors on ``device`` in ``dtype``. No gym package is
imported: the caller builds the env.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..gaussian_variable import GaussianVariable
from .base import Env

__all__ = ["GymEnv"]


class GymEnv(Env):
    """A ``gym.Env`` (or gymnasium's) as an ``Env``; its state lives on
    ``device`` (default ``cuda``) in ``dtype``."""

    def __init__(self, gym_env, render=False, *, device=None,
                 dtype=torch.float32):
        self._env = gym_env
        self._render = render
        self.device = resolve_device(device)
        self.dtype = dtype

        self._action_size = _size_from_space(gym_env.action_space)
        self._action_shape = _shape_from_space(gym_env.action_space)
        self._action_dtype = _dtype_from_space(gym_env.action_space)
        self._action_bounds = _bounds_from_space(gym_env.action_space)
        self._state_size = _size_from_space(gym_env.observation_space)

        self._state = torch.zeros(self._state_size, dtype=dtype,
                                  device=self.device)
        self.reset()

    @property
    def action_size(self):
        return self._action_size

    @property
    def state_size(self):
        return self._state_size

    def apply(self, u):
        u = (u.detach().cpu().numpy() if isinstance(u, torch.Tensor)
             else np.asarray(u))
        action = _action_from_u(u, self._action_shape, self._action_dtype,
                                self._action_bounds)
        self._set_observation(self._env.step(action)[0])
        if self._render:
            self._env.render()

    def get_state(self, var=1e-2) -> GaussianVariable:
        return GaussianVariable(self._state,
                                _var=var * torch.ones_like(self._state))

    def reset(self):
        obs = self._env.reset()
        if isinstance(obs, tuple):  # gymnasium returns (obs, info)
            obs = obs[0]
        self._set_observation(obs)
        if self._render:
            self._env.render()

    def close(self):
        self._env.close()

    def _set_observation(self, obs):
        self._state = torch.as_tensor(_state_from_observation(obs),
                                      dtype=self.dtype, device=self.device)


def _action_from_u(u, space_shape, space_dtype, space_bounds):
    """The env's action: ``u`` reshaped to the space, clamped to its
    bounds, cast to its dtype."""
    action = u.reshape(space_shape)
    min_bounds, max_bounds = space_bounds
    action = np.clip(action, min_bounds, max_bounds)
    return action.astype(space_dtype)


def _state_from_observation(obs):
    """An observation as a flat float64 numpy array."""
    if isinstance(obs, np.ndarray):
        state = obs.reshape(-1)
    elif isinstance(obs, (int, float, bool)):
        state = np.array([obs])
    else:
        state = np.asarray(obs).reshape(-1)
    return state.astype(np.float64)


def _size_from_space(space):
    if hasattr(space, "shape") and space.shape:
        return int(np.prod(space.shape))
    if hasattr(space, "n"):
        return 1
    raise NotImplementedError("Unsupported space: {}".format(space))


def _shape_from_space(space):
    if hasattr(space, "shape") and space.shape is not None:
        return tuple(space.shape)
    return ()


def _dtype_from_space(space):
    if hasattr(space, "dtype"):
        return space.dtype
    return np.float32


def _bounds_from_space(space):
    if hasattr(space, "low") and hasattr(space, "high"):
        return np.asarray(space.low), np.asarray(space.high)
    if hasattr(space, "n"):
        return np.array(0), np.array(space.n - 1)
    raise NotImplementedError("Unsupported space: {}".format(space))
