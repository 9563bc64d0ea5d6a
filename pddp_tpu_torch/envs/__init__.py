"""Environments of the port: the ``Env`` contract, ``SimEnv`` and the
gym adapter ``GymEnv``."""

from .base import Env, SimEnv
from .gym_env import GymEnv

__all__ = ["Env", "SimEnv", "GymEnv"]
