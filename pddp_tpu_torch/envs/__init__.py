"""Environments of the port (``GymEnv`` is not ported yet)."""

from .base import Env, SimEnv

__all__ = ["Env", "SimEnv"]
