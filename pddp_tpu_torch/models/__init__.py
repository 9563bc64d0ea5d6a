from .base import DynamicsModel

__all__ = ["DynamicsModel"]
