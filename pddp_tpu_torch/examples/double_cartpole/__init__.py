from .cost import DoubleCartpoleCost
from .model import DoubleCartpoleDynamicsModel

__all__ = ["DoubleCartpoleCost", "DoubleCartpoleDynamicsModel"]
