from .cost import DoubleCartpoleCost
from .env import DoubleCartpoleEnv
from .model import DoubleCartpoleDynamicsModel

__all__ = ["DoubleCartpoleCost", "DoubleCartpoleEnv", "DoubleCartpoleDynamicsModel"]
