from .cost import CartpoleCost
from .env import CartpoleEnv
from .model import CartpoleDynamicsModel

__all__ = ["CartpoleCost", "CartpoleEnv", "CartpoleDynamicsModel"]
