from .cost import PendulumCost
from .env import PendulumEnv
from .model import PendulumDynamicsModel

__all__ = ["PendulumCost", "PendulumEnv", "PendulumDynamicsModel"]
