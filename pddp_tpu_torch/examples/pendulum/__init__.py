from .cost import PendulumCost
from .model import PendulumDynamicsModel

__all__ = ["PendulumCost", "PendulumDynamicsModel"]
