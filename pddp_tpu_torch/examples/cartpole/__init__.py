from .cost import CartpoleCost
from .model import CartpoleDynamicsModel

__all__ = ["CartpoleCost", "CartpoleDynamicsModel"]
