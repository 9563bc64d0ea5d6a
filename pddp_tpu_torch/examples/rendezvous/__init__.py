from .cost import RendezvousCost
from .model import RendezvousDynamicsModel

__all__ = ["RendezvousCost", "RendezvousDynamicsModel"]
