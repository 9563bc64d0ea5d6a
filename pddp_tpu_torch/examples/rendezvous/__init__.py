from .cost import RendezvousCost
from .env import RendezvousEnv
from .model import RendezvousDynamicsModel

__all__ = ["RendezvousCost", "RendezvousEnv", "RendezvousDynamicsModel"]
