"""Controllers of the port: the iLQR functional core, its stateful
controller and the PDDP episodic loop over it."""

from .base import Controller
from .ilqr import ILQROptions, ILQRResult, iLQRController, iLQRState
from .pddp import PDDPController

__all__ = [
    "Controller",
    "ILQROptions",
    "ILQRResult",
    "PDDPController",
    "iLQRController",
    "iLQRState",
]
