"""Controllers of the port: the iLQR functional core and its stateful
controller (``PDDPController`` is not ported yet)."""

from .base import Controller
from .ilqr import ILQROptions, ILQRResult, iLQRController, iLQRState

__all__ = [
    "Controller",
    "ILQROptions",
    "ILQRResult",
    "iLQRController",
    "iLQRState",
]
