from .base import AggregateCost, Cost
from .quadratic import QRCost, augmented_qr_derivatives

__all__ = ["AggregateCost", "Cost", "QRCost", "augmented_qr_derivatives"]
