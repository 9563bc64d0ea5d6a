from .base import AggregateCost, Cost
from .quadratic import QRCost, SaturatingQRCost, augmented_qr_derivatives

__all__ = ["AggregateCost", "Cost", "QRCost", "SaturatingQRCost",
           "augmented_qr_derivatives"]
