"""Action constraints (port of ``pddp_tpu/utils/constraint.py``).

The box-QP backward is ROADMAP A8 and is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["constrain", "clamp"]


def constrain(u, min_bounds, max_bounds):
    """Squashes an action into [min, max] through tanh."""
    diff = (max_bounds - min_bounds) / 2.0
    mean = (max_bounds + min_bounds) / 2.0
    return diff * torch.tanh(u) + mean


def clamp(u, min_bounds, max_bounds):
    """Element-wise clamp."""
    return torch.minimum(torch.maximum(u, min_bounds), max_bounds)
