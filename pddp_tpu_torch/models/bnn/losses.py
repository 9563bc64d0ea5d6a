"""Bayesian neural network losses (port of ``pddp_tpu/models/bnn/losses.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["gaussian_log_likelihood"]


def gaussian_log_likelihood(targets, pred_means, pred_stds=None):
    """Heteroscedastic Gaussian log marginal likelihood over the last
    dim; without ``pred_stds``, the unit-variance one up to its
    constant."""
    deltas = pred_means - targets
    if pred_stds is not None:
        return (-0.5 * torch.sum(torch.square(deltas / pred_stds), dim=-1)
                - torch.sum(torch.log(pred_stds), dim=-1)
                - 0.5 * math.log(2 * math.pi))
    return -0.5 * torch.sum(torch.square(deltas), dim=-1)
