"""Trajectory utilities (port of ``pddp_tpu/utils/trajectory.py``)."""

from __future__ import annotations

import torch

__all__ = [
    "mean_trajectory",
    "sample_trajectory",
    "trajectory_to_training_data",
]


def mean_trajectory(X):
    """The means of a sequence of ``GaussianVariable`` s, stacked."""
    return torch.stack([x.mean() for x in X])


def sample_trajectory(X, generator=None):
    """One draw from each ``GaussianVariable`` of ``X``, in order, with
    noise from ``generator``, stacked."""
    return torch.stack([x.sample(generator) for x in X])


def trajectory_to_training_data(X, U):
    """States X (N+1, n) and actions U (N, nu) -> (state-action pairs
    (N, n + nu), state deltas X[i] - X[i+1])."""
    X_ = torch.cat([X[:-1], U], dim=-1)
    dX = X[:-1] - X[1:]
    return X_, dX
