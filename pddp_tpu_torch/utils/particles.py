"""Particle statistics (port of ``pddp_tpu/utils/particles.py``): the
sample covariance of a particle set and the standardization of episode
noise, both with the unbiased (ddof=1) estimator of the reference."""

from __future__ import annotations

import torch

__all__ = ["particles_covar", "standardize"]


def particles_covar(x, dim=0):
    """Sample covariance (ddof=1) of the particles along ``dim``:
    (..., P, ..., n) -> (..., n, n) with the particle axis removed."""
    x = x.movedim(dim, -2)
    deltas = x - x.mean(dim=-2, keepdim=True)
    return torch.einsum("...pi,...pj->...ij", deltas,
                        deltas) / (x.shape[-2] - 1)


def standardize(eps, dim=0):
    """Noise with zero mean and unit sample std (ddof=1) along ``dim``."""
    return ((eps - eps.mean(dim=dim, keepdim=True))
            / eps.std(dim=dim, keepdim=True, correction=1))
