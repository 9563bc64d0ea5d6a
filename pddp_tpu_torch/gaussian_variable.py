"""Multivariate Gaussian random variable (port of
``pddp_tpu/gaussian_variable.py``): the state type that envs hand to
controllers.

The variable stores one uncertainty representation (full covariance,
variances or standard deviations) and derives the others on demand.
``sample`` and ``random`` take a ``torch.Generator`` where ``pddp_tpu``
takes a PRNG key; the two give different draws from the same seed. The
noise is drawn on the generator's device and moved to the variable's.
"""

from __future__ import annotations

from typing import Optional

import torch

from .encoding import (StateEncoding, decode_covar, decode_mean, decode_std,
                       decode_var, encode)

__all__ = ["GaussianVariable"]


def _randn(generator, shape, dtype, device):
    """Standard normal noise from ``generator`` (or torch's default one),
    drawn on the generator's device, on ``device``."""
    where = device if generator is None else generator.device
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=where).to(device)


class GaussianVariable:
    """Multivariate Gaussian random variable.

    At least one of ``_covar``, ``_var``, ``_std`` must be given; the rest
    are derived on demand.
    """

    def __init__(self, _mean: torch.Tensor,
                 _covar: Optional[torch.Tensor] = None,
                 _var: Optional[torch.Tensor] = None,
                 _std: Optional[torch.Tensor] = None):
        self._mean = _mean
        self._covar = _covar
        self._var = _var
        self._std = _std

    def __repr__(self):
        return "GaussianVariable({})".format(tuple(self.shape))

    @property
    def shape(self):
        return self._mean.shape

    @property
    def dtype(self):
        return self._mean.dtype

    @property
    def device(self):
        return self._mean.device

    def mean(self):
        """Mean vector (Tensor<n>)."""
        return self._mean

    def covar(self):
        """Full covariance matrix (Tensor<n, n>)."""
        if self._covar is not None:
            return self._covar
        return torch.diag_embed(self.var())

    def var(self):
        """Variance vector (Tensor<n>)."""
        if self._var is not None:
            return self._var
        if self._covar is not None:
            return torch.diagonal(self._covar, dim1=-2, dim2=-1)
        if self._std is not None:
            return self._std.square()
        raise NotImplementedError("Cannot compute variance")

    def std(self):
        """Standard deviation vector (Tensor<n>)."""
        if self._std is not None:
            return self._std
        return torch.sqrt(self.var())

    def sample(self, generator=None, sample_shape=()):
        """A draw through the covariance's Cholesky factor (or the
        standard deviations), with noise from ``generator``.

        Returns:
            Tensor<*sample_shape, n>.
        """
        eps = _randn(generator, tuple(sample_shape) + tuple(self.shape),
                     self.dtype, self.device)
        if self._covar is not None:
            from .utils.linalg import safe_cholesky
            return self._mean + eps @ safe_cholesky(self._covar)
        return self._mean + eps * self.std()

    def encode(self, encoding: StateEncoding = StateEncoding.DEFAULT):
        """Encodes itself into a flat state vector."""
        if encoding in (StateEncoding.FULL_COVARIANCE_MATRIX,
                        StateEncoding.UPPER_TRIANGULAR_CHOLESKY):
            return encode(self.mean(), C=self.covar(), encoding=encoding)
        if encoding in (StateEncoding.VARIANCE_ONLY,
                        StateEncoding.IGNORE_UNCERTAINTY):
            return encode(self.mean(), V=self.var(), encoding=encoding)
        if encoding == StateEncoding.STANDARD_DEVIATION_ONLY:
            return encode(self.mean(), S=self.std(), encoding=encoding)
        raise NotImplementedError("Unknown StateEncoding: {}".format(encoding))

    @classmethod
    def decode(cls, z, encoding: StateEncoding = StateEncoding.DEFAULT,
               state_size=None):
        """Builds a GaussianVariable from an encoded state."""
        mean = decode_mean(z, encoding, state_size)
        if encoding in (StateEncoding.FULL_COVARIANCE_MATRIX,
                        StateEncoding.UPPER_TRIANGULAR_CHOLESKY):
            return cls(mean, _covar=decode_covar(z, encoding, state_size))
        if encoding in (StateEncoding.VARIANCE_ONLY,
                        StateEncoding.IGNORE_UNCERTAINTY):
            return cls(mean, _var=decode_var(z, encoding, state_size))
        if encoding == StateEncoding.STANDARD_DEVIATION_ONLY:
            return cls(mean, _std=decode_std(z, encoding, state_size))
        raise NotImplementedError("Unknown StateEncoding: {}".format(encoding))

    def clone(self):
        """A copy holding cloned tensors."""
        return type(self)(*(None if t is None else t.clone() for t in (
            self._mean, self._covar, self._var, self._std)))

    def detach(self):
        """A copy holding detached tensors."""
        return type(self)(*(None if t is None else t.detach() for t in (
            self._mean, self._covar, self._var, self._std)))

    @classmethod
    def random(cls, generator, n, reg=1e-1, dtype=torch.float32,
               device=None):
        """A random valid GaussianVariable of size n: a standard normal
        mean and covariance L^T L + reg I, L standard normal."""
        from .device import resolve_device
        device = resolve_device(device)
        mean = _randn(generator, (n,), dtype, device)
        L = _randn(generator, (n, n), dtype, device)
        covar = L.T @ L + reg * torch.eye(n, dtype=dtype, device=device)
        return cls(mean, _covar=covar)
