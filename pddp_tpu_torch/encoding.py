"""State-distribution encoding (port of ``pddp_tpu/encoding.py``).

Every state is a Gaussian over the true state, flattened into one vector
``z``: the mean, then the uncertainty in one of five codecs. All functions
broadcast over leading batch dims.
"""

from __future__ import annotations

import math
from enum import IntEnum

import torch

from .utils.linalg import safe_cholesky

__all__ = [
    "StateEncoding",
    "infer_encoded_state_size",
    "infer_state_size",
    "encode",
    "decode_mean",
    "decode_covar",
    "decode_var",
    "decode_std",
    "decode_covar_sqrt",
]


class StateEncoding(IntEnum):
    """State encoding types; same integer values as ``pddp_tpu``."""

    #: full covariance matrix: size n + n^2.
    FULL_COVARIANCE_MATRIX = 0
    #: upper-triangular Cholesky factor (default): size n + n(n+1)/2.
    UPPER_TRIANGULAR_CHOLESKY = 1
    #: variance only: size 2n.
    VARIANCE_ONLY = 2
    #: standard deviation only: size 2n.
    STANDARD_DEVIATION_ONLY = 3
    #: mean only, ignoring uncertainty: size n (plain iLQR).
    IGNORE_UNCERTAINTY = 4

    DEFAULT = 1


# Unit uncertainty reported when decoding IGNORE_UNCERTAINTY states.
_IGNORE_VAR = 1e-6
_IGNORE_STD = 1e-3


def infer_encoded_state_size(state_size: int,
                             encoding: StateEncoding = StateEncoding.DEFAULT
                             ) -> int:
    """Encoded vector size for a given state size."""
    if encoding == StateEncoding.FULL_COVARIANCE_MATRIX:
        return state_size + state_size**2
    if encoding == StateEncoding.UPPER_TRIANGULAR_CHOLESKY:
        return (3 * state_size + state_size**2) // 2
    if encoding in (StateEncoding.VARIANCE_ONLY,
                    StateEncoding.STANDARD_DEVIATION_ONLY):
        return 2 * state_size
    if encoding == StateEncoding.IGNORE_UNCERTAINTY:
        return state_size
    raise NotImplementedError("Unknown StateEncoding: {}".format(encoding))


def infer_state_size(encoded_state_size: int,
                     encoding: StateEncoding = StateEncoding.DEFAULT) -> int:
    """State size from an encoded vector size."""
    n = encoded_state_size
    if encoding == StateEncoding.FULL_COVARIANCE_MATRIX:
        return int(0.5 * (-1 + math.sqrt(1 + 4 * n)))
    if encoding == StateEncoding.UPPER_TRIANGULAR_CHOLESKY:
        return int(round(0.5 * (-3 + math.sqrt(9 + 8 * n))))
    if encoding in (StateEncoding.VARIANCE_ONLY,
                    StateEncoding.STANDARD_DEVIATION_ONLY):
        return n // 2
    if encoding == StateEncoding.IGNORE_UNCERTAINTY:
        return n
    raise NotImplementedError("Unknown StateEncoding: {}".format(encoding))


def _flatten_triu(U):
    """Row-major upper triangle of (..., n, n) as (..., n(n+1)/2)."""
    n = U.shape[-1]
    r, c = torch.triu_indices(n, n, device=U.device)
    return U[..., r, c]


def _unflatten_triu(X, n: int):
    """Inverse of ``_flatten_triu``: upper-triangular (..., n, n)."""
    r, c = torch.triu_indices(n, n, device=X.device)
    U = X.new_zeros(X.shape[:-1] + (n, n))
    U[..., r, c] = X
    return U


def _diag_embed(v):
    return torch.diag_embed(v)


def _V_from(C=None, V=None, S=None):
    if V is not None:
        return V
    if S is not None:
        return S.square()
    if C is not None:
        return torch.diagonal(C, dim1=-2, dim2=-1)
    raise ValueError("At least one of C, V, S must be specified")


def _C_from(C=None, V=None, S=None):
    if C is not None:
        return C
    return _diag_embed(_V_from(C, V, S))


def encode(M, C=None, V=None, S=None,
           encoding: StateEncoding = StateEncoding.DEFAULT,
           jitter_levels=None):
    """Encodes a state distribution; at least one of C, V, S is given
    unless ``encoding`` is IGNORE_UNCERTAINTY.

    Args:
        M (Tensor<..., n>): means.
        C (Tensor<..., n, n>): covariances.
        V (Tensor<..., n>): variances.
        S (Tensor<..., n>): standard deviations.
        jitter_levels: Cholesky jitter ladder override.

    Returns:
        Tensor<..., encoded_state_size>.
    """
    n = M.shape[-1]
    if encoding == StateEncoding.IGNORE_UNCERTAINTY:
        return M
    if encoding == StateEncoding.FULL_COVARIANCE_MATRIX:
        Cm = _C_from(C, V, S)
        other = Cm.reshape(Cm.shape[:-2] + (n * n,))
    elif encoding == StateEncoding.UPPER_TRIANGULAR_CHOLESKY:
        if C is None and (V is not None or S is not None):
            # The Cholesky factor of diag(v) is diag(sqrt(v)).
            U = _diag_embed(torch.sqrt(_V_from(C, V, S).clamp(min=0.0)))
        elif jitter_levels is not None:
            U = safe_cholesky(_C_from(C, V, S), jitter_levels=jitter_levels)
        else:
            U = safe_cholesky(_C_from(C, V, S))
        other = _flatten_triu(U)
    elif encoding == StateEncoding.VARIANCE_ONLY:
        other = _V_from(C, V, S)
    elif encoding == StateEncoding.STANDARD_DEVIATION_ONLY:
        other = torch.sqrt(_V_from(C, V, S)) if S is None else S
    else:
        raise NotImplementedError("Unknown StateEncoding: {}".format(encoding))
    other = other.expand(M.shape[:-1] + other.shape[-1:])
    return torch.cat([M, other], dim=-1)


def _split(Z, encoding: StateEncoding, state_size=None):
    if state_size is None:
        state_size = infer_state_size(Z.shape[-1], encoding)
    return Z[..., :state_size], Z[..., state_size:], state_size


def decode_mean(Z, encoding: StateEncoding = StateEncoding.DEFAULT,
                state_size=None):
    """Mean vector(s) from encoded state(s)."""
    return _split(Z, encoding, state_size)[0]


def decode_covar(Z, encoding: StateEncoding = StateEncoding.DEFAULT,
                 state_size=None):
    """Covariance matrices from encoded state(s)."""
    _, other, n = _split(Z, encoding, state_size)
    if encoding == StateEncoding.FULL_COVARIANCE_MATRIX:
        return other.reshape(other.shape[:-1] + (n, n))
    if encoding == StateEncoding.UPPER_TRIANGULAR_CHOLESKY:
        U = _unflatten_triu(other, n)
        return U.transpose(-1, -2) @ U
    if encoding == StateEncoding.VARIANCE_ONLY:
        return _diag_embed(other)
    if encoding == StateEncoding.STANDARD_DEVIATION_ONLY:
        return _diag_embed(other.square())
    if encoding == StateEncoding.IGNORE_UNCERTAINTY:
        C = _IGNORE_VAR * torch.eye(n, dtype=Z.dtype, device=Z.device)
        return C.expand(Z.shape[:-1] + (n, n))
    raise NotImplementedError("Unknown StateEncoding: {}".format(encoding))


def decode_var(Z, encoding: StateEncoding = StateEncoding.DEFAULT,
               state_size=None):
    """Variance vector(s) from encoded state(s)."""
    _, other, n = _split(Z, encoding, state_size)
    if encoding == StateEncoding.FULL_COVARIANCE_MATRIX:
        C = other.reshape(other.shape[:-1] + (n, n))
        return torch.diagonal(C, dim1=-2, dim2=-1)
    if encoding == StateEncoding.UPPER_TRIANGULAR_CHOLESKY:
        return _unflatten_triu(other, n).square().sum(dim=-2)
    if encoding == StateEncoding.VARIANCE_ONLY:
        return other
    if encoding == StateEncoding.STANDARD_DEVIATION_ONLY:
        return other.square()
    if encoding == StateEncoding.IGNORE_UNCERTAINTY:
        return torch.full_like(Z, _IGNORE_VAR)
    raise NotImplementedError("Unknown StateEncoding: {}".format(encoding))


def decode_std(Z, encoding: StateEncoding = StateEncoding.DEFAULT,
               state_size=None):
    """Standard deviation vector(s) from encoded state(s)."""
    if encoding == StateEncoding.STANDARD_DEVIATION_ONLY:
        return _split(Z, encoding, state_size)[1]
    if encoding == StateEncoding.IGNORE_UNCERTAINTY:
        return torch.full_like(Z, _IGNORE_STD)
    return torch.sqrt(decode_var(Z, encoding, state_size))


def decode_covar_sqrt(Z, encoding: StateEncoding = StateEncoding.DEFAULT,
                      state_size=None):
    """Upper-triangular U with C = U^T U (particles: ``mean + eps @ U``)."""
    _, other, n = _split(Z, encoding, state_size)
    if encoding == StateEncoding.FULL_COVARIANCE_MATRIX:
        return safe_cholesky(other.reshape(other.shape[:-1] + (n, n)))
    if encoding == StateEncoding.UPPER_TRIANGULAR_CHOLESKY:
        return _unflatten_triu(other, n)
    if encoding == StateEncoding.VARIANCE_ONLY:
        return _diag_embed(torch.sqrt(other.clamp(min=0.0)))
    if encoding == StateEncoding.STANDARD_DEVIATION_ONLY:
        return _diag_embed(other)
    if encoding == StateEncoding.IGNORE_UNCERTAINTY:
        U = _IGNORE_STD * torch.eye(n, dtype=Z.dtype, device=Z.device)
        return U.expand(Z.shape[:-1] + (n, n))
    raise NotImplementedError("Unknown StateEncoding: {}".format(encoding))
