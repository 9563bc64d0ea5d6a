"""Angular state augmentation (port of ``pddp_tpu/utils/angular.py``).

Angular components theta are replaced by [sin(theta), cos(theta)]; the
augmented layout is [non_angular_states, sin(a1), cos(a1), ...]. For a
Gaussian belief the augmentation is moment-matched exactly:
E[sin theta] = e^{-v/2} sin(mu), and so on, with the full joint covariance
of the augmented vector. Everything broadcasts over leading batch dims
and runs under ``torch.func`` transforms (no in-place writes).
"""

from __future__ import annotations

import torch

from ..encoding import (StateEncoding, decode_covar, decode_mean, decode_var,
                        encode)

__all__ = ["augment_state", "reduce_state", "augment_encoded_state",
           "complementary_indices", "infer_augmented_state_size",
           "infer_reduced_state_size"]


def _as_tuple(idx):
    return tuple(int(i) for i in idx)


def complementary_indices(indices, size: int):
    """The indices of ``range(size)`` not in ``indices`` (ints in a
    sequence, an array or a tensor, or one int), in order."""
    idx = set(torch.as_tensor(indices).reshape(-1).tolist())
    return tuple(i for i in range(size) if i not in idx)


def infer_augmented_state_size(angular_indices, non_angular_indices) -> int:
    """Size after augmentation."""
    return len(_as_tuple(non_angular_indices)) + 2 * len(
        _as_tuple(angular_indices))


def infer_reduced_state_size(angular_indices, non_angular_indices) -> int:
    """Size after reduction."""
    return len(_as_tuple(non_angular_indices)) + len(
        _as_tuple(angular_indices))


def _interleave(a, b):
    """(..., k), (..., k) -> (..., 2k) as [a0, b0, a1, b1, ...]."""
    return torch.stack([a, b], dim=-1).flatten(-2)


def augment_state(x, angular_indices, non_angular_indices):
    """Replace angular components by [sin, cos] pairs.

    Args:
        x (Tensor<..., state_size>): state vector(s).

    Returns:
        Tensor<..., non_angular + 2*angular>.
    """
    ai = _as_tuple(angular_indices)
    if not ai:
        return x
    nai = _as_tuple(non_angular_indices)
    th = x[..., list(ai)]
    return torch.cat([x[..., list(nai)],
                      _interleave(torch.sin(th), torch.cos(th))], dim=-1)


def reduce_state(x_, angular_indices, non_angular_indices):
    """Inverse of ``augment_state`` through atan2."""
    ai = _as_tuple(angular_indices)
    if not ai:
        return x_
    nai = _as_tuple(non_angular_indices)
    n_others = len(nai)
    sin_cos = x_[..., n_others:]
    angles = torch.atan2(sin_cos[..., 0::2], sin_cos[..., 1::2])
    parts = [None] * (len(ai) + n_others)
    for k, a in enumerate(ai):
        parts[a] = angles[..., k]
    for k, a in enumerate(nai):
        parts[a] = x_[..., k]
    return torch.stack(parts, dim=-1)


def _augment_var(m, v, angular_indices, non_angular_indices):
    """Moment-matched augmentation of mean and variance vectors:

        Var[sin] = 0.5 ((1 - e^{-v}) - (e^{-2v} - e^{-v}) cos(2m))
        Var[cos] = 0.5 ((1 - e^{-v}) + (e^{-2v} - e^{-v}) cos(2m))
    """
    ai = _as_tuple(angular_indices)
    if not ai:
        return m, v
    nai = list(_as_tuple(non_angular_indices))
    mi, vi = m[..., list(ai)], v[..., list(ai)]
    exp_vi_h = torch.exp(-0.5 * vi)
    Ma = _interleave(exp_vi_h * torch.sin(mi), exp_vi_h * torch.cos(mi))
    exp_m_vi = torch.exp(-vi)
    U3 = 1.0 - exp_m_vi
    U4 = (torch.exp(-2.0 * vi) - exp_m_vi) * torch.cos(2.0 * mi)
    Va = 0.5 * _interleave(U3 - U4, U3 + U4)
    return (torch.cat([m[..., nai], Ma], dim=-1),
            torch.cat([v[..., nai], Va], dim=-1))


def _augment_covar(m, c, angular_indices, non_angular_indices):
    """Moment-matched augmentation with the full covariance, including
    the cross covariances between the non-angular states and the sin/cos
    pairs (C^T Ca)."""
    ai = _as_tuple(angular_indices)
    if not ai:
        return m, c
    nai = list(_as_tuple(non_angular_indices))
    na, D = len(ai), m.shape[-1]
    mi = m[..., list(ai)]
    ci = c[..., list(ai), :][..., list(ai)]                  # (..., na, na)
    cii = torch.diagonal(ci, dim1=-2, dim2=-1)

    exp_cii_h = torch.exp(-0.5 * cii)
    Ma_sin = exp_cii_h * torch.sin(mi)
    Ma_cos = exp_cii_h * torch.cos(mi)
    Ma = _interleave(Ma_sin, Ma_cos)

    lq = -0.5 * (cii[..., :, None] + cii[..., None, :])
    q = torch.exp(lq)
    exp_lq_p_ci = torch.exp(lq + ci)
    exp_lq_m_ci = torch.exp(lq - ci)
    dm = mi[..., :, None] - mi[..., None, :]
    sm = mi[..., :, None] + mi[..., None, :]
    U1 = (exp_lq_p_ci - q) * torch.sin(dm)
    U2 = (exp_lq_m_ci - q) * torch.sin(sm)
    U3 = (exp_lq_p_ci - q) * torch.cos(dm)
    U4 = (exp_lq_m_ci - q) * torch.cos(sm)

    # Interleaved sin/cos block (..., 2na, 2na) from (..., na, na, 2, 2)
    # blocks [[ss, sc], [cs, cc]].
    blocks = torch.stack([
        torch.stack([U3 - U4, U1 + U2], dim=-1),
        torch.stack([(U1 + U2).transpose(-1, -2), U3 + U4], dim=-1),
    ], dim=-2)
    Va = 0.5 * blocks.movedim(-2, -3).reshape(blocks.shape[:-4]
                                              + (2 * na, 2 * na))

    # Input-output helper Ca (..., D, 2na): the row of angle k holds
    # (E[cos], -E[sin]) at its sin/cos columns.
    batch = m.shape[:-1]
    zero1 = m.new_zeros(batch + (1,))
    rows = []
    for d in range(D):
        if d in ai:
            kk = ai.index(d)
            rows.append(torch.cat(
                [zero1] * (2 * kk) + [Ma_cos[..., kk:kk + 1],
                                      -Ma_sin[..., kk:kk + 1]]
                + [zero1] * (2 * na - 2 * kk - 2), dim=-1))
        else:
            rows.append(m.new_zeros(batch + (2 * na,)))
    Ca = torch.stack(rows, dim=-2)

    M = torch.cat([m[..., nai], Ma], dim=-1)
    if not nai:
        return M, Va
    Vna = c[..., nai, :][..., nai]
    cross = torch.einsum("...ji,...jk->...ik", c, Ca)[..., nai, :]
    top = torch.cat([Vna, cross], dim=-1)
    bottom = torch.cat([cross.transpose(-1, -2), Va], dim=-1)
    return M, torch.cat([top, bottom], dim=-2)


def augment_encoded_state(z, angular_indices, non_angular_indices,
                          encoding: StateEncoding = StateEncoding.DEFAULT,
                          state_size=None):
    """Distribution-level augmentation of an encoded state."""
    if encoding == StateEncoding.IGNORE_UNCERTAINTY:
        return augment_state(z, angular_indices, non_angular_indices)
    mean = decode_mean(z, encoding, state_size)
    if encoding in (StateEncoding.FULL_COVARIANCE_MATRIX,
                    StateEncoding.UPPER_TRIANGULAR_CHOLESKY):
        M, C = _augment_covar(mean, decode_covar(z, encoding, state_size),
                              angular_indices, non_angular_indices)
        return encode(M, C=C, encoding=encoding)
    if encoding in (StateEncoding.VARIANCE_ONLY,
                    StateEncoding.STANDARD_DEVIATION_ONLY):
        M, V = _augment_var(mean, decode_var(z, encoding, state_size),
                            angular_indices, non_angular_indices)
        return encode(M, V=V, encoding=encoding)
    raise NotImplementedError("Unknown StateEncoding: {}".format(encoding))
