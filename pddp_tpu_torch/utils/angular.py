"""Angular state augmentation (port of ``pddp_tpu/utils/angular.py``).

Angular components theta are replaced by [sin(theta), cos(theta)]; the
augmented layout is [non_angular_states, sin(a1), cos(a1), ...]. Only the
mean-state form is ported: the moment-matched belief forms are ROADMAP A9.
"""

from __future__ import annotations

import torch

from ..encoding import StateEncoding

__all__ = ["augment_state", "augment_encoded_state",
           "infer_augmented_state_size"]


def _as_tuple(idx):
    return tuple(int(i) for i in idx)


def infer_augmented_state_size(angular_indices, non_angular_indices) -> int:
    """Size after augmentation."""
    return len(_as_tuple(non_angular_indices)) + 2 * len(
        _as_tuple(angular_indices))


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
    sc = torch.stack([torch.sin(th), torch.cos(th)], dim=-1).flatten(-2)
    return torch.cat([x[..., list(nai)], sc], dim=-1)


def augment_encoded_state(z, angular_indices, non_angular_indices,
                          encoding: StateEncoding = StateEncoding.DEFAULT,
                          state_size=None):
    """Distribution-level augmentation of an encoded state."""
    if encoding == StateEncoding.IGNORE_UNCERTAINTY:
        return augment_state(z, angular_indices, non_angular_indices)
    raise NotImplementedError(
        "moment-matched augmentation of {} is not ported yet".format(
            StateEncoding(encoding).name))
