"""Particles: distribution -> particles -> distribution (port of
``pddp_tpu/utils/particles.py``).

``particles_covar`` and ``standardize`` are the particle statistics, with
the unbiased (ddof=1) estimator of the reference. ``infer_eps`` and
``moment_match`` are the two ends of a particle step, shared by the
belief-state BNN and ``ParticleDynamicsModel``. ``particulate_model``
wraps any deterministic dynamics model into a ``ParticleDynamicsModel``:
at each step it decodes z into the mean and the upper covariance factor,
pushes ``n_particles`` particles through the inner model under
IGNORE_UNCERTAINTY and moment-matches them back into an encoded state.

Noise: the standardized episode noise ``eps`` (horizon, P, n) is drawn
once; at step i > 0 the noise is inferred by back-solving the previous
step's particle outputs (the model's rolling state) through the
covariance factor, and falls back to ``eps[i]`` where that solve is not
finite. The noise used is the step's aux, replayed as a constant by
``apply`` (the local model's Jacobians go through ``apply``). Every method
takes leading batch dims: z is (..., nz), the state (..., P, n).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..encoding import StateEncoding, decode_covar_sqrt, decode_mean, encode
from ..models.base import DynamicsModel
from . import draws
from .linalg import tria_solve_right

__all__ = ["ParticleDynamicsModel", "ParticleState", "infer_eps",
           "moment_match", "particles_covar", "particulate_model",
           "standardize", "tensor_like"]


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


def infer_eps(U_chol, deltas, eps0, first, group=None):
    """The noise of one step: ``eps @ U_chol = deltas`` solved per
    particle, or ``eps0`` for the whole (P, n) array where any element of
    the solve is not finite, or at the first step. A blend by a 0/1
    weight, not a branch, so that every lane of a batch and every tangent
    of ``torch.func`` see one function; the solve is detached.

    Args:
        U_chol (..., n, n), deltas (..., P, n), eps0 (P, n) or (..., P, n),
        first: whether this is step 0.
        group: the process group over which the particles are sharded
            (each rank holds a block of them), or None. The fallback is
            then taken on every rank where the solve fails on any.
    """
    eps_inf = tria_solve_right(U_chol, deltas).detach()
    finite = torch.isfinite(eps_inf)
    eps_safe = torch.where(finite, eps_inf, torch.zeros_like(eps_inf))
    bad = (~finite.all(dim=-1).all(dim=-1)).to(deltas.dtype)
    if group is not None:
        from ..parallel.collectives import any_rank
        bad = any_rank(bad, group)
    w = torch.clamp(bad, min=float(first))[..., None, None]
    return eps0 * w + eps_safe * (1.0 - w)


def moment_match(output, encoding, jitter_levels=None, group=None,
                 n_global=0):
    """Particles (..., P, n) -> encoded distribution (..., nz): the mean,
    and the ddof=1 covariance through ``encode`` (the Cholesky codec with
    the ``jitter_levels`` ladder), or the ddof=0 std for the diagonal
    codecs.

    With ``group`` (the particles sharded over its ranks, ``n_global`` of
    them in all), the mean and then the covariance or the variance are
    sums over the ranks of each rank's sums: two all-reduces."""
    matrix = encoding in (StateEncoding.FULL_COVARIANCE_MATRIX,
                          StateEncoding.UPPER_TRIANGULAR_CHOLESKY)
    if group is None:
        M = output.mean(dim=-2)
        if matrix:
            return encode(M, C=particles_covar(output, dim=-2),
                          encoding=encoding, jitter_levels=jitter_levels)
        return encode(M, S=output.std(dim=-2, correction=0),
                      encoding=encoding)
    from ..parallel.collectives import all_reduce_sum
    M = all_reduce_sum(output.sum(dim=-2), group) / n_global
    deltas = output - M[..., None, :]
    if matrix:
        C = all_reduce_sum(torch.einsum("...pi,...pj->...ij", deltas,
                                        deltas), group) / (n_global - 1)
        return encode(M, C=C, encoding=encoding, jitter_levels=jitter_levels)
    V = all_reduce_sum((deltas * deltas).sum(dim=-2), group) / n_global
    return encode(M, S=torch.sqrt(V), encoding=encoding)


def tensor_like(model):
    """A floating tensor of ``model``'s parameters (None if it has none):
    where its noise lives, and in which dtype."""
    return next((v for v in vars(model).values()
                 if isinstance(v, torch.Tensor) and v.is_floating_point()),
                None)


@dataclass
class ParticleState:
    """Rolling carry: the previous step's particle outputs (..., P, n)."""

    prev_output: torch.Tensor


class ParticleDynamicsModel(DynamicsModel):
    """A deterministic model ``inner`` as a particle distribution model.

    Fields: ``inner``, ``eps`` (horizon, P, n) standardized episode noise,
    ``n_particles``, ``horizon``, ``infer_noise_variables``. Without noise
    inference every step takes ``eps[i]``.
    """

    def __init__(self, inner, eps, n_particles=100, horizon=100,
                 infer_noise_variables=True):
        self.inner = inner
        self.eps = eps
        self.n_particles = n_particles
        self.horizon = horizon
        self.infer_noise_variables = infer_noise_variables

    @property
    def state_size(self):
        return self.inner.state_size

    @property
    def action_size(self):
        return self.inner.action_size

    @property
    def angular_indices(self):
        return self.inner.angular_indices

    @property
    def non_angular_indices(self):
        return self.inner.non_angular_indices

    @classmethod
    def create(cls, inner, generator=None, n_particles=100, horizon=100,
               infer_noise_variables=True, dtype=None, eps=None):
        """A particle model over ``inner`` with fresh episode noise: the
        standard normal draws ``eps`` (horizon, P, n) where given (numpy or
        a tensor, standardized here), else drawn from ``generator``. The
        noise lives on the inner model's device, in ``dtype`` (by default
        the inner model's; a model without parameters: ``cuda``,
        float32)."""
        probe = tensor_like(inner)
        if dtype is None:
            dtype = probe.dtype if probe is not None else torch.float32
        device = probe.device if probe is not None else resolve_device(None)
        shape = (horizon, n_particles, inner.state_size)
        raw = (draws.normal(generator, shape, dtype, device) if eps is None
               else draws.explicit(eps, dtype, device, shape))
        return cls(inner, standardize(raw, dim=1), n_particles=n_particles,
                   horizon=horizon,
                   infer_noise_variables=infer_noise_variables)

    def replace(self, **fields):
        """A shallow copy with ``fields`` set."""
        new = copy.copy(self)
        for k, v in fields.items():
            if not hasattr(new, k):
                raise AttributeError(k)
            setattr(new, k, v)
        return new

    def resample(self, generator=None, noise=None):
        """Fresh episode noise from ``generator``, then the inner model's
        ``resample`` (the identity for analytic models); or explicit
        draws, ``noise`` a mapping with ``eps`` (raw standard normal,
        standardized here) and ``inner`` (the inner model's ``noise``)."""
        noise = noise or {}
        raw = noise.get("eps")
        raw = (draws.normal(generator, self.eps.shape, self.eps.dtype,
                            self.eps.device) if raw is None else
               draws.explicit(raw, self.eps.dtype, self.eps.device,
                              self.eps.shape))
        inner = self.inner.resample(generator, noise.get("inner"))
        return self.replace(inner=inner, eps=standardize(raw, dim=1))

    def init_state(self, batch_shape=()):
        return ParticleState(prev_output=self.eps.new_zeros(
            tuple(batch_shape) + (self.n_particles, self.state_size)))

    def aux_zero(self):
        return self.eps.new_zeros((self.n_particles, self.state_size))

    def _effective_eps(self, z, i, state: ParticleState, encoding):
        """(eps, mean, U_chol) of step i (see ``infer_eps``)."""
        mean = decode_mean(z, encoding, self.state_size)
        U_chol = decode_covar_sqrt(z, encoding, self.state_size)
        eps0 = self.eps[i].to(z.dtype)
        if not self.infer_noise_variables:
            return eps0.expand(z.shape[:-1] + eps0.shape), mean, U_chol
        deltas = state.prev_output - mean[..., None, :]
        return infer_eps(U_chol, deltas, eps0, i == 0), mean, U_chol

    def _push(self, X, u, i):
        """The inner model on every particle, ``u`` (..., nu) broadcast
        to (..., P, nu)."""
        u_b = u[..., None, :].expand(X.shape[:-1] + u.shape[-1:])
        return self.inner.apply(X, u_b, i, (),
                                StateEncoding.IGNORE_UNCERTAINTY)

    def step(self, z, u, i, state: ParticleState,
             encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        eps, mean, U_chol = self._effective_eps(z, i, state, encoding)
        X = mean[..., None, :] + torch.matmul(eps, U_chol)
        output = self._push(X, u, i)
        z_next = moment_match(output, encoding)
        return z_next, ParticleState(prev_output=output.detach()), eps

    def apply(self, z, u, i, aux, encoding=StateEncoding.DEFAULT, **kwargs):
        """Smooth dynamics with the step's noise ``aux`` held constant."""
        mean = decode_mean(z, encoding, self.state_size)
        U_chol = decode_covar_sqrt(z, encoding, self.state_size)
        X = mean[..., None, :] + torch.matmul(aux, U_chol)
        return moment_match(self._push(X, u, i), encoding)

    def __call__(self, z, u, i, encoding=StateEncoding.DEFAULT, **kwargs):
        return self.step(z, u, i, self.init_state(z.shape[:-1]),
                         encoding)[0]

    def fit(self, X, U, dX, **kwargs):
        """Fits the inner model; returns the updated particle model."""
        return self.replace(inner=self.inner.fit(X, U, dX, **kwargs))


def particulate_model(model, generator=None, n_particles=100, **kwargs):
    """``model`` (a deterministic ``DynamicsModel`` instance) as a
    ``ParticleDynamicsModel``; ``kwargs`` go to ``create``."""
    return ParticleDynamicsModel.create(model, generator,
                                        n_particles=n_particles, **kwargs)
