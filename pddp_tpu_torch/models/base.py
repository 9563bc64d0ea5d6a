"""Dynamics model contract (port of ``pddp_tpu/models/base.py``).

A model exposes two levels:

 * ``step(z, u, i, state, encoding) -> (z_next, state_next, aux)``: one
   rollout step, with the model's rolling carry ``state`` and the per-step
   noise constants ``aux`` it used;
 * ``apply(z, u, i, aux, encoding)``: the smooth function of (z, u) with
   ``aux`` held fixed, so that ``step(...)[0] == apply(z, u, i, aux, ...)``.
   Jacobians are taken through ``apply`` (``utils/evaluation.py``), which
   replays the recorded aux.

Deterministic models carry nothing: their state and aux are ``()``.

Learning: ``fit``, ``resample`` and ``reset_parameters`` return the
updated model (``PDDPController`` replaces its model with the result);
for analytic models each is the identity.
"""

from __future__ import annotations

from ..encoding import StateEncoding

__all__ = ["DynamicsModel"]


class DynamicsModel:
    """Base dynamics model.

    Class attributes:
        state_size (int), action_size (int),
        angular_indices (tuple<int>), non_angular_indices (tuple<int>).
    """

    state_size: int = None
    action_size: int = None
    angular_indices: tuple = ()
    non_angular_indices: tuple = ()

    def init_state(self, batch_shape=()):
        """Initial rolling carry for a fresh rollout."""
        return ()

    def step(self, z, u, i, state,
             encoding: StateEncoding = StateEncoding.DEFAULT):
        """One rollout step: (z_next, state_next, aux)."""
        return self.apply(z, u, i, (), encoding), state, ()

    def aux_zero(self):
        """A placeholder aux with the right structure."""
        return ()

    def apply(self, z, u, i, aux,
              encoding: StateEncoding = StateEncoding.DEFAULT):
        """Smooth dynamics: encoded state + action -> next encoded state."""
        raise NotImplementedError

    def __call__(self, z, u, i, encoding: StateEncoding = StateEncoding.DEFAULT,
                 **kwargs):
        """Single stateless step."""
        return self.step(z, u, i, self.init_state(), encoding)[0]

    def fit(self, X, U, dX, **kwargs):
        """Fits the model to state transitions; returns the updated model.
        Analytic models are exact: the identity."""
        return self

    def resample(self, generator=None, noise=None):
        """A model with fresh episode noise (stochastic models)."""
        return self

    def reset_parameters(self, generator=None):
        """A freshly initialized copy; analytic models carry fixed
        physical parameters: the identity."""
        return self
