"""PDDP controller (port of ``pddp_tpu/controllers/pddp.py``): episodic
learning and trajectory optimization.

The loop collects rollouts from the environment, trains the BNN dynamics
model on them, optimizes the trajectory by iLQR on the learned belief
model, runs MPC on the environment to gather fresh data, and repeats.
Models are immutable: training, resampling and resetting return a new
model, which replaces ``self.model``.

Draws: one ``torch.Generator`` (seeded ``seed``, on the env's device)
supplies, in order, the exploration actions of each extra initial
rollout, then every model fit's draws and every episode's resample, as
``pddp_tpu``'s key chain does. ``draws`` replaces them with explicit
arrays: an iterable of ``(site, arrays)`` in that order, ``site`` one of
``"explore"`` (uniform [0, 1) actions of U's shape), ``"fit"`` (the
keywords ``batch_idx`` and ``noise`` of ``fit_bnn``) and ``"resample"``
(the ``noise`` mapping of the model's ``resample``).

As in ``pddp_tpu``, the loop's iLQR runs the scan backward and the scan
line search (``riccati_mode`` and ``fused_rollout`` are not taken), and
the keywords of ``fit`` past its own reach every solve and every MPC
tick, whose ``step`` ignores those it does not know.
"""

from __future__ import annotations

import inspect

import torch

from ..device import resolve_device
from ..encoding import StateEncoding, decode_mean
from ..envs.base import SimEnv
from ..gaussian_variable import GaussianVariable
from ..utils import draws as _draws
from .ilqr import iLQRController, iLQRState, trajectory_cost

__all__ = ["PDDPController"]


class PDDPController(iLQRController):
    """Probabilistic DDP controller."""

    def __init__(self, env, model, cost, model_opts=None, cost_opts=None,
                 training_opts=None, seed=0, draws=None, **kwargs):
        """Args beyond (env, model, cost, model_opts, cost_opts):

        training_opts: keywords of every model fit (``fit_bnn``'s
            ``n_iter``, ``learning_rate``, ``batch_size``, ...).
        seed: of the generator of every draw.
        draws: explicit draws in place of the generator's (see the
            module's docstring).
        """
        super().__init__(env, model, cost, model_opts=model_opts,
                         cost_opts=cost_opts)
        self._training_opts = training_opts or {}
        self.device = getattr(env, "device", None) or resolve_device(None)
        self._generator = torch.Generator(
            device=self.device).manual_seed(seed)
        self._draws = None if draws is None else iter(draws)

    def _next_draw(self, site):
        """The explicit arrays of the next draw, None without ``draws``."""
        if self._draws is None:
            return None
        got, arrays = next(self._draws)
        if got != site:
            raise ValueError("the next explicit draw is for {!r}, not "
                             "{!r}".format(got, site))
        return arrays

    def fit(self, U, encoding: StateEncoding = StateEncoding.DEFAULT,
            quiet=False, on_trial=None, max_trials=None,
            n_initial_sample_trajectories=2, sampling_noise=1.0,
            train_on_start=True, max_dataset_size=1000, resample_model=True,
            u_min=None, u_max=None, **kwargs):
        """Learns the model and the path that minimizes the cost.

        Args:
            U: initial actions (N, nu).
            on_trial: optional callback (trial, X, U) of every collected
                rollout; trials count the initial ones.
            max_trials: stop once this many rollouts were collected (the
                loop runs at least one MPC trial); None: never, unless
                the controller is in eval mode.
            n_initial_sample_trajectories: rollouts before the first fit,
                the first with U, the others uniform in [u_min, u_max]
                (in [0, sampling_noise) without bounds).
            train_on_start: whether to collect and fit those.
            max_dataset_size: the FIFO cap of the dataset.
            resample_model: fresh episode noise before every solve.
            kwargs: keywords of every ``iLQRController.fit`` and MPC tick.

        Returns:
            Tuple (Z, U, state) of the last solve.
        """
        U = torch.as_tensor(U, device=self.device)
        N = U.shape[0]
        if u_min is not None and u_max is not None:
            u_min, u_max = (torch.as_tensor(b, dtype=U.dtype,
                                            device=self.device)
                            for b in (u_min, u_max))
        total_trials = 0
        state = iLQRState.UNDEFINED
        Z = None

        dataset = None
        if train_on_start:
            for i in range(n_initial_sample_trajectories):
                self.env.reset()
                if i == 0:
                    Ui = U
                else:
                    d = self._next_draw("explore")
                    noise = (_draws.uniform(self._generator, U.shape,
                                            U.dtype, self.device)
                             if d is None else
                             _draws.explicit(d, U.dtype, self.device,
                                             U.shape))
                    Ui = sampling_noise * noise
                    if u_min is not None and u_max is not None:
                        Ui = (u_max - u_min) * Ui + u_min
                new_data, _ = self._apply_controller(
                    Ui, N, encoding, mpc=False, u_min=u_min, u_max=u_max)
                dataset = _concat_datasets(dataset, new_data,
                                           max_dataset_size)
                if callable(on_trial):
                    on_trial(total_trials, new_data[0], new_data[1])
                total_trials += 1
            self.model = self._fit_model(dataset, max_dataset_size, quiet)

        while True:
            self.env.reset()
            if resample_model and hasattr(self.model, "resample"):
                d = self._next_draw("resample")
                self.model = self.model.resample(
                    self._generator if d is None else None, noise=d)

            Z, U, state = super().fit(U, encoding=encoding, quiet=quiet,
                                      u_min=u_min, u_max=u_max, **kwargs)
            if not self.training:
                break

            new_data, _ = self._apply_controller(
                self, 2 * N, encoding, mpc=True, u_min=u_min, u_max=u_max,
                **kwargs)
            if callable(on_trial):
                on_trial(total_trials, new_data[0], new_data[1])
            dataset = _concat_datasets(dataset, new_data, max_dataset_size)
            self.model = self._fit_model(dataset, max_dataset_size, quiet)

            total_trials += 1
            if max_trials is not None and total_trials >= max_trials:
                break

        return Z, U, state

    def _fit_model(self, dataset, max_dataset_size, quiet):
        """Trains the model on the dataset. Models that take ``n_valid``
        (the class attribute ``supports_n_valid``, else an explicit
        parameter of ``fit``) get it padded with zeros to
        ``max_dataset_size`` rows, as ``pddp_tpu`` pads to keep one
        compiled trainer; the others the rows as they are."""
        X, U, dX = dataset
        kwargs = dict(quiet=quiet, **self._training_opts)
        d = self._next_draw("fit")
        if d is None:
            kwargs["generator"] = self._generator
        else:
            kwargs.update(d)
        accepts_n_valid = getattr(self.model, "supports_n_valid", None)
        if accepts_n_valid is None:
            try:
                params = inspect.signature(self.model.fit).parameters
                accepts_n_valid = "n_valid" in params
            except (TypeError, ValueError):
                accepts_n_valid = False
        n = X.shape[0]
        if (not accepts_n_valid or max_dataset_size is None
                or n >= max_dataset_size):
            return self.model.fit(X, U, dX, **kwargs)
        pad = max_dataset_size - n
        padded = tuple(torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
                       for a in (X, U, dX))
        return self.model.fit(*padded, n_valid=n, **kwargs)

    def _apply_controller(self, controller, H, encoding, mpc=False,
                          u_min=None, u_max=None, **kwargs):
        """An env-in-the-loop rollout of H steps collecting training data.

        ``controller`` is an action tensor (open loop; on a ``SimEnv``
        through its pure ``step_fn``) or a controller called once a step
        (``mpc=True``: a warm-started solve a tick).

        Returns:
            ((X, U, dX), J): the states the actions met, the actions, the
            state deltas, and the trajectory's cost.
        """
        env = self.env
        is_open_loop = isinstance(controller, torch.Tensor)
        if is_open_loop and isinstance(env, SimEnv):
            U_out = controller[:H]
            x = env._x
            Zs = []
            for u in U_out:
                Zs.append(_encode_obs(x, encoding))
                x = env.step_fn(x, u)
            Zs.append(_encode_obs(x, encoding))
            env._x = x
            Z = torch.stack(Zs)
        else:
            Zs, Us = [], []
            for i in range(H):
                z = env.get_state().encode(encoding)
                Zs.append(z)
                if is_open_loop:
                    u = controller[i]
                else:
                    u = controller(z, i, encoding, mpc=mpc, u_min=u_min,
                                   u_max=u_max, **kwargs)
                Us.append(u)
                env.apply(u)
            Zs.append(env.get_state().encode(encoding))
            Z = torch.stack(Zs)
            U_out = torch.stack(Us)

        J = trajectory_cost(self.cost, Z, U_out, encoding, self._cost_opts)
        X = decode_mean(Z, encoding=encoding)
        return (X[:-1], U_out, X[1:] - X[:-1]), J


def _encode_obs(x, encoding, var=1e-2):
    """An observation as an encoded state with the fixed observation-noise
    prior ``var`` (as ``SimEnv.get_state``)."""
    return GaussianVariable(x, _var=var * torch.ones_like(x)).encode(encoding)


def _concat_datasets(first, second, max_dataset_size=None):
    """(X, U, dX) datasets concatenated, the newest ``max_dataset_size``
    rows kept."""
    if first is None:
        return second
    if second is None:
        return first
    out = tuple(torch.cat([a, b]) for a, b in zip(first, second))
    if max_dataset_size is not None:
        out = tuple(a[-max_dataset_size:] for a in out)
    return out
