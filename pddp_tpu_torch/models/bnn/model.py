"""Bayesian neural network dynamics (port of ``pddp_tpu/models/bnn/model.py``).

``ParticlesBNNDynamicsModel`` maps raw particles through the network
(input normalization, angular augmentation, optional tanh action
constraint, optional predicted-std output noise). ``BNNDynamicsModel``
works on an encoded Gaussian belief: it decodes z into the mean and the
upper covariance factor, pushes ``n_particles`` particles through the
network and moment-matches the outputs back into an encoded state.

Noise: the episode noise ``eps_in``/``eps_out`` (horizon, P, n) is drawn
once; at step i > 0 the input noise is inferred by back-solving the
previous step's particle outputs (the model's rolling state) through the
covariance factor, and falls back to ``eps_in[i]`` when that solve is
not finite. The noise used is the step's aux, replayed as a constant by
``apply`` and ``jacobians``. Every method takes leading batch dims: z is
(..., nz), the state (..., P, n).

Learning: ``resample`` draws new episode noise (the dropout masks and
``eps_out``/``eps_in``), ``fit`` trains the net with ``fit_bnn``, and
``reset_parameters`` redraws the weights; each returns a new model. The
draws come from a ``torch.Generator``, or are passed as explicit arrays
(``pddp_tpu``'s draws, in tests). ``save_bnn_npz`` writes the learned
state in ``pddp_tpu``'s file layout.
"""

from __future__ import annotations

import copy
import json
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import jvp, vmap

from ...encoding import StateEncoding, decode_covar_sqrt, decode_mean
from ...utils import draws
from ...utils.angular import augment_state, infer_augmented_state_size
from ...utils.constraint import constrain
from ...utils.optim import amsgrad, apply_updates
from ...utils.particles import infer_eps, moment_match, standardize
from ..base import DynamicsModel
from .losses import gaussian_log_likelihood
from .network import Linear, bayesian_mlp, trainable_mask

__all__ = ["ParticlesBNNDynamicsModel", "BNNDynamicsModel", "BNNState",
           "bnn_dynamics_model_factory", "fit_bnn", "infer_eps",
           "load_bnn_npz", "moment_match", "save_bnn_npz", "training_loss"]


@dataclass
class BNNState:
    """Rolling carry: the previous step's particle outputs (..., P, n)."""

    prev_output: torch.Tensor


def _episode_noise(generator, raw, like):
    """Standardized (over particles, ddof=1) episode noise of ``like``'s
    shape (horizon, P, n): ``raw`` standard normal draws if given, else
    drawn from ``generator``."""
    if raw is None:
        eps = draws.normal(generator, like.shape, like.dtype, like.device)
    else:
        eps = draws.explicit(raw, like.dtype, like.device, like.shape)
    return standardize(eps, dim=1)


class ParticlesBNNDynamicsModel(DynamicsModel):
    """BNN dynamics over raw particles: ``forward_particles(X, u, i)``
    maps (..., P, state_size) particles through one sampled network per
    particle."""

    #: ``fit`` takes datasets padded past ``n_valid`` rows
    #: (``PDDPController`` pads only for models that say so).
    supports_n_valid = True

    def __init__(self, net, X_mean, X_std, dX_mean, dX_std, eps_out,
                 state_size, action_size, angular_indices=(),
                 non_angular_indices=(), n_particles=100, horizon=100,
                 u_min=None, u_max=None, use_predicted_std=False,
                 sample_input_distribution=True, infer_noise_variables=True,
                 independent_noise=False):
        self.net = net
        self.X_mean, self.X_std = X_mean, X_std
        self.dX_mean, self.dX_std = dX_mean, dX_std
        self.eps_out = eps_out
        self.u_min, self.u_max = u_min, u_max
        self.state_size, self.action_size = state_size, action_size
        self.angular_indices = tuple(angular_indices)
        self.non_angular_indices = tuple(non_angular_indices)
        self.n_particles, self.horizon = n_particles, horizon
        self.constrained = u_min is not None and u_max is not None
        self.use_predicted_std = use_predicted_std
        self.sample_input_distribution = sample_input_distribution
        self.infer_noise_variables = infer_noise_variables
        self.independent_noise = independent_noise

    def replace(self, **fields):
        """A shallow copy with ``fields`` set."""
        new = copy.copy(self)
        for k, v in fields.items():
            if not hasattr(new, k):
                raise AttributeError(k)
            setattr(new, k, v)
        return new

    # -- shared pieces -------------------------------------------------------

    def _constrain(self, u):
        if self.constrained:
            return constrain(u, self.u_min, self.u_max)
        return u

    def _normalize_input(self, x_):
        return (x_ - self.X_mean) / self.X_std

    def _scale_output(self, mean, log_std):
        return (mean * self.dX_std + self.dX_mean,
                log_std + torch.log(self.dX_std))

    def _net_inputs(self, X, u):
        """Angular augment, constrain, concatenate, normalize. ``u`` is
        (..., nu) for all particles or (..., P, nu) per particle."""
        if self.angular_indices:
            X_ = augment_state(X, self.angular_indices,
                               self.non_angular_indices)
        else:
            X_ = X
        u = self._constrain(u)
        if u.dim() < X_.dim():
            u = u.unsqueeze(-2)
        u_b = u.expand(X_.shape[:-1] + u.shape[-1:])
        return self._normalize_input(torch.cat([X_, u_b], dim=-1))

    def _delta_from_out(self, out, i):
        """Raw net output -> state delta (de-normalize, then add the
        predicted-std noise ``eps_out[i]``)."""
        dx, log_std = out.split(self.state_size, dim=-1)
        dx, log_std = self._scale_output(dx, log_std)
        if self.use_predicted_std:
            noise_std = torch.exp(log_std)
            if self.independent_noise:
                noise_std = noise_std.detach()
            dx = dx + noise_std * self.eps_out[i]
        return dx

    def forward_particles(self, X, u, i):
        """Next-state particles."""
        return X + self._delta_from_out(self.net(self._net_inputs(X, u)), i)

    def apply(self, X, u, i, aux=(),
              encoding: StateEncoding = StateEncoding.IGNORE_UNCERTAINTY,
              **kwargs):
        """Particles in, particles out."""
        return self.forward_particles(X, u, i)

    # -- learning ------------------------------------------------------------

    def resample(self, generator=None, noise=None):
        """Fresh episode noise: ``eps_out``, then each layer's dropout
        noise, from ``generator``; or explicit draws, ``noise`` a mapping
        with ``eps_out`` (raw standard normal, standardized here) and
        ``net`` (one array per hidden layer)."""
        noise = noise or {}
        eps_out = _episode_noise(generator, noise.get("eps_out"),
                                 self.eps_out)
        return self.replace(net=self.net.resample(generator, noise.get("net")),
                            eps_out=eps_out)

    def fit(self, X, U, dX, generator=None, n_valid=None, **kwargs):
        """Trains the net (see ``fit_bnn``); returns the updated model.
        Rows past ``n_valid`` are padding."""
        return fit_bnn(self, X, U, dX, generator=generator, n_valid=n_valid,
                       **kwargs)

    def reset_parameters(self, generator=None):
        """Fresh weights (Xavier-normal with the ReLU gain, biases uniform
        in [-0.1, 0.1]) and episode noise, drawn from ``generator``."""
        layers = []
        for layer in self.net.layers:
            W, b = layer.W, layer.b
            fan_in, fan_out = W.shape
            std = math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out))
            layers.append(Linear(
                std * draws.normal(generator, W.shape, W.dtype, W.device),
                draws.uniform(generator, b.shape, b.dtype, b.device, -0.1,
                              0.1)))
        net = self.net._like(layers, self.net.dropouts)
        return self.replace(net=net).resample(generator)


class BNNDynamicsModel(ParticlesBNNDynamicsModel):
    """BNN dynamics on an encoded Gaussian belief.

    ``chol_jitter`` is the Cholesky jitter ladder of the moment match
    (None: ``utils.linalg.JITTER_LEVELS``).

    Sharded ensemble (``parallel.particle_sharded_solve``): with
    ``particle_group`` set, this model holds one rank's block of the
    particles (``n_particles`` of ``n_particles_global``, its slices of
    ``eps_in``, ``eps_out`` and the dropout noise), the moment match sums
    the mean and the covariance (or the variance) over the group's ranks,
    and the noise falls back to ``eps_in[i]`` on every rank when the
    inference fails on any. Unsharded: None and 0."""

    def __init__(self, *args, eps_in=None, chol_jitter=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.eps_in = eps_in
        self.chol_jitter = None if chol_jitter is None else tuple(chol_jitter)
        self.particle_group = None
        self.n_particles_global = 0

    def _effective_eps(self, z, i, state: BNNState, encoding):
        """(eps, mean, U_chol) of step i (see ``infer_eps``)."""
        mean = decode_mean(z, encoding, self.state_size)
        U_chol = decode_covar_sqrt(z, encoding, self.state_size)
        eps0 = self.eps_in[i].to(z.dtype)
        if not self.infer_noise_variables:
            return eps0.expand(z.shape[:-1] + eps0.shape), mean, U_chol
        deltas = state.prev_output - mean[..., None, :]
        return (infer_eps(U_chol, deltas, eps0, i == 0, self.particle_group),
                mean, U_chol)

    def _moment_match(self, output, encoding):
        return moment_match(output, encoding, self.chol_jitter,
                            self.particle_group, self.n_particles_global)

    def resample(self, generator=None, noise=None):
        """As ``ParticlesBNNDynamicsModel.resample``, then ``eps_in``
        (``noise["eps_in"]`` where given)."""
        noise = noise or {}
        m = super().resample(generator, noise)
        return m.replace(eps_in=_episode_noise(generator,
                                               noise.get("eps_in"),
                                               self.eps_in))

    def _particles(self, z, aux, encoding):
        mean = decode_mean(z, encoding, self.state_size)
        if self.sample_input_distribution:
            U_chol = decode_covar_sqrt(z, encoding, self.state_size)
            return mean[..., None, :] + torch.matmul(aux, U_chol)
        return mean[..., None, :].expand(
            mean.shape[:-1] + (self.n_particles, self.state_size))

    def init_state(self, batch_shape=()):
        return BNNState(prev_output=self.eps_in.new_zeros(
            tuple(batch_shape) + (self.n_particles, self.state_size)))

    def aux_zero(self):
        return self.eps_in.new_zeros((self.n_particles, self.state_size))

    def step(self, z, u, i, state: BNNState,
             encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        if self.sample_input_distribution:
            eps, mean, U_chol = self._effective_eps(z, i, state, encoding)
            X = mean[..., None, :] + torch.matmul(eps, U_chol)
        else:
            eps = z.new_zeros(z.shape[:-1] + (self.n_particles,
                                              self.state_size))
            X = self._particles(z, eps, encoding)
        output = self.forward_particles(X, u, i)
        z_next = self._moment_match(output, encoding)
        return z_next, BNNState(prev_output=output.detach()), eps

    def apply(self, z, u, i, aux, encoding=StateEncoding.DEFAULT, **kwargs):
        """Smooth dynamics with the step's noise ``aux`` held constant."""
        output = self.forward_particles(self._particles(z, aux, encoding),
                                        u, i)
        return self._moment_match(output, encoding)

    def jacobians(self, z, u, i, aux, encoding=StateEncoding.DEFAULT,
                  **kwargs):
        """Structured (z_next, F_z, F_u) of one unbatched step.

        The chain (z, u) -g-> (net input (P, F), particles X) -net-> out
        -h-> z_next is differentiated in three forward-mode sweeps: g and
        h with the nz + nu basis tangents, the MLP only with the F basis
        tangents of one particle's input (the net acts row by row), and
        the factors composed over F.
        """
        nz = z.shape[-1]
        dtype = z.dtype
        zu = torch.cat([z, u], dim=-1)

        def g(zu_):
            X = self._particles(zu_[:nz], aux, encoding)
            return self._net_inputs(X, zu_[nz:]), X

        x_net, X = g(zu)
        basis_zu = torch.eye(zu.shape[-1], dtype=dtype, device=zu.device)
        T_x, T_X = vmap(lambda t: jvp(g, (zu,), (t,))[1])(basis_zu)

        out = self.net(x_net)
        F = x_net.shape[-1]
        basis_x = torch.eye(F, dtype=dtype, device=zu.device)
        J_net = vmap(lambda e: jvp(self.net, (x_net,),
                                   (e.expand(x_net.shape),))[1])(basis_x)
        if F <= 8:
            T_out = sum(T_x[:, :, f, None] * J_net[None, f, :, :]
                        for f in range(F))
        else:
            T_out = torch.einsum("tpf,fpo->tpo", T_x, J_net)

        def h(out_, X_):
            return self._moment_match(X_ + self._delta_from_out(out_, i),
                                      encoding)

        z_next = h(out, X)
        J = vmap(lambda to, tX: jvp(h, (out, X), (to, tX))[1])(T_out, T_X)
        # Forward mode can promote a tangent to float64 (see
        # utils/evaluation.eval_dynamics); the Jacobian keeps z's dtype.
        J = J.T.to(dtype)
        return z_next, J[:, :nz], J[:, nz:]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def training_loss(model, likelihood=gaussian_log_likelihood, reg_scale=1.0,
                  n_data=1):
    """``fit_bnn``'s loss of a minibatch as ``(loss_fn, params)``.

    ``params`` are the net's trainable leaves (``trainable_mask``, in
    ``leaves`` order), detached; ``loss_fn(params, batch)`` is the
    negative Gaussian log likelihood of the de-normalized outputs, averaged
    over the batch's rows, plus ``reg_scale`` times the dropout regularizer
    over ``n_data``. ``batch`` has ``x`` (the normalized net inputs, a row
    each), ``dX`` (the targets) and ``noise`` (the training noise of each
    hidden layer, a row each, None where a layer has no dropout).
    """
    leaves = [t.detach() for t in model.net.leaves()]
    train = [i for i, m in enumerate(trainable_mask(model.net)) if m]
    dX_mean, dX_std = model.dX_mean, model.dX_std
    log_dX_std = torch.log(dX_std)

    def loss_fn(params, batch):
        full = list(leaves)
        for i, p in zip(train, params):
            full[i] = p
        net = model.net.with_leaves(full)
        out = net(batch["x"], noise=batch["noise"])
        mean, log_std = out.split(out.shape[-1] // 2, dim=-1)
        nll = -likelihood(batch["dX"], mean * dX_std + dX_mean,
                          torch.exp(log_std + log_dX_std)).mean()
        return nll + reg_scale * (net.regularization() / n_data)

    return loss_fn, [leaves[i] for i in train]


def _with_trainable(net, params):
    """``net`` with its trainable leaves replaced by ``params``."""
    leaves = [t.detach() for t in net.leaves()]
    train = [i for i, m in enumerate(trainable_mask(net)) if m]
    for i, p in zip(train, params):
        leaves[i] = p.detach()
    return net.with_leaves(leaves)


def fit_bnn(model, X, U, dX, generator=None, n_iter=500, batch_size=128,
            reg_scale=1.0, learning_rate=1e-4,
            likelihood=gaussian_log_likelihood, normalize=True, quiet=True,
            return_losses=False, n_valid=None, batch_idx=None, noise=None,
            **kwargs):
    """Trains the net on transitions (X, U) -> dX; returns the updated
    model, and the loss of every step with ``return_losses``.

    The loss of a minibatch is ``training_loss``'s: the negative Gaussian
    log likelihood of the de-normalized outputs plus ``reg_scale`` times
    the dropout regularizer over the number of rows. The optimizer is
    ``utils.optim.amsgrad`` (``optax.amsgrad``'s), on the leaves of
    ``trainable_mask``. The normalizers are the mean and the ddof=0 std
    (floored at 1e-8 to 1) of the first ``n_valid`` rows, the augmented
    and constrained inputs' and dX's; rows past ``n_valid`` (padding) are
    never drawn.

    Draws: ``batch_idx`` (n_iter, batch_size) in [0, n_valid), then each
    step's noise per hidden layer, from ``generator``; or explicit,
    ``batch_idx`` and ``noise`` (one array (n_iter, batch_size, width) per
    hidden layer, None where a layer has no dropout). Without both, a
    ``generator`` is required, as ``pddp_tpu``'s takes a key. ``quiet`` is accepted for ``pddp_tpu``'s
    signature.
    """
    del quiet, kwargs
    if model.angular_indices:
        X = augment_state(X, model.angular_indices,
                          model.non_angular_indices)
    X_ = torch.cat([X, model._constrain(U)], dim=-1)
    N = X_.shape[0] if n_valid is None else int(n_valid)
    dtype, device = X_.dtype, X_.device
    if normalize:
        X_std = X_[:N].std(dim=0, correction=0)
        dX_std = dX[:N].std(dim=0, correction=0)
        model = model.replace(
            X_mean=X_[:N].mean(dim=0),
            X_std=torch.where(X_std < 1e-8, 1.0, X_std),
            dX_mean=dX[:N].mean(dim=0),
            dX_std=torch.where(dX_std < 1e-8, 1.0, dX_std))
    if generator is None and (batch_idx is None or noise is None):
        raise ValueError("fit_bnn draws its batches and dropout noise "
                         "from a generator: pass one, or both batch_idx "
                         "and noise")
    if batch_idx is None:
        batch_idx = draws.randint(generator, 0, N, (n_iter, batch_size),
                                  device)
    else:
        batch_idx = torch.as_tensor(batch_idx, dtype=torch.long,
                                    device=device)
    if noise is not None:
        noise = [None if n is None else draws.explicit(n, dtype, device)
                 for n in noise]
    x_norm = model._normalize_input(X_)
    loss_fn, params = training_loss(
        model, likelihood, reg_scale,
        torch.as_tensor(N, dtype=dtype, device=device))
    opt = amsgrad(learning_rate)
    state = opt.init(params)
    losses = []
    for t in range(n_iter):
        for p in params:
            p.requires_grad_(True)
        idx = batch_idx[t]
        step_noise = (model.net.draw_noise(generator, (idx.shape[0],))
                      if noise is None else
                      [None if n is None else n[t] for n in noise])
        with torch.enable_grad():
            loss = loss_fn(params, {"x": x_norm[idx], "dX": dX[idx],
                                    "noise": step_noise})
            grads = torch.autograd.grad(loss, params)
        losses.append(loss.detach())
        updates, state = opt.update(list(grads), state, params)
        params = apply_updates(params, updates)
    model = model.replace(net=_with_trainable(model.net, params))
    if return_losses:
        return model, (torch.stack(losses) if losses else
                       x_norm.new_zeros((0,)))
    return model


def save_bnn_npz(model, path, meta=None):
    """Writes a BNN model's learned state to one ``.npz`` in
    ``pddp_tpu``'s layout: the net's leaves as ``net_<i>`` in flatten
    order, ``X_mean``, ``X_std``, ``dX_mean``, ``dX_std``, and ``meta`` (a
    JSON-able dict) as the bytes of ``meta_json``. Both packages'
    ``load_bnn_npz`` read it into a model of the same configuration."""
    def a(t):
        return t.detach().cpu().numpy()

    arrs = {"net_{}".format(i): a(t)
            for i, t in enumerate(model.net.leaves())}
    for k in ("X_mean", "X_std", "dX_mean", "dX_std"):
        arrs[k] = a(getattr(model, k))
    if meta is not None:
        arrs["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                          dtype=np.uint8)
    np.savez(path, **arrs)


def _standardized_normal(rng, shape, dtype, device):
    eps = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float64)
    return standardize(eps, dim=1).to(dtype=dtype, device=device)


def bnn_dynamics_model_factory(state_size, action_size, hidden_features,
                               angular_indices=None, non_angular_indices=None,
                               constrain_min=None, constrain_max=None,
                               particles=False, **network_kwargs):
    """A configured BNN dynamics model class, whose ``init(...)`` builds
    an instance with freshly drawn weights, masks and episode noise."""
    angular = angular_indices is not None and non_angular_indices is not None
    ai = tuple(int(i) for i in (angular_indices or ()))
    nai = tuple(int(i) for i in (non_angular_indices or ()))
    aug = infer_augmented_state_size(ai, nai) if angular else state_size
    should_constrain = constrain_min is not None and constrain_max is not None

    class _Factory:
        @staticmethod
        def init(seed=0, n_particles=100, horizon=100,
                 use_predicted_std=False, sample_input_distribution=True,
                 infer_noise_variables=True, independent_noise=False,
                 dtype=torch.float32, device=None, chol_jitter=None):
            """Draws come from numpy's generator at ``seed``."""
            from ...device import resolve_device
            device = resolve_device(device)
            rng = np.random.default_rng(seed)
            net = bayesian_mlp(aug + action_size, 2 * state_size,
                               hidden_features, n_particles=n_particles,
                               seed=int(rng.integers(2**31)), dtype=dtype,
                               device=device, **network_kwargs)

            def t(v):
                return torch.as_tensor(v, dtype=dtype, device=device)

            shape = (horizon, n_particles, state_size)
            eps_out = _standardized_normal(rng, shape, dtype, device)
            common = dict(
                net=net, X_mean=t(np.zeros(aug + action_size)),
                X_std=t(np.ones(aug + action_size)),
                dX_mean=t(np.zeros(state_size)),
                dX_std=t(np.ones(state_size)), eps_out=eps_out,
                state_size=state_size, action_size=action_size,
                angular_indices=ai, non_angular_indices=nai,
                n_particles=n_particles, horizon=horizon,
                u_min=t(constrain_min) if should_constrain else None,
                u_max=t(constrain_max) if should_constrain else None,
                use_predicted_std=use_predicted_std,
                sample_input_distribution=sample_input_distribution,
                infer_noise_variables=infer_noise_variables,
                independent_noise=independent_noise)
            if particles:
                return ParticlesBNNDynamicsModel(**common)
            eps_in = _standardized_normal(rng, shape, dtype, device)
            return BNNDynamicsModel(eps_in=eps_in, chol_jitter=chol_jitter,
                                    **common)

    _Factory.state_size = state_size
    _Factory.action_size = action_size
    _Factory.angular_indices = ai
    _Factory.non_angular_indices = nai
    _Factory.__name__ = ("ParticlesBNNDynamicsModel" if particles
                         else "BNNDynamicsModel")
    return _Factory


def load_bnn_npz(model, path):
    """``model`` with its net's tensors and normalizers replaced by those
    of an ``.npz`` written by ``pddp_tpu.models.bnn.save_bnn_npz``
    (``net_<i>`` in flatten order, ``X_mean``, ``X_std``, ``dX_mean``,
    ``dX_std``). Shapes must match the model's configuration; values take
    the model's dtype and device."""
    data = np.load(path)
    old = model.net.leaves()
    new = []
    for i, leaf in enumerate(old):
        a = data["net_{}".format(i)]
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError("leaf {}: file has shape {}, model {}".format(
                i, a.shape, tuple(leaf.shape)))
        new.append(torch.as_tensor(a, dtype=leaf.dtype, device=leaf.device))
    ref = model.X_mean

    def t(k):
        return torch.as_tensor(data[k], dtype=ref.dtype, device=ref.device)

    return model.replace(net=model.net.with_leaves(new), X_mean=t("X_mean"),
                         X_std=t("X_std"), dX_mean=t("dX_mean"),
                         dX_std=t("dX_std"))

