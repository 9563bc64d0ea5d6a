"""Bayesian MLP with resampleable dropout masks (port of
``pddp_tpu/models/bnn/network.py``).

Each particle carries its own dropout mask per hidden layer, so one
particle traverses one sampled network for a whole episode. The masks
are functions of stored noise (``eval_mask``), drawn anew by
``resample``. In training mode the forward takes fresh noise of each
hidden layer's input shape (``BayesianMLP.__call__(x, noise)``, the
draws from ``draw_noise``). ``compute_dtype`` and ``matmul_dtype`` are
not ported yet.

Leaves are listed in the JAX package's flatten order (``leaves``), which
is the order of the ``net_<i>`` entries of the ``.npz`` files that
``load_bnn_npz`` reads and ``save_bnn_npz`` writes; ``trainable_mask``
marks those the optimizer updates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...utils import draws

__all__ = ["Linear", "BDropout", "CDropout", "TLNDropout", "BayesianMLP",
           "TRAINABLE_FIELDS", "bayesian_mlp", "trainable_mask"]

#: Leaf fields the optimizer may update: the Linear weights, CDropout's
#: logit_p and TLNDropout's two posterior logits. The others (rates,
#: regularizer scales, temperatures, intervals, the stored noise) stay
#: fixed in training; a trained TLN interval would degenerate to b <= a.
TRAINABLE_FIELDS = frozenset(
    {"W", "b", "logit_p", "logit_posterior_mean", "logit_posterior_std"})


class _Leaves:
    """Tensor fields listed in ``FIELDS`` order (the JAX flatten order)."""

    FIELDS: tuple = ()

    def __init__(self, *values):
        for name, v in zip(self.FIELDS, values):
            setattr(self, name, v)

    def leaves(self):
        return [getattr(self, n) for n in self.FIELDS]

    def with_leaves(self, values):
        return type(self)(*values)

    def trainable_mask(self):
        return [n in TRAINABLE_FIELDS for n in self.FIELDS]

    def _with_noise(self, noise):
        return self.with_leaves(self.leaves()[:-1] + [noise])


class _Dropout(_Leaves):
    """A dropout layer: ``noise`` (its last field) is the stored episode
    noise, one row per particle; ``_mask`` turns noise into the mask."""

    def draw_noise(self, generator, shape):
        """Fresh noise of ``shape`` from ``generator`` (uniform in
        [1e-5, 1 - 1e-5))."""
        return draws.uniform(generator, shape, self.noise.dtype,
                             self.noise.device, 1e-5, 1.0 - 1e-5)

    def eval_mask(self):
        """The episode mask of the stored noise."""
        return self._mask(self.noise)

    def resample(self, generator=None, noise=None):
        """A copy with fresh stored noise: ``noise`` if given, else a
        draw from ``generator``."""
        if noise is None:
            noise = self.draw_noise(generator, self.noise.shape)
        return self._with_noise(draws.explicit(
            noise, self.noise.dtype, self.noise.device, self.noise.shape))

    def apply(self, x, noise=None):
        """``x`` times the mask of fresh ``noise`` of x's shape
        (training), or times the stored episode mask."""
        if noise is not None:
            return x * self._mask(draws.explicit(noise, x.dtype, x.device,
                                                 x.shape))
        return x * self.eval_mask()


class Linear(_Leaves):
    FIELDS = ("W", "b")

    def __call__(self, x):
        W, b = self.W, self.b
        if W.dtype != x.dtype:
            W, b = W.to(x.dtype), b.to(x.dtype)
        return torch.matmul(x, W) + b


class BDropout(_Dropout):
    """Binary dropout: the stored Bernoulli noise (keep probability
    p = 1 - rate) is the mask."""

    FIELDS = ("rate", "reg", "noise")

    @property
    def p(self):
        return 1.0 - self.rate

    def draw_noise(self, generator, shape):
        return draws.bernoulli(generator, self.p, shape, self.noise.dtype,
                               self.noise.device)

    def _mask(self, noise):
        return noise

    def regularization(self, W, b):
        return self.reg * (self.p * torch.sum(torch.square(W))
                           + torch.sum(torch.square(b)))


class CDropout(_Dropout):
    """Concrete dropout: mask = sigmoid((logit_p + log u - log(1 - u)) /
    temperature) of uniform noise u, ``logit_p`` trainable."""

    FIELDS = ("logit_p", "temperature", "reg", "noise")

    @property
    def p(self):
        return torch.sigmoid(self.logit_p)

    def _mask(self, u):
        concrete = self.logit_p + torch.log(u) - torch.log1p(-u)
        return torch.sigmoid(concrete / self.temperature)

    def regularization(self, W, b):
        p = self.p
        reg = self.reg * (p * torch.sum(torch.square(W))
                          + torch.sum(torch.square(b)))
        # Minus the Bernoulli entropy.
        return reg - (-(1.0 - p) * torch.log1p(-p) - p * torch.log(p))


class TLNDropout(_Dropout):
    """Truncated log-normal multiplicative noise exp(xi), xi drawn from
    the truncated normal through its inverse CDF of uniform noise; the
    posterior mean and std logits are trainable."""

    FIELDS = ("logit_posterior_mean", "logit_posterior_std", "interval",
              "s_interval", "reg", "noise")

    def _posterior(self):
        a, b = self.interval[0], self.interval[1]
        s_min, s_max = self.s_interval[0], self.s_interval[1]
        mu = (b - a) * torch.sigmoid(self.logit_posterior_mean) + a
        sigma = (s_max - s_min) * torch.sigmoid(
            self.logit_posterior_std) + s_min
        return a, b, mu, sigma

    def _mask(self, u):
        a, b, mu, sigma = self._posterior()
        phi_alpha = torch.special.ndtr((a - mu) / sigma)
        Z = torch.special.ndtr((b - mu) / sigma) - phi_alpha
        p = torch.clamp(phi_alpha + Z * u, 1e-7, 1.0 - 1e-7)
        return torch.exp(mu + sigma * torch.special.ndtri(p))

    def regularization(self, W, b_unused):
        """A KL-style penalty, independent of the weights. As in
        ``pddp_tpu``, the normal CDF stands where the density would."""
        phi = torch.special.ndtr
        a, b, mu, sigma = self._posterior()
        alpha = (a - mu) / sigma
        beta = (b - mu) / sigma
        Z = phi(beta) - phi(alpha)
        reg = (torch.log(b - a) - torch.log(sigma * math.sqrt(2.0 * math.pi))
               - torch.log(Z)
               - ((alpha * phi(alpha) - beta * phi(beta)) / sigma)
               / (2.0 * Z))
        return self.reg * torch.sum(reg)


class BayesianMLP:
    """[Linear -> dropout mask -> activation]* -> Linear."""

    def __init__(self, layers, dropouts, activation="relu"):
        self.layers = tuple(layers)
        self.dropouts = tuple(dropouts)
        self.activation = activation

    def _act(self, x):
        return getattr(torch, self.activation)(x)

    def eval_masks(self):
        """The (P, width) mask of each hidden layer, None where the layer
        has no dropout."""
        return [None if d is None else d.eval_mask() for d in self.dropouts]

    def __call__(self, x, noise=None):
        """The forward pass: with ``noise`` (one array per hidden layer,
        of that layer's input shape, None where it has no dropout) the
        training forward on fresh noise; without, the episode masks."""
        for i, (layer, drop) in enumerate(zip(self.layers[:-1],
                                              self.dropouts)):
            x = layer(x)
            if drop is not None:
                x = drop.apply(x, None if noise is None else noise[i])
            x = self._act(x)
        return self.layers[-1](x)

    def draw_noise(self, generator, batch_shape):
        """Fresh training noise for an input of ``batch_shape`` (its
        shape without the feature dim), one draw per hidden layer."""
        return [None if d is None else d.draw_noise(
            generator, tuple(batch_shape) + (layer.W.shape[1],))
            for layer, d in zip(self.layers, self.dropouts)]

    def resample(self, generator=None, noise=None):
        """Fresh episode masks: ``noise`` (one array per hidden layer)
        if given, else draws from ``generator`` in layer order."""
        drops = [None if d is None else d.resample(
            generator, None if noise is None else noise[i])
            for i, d in enumerate(self.dropouts)]
        return BayesianMLP(self.layers, drops, self.activation)

    def regularization(self):
        """The sum of each (dropout, following Linear) pair's penalty."""
        reg = 0.0
        for drop, layer in zip(self.dropouts, self.layers[1:]):
            if drop is not None:
                reg = reg + drop.regularization(layer.W, layer.b)
        return reg

    def leaves(self):
        """Every tensor of the net in the JAX package's flatten order."""
        out = [t for layer in self.layers for t in layer.leaves()]
        for d in self.dropouts:
            if d is not None:
                out += d.leaves()
        return out

    def with_leaves(self, values):
        """A copy with the tensors of ``leaves`` replaced, in order."""
        values = list(values)
        pos = 0

        def take(obj):
            nonlocal pos
            k = len(obj.FIELDS)
            new = obj.with_leaves(values[pos:pos + k])
            pos += k
            return new

        layers = [take(layer) for layer in self.layers]
        drops = [None if d is None else take(d) for d in self.dropouts]
        if pos != len(values):
            raise ValueError("expected {} leaves, got {}".format(
                pos, len(values)))
        return BayesianMLP(layers, drops, self.activation)


def trainable_mask(net):
    """One bool per leaf of ``net.leaves()``: True where the optimizer
    updates it (see ``TRAINABLE_FIELDS``)."""
    out = [m for layer in net.layers for m in layer.trainable_mask()]
    for d in net.dropouts:
        if d is not None:
            out += d.trainable_mask()
    return out


def _xavier_normal_relu(rng, shape):
    fan_in, fan_out = shape
    return (math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out))
            * rng.standard_normal(shape))


def bayesian_mlp(in_features, out_features, hidden_features, n_particles=100,
                 dropout_rate=0.5, dropout_class=CDropout, temperature=0.1,
                 reg=1.0, seed=0, dtype=torch.float32, device=None,
                 compute_dtype=None, matmul_dtype=None):
    """A freshly initialized Bayesian MLP: Xavier-normal weights with the
    ReLU gain, biases uniform in [-0.1, 0.1], masks of shape
    (n_particles, width), on ``device`` (default ``cuda``, see
    ``device.resolve_device``). Draws come from numpy's generator at
    ``seed`` (JAX's bits cannot be reproduced; ``convert.bnn`` carries a
    JAX net's values across)."""
    if compute_dtype is not None or matmul_dtype is not None:
        raise NotImplementedError(
            "compute_dtype and matmul_dtype are not ported yet")
    from ...device import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    dims = [in_features] + list(hidden_features) + [out_features]
    layers = [Linear(t(_xavier_normal_relu(rng, (din, dout))),
                     t(rng.uniform(-0.1, 0.1, dout)))
              for din, dout in zip(dims[:-1], dims[1:])]
    drops = []
    for width in hidden_features:
        shape = (n_particles, width)
        if dropout_class is None:
            drops.append(None)
        elif dropout_class is CDropout:
            drops.append(CDropout(
                t(-math.log(1.0 / dropout_rate - 1.0)), t(temperature),
                t(reg), t(rng.uniform(1e-5, 1.0 - 1e-5, shape))))
        elif dropout_class is BDropout:
            drops.append(BDropout(
                t(dropout_rate), t(reg),
                t(rng.random(shape) < 1.0 - dropout_rate)))
        elif dropout_class is TLNDropout:
            a, b = -4.0, 0.0
            mu0 = max(a + 1e-2 * (b - a), 0.0) + min(b - 1e-2 * (b - a), 0.0)
            drops.append(TLNDropout(
                t(np.full(width, -math.log((b - a) / (mu0 - a) - 1.0))),
                t(rng.uniform(-3.0, -1.0, width)), t([a, b]),
                t([1e-2, math.sqrt((b - a)**2 / 12.0)]), t(reg),
                t(rng.uniform(1e-5, 1.0 - 1e-5, shape))))
        else:
            raise NotImplementedError(
                "Unsupported dropout class: {}".format(dropout_class))
    return BayesianMLP(layers, drops)
