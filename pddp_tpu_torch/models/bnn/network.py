"""Bayesian MLP with fixed episode dropout masks (port of
``pddp_tpu/models/bnn/network.py``, eval mode).

Each particle carries its own dropout mask per hidden layer, so one
particle traverses one sampled network for a whole episode. The masks
are functions of stored noise (``eval_mask``). Training mode (fresh
noise per minibatch), ``compute_dtype`` and ``matmul_dtype`` are not
ported yet.

Leaves are listed in the JAX package's flatten order (``leaves``), which
is the order of the ``net_<i>`` entries of the ``.npz`` files that
``load_bnn_npz`` reads.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Linear", "BDropout", "CDropout", "TLNDropout", "BayesianMLP",
           "bayesian_mlp"]


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


class Linear(_Leaves):
    FIELDS = ("W", "b")

    def __call__(self, x):
        W, b = self.W, self.b
        if W.dtype != x.dtype:
            W, b = W.to(x.dtype), b.to(x.dtype)
        return torch.matmul(x, W) + b


class BDropout(_Leaves):
    """Binary dropout: the stored Bernoulli noise is the mask."""

    FIELDS = ("rate", "reg", "noise")

    def eval_mask(self):
        return self.noise


class CDropout(_Leaves):
    """Concrete dropout: mask = sigmoid((logit_p + log u - log(1 - u)) /
    temperature) of the stored uniform noise u."""

    FIELDS = ("logit_p", "temperature", "reg", "noise")

    def eval_mask(self):
        u = self.noise
        concrete = self.logit_p + torch.log(u) - torch.log1p(-u)
        return torch.sigmoid(concrete / self.temperature)


class TLNDropout(_Leaves):
    """Truncated log-normal multiplicative noise exp(xi), xi drawn from
    the truncated normal through its inverse CDF of the stored uniform
    noise."""

    FIELDS = ("logit_posterior_mean", "logit_posterior_std", "interval",
              "s_interval", "reg", "noise")

    def eval_mask(self):
        a, b = self.interval[0], self.interval[1]
        s_min, s_max = self.s_interval[0], self.s_interval[1]
        mu = (b - a) * torch.sigmoid(self.logit_posterior_mean) + a
        sigma = (s_max - s_min) * torch.sigmoid(
            self.logit_posterior_std) + s_min
        phi_alpha = torch.special.ndtr((a - mu) / sigma)
        Z = torch.special.ndtr((b - mu) / sigma) - phi_alpha
        p = torch.clamp(phi_alpha + Z * self.noise, 1e-7, 1.0 - 1e-7)
        return torch.exp(mu + sigma * torch.special.ndtri(p))


class BayesianMLP:
    """[Linear -> dropout mask -> activation]* -> Linear, in eval mode."""

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

    def __call__(self, x):
        for layer, drop in zip(self.layers[:-1], self.dropouts):
            x = layer(x)
            if drop is not None:
                x = x * drop.eval_mask()
            x = self._act(x)
        return self.layers[-1](x)

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
