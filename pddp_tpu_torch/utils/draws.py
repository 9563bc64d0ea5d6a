"""Random draws from a ``torch.Generator`` (the port's counterpart of
``pddp_tpu``'s PRNG keys).

Each draw is made on the generator's device (torch's default generator
on ``device`` when ``generator`` is None) and moved to ``device``, so a
CPU generator gives the same numbers whatever device the result lives
on. The bits are not JAX's: a caller that needs ``pddp_tpu``'s draws
passes them as explicit arrays where a function takes them.
"""

from __future__ import annotations

import torch

__all__ = ["bernoulli", "normal", "randint", "uniform", "explicit"]


def _where(generator, device):
    return torch.device(device) if generator is None else generator.device


def uniform(generator, shape, dtype, device, low=0.0, high=1.0):
    """Uniform in [low, high)."""
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=_where(generator, device))
    return (u * (high - low) + low).to(device)


def normal(generator, shape, dtype, device):
    """Standard normal."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=_where(generator, device)).to(device)


def bernoulli(generator, p, shape, dtype, device):
    """1 with probability ``p`` (a number or a 0-d tensor on ``device``),
    else 0, in ``dtype``."""
    u = torch.rand(tuple(shape), generator=generator,
                   device=_where(generator, device)).to(device)
    return (u < p).to(dtype)


def randint(generator, low, high, shape, device):
    """Integers uniform in [low, high), int64."""
    return torch.randint(low, high, tuple(shape), generator=generator,
                         device=_where(generator, device)).to(device)


def explicit(a, dtype, device, shape=None):
    """An explicit draw (numpy or tensor) as a tensor of ``dtype`` on
    ``device``, its shape checked against ``shape`` where given."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError("explicit draw has shape {}, expected {}".format(
            tuple(t.shape), tuple(shape)))
    return t
