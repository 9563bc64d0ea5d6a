"""Composable cost functions (port of ``pddp_tpu/costs/base.py``).

A ``Cost`` maps (encoded state, action, time index) to the expected
scalar cost, broadcasting over leading batch dims; costs compose through
operator overloading into ``AggregateCost`` trees.
"""

from __future__ import annotations

import operator
from typing import Any

from ..encoding import StateEncoding

__all__ = ["Cost", "AggregateCost"]

_OPS = {
    "add": operator.add,
    "sub": operator.sub,
    "mul": operator.mul,
    "div": operator.truediv,
    "pow": operator.pow,
}


class Cost:
    """Base cost function.

    Subclasses implement ``__call__(z, u, i, terminal, encoding)``
    returning the expected cost, broadcasting over leading batch dims.
    """

    def __call__(self, z, u, i, terminal=False,
                 encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        raise NotImplementedError

    def __add__(self, other):
        return AggregateCost(self, other, op="add")

    def __radd__(self, other):
        return AggregateCost(other, self, op="add")

    def __sub__(self, other):
        return AggregateCost(self, other, op="sub")

    def __rsub__(self, other):
        return AggregateCost(other, self, op="sub")

    def __mul__(self, other):
        return AggregateCost(self, other, op="mul")

    def __rmul__(self, other):
        return AggregateCost(other, self, op="mul")

    def __truediv__(self, other):
        return AggregateCost(self, other, op="div")

    def __rtruediv__(self, other):
        return AggregateCost(other, self, op="div")

    def __pow__(self, other):
        return AggregateCost(self, other, op="pow")

    def __neg__(self):
        return AggregateCost(self, -1.0, op="mul")


class AggregateCost(Cost):
    """Pointwise combination of two costs, or of a cost and a scalar:
    E[L(x, u)] = op(E[L_1(x, u)], E[L_2(x, u)])."""

    def __init__(self, first: Any, second: Any, op: str = "add"):
        if op not in _OPS:
            raise ValueError("unknown cost op {!r}".format(op))
        self.first = first
        self.second = second
        self.op = op

    def __call__(self, z, u, i, terminal=False,
                 encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        first, second = (
            c(z, u, i, terminal, encoding, **kwargs) if isinstance(c, Cost)
            else c for c in (self.first, self.second))
        return _OPS[self.op](first, second)
