"""Utilities of the port, imported lazily (the encoding core itself
imports ``utils.linalg``): linear algebra, angles, constraints,
derivatives, optimizers, particles, draws, trajectories, checkpoints and
timing, and the reference-layout aliases ``encoding`` and
``gaussian_variable``."""

import importlib

_SUBMODULES = (
    "angular",
    "checkpoint",
    "constraint",
    "draws",
    "evaluation",
    "linalg",
    "optim",
    "particles",
    "profiling",
    "trajectory",
)

#: aliases of the top-level modules, kept at ``pddp_tpu``'s import paths.
_TOPLEVEL_ALIASES = ("encoding", "gaussian_variable")

__all__ = list(_SUBMODULES) + list(_TOPLEVEL_ALIASES)


def __getattr__(name):
    if name in __all__:
        return importlib.import_module("." + name, __name__)
    raise AttributeError("module {!r} has no attribute {!r}".format(
        __name__, name))
