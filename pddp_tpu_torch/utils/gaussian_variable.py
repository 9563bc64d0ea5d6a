"""Reference-layout alias: ``GaussianVariable`` also under
``pddp_tpu_torch.utils.gaussian_variable``, as ``pddp_tpu`` keeps it."""

from ..gaussian_variable import *  # noqa: F401,F403
from ..gaussian_variable import __all__  # noqa: F401
