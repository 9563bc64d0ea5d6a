"""Reference-layout alias: the state codec also under
``pddp_tpu_torch.utils.encoding``, as ``pddp_tpu`` keeps it."""

from ..encoding import *  # noqa: F401,F403
from ..encoding import __all__  # noqa: F401
