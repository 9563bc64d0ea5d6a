"""PyTorch/CUDA port of ``pddp_tpu``.

Same module layout and names as the JAX package, in PyTorch's idiom:
plain functions on tensors, small classes holding parameter tensors,
Python loops where JAX had ``lax.while_loop``. The TPU kernels are
hand-written CUDA kernels (sources in ``csrc/``): the Riccati backward
(``ops/backward_kernel.py``) and the line-search rollout
(``ops/fused_rollout.py``) for the known-dynamics cartpole and, stage (d),
for the belief-state BNN (``ops/fused_bnn_rollout.py``), each beside a
plain PyTorch version that runs on the CPU.

Entry points build their tensors on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise (see ``device.py``).
"""

from .__version__ import __version__
from .device import resolve_device
from .encoding import StateEncoding

__all__ = ["__version__", "StateEncoding", "resolve_device"]
