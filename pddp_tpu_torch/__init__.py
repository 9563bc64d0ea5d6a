"""PyTorch/CUDA port of ``pddp_tpu``.

Same module layout and names as the JAX package, in PyTorch's idiom:
plain functions on tensors, small classes holding parameter tensors,
Python loops where JAX had ``lax.while_loop``. The two TPU kernels of the
known-dynamics iLQR path are hand-written CUDA kernels
(``ops/backward_kernel.py``, ``ops/fused_rollout.py``, sources in
``csrc/``), each beside a plain PyTorch version that runs on the CPU.

Entry points build their tensors on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise (see ``device.py``).
"""

from .device import resolve_device
from .encoding import StateEncoding

__all__ = ["StateEncoding", "resolve_device"]
