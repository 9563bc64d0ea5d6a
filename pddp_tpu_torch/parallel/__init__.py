"""Batched solves (port of ``pddp_tpu/parallel``).

``batched_solve`` runs B independent solves as one batch of lanes on one
card. The multi-device entry points of ``pddp_tpu.parallel``
(``make_mesh``, ``replicate``, ``dp_train_step``, the particle- and
horizon-sharded solves) are not ported yet: a ``mesh`` raises.
"""

from .batch import batched_solve

__all__ = ["batched_solve"]
