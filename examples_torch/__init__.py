"""The example scripts of ``examples/``, ported to ``pddp_tpu_torch``.

Each script runs from the repository root, on the card by default:

    python examples_torch/known_dynamics.py pendulum 5
    python examples_torch/known_dynamics.py pendulum 5 --device cpu
"""
