"""Writes ``pddp_tpu_torch/data/golden_U0.npz``: the initial actions of
every golden case of ``cases.py``, as ``make_solve_args`` draws them
(0.1 times a standard normal draw from JAX's ``PRNGKey(42)``, float64),
one array per case name. The port reads them through
``pddp_tpu_torch.convert.golden_U0``, since it cannot draw JAX's random
bits itself. Regenerate with

    JAX_PLATFORMS=cpu python -m tests.golden.golden_u0
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                    "pddp_tpu_torch", "data", "golden_U0.npz")


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    from tests.golden.cases import build_cases, make_solve_args
    U0 = {name: np.asarray(make_solve_args(name)[3])
          for name in sorted(build_cases())}
    np.savez(os.path.normpath(PATH), **U0)
    print("wrote {} ({})".format(os.path.normpath(PATH), ", ".join(
        "{} {}".format(k, v.shape) for k, v in U0.items())))


if __name__ == "__main__":
    main()
