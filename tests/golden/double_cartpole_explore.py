"""``pddp_tpu``'s double-cartpole env under ``examples/experiment.py``'s
first exploration actions, for ``tests/test_torch_example_scripts.py``.

The experiment (dt = 0.1, float32, actions uniform in [-20, 20], drawn
here by numpy at the script's seed as the port's script draws them)
drives its env open loop for its first trial of N = 25 steps. The double
cartpole leaves float32's range within that trial, so the trial's data,
the model fit on them and the solves after carry NaN. Stored: the env's
reset state (seed 0), the actions, ``pddp_tpu``'s float32 states step by
step (its env's ``step_fn``, eager) and the first step whose state is not
finite.

    JAX_PLATFORMS=cpu python -m tests.golden.double_cartpole_explore
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "double_cartpole_explore.npz")
N, DT, UMAX, SEED = 25, 0.1, 20.0, 0


def actions():
    """examples_torch/experiment.py's ``initial_actions`` for one action
    in [-UMAX, UMAX]."""
    u = np.random.default_rng(SEED + 1).random((N, 1))
    return (2 * UMAX * u - UMAX).astype(np.float32)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pddp_tpu.examples.problems import SampleProblems

    env, _, _ = SampleProblems.DOUBLE_CARTPOLE.setup(DT, seed=SEED)
    U = actions()
    x = env._x
    X = [np.asarray(x)]
    for u in U:
        x = env.step_fn(x, jnp.asarray(u))
        X.append(np.asarray(x))
    X = np.stack(X)
    bad = ~np.isfinite(X).all(axis=1)
    first = int(np.argmax(bad)) if bad.any() else -1
    np.savez(PATH, x0=X[0], U=U, X=X, first_nonfinite=np.array(first))
    print("wrote", PATH, "dtype", X.dtype, "first non-finite step", first)


if __name__ == "__main__":
    main()
