"""``pddp_tpu``'s float32 cartpole cost under STANDARD_DEVIATION_ONLY at
states near 0 rad, for ``tests/test_torch_bf16_rollouts.py``'s check of
the port's cost there.

The cost augments the belief with the moment-matched variance of sin
and cos of the angle, Var[cos] = 0.5 ((1 - e^{-v}) + (e^{-2v} - e^{-v})
cos 2m), which cancels to about v^2 near m = 0: below float32's rounding
of its terms when the angle's variance v is small, so it lands on either
side of 0, and a negative one's square root (the STD codec re-encodes the
augmented belief) makes J NaN. Stored: ``STATES`` states drawn by numpy
(the angle in [-0.05, 0.05] rad, one standard deviation for all four
states in [1e-4, 1e-1], log-uniform), ``pddp_tpu``'s float32 running cost
at each (u = 0) and its float32 Var[cos] (``_augment_var``).

    JAX_PLATFORMS=cpu python -m tests.golden.std_cost_f32
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "std_cost_f32.npz")
STATES = 256


def states():
    rng = np.random.default_rng(0)
    th = rng.uniform(-0.05, 0.05, STATES)
    sd = 10 ** rng.uniform(-4, -1, STATES)
    one = np.ones(STATES)
    return np.stack([0.01 * one, -0.02 * one, th, 0.05 * one, sd, sd, sd,
                     sd], 1).astype(np.float32)


def main():
    import jax
    import jax.numpy as jnp

    from pddp_tpu.encoding import StateEncoding
    from pddp_tpu.examples.cartpole import CartpoleCost
    from pddp_tpu.utils.angular import _augment_var

    Z = states()
    cost = CartpoleCost()
    J = jax.jit(jax.vmap(lambda z: cost(
        z, jnp.zeros(1, jnp.float32), 0, terminal=False,
        encoding=StateEncoding.STANDARD_DEVIATION_ONLY)))(jnp.asarray(Z))
    _, Va = _augment_var(jnp.asarray(Z[:, :4]), jnp.asarray(Z[:, 4:]) ** 2,
                         (2,), (0, 1, 3))
    J, Va = np.asarray(J), np.asarray(Va)
    assert J.dtype == np.float32
    np.savez(PATH, Z=Z, J=J, var_cos=Va[:, -1])
    print("wrote", PATH, "NaN", int(np.isnan(J).sum()), "of", STATES)


if __name__ == "__main__":
    main()
