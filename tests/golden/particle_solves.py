"""``pddp_tpu``'s particle-model solves, stored for the port's tests
(``tests/test_torch_particles.py``).

``pddp_tpu.controllers.ilqr.solve`` on the CPU in float64 over
``particulate_model`` of the cartpole (dt 0.05, P=8 particles, N=20),
under each belief codec (``VARIANCE_ONLY``, ``STANDARD_DEVIATION_ONLY``,
``FULL_COVARIANCE_MATRIX``, ``UPPER_TRIANGULAR_CHOLESKY``), and under the
Cholesky codec with the cartpole's actions squashed into [-U_MAX, U_MAX]
by ``constrain_model`` (``cholesky_constrained``). Each case stores the
particle noise ``eps`` the model drew, the start ``z0``, and the solve's
Z, U, K, J_opt, state, mu, delta, iterations and evals; the Cholesky case
also ``local_model``'s output (``LOCAL``) on the rollout of ``U0``. JAX
compiles each solve for tens of seconds on the CPU, so the results are
stored in ``particle_solves.npz``. Regenerate it with

    JAX_PLATFORMS=cpu python -m tests.golden.particle_solves
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "particle_solves.npz")

DT, P, N = 0.05, 8, 20
U_MAX = 2.0
#: the start: the pole 0.3 rad from upright, the cart at rest, each
#: coordinate with variance 1e-2.
MEAN0, VAR0 = np.array([0.0, 0.0, 0.3, 0.0]), 1e-2 * np.ones(4)
OPTS = {"n_iterations": 5, "max_evals": 12}
#: case -> (codec name, constrained).
CASES = {
    "variance": ("VARIANCE_ONLY", False),
    "std": ("STANDARD_DEVIATION_ONLY", False),
    "full": ("FULL_COVARIANCE_MATRIX", False),
    "cholesky": ("UPPER_TRIANGULAR_CHOLESKY", False),
    "cholesky_constrained": ("UPPER_TRIANGULAR_CHOLESKY", True),
}
FIELDS = ("Z", "U", "K", "J_opt", "state", "mu", "delta", "iterations",
          "evals")
#: local_model's outputs, in its order.
LOCAL = ("Z", "F_z", "F_u", "L", "L_z", "L_u", "L_zz", "L_uz", "L_uu")


def U0():
    """The initial actions (N, 1): 0.5 N(0, 1) from numpy seed 3."""
    return 0.5 * np.random.default_rng(3).standard_normal((N, 1))


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pddp_tpu.controllers.ilqr import (ILQROptions, local_model,
                                           rollout, solve)
    from pddp_tpu.encoding import StateEncoding, encode
    from pddp_tpu.examples.cartpole import (CartpoleCost,
                                            CartpoleDynamicsModel)
    from pddp_tpu.utils.constraint import constrain_model
    from pddp_tpu.utils.particles import particulate_model

    out = {}
    cost = CartpoleCost()
    for c, (name, (codec, constrained)) in enumerate(CASES.items()):
        enc = StateEncoding[codec]
        cls = CartpoleDynamicsModel
        if constrained:
            cls = constrain_model(-U_MAX, U_MAX)(cls)
        model = particulate_model(cls(dt=DT), jax.random.PRNGKey(c),
                                  n_particles=P, horizon=N,
                                  dtype=jnp.float64)
        z0 = encode(jnp.asarray(MEAN0), V=jnp.asarray(VAR0), encoding=enc)
        r = solve(model, cost, z0, jnp.asarray(U0()), ILQROptions(**OPTS),
                  encoding=enc)
        if name == "cholesky":
            Z, AUX = rollout(model, z0, jnp.asarray(U0()), enc)
            derivs = local_model(Z, jnp.asarray(U0()), AUX, model, cost, enc)
            for f, a in zip(LOCAL, derivs):
                out["local_" + f] = np.asarray(a)
        out[name + "_eps"] = np.asarray(model.eps)
        out[name + "_z0"] = np.asarray(z0)
        for f in FIELDS:
            out["{}_{}".format(name, f)] = np.asarray(getattr(r, f))
        print(name, "state", out[name + "_state"], "iterations",
              out[name + "_iterations"], "evals", out[name + "_evals"],
              "J", out[name + "_J_opt"], flush=True)
    np.savez(PATH, **out)
    print("wrote", PATH)


if __name__ == "__main__":
    main()
