"""``pddp_tpu``'s float32 particle cartpole under the Cholesky codec at the
size and seeds of ``chip_smoke.py``'s phase 17, stored for the port's
test (``tests/test_torch_particle_f32.py``).

``particulate_model`` of the cartpole (dt 0.05) with P = 100 particles
over a horizon of 100, its noise the standard normal draws of numpy seed
17 standardized over the particles, started at x0 = [0, 0, 0.1, 0] with
covariance 1e-2 I under UPPER_TRIANGULAR_CHOLESKY, U0 (50, 1) 0.1 times
the standard normal draws of numpy seed 18, all in float32 (JAX's
default, x64 off). Stored: the inputs, the rollout of U0 (Z, AUX), whether
the plain backward's gains on its local model are finite (``ok``) at each
reg of ``REGS`` (phase 17's ``PARTICLE_K1_REGS``), and the whole solve's
end (state, iterations, evaluations, J) at phase 17's depth. JAX compiles
the local model and the solve for minutes on the CPU, so the results are
stored in ``particle_f32.npz``. Regenerate it with

    JAX_PLATFORMS=cpu python -m tests.golden.particle_f32
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "particle_f32.npz")

DT, P, H, N = 0.05, 100, 100, 50
X0 = [0.0, 0.0, 0.1, 0.0]
REGS = tuple(10.0**k for k in range(1, 11))
OPTS = {"n_iterations": 3, "max_evals": 6}


def draws():
    """(raw episode noise (H, P, 4), U0 (N, 1)) as float64 numpy."""
    eps = np.random.default_rng(17).standard_normal((H, P, 4))
    U0 = 0.1 * np.random.default_rng(18).standard_normal((N, 1))
    return eps, U0


def main():
    import jax
    import jax.numpy as jnp

    from pddp_tpu.controllers.ilqr import (ILQROptions, backward,
                                           local_model, rollout, solve)
    from pddp_tpu.encoding import StateEncoding, encode
    from pddp_tpu.examples.cartpole import CartpoleCost, CartpoleDynamicsModel
    from pddp_tpu.struct import replace
    from pddp_tpu.utils.particles import _standardize, particulate_model

    f32 = jnp.float32
    enc = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    raw, U0 = draws()
    model = particulate_model(CartpoleDynamicsModel(dt=DT),
                              jax.random.PRNGKey(0), n_particles=P,
                              horizon=H, dtype=f32)
    model = replace(model, eps=jax.vmap(_standardize)(jnp.asarray(raw, f32)))
    cost = CartpoleCost()
    z0 = encode(jnp.asarray(X0, f32), C=1e-2 * jnp.eye(4, dtype=f32),
                encoding=enc)
    U0 = jnp.asarray(U0, f32)
    Z, AUX = jax.jit(lambda z, u: rollout(model, z, u, enc))(z0, U0)
    derivs = jax.jit(lambda Z, U, A: local_model(Z, U, A, model, cost,
                                                 enc))(Z, U0, AUX)
    ok = [bool(backward(*derivs, reg=reg)[2]) for reg in REGS]
    r = solve(model, cost, z0, U0, ILQROptions(**OPTS), encoding=enc)
    out = {"eps": np.asarray(model.eps), "z0": np.asarray(z0),
           "U0": np.asarray(U0), "Z": np.asarray(Z), "AUX": np.asarray(AUX),
           "ok": np.asarray(ok), "regs": np.asarray(REGS),
           "solve_state": np.asarray(int(r.state)),
           "solve_state_name": np.asarray(r.state.name
                                          if hasattr(r.state, "name")
                                          else str(r.state)),
           "solve_iterations": np.asarray(int(r.iterations)),
           "solve_evals": np.asarray(int(r.evals)),
           "solve_J": np.asarray(r.J_opt)}
    print({k: v for k, v in out.items() if v.size < 20})
    print("Z finite", bool(np.isfinite(out["Z"]).all()),
          "max |Z|", float(np.abs(out["Z"]).max()))
    np.savez(PATH, **out)
    print("wrote", PATH)


if __name__ == "__main__":
    main()
