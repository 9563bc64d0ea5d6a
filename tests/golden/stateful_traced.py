"""``pddp_tpu``'s line search of the stateful rows K2(g) and the traced
K2(e) cover, stored for the port's tests
(``tests/test_torch_stateful_traced.py``).

The rows (``tests/traced_models.py``'s STATEFUL_ROWS): G1 the cartpole
behind a first-order actuator lag (IGNORE_UNCERTAINTY, ``CartpoleCost``,
bounds), G2 and G3 the planar quadrotor in a filtered gust (IGNORE with
``SaturatingQRCost``; Cholesky with ``QRCost``), each a user's stateful
model defined here in ``pddp_tpu``'s way (``@pytree_dataclass``, as
``tests/golden/traced_rollouts.py`` defines the quadrotor); E1
``particulate_model`` of a bare subclass of the cartpole (Cholesky), E2
``particulate_model`` of the planar quadrotor, which reads its wind table
by the step (VARIANCE_ONLY).

For each, ``pddp_tpu.ops.fused_rollout.fused_control_law(...,
interpret=True, with_aux=True)`` on the CPU in float64 at N = 6, A = 3
and P = 8 particles, with the cost. Where interpret mode raises, the scan
``control_law`` is stored instead (with the cost in the scan under
IGNORE_UNCERTAINTY, the kernel's order), and ``<row>_source`` says so, as
``tests/golden/stateful_rollouts.py`` does.

The inputs are made with numpy (``traced_models.stateful_inputs``, the
wind ``traced_models.wind``, the particles' noise
``traced_models.particle_eps``) and stored beside the outputs: z0, the
nominal Z (``rollout`` of U from z0), U, k, K and the noise.

Regenerate with

    JAX_PLATFORMS=cpu python -m tests.golden.stateful_traced
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "stateful_traced.npz")

N, P = 6, 8
ALPHAS = (1.0, 0.5, 0.1)


def jax_models():
    """(LaggedCartpole, GustQuadrotor): ``pddp_tpu``'s twins of
    ``traced_models.LaggedCartpoleModel`` and ``GustQuadrotorModel``."""
    import jax.numpy as jnp

    from pddp_tpu.encoding import StateEncoding
    from pddp_tpu.examples.cartpole import CartpoleDynamicsModel
    from pddp_tpu.struct import pytree_dataclass
    from tests import traced_models as tm
    from tests.golden.traced_rollouts import jax_quadrotor

    @pytree_dataclass
    class LaggedCartpole(CartpoleDynamicsModel):
        tau: jnp.ndarray = tm.LAG_TAU

        def init_state(self, batch_shape=()):
            return jnp.zeros(tuple(batch_shape) + (1,))

        def aux_zero(self):
            return jnp.zeros((1,))

        def force(self, f, u):
            return f + self.dt / self.tau * (u - f)

        def step(self, z, u, i, state,
                 encoding: StateEncoding = StateEncoding.DEFAULT):
            f = self.force(state, u)
            return super().apply(z, f, i, (), encoding), f, state

        def apply(self, z, u, i, aux,
                  encoding: StateEncoding = StateEncoding.DEFAULT, **kw):
            return super().apply(z, self.force(aux, u), i, (), encoding)

    @pytree_dataclass
    class GustQuadrotor(jax_quadrotor()):
        beta: jnp.ndarray = tm.GUST_BETA

        def init_state(self, batch_shape=()):
            return jnp.zeros(tuple(batch_shape) + (2,))

        def aux_zero(self):
            return jnp.zeros((2,))

        def gust(self, g, i):
            return g + self.beta * (self.w[i] - g)

        def step(self, z, u, i, state,
                 encoding: StateEncoding = StateEncoding.DEFAULT):
            g = self.gust(state, i)
            return self.dynamics(z, u, g, encoding), g, state

        def apply(self, z, u, i, aux,
                  encoding: StateEncoding = StateEncoding.DEFAULT, **kw):
            return self.dynamics(z, u, self.gust(aux, i), encoding)

    return LaggedCartpole, GustQuadrotor


def jax_row(row):
    """(model, cost, encoding, bounds, noise or None) of a stateful row in
    ``pddp_tpu``."""
    import jax
    import jax.numpy as jnp

    from pddp_tpu.costs.quadratic import QRCost, SaturatingQRCost
    from pddp_tpu.encoding import StateEncoding
    from pddp_tpu.examples.cartpole import (CartpoleCost,
                                            CartpoleDynamicsModel)
    from pddp_tpu.struct import pytree_dataclass, replace
    from pddp_tpu.utils.particles import particulate_model
    from tests import traced_models as tm
    from tests.golden.traced_rollouts import jax_quadrotor

    kind, codec, cost_kind = tm.STATEFUL_ROWS[row]
    enc = StateEncoding[codec]
    name = tm.example_name(kind)
    lagged, gusty = jax_models()
    if name == "quadrotor":
        cls = gusty if kind.startswith("gust") else jax_quadrotor()
        model = cls(w=jnp.asarray(tm.wind(N)))
        Q, R, Q_term, x_goal, u_goal = (jnp.asarray(a)
                                        for a in tm.quad_weights())
        kw = dict(Q_term=Q_term, x_goal=x_goal, u_goal=u_goal)
        cost = (SaturatingQRCost(Q, R, **kw) if cost_kind == "saturating"
                else QRCost(Q, R, **kw))
    else:
        cls = (lagged if kind.startswith("lagged") else pytree_dataclass(
            type("UserCartpoleDynamicsModel", (CartpoleDynamicsModel,), {})))
        model = cls(dt=tm.STARTS[name][0])
        cost = CartpoleCost()
    eps = None
    if kind.startswith("particle"):
        eps = tm.particle_eps(row, N, P, model.state_size)
        model = particulate_model(model, jax.random.PRNGKey(0),
                                  n_particles=P, horizon=N + 1,
                                  dtype=jnp.float64)
        model = replace(model, eps=jnp.asarray(eps))
    bounds = tm.LAG_BOUNDS if row in tm.STATEFUL_BOUNDED else None
    return model, cost, enc, bounds, eps


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pddp_tpu.controllers.ilqr import control_law, rollout
    from pddp_tpu.encoding import (StateEncoding, encode,
                                   infer_encoded_state_size)
    from pddp_tpu.ops.fused_rollout import (fused_control_law,
                                            supports_fused_rollout)
    from tests import traced_models as tm

    out = {"N": np.asarray(N), "P": np.asarray(P),
           "alphas": np.asarray(ALPHAS), "wind": tm.wind(N)}
    alphas = jnp.asarray(ALPHAS, jnp.float64)
    for row in tm.STATEFUL_ROWS:
        model, cost, enc, bounds, eps = jax_row(row)
        n, nu = model.state_size, model.action_size
        nz = infer_encoded_state_size(n, enc)
        name = tm.example_name(tm.STATEFUL_ROWS[row][0])
        z0 = encode(jnp.asarray(tm.STARTS[name][1], jnp.float64),
                    V=1e-2 * jnp.ones(n, jnp.float64), encoding=enc)
        U, k, K = tm.stateful_inputs(row, N, nz, nu)
        Z, _ = rollout(model, z0, jnp.asarray(U), enc)
        lo, hi = bounds if bounds is not None else (None, None)
        assert supports_fused_rollout(model, enc, allow_stateful=True)
        args = (model, Z, jnp.asarray(U), jnp.asarray(k), jnp.asarray(K),
                alphas, enc)
        kw = dict(cost=cost, u_min=lo, u_max=hi, with_aux=True)
        try:
            res = fused_control_law(*args, interpret=True, **kw)
            source = "interpret"
        except Exception as e:  # noqa: BLE001 - recorded, then the scan
            print(row, "interpret mode raised:", repr(e)[:200])
            res = control_law(*args, cost_in_scan=(
                enc == StateEncoding.IGNORE_UNCERTAINTY), **kw)
            source = "scan"
        print(row, source, "J", np.asarray(res[2]), flush=True)
        out[row + "_source"] = np.asarray(source)
        out[row + "_z0"] = np.asarray(z0)
        out[row + "_Z"] = np.asarray(Z)
        if eps is not None:
            out[row + "_eps"] = eps
        for key, a in (("U", U), ("k", k), ("K", K)):
            out["{}_{}".format(row, key)] = a
        for key, a in zip(("Z_out", "U_out", "J_out", "AUX_out"), res):
            out["{}_{}".format(row, key)] = np.asarray(a)
    np.savez(PATH, **out)
    print("wrote", PATH)


if __name__ == "__main__":
    main()
