"""Seeded inputs of the port's belief-state BNN tests, and the JAX results
they are held against.

``make_inputs(seed)`` draws a small BNN (P=8 particles, hidden [16, 16],
cartpole sizes, float64) with numpy: the net's leaves in pddp_tpu's
flatten order, the normalizers and the episode noise. ``jax_model``
builds the pddp_tpu model from them; the port builds its own through
``pddp_tpu_torch.convert.bnn``.

On the CPU, pddp_tpu takes minutes to compile the local model of this
path (the cost's Hessian through the 5-rung Cholesky ladder of the
augmented belief) and its solve loop, far past the test budget, so the
JAX side of one iteration and of a 2-iteration solve is stored in
``bnn_path.npz``. Regenerate it with

    JAX_PLATFORMS=cpu python -m tests.golden.bnn_path
"""

import os

import numpy as np

P, HIDDEN, N, SEED = 8, [16, 16], 5, 0
STATE, ACTION, ANGULAR, NON_ANGULAR = 4, 1, (2,), (0, 1, 3)
JITTER = (1e-12, 1e-6)
REG = 1.0
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "bnn_path.npz")


def _standardized(rng, shape):
    e = rng.standard_normal(shape)
    return (e - e.mean(axis=1, keepdims=True)) / e.std(axis=1, ddof=1,
                                                       keepdims=True)


def make_inputs(seed=SEED, n_particles=P, hidden=HIDDEN, horizon=N + 1):
    """(net leaves, buffers) as float64 numpy arrays: weights Xavier-normal
    with the ReLU gain, biases in [-0.1, 0.1], concrete dropout at rate
    0.5 and temperature 0.1, modest normalizers so that a few steps stay
    bounded."""
    rng = np.random.default_rng(seed)
    dims = [STATE + len(ANGULAR) + ACTION] + list(hidden) + [2 * STATE]
    leaves = []
    for din, dout in zip(dims[:-1], dims[1:]):
        leaves.append(np.sqrt(2.0) * np.sqrt(2.0 / (din + dout))
                      * rng.standard_normal((din, dout)))
        leaves.append(rng.uniform(-0.1, 0.1, dout))
    for width in hidden:
        leaves += [np.array(0.0), np.array(0.1), np.array(1.0),
                   rng.uniform(1e-5, 1.0 - 1e-5, (n_particles, width))]
    F = dims[0]
    buffers = dict(
        X_mean=0.1 * rng.standard_normal(F),
        X_std=0.5 + rng.random(F),
        dX_mean=0.01 * rng.standard_normal(STATE),
        dX_std=0.05 + 0.1 * rng.random(STATE),
        eps_in=_standardized(rng, (horizon, n_particles, STATE)),
        eps_out=_standardized(rng, (horizon, n_particles, STATE)))
    return leaves, buffers


def problem():
    """(z0 as mean and variance, U0) of the path: the bench's start."""
    return np.zeros(STATE), 1e-2 * np.ones(STATE), 0.1 * np.ones((N, 1))


def jax_model(leaves, buffers, n_particles=P, hidden=HIDDEN, horizon=N + 1,
              factory_kwargs=None, **init_kwargs):
    """The pddp_tpu BNN model holding these arrays (a
    ``ParticlesBNNDynamicsModel`` with ``factory_kwargs={"particles":
    True}``, which takes no ``eps_in``)."""
    import jax
    import jax.numpy as jnp

    from pddp_tpu.models.bnn import bnn_dynamics_model_factory
    from pddp_tpu.struct import replace

    cls = bnn_dynamics_model_factory(STATE, ACTION, hidden,
                                     angular_indices=ANGULAR,
                                     non_angular_indices=NON_ANGULAR,
                                     **(factory_kwargs or {}))
    m = cls.init(jax.random.PRNGKey(0), n_particles=n_particles,
                 horizon=horizon, dtype=jnp.float64, **init_kwargs)
    treedef = jax.tree_util.tree_structure(m.net)
    net = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a, jnp.float64) for a in leaves])
    fields = {k: jnp.asarray(v) for k, v in buffers.items()
              if hasattr(m, k) and getattr(m, k) is not None}
    if hasattr(m, "chol_jitter"):
        fields["chol_jitter"] = JITTER
    return replace(m, net=net, **fields)


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pddp_tpu.controllers import ilqr
    from pddp_tpu.encoding import StateEncoding, encode
    from pddp_tpu.examples.cartpole import CartpoleCost

    enc = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    leaves, buffers = make_inputs()
    model = jax_model(leaves, buffers)
    cost = CartpoleCost()
    m0, v0, U0 = problem()
    z0 = encode(jnp.asarray(m0), V=jnp.asarray(v0), encoding=enc)
    U0 = jnp.asarray(U0)
    alphas = ilqr.default_fit_alphas(jnp.float64)

    Z, AUX = jax.jit(lambda z, u: ilqr.rollout(model, z, u, enc))(z0, U0)
    derivs = jax.jit(lambda Z, U, A: ilqr.local_model(
        Z, U, A, model, cost, enc))(Z, U0, AUX)
    k, K, ok = ilqr.backward(*derivs, reg=REG)
    Z_b, U_b, J_b, AUX_b = jax.jit(lambda Z, k, K: ilqr.control_law(
        model, Z, U0, k, K, alphas, enc, cost=cost, with_aux=True))(
            derivs[0], k, K)
    r = ilqr.solve(model, cost, z0, U0,
                   ilqr.ILQROptions(n_iterations=2, max_evals=15), encoding=enc)
    out = {"derivs_" + n: np.asarray(a) for n, a in zip(
        ("Z", "F_z", "F_u", "L", "L_z", "L_u", "L_zz", "L_uz", "L_uu"),
        derivs)}
    out.update(k=np.asarray(k), K=np.asarray(K), Z_b=np.asarray(Z_b),
               U_b=np.asarray(U_b), J_b=np.asarray(J_b),
               AUX_b=np.asarray(AUX_b), solve_Z=np.asarray(r.Z),
               solve_U=np.asarray(r.U), solve_J=np.asarray(r.J_opt),
               solve_state=np.asarray(int(r.state)),
               solve_iterations=np.asarray(int(r.iterations)),
               solve_evals=np.asarray(int(r.evals)),
               solve_mu=np.asarray(r.mu))
    np.savez(PATH, **out)
    print("wrote", PATH, {k: v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
