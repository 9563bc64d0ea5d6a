"""``pddp_tpu.parallel``'s sharded functions, stored for the port's
multi-process tests (``tests/test_torch_parallel.py``).

Run on a virtual CPU mesh of four devices in float64, at the sizes of
``pddp_tpu``'s own ``tests/parallel/``:

 * ``particle_sharded_solve`` of ``test_particles.py``'s BNN (4 states, 1
   action, hidden [8, 8], P=16 particles, horizon H + 1 = 5) on the
   cartpole cost, under the Cholesky codec (``psolve_chol``) and under
   STANDARD_DEVIATION_ONLY (``psolve_std``), the particles over a 1-D
   ``pp`` mesh; and ``particle_sharded_batched_solve`` of B=4 offset
   starts under the Cholesky codec on a 2 x 2 ``dp`` x ``pp`` mesh
   (``pbsolve``). The net's leaves (``bnn_net_<i>``, flatten order) and
   buffers (``bnn_<name>``) are stored, so that ``convert.bnn`` builds the
   port's model from them.
 * ``batched_solve`` of ``test_batch.py``'s pendulum (dt 0.1) at B=16,
   N=5 over a 1-D ``dp`` mesh, whole (``batch``) and in chunks of 8
   (``batch_chunk``).
 * ``shard_over_horizon`` + ``parallel_backward`` of ``test_horizon.py``'s
   cartpole local model (H=64) over an ``sp`` mesh: the local model
   (``horizon_derivs_<i>``) and the gains (``horizon_k``, ``horizon_K``).
 * ``dp_train_step`` of ``test_batch.py``'s linear regression with
   ``optax.sgd(0.1)``: the inputs and the step's W and loss.

JAX compiles the sharded solves for minutes on the CPU, past the test
budget, so the results are stored in ``parallel_solves.npz``. Regenerate
it with

    JAX_PLATFORMS=cpu python -m tests.golden.parallel_solves
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "parallel_solves.npz")

DEVICES = 4
H, P, HIDDEN = 4, 16, (8, 8)
BNN_OPTS = {"n_iterations": 2, "max_evals": 6}
PB_B = 4
BATCH_B, BATCH_N = 16, 5
BATCH_OPTS = {"n_iterations": 2, "max_evals": 8}
BATCH_CHUNK = 8
HORIZON_H = 64
FIELDS = ("Z", "U", "K", "J_opt", "state", "mu", "delta", "iterations",
          "evals")
BUFFERS = ("X_mean", "X_std", "dX_mean", "dX_std", "eps_in", "eps_out")


def _result(out, prefix, r):
    for f in FIELDS:
        out["{}_{}".format(prefix, f)] = np.asarray(getattr(r, f))


def main():
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count={}".format(
            DEVICES)).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from pddp_tpu.controllers.ilqr import ILQROptions, forward
    from pddp_tpu.encoding import StateEncoding, encode
    from pddp_tpu.examples.cartpole import (CartpoleCost,
                                            CartpoleDynamicsModel)
    from pddp_tpu.examples.pendulum import PendulumCost, PendulumDynamicsModel
    from pddp_tpu.models.bnn import bnn_dynamics_model_factory
    from pddp_tpu.ops.riccati import parallel_backward
    from pddp_tpu.parallel import (batched_solve, dp_train_step, make_mesh,
                                   particle_sharded_batched_solve,
                                   particle_sharded_solve,
                                   shard_over_horizon)

    assert jax.device_count() == DEVICES
    out = {}

    # The particle-sharded BNN solves (tests/parallel/test_particles.py).
    cls = bnn_dynamics_model_factory(4, 1, list(HIDDEN),
                                     angular_indices=(2,),
                                     non_angular_indices=(0, 1, 3))
    model = cls.init(jax.random.PRNGKey(0), n_particles=P, horizon=H + 1,
                     dtype=jnp.float64)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(model.net)):
        out["bnn_net_{}".format(i)] = np.asarray(leaf)
    for k in BUFFERS:
        out["bnn_" + k] = np.asarray(getattr(model, k))
    cost = CartpoleCost()
    U0 = 0.1 * jnp.ones((H, 1))
    opts = ILQROptions(**BNN_OPTS)
    pp = make_mesh("pp")
    for label, enc in (("chol", StateEncoding.UPPER_TRIANGULAR_CHOLESKY),
                       ("std", StateEncoding.STANDARD_DEVIATION_ONLY)):
        z0 = encode(jnp.zeros(4), V=1e-2 * jnp.ones(4), encoding=enc)
        out["psolve_{}_z0".format(label)] = np.asarray(z0)
        _result(out, "psolve_" + label, particle_sharded_solve(
            model, cost, z0, U0, opts, encoding=enc, mesh=pp))
    enc = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    z0 = encode(jnp.zeros(4), V=1e-2 * jnp.ones(4), encoding=enc)
    z0s = jnp.broadcast_to(z0, (PB_B,) + z0.shape) + 0.001 * (
        jax.random.normal(jax.random.PRNGKey(3), (PB_B,) + z0.shape))
    out["pbsolve_z0s"] = np.asarray(z0s)
    mesh2 = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("dp", "pp"))
    _result(out, "pbsolve", particle_sharded_batched_solve(
        model, cost, z0s, 0.1 * jnp.ones((PB_B, H, 1)), opts, encoding=enc,
        mesh=mesh2))

    # The batch-sharded pendulum (tests/parallel/test_batch.py).
    ign = StateEncoding.IGNORE_UNCERTAINTY
    z0s = 0.05 * jax.random.normal(jax.random.PRNGKey(0), (BATCH_B, 2))
    U0s = 0.1 * jnp.ones((BATCH_B, BATCH_N, 1))
    out["batch_z0s"] = np.asarray(z0s)
    dp = make_mesh()
    pend = PendulumDynamicsModel(dt=0.1)
    bopts = ILQROptions(**BATCH_OPTS)
    _result(out, "batch", batched_solve(pend, PendulumCost(), z0s, U0s,
                                        bopts, encoding=ign, mesh=dp))
    _result(out, "batch_chunk", batched_solve(
        pend, PendulumCost(), z0s, U0s, bopts, encoding=ign, mesh=dp,
        chunk=BATCH_CHUNK))

    # The horizon-sharded Riccati (tests/parallel/test_horizon.py).
    derivs = jax.jit(lambda z, u: forward(
        z, u, CartpoleDynamicsModel(dt=0.05), CartpoleCost(), ign))(
            jnp.array([0.0, 0.0, 0.1, 0.0]), 0.1 * jnp.ones((HORIZON_H, 1)))
    for i, d in enumerate(derivs):
        out["horizon_derivs_{}".format(i)] = np.asarray(d)
    k, K, ok = jax.jit(parallel_backward)(
        *shard_over_horizon(derivs, make_mesh("sp"), "sp"))
    assert bool(ok)
    out["horizon_k"], out["horizon_K"] = np.asarray(k), np.asarray(K)

    # One data-parallel step (tests/parallel/test_batch.py).
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    W = jax.random.normal(k1, (4, 2))
    batch = {"x": jax.random.normal(k2, (32, 4)),
             "y": jax.random.normal(k3, (32, 2))}

    def loss_fn(W, b):
        return jnp.mean((b["x"] @ W - b["y"]) ** 2)

    opt = optax.sgd(0.1)
    W_dp, _, loss_dp = dp_train_step(loss_fn, W, opt, opt.init(W), batch, dp)
    out.update(dp_W0=np.asarray(W), dp_x=np.asarray(batch["x"]),
               dp_y=np.asarray(batch["y"]), dp_W=np.asarray(W_dp),
               dp_loss=np.asarray(loss_dp))
    np.savez(PATH, **out)
    print("wrote", PATH)


if __name__ == "__main__":
    main()
