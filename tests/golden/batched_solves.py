"""``pddp_tpu``'s batched solves, stored for the port's lane-by-lane tests
(``tests/test_torch_batch.py``).

``pddp_tpu.parallel.batched_solve`` on the CPU in float64:

 * ``cartpole_scan`` and ``cartpole_parallel``: the cartpole (dt 0.05) at
   B=6, N=30, ``riccati_mode`` "scan" and "parallel", from start states
   spread in the pole angle so that the lanes end after different numbers
   of iterations and evaluations;
 * ``cartpole_box``: the same lanes with actions in [-2, 2] (the box-QP
   backward);
 * ``bnn``: a small belief-state BNN (hidden [16, 16], P=8 particles,
   N=6, the Cholesky codec) at B=4 in chunks of 2, 3 iterations.

and ``pddp_tpu.ops.riccati.parallel_backward`` on seeded local models
(``riccati_inputs``). JAX compiles a vmapped solve loop for minutes on the
CPU, past the test budget, so the results are stored in
``batched_solves.npz``. Regenerate it with

    JAX_PLATFORMS=cpu python -m tests.golden.batched_solves
"""

import os

import numpy as np

from tests.golden import bnn_path

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "batched_solves.npz")

DT, N, B = 0.05, 30, 6
CARTPOLE_OPTS = {"n_iterations": 8, "max_evals": 20}
BOX = (-2.0, 2.0)
BNN_N, BNN_B, BNN_CHUNK = 6, 4, 2
BNN_OPTS = {"n_iterations": 3, "max_evals": 15}
#: (nz, nu, N, reg) of the stored parallel_backward cases.
RICCATI_CASES = ((4, 1, 12, 0.0), (4, 1, 12, 0.5), (5, 2, 9, 0.0),
                 (5, 2, 9, 2.0))
CASES = ("cartpole_scan", "cartpole_parallel", "cartpole_box", "bnn")
FIELDS = ("Z", "U", "K", "J_opt", "state", "mu", "delta", "iterations",
          "evals")


def cartpole_problem():
    """(z0s (B, 4), U0s (B, N, 1)): the pole from 0.1 to 2.6 rad, the
    cart at rest; U0 = 0.1 as in bench.py."""
    z0s = np.zeros((B, 4))
    z0s[:, 2] = np.linspace(0.1, 2.6, B)
    z0s[:, 0] = np.linspace(-0.2, 0.3, B)
    return z0s, 0.1 * np.ones((B, N, 1))


def bnn_problem():
    """(mean, variance, offsets (B, nz), U0s (B, N, 1)) of the BNN case:
    bench.py's start, each lane's encoded state offset by 0.01 N(0, 1)."""
    rng = np.random.default_rng(7)
    nz = 14
    return (np.zeros(4), 1e-2 * np.ones(4),
            0.01 * rng.standard_normal((BNN_B, nz)),
            0.1 * np.ones((BNN_B, BNN_N, 1)))


def bnn_inputs():
    """The BNN case's net leaves and buffers (tests/golden/bnn_path.py's
    draws at horizon N + 1)."""
    return bnn_path.make_inputs(horizon=BNN_N + 1)


def riccati_inputs(nz, nu, n, seed):
    """A seeded local model (F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu) and
    Z: stable-ish dynamics, positive semidefinite state costs and positive
    definite action costs, as the parallel form needs."""
    rng = np.random.default_rng(seed)
    F_z = np.eye(nz) + 0.1 * rng.standard_normal((n, nz, nz))
    F_u = 0.3 * rng.standard_normal((n, nz, nu))
    A = rng.standard_normal((n + 1, nz, nz))
    L_zz = 0.2 * A @ A.transpose(0, 2, 1) + 0.1 * np.eye(nz)
    R = rng.standard_normal((n, nu, nu))
    L_uu = R @ R.transpose(0, 2, 1) + 0.5 * np.eye(nu)
    L_uz = 0.05 * rng.standard_normal((n, nu, nz))
    return dict(Z=rng.standard_normal((n + 1, nz)), F_z=F_z, F_u=F_u,
                L=rng.standard_normal(n + 1),
                L_z=rng.standard_normal((n + 1, nz)),
                L_u=rng.standard_normal((n, nu)), L_zz=L_zz, L_uz=L_uz,
                L_uu=L_uu)


RICCATI_ARGS = ("Z", "F_z", "F_u", "L", "L_z", "L_u", "L_zz", "L_uz", "L_uu")


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pddp_tpu.controllers.ilqr import ILQROptions
    from pddp_tpu.encoding import StateEncoding, encode
    from pddp_tpu.examples.cartpole import (CartpoleCost,
                                            CartpoleDynamicsModel)
    from pddp_tpu.ops.riccati import parallel_backward
    from pddp_tpu.parallel import batched_solve

    out = {}

    def store(name, r):
        for f in FIELDS:
            out["{}_{}".format(name, f)] = np.asarray(getattr(r, f))

    model = CartpoleDynamicsModel(dt=DT)
    cost = CartpoleCost()
    enc = StateEncoding.IGNORE_UNCERTAINTY
    z0s, U0s = (jnp.asarray(a) for a in cartpole_problem())
    for name, kw in (("cartpole_scan", {}),
                     ("cartpole_parallel", {"riccati_mode": "parallel"}),
                     ("cartpole_box", {"u_min": jnp.asarray(BOX[0]),
                                       "u_max": jnp.asarray(BOX[1])})):
        store(name, batched_solve(model, cost, z0s, U0s,
                                  ILQROptions(**CARTPOLE_OPTS, **kw),
                                  encoding=enc))

    chol = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    leaves, buffers = bnn_inputs()
    bnn = bnn_path.jax_model(leaves, buffers, horizon=BNN_N + 1)
    m0, v0, offsets, U0b = bnn_problem()
    z0 = encode(jnp.asarray(m0), V=jnp.asarray(v0), encoding=chol)
    store("bnn", batched_solve(bnn, CartpoleCost(), z0 + jnp.asarray(offsets),
                               jnp.asarray(U0b), ILQROptions(**BNN_OPTS),
                               encoding=chol, chunk=BNN_CHUNK))

    for c, (nz, nu, n, reg) in enumerate(RICCATI_CASES):
        ins = riccati_inputs(nz, nu, n, seed=100 + c)
        k, K, ok = parallel_backward(
            *(jnp.asarray(ins[a]) for a in RICCATI_ARGS), reg=reg)
        out["riccati{}_k".format(c)] = np.asarray(k)
        out["riccati{}_K".format(c)] = np.asarray(K)
        out["riccati{}_ok".format(c)] = np.asarray(ok)
    np.savez(PATH, **out)
    print("wrote", PATH)
    for name in CASES:
        print(name, "state", out[name + "_state"], "iterations",
              out[name + "_iterations"], "evals", out[name + "_evals"])


if __name__ == "__main__":
    main()
