"""The bf16 rows' J against float32 at full width, in both packages.

``chip_smoke.py`` phase 16b holds the BNN's bf16 rows (untrained weights,
``compute_dtype`` or ``matmul_dtype`` bfloat16) against float32 on the
lanes that end alike (state, iterations, evaluations) within the 5 % of
``pddp_tpu``'s ``tests/parallel/test_batch.py:141-170``, and counts the
others (ROADMAP.md, C). This script shows that ``pddp_tpu`` parts the
same lanes: on the first ``B`` lanes of phase 16b's batch (phase 8's net
6-200-200-8, P=100, the Cholesky codec, N=25, 5 iterations, 15
evaluations, float32, the port's untrained weights carried across), it
runs ``batched_solve`` of both packages on the CPU with and without each
knob and prints, per package and knob, each lane's J relative to
float32's and the accepted iterations. JAX compiles each of its three
solves for about two minutes:

    JAX_PLATFORMS=cpu python -m tests.golden.bf16_lanes [B]
"""

import sys
import time

import numpy as np

N = 25
KNOBS = (None, "compute_dtype", "matmul_dtype")


def port_runs(B):
    import torch

    import chip_smoke as cs
    from pddp_tpu_torch.controllers.ilqr import ILQROptions
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.parallel import batched_solve
    z0s, U0s = cs.bnn_batch(torch, torch.float32, "cpu", 1024, N)
    out = {}
    for knob in KNOBS:
        kw = {} if knob is None else {knob: torch.bfloat16}
        model = cs.bnn_model(torch, torch.float32, N, False, device="cpu",
                             **kw)
        r = batched_solve(model, CartpoleCost(device="cpu"), z0s[:B],
                          U0s[:B], ILQROptions(n_iterations=5, max_evals=15),
                          encoding=StateEncoding.UPPER_TRIANGULAR_CHOLESKY)
        out[knob] = tuple(np.asarray(getattr(r, f).numpy()) for f in
                          ("J_opt", "iterations", "evals", "state"))
    return out, model, z0s[:B].numpy(), U0s[:B].numpy()


def jax_runs(model, z0s, U0s):
    import jax
    import jax.numpy as jnp

    from chip_smoke import BNN_JITTER
    from pddp_tpu.controllers.ilqr import ILQROptions
    from pddp_tpu.encoding import StateEncoding
    from pddp_tpu.examples.cartpole import CartpoleCost
    from pddp_tpu.models.bnn import bnn_dynamics_model_factory
    from pddp_tpu.parallel import batched_solve
    from pddp_tpu.struct import replace
    leaves = [jnp.asarray(t.numpy()) for t in model.net.leaves()]
    buffers = {k: jnp.asarray(getattr(model, k).numpy()) for k in (
        "X_mean", "X_std", "dX_mean", "dX_std", "eps_in", "eps_out")}
    out = {}
    for knob in KNOBS:
        kw = {} if knob is None else {knob: jnp.bfloat16}
        cls = bnn_dynamics_model_factory(4, 1, [200, 200],
                                         angular_indices=(2,),
                                         non_angular_indices=(0, 1, 3), **kw)
        m = cls.init(jax.random.PRNGKey(0), n_particles=100, horizon=N + 1,
                     dtype=jnp.float32)
        net = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(m.net), leaves)
        m = replace(m, net=net, chol_jitter=BNN_JITTER, **buffers)
        r = batched_solve(m, CartpoleCost(), jnp.asarray(z0s),
                          jnp.asarray(U0s),
                          ILQROptions(n_iterations=5, max_evals=15),
                          encoding=StateEncoding.UPPER_TRIANGULAR_CHOLESKY)
        out[knob] = tuple(np.asarray(getattr(r, f)) for f in
                          ("J_opt", "iterations", "evals", "state"))
    return out


def report(name, out):
    J32, it32, ev32, st32 = out[None]
    for knob in KNOBS[1:]:
        J, it, ev, st = out[knob]
        rel = np.abs(J - J32) / np.abs(J32)
        same = (it == it32) & (ev == ev32) & (st == st32)
        print("{} {}: J off float32 by at most {:.4g} ({} lanes end alike, "
              "those within {:.4g})".format(
                  name, knob, rel.max(), same.sum(),
                  rel[same].max() if same.any() else float("nan")))
        print("  J rel", np.round(rel, 4).tolist())
        print("  iterations float32", it32.tolist(), "bf16", it.tolist())


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    t0 = time.perf_counter()
    port, model, z0s, U0s = port_runs(B)
    report("pddp_tpu_torch", port)
    report("pddp_tpu", jax_runs(model, z0s, U0s))
    print("seconds", time.perf_counter() - t0)


if __name__ == "__main__":
    main()
