"""``pddp_tpu_torch.parallel`` against ``pddp_tpu.parallel`` in float64 on
the CPU.

One world of four gloo processes (``tests/_parallel_world.py``), started
once for the module, runs every sharded case: the particle-sharded BNN
solves under the Cholesky and the std codec and on a 2 x 2 ``dp`` x
``pp`` mesh, the batch-sharded pendulum (whole and chunked), the
horizon-sharded parallel Riccati, one ``dp_train_step``, the ValueErrors
of indivisible sizes, and the all-reduce under ``vmap(jvp)`` and reverse
mode. Each result is held against ``tests/golden/parallel_solves.npz``
(``pddp_tpu``'s sharded functions on a four-device virtual mesh) to the
tolerances of ``pddp_tpu``'s ``tests/parallel/``, and against the port's
unsharded functions, run in this process while the world runs. Also here:
``utils.optim`` against optax, and the reference-name aliases.
"""

import multiprocessing
import socket

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pddp_tpu.models.bnn as jbnn
import pddp_tpu.utils.angular as jangular
import pddp_tpu.utils.evaluation as jevaluation
from pddp_tpu_torch import parallel
from pddp_tpu_torch.controllers.ilqr import solve, solve_lanes
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.models import bnn as tbnn
from pddp_tpu_torch.ops.riccati import parallel_backward
from pddp_tpu_torch.utils import angular as tangular
from pddp_tpu_torch.utils import evaluation as tevaluation
from pddp_tpu_torch.utils import optim
from pddp_tpu_torch.utils.evaluation import eval_dynamics
from tests import _parallel_world as pw
from tests.golden import parallel_solves as golden

SIZE = 4
F64 = torch.float64
# pddp_tpu's tests/parallel/ tolerances: test_particles.py:48-51,
# test_horizon.py:39-42, test_batch.py:38-39 and :70.
PARTICLE_TOL = {"J_opt": (1e-9, 0.0), "U": (1e-7, 1e-10),
                "Z": (1e-7, 1e-10), "K": (1e-6, 1e-8)}
HORIZON_TOL = (1e-7, 1e-10)
BATCH_TOL = {"J_opt": (1e-5, 0.0), "U": (1e-4, 1e-6)}
ENDS = ("state", "iterations", "evals")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _references(data):
    """The port's unsharded counterparts of the world's cases."""
    refs = {}
    model = pw.bnn_model(data)
    for label in ("chol", "std"):
        cost, z0, U0, opts, enc = pw.bnn_problem(data, label)
        refs["psolve_" + label] = pw.as_numpy(
            solve(model, cost, z0, U0, opts, encoding=enc))
    cost, z0, U0, opts, enc = pw.bnn_problem(data, "chol")
    refs["jac"] = [t.numpy() for t in eval_dynamics(
        model, z0, U0[0], 1, encoding=enc, aux=model.eps_in[1])]
    refs["pbsolve"] = pw.as_numpy(solve_lanes(
        model, cost, torch.as_tensor(data["pbsolve_z0s"], dtype=F64),
        torch.full((golden.PB_B, golden.H, 1), 0.1, dtype=F64), opts,
        encoding=enc))
    pend, pcost, z0s, U0s, bopts = pw.pendulum_problem(data)
    refs["batch"] = pw.as_numpy(parallel.batched_solve(
        pend, pcost, z0s, U0s, bopts,
        encoding=StateEncoding.IGNORE_UNCERTAINTY))
    for n in (golden.HORIZON_H, golden.HORIZON_H - 1, golden.HORIZON_H - 2):
        refs["horizon{}".format(n)] = [
            t.numpy() for t in parallel_backward(*pw.horizon_derivs(data, n))]
    return refs


@pytest.fixture(scope="module")
def world():
    """(results by rank, unsharded references, the stored npz)."""
    data = pw.load()
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=pw.run, args=(r, SIZE, port, queue),
                         daemon=True) for r in range(SIZE)]
    for p in procs:
        p.start()
    try:
        refs = _references(data)
        results = dict(queue.get(timeout=180) for _ in range(SIZE))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    errors = [r["error"] for r in results.values() if "error" in r]
    assert not errors, errors[0]
    return results, refs, data


def _close(a, b, tol, what):
    rtol, atol = tol
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _hold(res, prefix, ref, tols, what):
    for f in ENDS:
        np.testing.assert_array_equal(res[prefix + f], ref[f],
                                      err_msg=what + " " + f)
    for f, tol in tols.items():
        _close(res[prefix + f], ref[f], tol, what + " " + f)


def _stored(data, prefix):
    return {f: data[prefix + "_" + f] for f in pw.FIELDS}


@pytest.mark.parametrize("label", ["chol", "std"])
def test_particle_sharded_solve(world, label):
    results, refs, data = world
    prefix = "psolve_{}_".format(label)
    _hold(results[0], prefix, _stored(data, "psolve_" + label),
          PARTICLE_TOL, "against pddp_tpu")
    _hold(results[0], prefix, refs["psolve_" + label], PARTICLE_TOL,
          "against the unsharded port")
    for r in range(1, SIZE):   # every rank returns the same solve
        for f in pw.FIELDS:
            np.testing.assert_array_equal(results[r][prefix + f],
                                          results[0][prefix + f])


def test_particle_sharded_structured_jacobians(world):
    """One rank's block of the particles gives the unsharded model's
    structured Jacobians through the all-reduce's tangents; the K2(d)
    gate refuses the sharded model."""
    results, refs, _ = world
    for r in range(SIZE):
        for key, ref in zip(("jac_z_next", "jac_F_z", "jac_F_u"),
                            refs["jac"]):
            _close(results[r][key], ref, (1e-12, 1e-14), key)
        assert not results[r]["k2d_supports_sharded"]


def test_particle_sharded_batched_solve_2d_mesh(world):
    results, refs, data = world
    for r in range(SIZE):
        _hold(results[r], "pbsolve_", _stored(data, "pbsolve"),
              PARTICLE_TOL, "rank {} against pddp_tpu".format(r))
        _hold(results[r], "pbsolve_", refs["pbsolve"], PARTICLE_TOL,
              "rank {} against the unsharded port".format(r))


@pytest.mark.parametrize("label", ["batch", "batch_chunk"])
def test_batch_sharded_solve(world, label):
    """Against pddp_tpu to its tolerances, and in float64 the bits of the
    unsharded port's lanes."""
    results, refs, data = world
    for r in range(SIZE):
        _hold(results[r], label + "_", _stored(data, label), BATCH_TOL,
              "rank {} against pddp_tpu".format(r))
        for f in pw.FIELDS:
            np.testing.assert_array_equal(results[r][label + "_" + f],
                                          refs["batch"][f])


@pytest.mark.parametrize("case, match", [
    ("raise_particles", "n_particles 10 not divisible"),
    ("raise_batch", "batch 6 not divisible by mesh axis"),
    ("raise_chunk", "batch 16 not divisible by chunk 6"),
    ("raise_chunk_size", "chunk 2 not divisible by mesh size 4"),
])
def test_indivisible_sizes_raise(world, case, match):
    results, _, _ = world
    for r in range(SIZE):
        assert results[r][case] is not None and match in results[r][case]


@pytest.mark.parametrize("n", [golden.HORIZON_H, golden.HORIZON_H - 1,
                               golden.HORIZON_H - 2])
def test_horizon_sharded_riccati(world, n):
    """N = 64 runs the two-level scan, each rank its block of 16 steps;
    N = 63 gathers the 64-long leaves and N = 62 shards nothing, each
    rank then returning the whole horizon."""
    results, refs, data = world
    key = "horizon{}".format(n)
    k_ref, K_ref, ok_ref = refs[key]
    if n == golden.HORIZON_H:
        k = np.concatenate([results[r][key + "_k"] for r in range(SIZE)])
        K = np.concatenate([results[r][key + "_K"] for r in range(SIZE)])
        _close(k, data["horizon_k"], HORIZON_TOL, "k against pddp_tpu")
        _close(K, data["horizon_K"], HORIZON_TOL, "K against pddp_tpu")
    for r in range(SIZE):
        if n != golden.HORIZON_H:
            k, K = results[r][key + "_k"], results[r][key + "_K"]
        assert bool(results[r][key + "_ok"]) and bool(ok_ref)
        _close(k, k_ref, HORIZON_TOL, "k against the unsharded port")
        _close(K, K_ref, HORIZON_TOL, "K against the unsharded port")


def test_shard_over_horizon_blocks(world):
    """Each rank's block of the N-long leaves, the N+1-long ones whole."""
    results, _, _ = world
    for r in range(SIZE):
        assert list(results[r]["horizon_parts"]) == [
            "whole", "block", "block", "whole", "whole", "block", "whole",
            "block", "block"]


def test_dp_train_step(world):
    results, _, data = world
    W0, x, y = (torch.as_tensor(data[k]) for k in ("dp_W0", "dp_x", "dp_y"))
    W = W0.clone().requires_grad_(True)
    loss = pw.dp_loss(W, {"x": x, "y": y})
    (g,) = torch.autograd.grad(loss, W)
    opt = optim.sgd(0.1)
    W_ref = optim.apply_updates(W0, opt.update(g, opt.init(W0), W0)[0])
    for r in range(SIZE):
        # pddp_tpu's 1e-5 (test_batch.py:70); float64 holds 1e-12.
        _close(results[r]["dp_W"], data["dp_W"], (1e-12, 1e-14), "W")
        _close(results[r]["dp_loss"], data["dp_loss"], (1e-12, 0.0), "loss")
        _close(results[r]["dp_W"], W_ref.numpy(), (1e-12, 1e-14), "W")
        _close(results[r]["dp_loss"], loss.detach().numpy(), (1e-12, 0.0),
               "loss")


def test_all_reduce_under_vmap_jvp_and_grad(world):
    """The sum all-reduce's forward-mode and batching rules give every
    rank the Jacobian of its output with respect to the shared input (all
    ranks move their x together), and its backward the gradient of the
    summed outputs, as one process computes them over the stacked x."""
    results, _, _ = world
    xs = torch.stack([pw.collective_input(r) for r in range(SIZE)])

    def whole(X):
        s = (X * X).sum(0)
        return torch.sin(s) * X

    J = torch.autograd.functional.jacobian(whole, xs)   # (S, 3, S, 3)
    X = xs.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(whole(X).sum(), X)
    for r in range(SIZE):
        J_shared = J[r].sum(dim=1)   # (3, 3): d y_r / d x, x shared
        _close(results[r]["collective_J"], J_shared.T.numpy(),
               (1e-13, 1e-15), "vmap(jvp)")
        _close(results[r]["collective_grad"], g[r].numpy(), (1e-13, 1e-15),
               "grad")


def test_replicate_and_specs(world):
    results, _, data = world
    for r in range(SIZE):
        np.testing.assert_array_equal(results[r]["replicated"], [0.0, 0.0])
    specs = parallel.particle_partition_specs(pw.bnn_model(data), "pp")
    assert specs["eps_in"] == specs["eps_out"] == 1
    assert specs["net.dropouts.0.noise"] == specs["net.dropouts.1.noise"] == 0
    assert specs["net.layers.0.W"] is None and specs["X_mean"] is None
    assert {k for k, v in specs.items() if v is not None} == {
        "eps_in", "eps_out", "net.dropouts.0.noise", "net.dropouts.1.noise"}


def test_exports():
    assert sorted(parallel.__all__) == sorted([
        "batched_solve", "dp_train_step", "make_mesh", "replicate",
        "particle_partition_specs", "particle_sharded_solve",
        "particle_sharded_batched_solve", "shard_over_horizon"])


@pytest.mark.parametrize("name", ["sgd", "amsgrad"])
def test_optim_matches_optax(name):
    """Four steps on a tree of two leaves, float64, each gradient drawn
    anew: the updates and the parameters equal optax's to rounding."""
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((3, 2)), "b": rng.standard_normal(4)}
    jopt = getattr(optax, name)(0.05)
    topt = getattr(optim, name)(0.05)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.as_tensor(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = {k: rng.standard_normal(v.shape) for k, v in p0.items()}
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        tu, ts = topt.update({k: torch.as_tensor(v) for k, v in g.items()},
                             ts, tp)
        jp, tp = optax.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        for k in p0:
            _close(tu[k].numpy(), np.asarray(ju[k]), (1e-14, 1e-16), k)
            _close(tp[k].numpy(), np.asarray(jp[k]), (1e-14, 1e-16), k)


def test_reference_name_aliases():
    assert tbnn.BSequential is tbnn.BayesianMLP
    assert tbnn.bayesian_model is tbnn.bayesian_mlp
    assert jbnn.BSequential is jbnn.BayesianMLP
    assert tevaluation.batch_eval_cost is tevaluation.eval_cost
    assert tevaluation.batch_eval_dynamics is tevaluation.eval_dynamics
    assert jevaluation.batch_eval_cost is jevaluation.eval_cost
    for indices, size in (((0, 2), 4), ([1], 3), (np.array([3, 0]), 5),
                          (2, 4), ((), 2)):
        assert (tangular.complementary_indices(indices, size)
                == jangular.complementary_indices(indices, size))
