"""A world of gloo processes that runs the port's sharded functions for
``tests/test_torch_parallel.py``, on the CPU in float64.

``run`` is each rank's body: it joins the process group, runs every case
of ``tests/golden/parallel_solves.npz`` through ``pddp_tpu_torch.parallel``
and puts ``(rank, results)`` on a queue, the results numpy arrays (or the
traceback of a failure under ``"error"``). This module imports neither JAX
nor ``pddp_tpu``: the ranks start from a fresh import of it.
"""

import traceback

import numpy as np
import torch

from tests.golden import parallel_solves as golden

F64 = torch.float64
CPU = "cpu"
FIELDS = golden.FIELDS


def load():
    return dict(np.load(golden.PATH))


def bnn_model(data, n_particles=golden.P):
    """The port's BNN of the stored net and buffers (``n_particles``
    below the stored count takes the first particles)."""
    from pddp_tpu_torch import convert
    leaves = [data["bnn_net_{}".format(i)] for i in range(
        sum(k.startswith("bnn_net_") for k in data))]
    buffers = {k: data["bnn_" + k] for k in golden.BUFFERS}
    if n_particles != golden.P:
        # The dropouts' noise, (P, width), is the only leaf of P rows.
        leaves = [a[:n_particles] if a.ndim == 2 and a.shape[0] == golden.P
                  else a for a in leaves]
        buffers = {k: v[:, :n_particles] if k.startswith("eps") else v
                   for k, v in buffers.items()}
    return convert.bnn(leaves, buffers, 4, 1, list(golden.HIDDEN),
                       angular_indices=(2,), non_angular_indices=(0, 1, 3),
                       device=CPU, dtype=F64, n_particles=n_particles,
                       horizon=golden.H + 1)


def bnn_problem(data, label):
    """(cost, z0, U0, opts, encoding) of the stored particle solve
    ``label`` ("chol" or "std")."""
    from pddp_tpu_torch.controllers.ilqr import ILQROptions
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    enc = (StateEncoding.UPPER_TRIANGULAR_CHOLESKY if label == "chol"
           else StateEncoding.STANDARD_DEVIATION_ONLY)
    return (CartpoleCost(device=CPU, dtype=F64),
            torch.as_tensor(data["psolve_{}_z0".format(label)], dtype=F64),
            torch.full((golden.H, 1), 0.1, dtype=F64),
            ILQROptions(**golden.BNN_OPTS), enc)


def pendulum_problem(data):
    """(model, cost, z0s, U0s, opts) of the stored batched solve."""
    from pddp_tpu_torch.controllers.ilqr import ILQROptions
    from pddp_tpu_torch.examples.pendulum import (PendulumCost,
                                                  PendulumDynamicsModel)
    return (PendulumDynamicsModel(dt=0.1, device=CPU, dtype=F64),
            PendulumCost(device=CPU, dtype=F64),
            torch.as_tensor(data["batch_z0s"], dtype=F64),
            torch.full((golden.BATCH_B, golden.BATCH_N, 1), 0.1, dtype=F64),
            ILQROptions(**golden.BATCH_OPTS))


def horizon_derivs(data, n=golden.HORIZON_H):
    """The stored local model cut to ``n`` steps (its N+1-long leaves to
    n + 1 entries)."""
    H = golden.HORIZON_H
    return tuple(torch.as_tensor(d[:n + 1] if d.shape[0] == H + 1 else d[:n],
                                 dtype=F64)
                 for d in (data["horizon_derivs_{}".format(i)]
                           for i in range(9)))


def dp_loss(W, b):
    return torch.mean((b["x"] @ W - b["y"]) ** 2)


def collective_fn(x, group):
    """sin(the sum over ranks of x * x) * x."""
    from pddp_tpu_torch.parallel.collectives import all_reduce_sum
    return torch.sin(all_reduce_sum(x * x, group)) * x


def collective_input(rank):
    return torch.as_tensor(
        np.random.default_rng(rank).standard_normal(3), dtype=F64)


def as_numpy(r):
    """An ``ILQRResult``'s fields as numpy arrays (numbers as they are)."""
    return {f: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for f, v in ((f, getattr(r, f)) for f in FIELDS)}


def _raises(fn):
    """The message of the ValueError ``fn`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def cases(rank, size):
    """Every case of the world; returns the rank's results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.func import jvp, vmap

    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_bnn_rollout
    from pddp_tpu_torch.ops.riccati import parallel_backward
    from pddp_tpu_torch.parallel import (batched_solve, dp_train_step,
                                         make_mesh,
                                         particle_sharded_batched_solve,
                                         particle_sharded_solve, replicate,
                                         shard_over_horizon)
    from pddp_tpu_torch.parallel.particles import _local_ensemble
    from pddp_tpu_torch.utils.evaluation import eval_dynamics
    from pddp_tpu_torch.utils.optim import sgd

    data = load()
    out = {}
    pp = make_mesh("pp", devices=CPU)
    model = bnn_model(data)
    for label in ("chol", "std"):
        cost, z0, U0, opts, enc = bnn_problem(data, label)
        for f, v in as_numpy(particle_sharded_solve(
                model, cost, z0, U0, opts, encoding=enc, mesh=pp)).items():
            out["psolve_{}_{}".format(label, f)] = v
    cost, z0, U0, opts, enc = bnn_problem(data, "chol")
    local = _local_ensemble(model, pp.get_group("pp"))
    out["k2d_supports_sharded"] = np.asarray(
        fused_bnn_rollout.supports(local, enc))
    zn, F_z, F_u = eval_dynamics(local, z0, U0[0], 1, encoding=enc,
                                 aux=local.eps_in[1])
    out.update(jac_z_next=zn.numpy(), jac_F_z=F_z.numpy(),
               jac_F_u=F_u.numpy())
    out["raise_particles"] = _raises(lambda: particle_sharded_solve(
        bnn_model(data, 10), cost, z0, U0, opts, encoding=enc, mesh=pp))

    mesh2 = init_device_mesh(CPU, (2, size // 2),
                             mesh_dim_names=("dp", "pp"))
    z0s = torch.as_tensor(data["pbsolve_z0s"], dtype=F64)
    for f, v in as_numpy(particle_sharded_batched_solve(
            model, cost, z0s, torch.full((golden.PB_B, golden.H, 1), 0.1,
                                         dtype=F64), opts, encoding=enc,
            mesh=mesh2)).items():
        out["pbsolve_" + f] = v

    dp = make_mesh(devices=CPU)
    pend, pcost, z0s, U0s, bopts = pendulum_problem(data)
    ign = StateEncoding.IGNORE_UNCERTAINTY
    for label, chunk in (("batch", None), ("batch_chunk", golden.BATCH_CHUNK)):
        for f, v in as_numpy(batched_solve(pend, pcost, z0s, U0s, bopts,
                                          encoding=ign, mesh=dp,
                                          chunk=chunk)).items():
            out["{}_{}".format(label, f)] = v
    for label, B, chunk in (("batch", 6, None), ("chunk", 16, 6),
                            ("chunk_size", 16, 2)):
        out["raise_" + label] = _raises(lambda: batched_solve(
            pend, pcost, z0s[:B], U0s[:B], bopts, encoding=ign, mesh=dp,
            chunk=chunk))

    sp = make_mesh("sp", devices=CPU)
    whole = horizon_derivs(data)
    n = golden.HORIZON_H // size
    out["horizon_parts"] = np.array([
        "block" if torch.equal(b, d[rank * n:(rank + 1) * n]) else
        "whole" if b is d else "wrong"
        for d, b in zip(whole, shard_over_horizon(whole, sp, "sp"))])
    for n in (golden.HORIZON_H, golden.HORIZON_H - 1, golden.HORIZON_H - 2):
        k, K, ok = parallel_backward(
            *shard_over_horizon(horizon_derivs(data, n), sp, "sp"),
            group=sp.get_group("sp"))
        out.update({"horizon{}_k".format(n): k.numpy(),
                    "horizon{}_K".format(n): K.numpy(),
                    "horizon{}_ok".format(n): np.asarray(ok)})

    W0 = torch.as_tensor(data["dp_W0"], dtype=F64)
    batch = {"x": torch.as_tensor(data["dp_x"], dtype=F64),
             "y": torch.as_tensor(data["dp_y"], dtype=F64)}
    opt = sgd(0.1)
    W, _, loss = dp_train_step(dp_loss, W0, opt, opt.init(W0), batch, dp)
    out.update(dp_W=W.numpy(), dp_loss=loss.numpy())

    group = dist.group.WORLD
    x = collective_input(rank)
    basis = torch.eye(3, dtype=F64)
    out["collective_J"] = vmap(lambda t: jvp(
        lambda x_: collective_fn(x_, group), (x,), (t,))[1])(basis).numpy()
    xg = x.clone().requires_grad_(True)
    out["collective_grad"] = torch.autograd.grad(
        collective_fn(xg, group).sum(), xg)[0].numpy()
    out["replicated"] = replicate(
        {"a": torch.full((2,), float(rank), dtype=F64), "n": rank},
        dp)["a"].numpy()
    return out


def run(rank, size, port, queue):
    """One rank: join the gloo world at ``tcp://127.0.0.1:<port>``, run
    ``cases`` and put ``(rank, results)`` on ``queue``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{}"
                                .format(port), world_size=size, rank=rank)
        try:
            queue.put((rank, cases(rank, size)))
        finally:
            dist.destroy_process_group()
    except Exception:   # the test process reports it
        queue.put((rank, {"error": traceback.format_exc()}))
