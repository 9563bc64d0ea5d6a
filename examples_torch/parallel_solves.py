"""Scale-out demo: batches of independent solves over the ranks of a
``torch.distributed`` world (port of ``examples/parallel_solves.py``).

The solver is one loop over a lane axis, so

 * a batch of B problem instances is ONE solve of B lanes;
 * the batch shards over the world's ranks (``parallel.make_mesh``), one
   card a rank (no collectives but the final gather);
 * memory-heavy models (the 100-particle BNN) run the batch in fixed-size
   chunks (``chunk=``).

By default the script starts a world of one rank itself (``nccl`` on the
card, ``gloo`` on the CPU); under ``torchrun`` it joins torchrun's world,
one card a rank:

    torchrun --nproc-per-node 4 examples_torch/parallel_solves.py

and prints the world's size beside its rates.

Usage:
    python examples_torch/parallel_solves.py [batch] [horizon] [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _root not in _sys.path:
    _sys.path.insert(0, _root)

import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from examples_torch.utils import device_parser, sync
from pddp_tpu_torch.controllers.ilqr import ILQROptions
from pddp_tpu_torch.device import resolve_device
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.cartpole import (CartpoleCost,
                                              CartpoleDynamicsModel)
from pddp_tpu_torch.parallel import batched_solve, make_mesh

B = 256
H = 100
OPTIONS = {"n_iterations": 10, "max_evals": 30}  # ILQROptions of the batch
DTYPE = torch.float32
ENCODING = StateEncoding.IGNORE_UNCERTAINTY


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(device):
    """This process's rank device: torchrun's world (its environment), or
    a world of one rank started here. Returns (device, whether this call
    started the world)."""
    if dist.is_initialized():
        return device, False
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        dist.init_process_group(backend)
    else:
        kw = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group(
            backend, init_method="tcp://127.0.0.1:{}".format(_free_port()),
            world_size=1, rank=0, **kw)
    return device, True


def report(*args):
    if dist.get_rank() == 0:
        print(*args, flush=True)


def timed(fn, device):
    """(fn's result, wall seconds), the card waited for on both ends."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def main(argv=None):
    parser = device_parser("Batched and particle-sharded solves.")
    parser.add_argument("batch", nargs="?", type=int, default=B)
    parser.add_argument("horizon", nargs="?", type=int, default=H)
    args = parser.parse_args(argv)
    device, started = start_world(resolve_device(args.device))
    try:
        return run(args.batch, args.horizon, device)
    finally:
        if started:
            dist.destroy_process_group()


def run(B, H, device):
    model = CartpoleDynamicsModel(dt=0.05, device=device, dtype=DTYPE)
    cost = CartpoleCost(device=device, dtype=DTYPE)
    opts = ILQROptions(**OPTIONS)

    # B problem instances: perturbed initial states around hanging rest.
    z0s = torch.as_tensor(
        0.05 * np.random.default_rng(0).standard_normal((B, 4)),
        dtype=DTYPE, device=device)
    U0s = 0.1 * torch.ones((B, H, 1), dtype=DTYPE, device=device)

    mesh = make_mesh(devices=device.type)
    n_dev = dist.get_world_size()
    report(f"{B} cartpole solves (H={H}) over a {n_dev}-rank world "
           f"[{device.type}]")

    def solve(chunk=None):
        return batched_solve(model, cost, z0s, U0s, opts, encoding=ENCODING,
                             mesh=mesh, chunk=chunk)

    # Warm-up, then timed run.
    solve()
    r, dt = timed(solve, device)
    J = r.J_opt.detach().cpu().numpy()
    report(f"  sharded: {dt * 1e3:8.1f} ms  ({B / dt:9.0f} solves/s, "
           f"{n_dev} ranks)  J mean {J.mean():.2f}  all finite: "
           f"{bool(np.isfinite(J).all())}")

    # Chunked variant: same results, bounded peak memory. The chunk must
    # divide the batch and the world's size must divide the chunk; fall
    # back to the whole batch when no such chunk exists.
    chunk = B
    for c in range(max(n_dev, B // 4), B):
        if B % c == 0 and c % n_dev == 0:
            chunk = c
            break
    solve(chunk)
    r_c, dt_c = timed(lambda: solve(chunk), device)
    report(f"  chunked ({chunk}): {dt_c * 1e3:8.1f} ms  "
           f"({B / dt_c:9.0f} solves/s, {n_dev} ranks)  max |dJ| vs full: "
           f"{float((r_c.J_opt - r.J_opt).abs().max()):.2e}")

    rp = particle_sharded_demo(n_dev, device)
    return r, r_c, rp


def particle_sharded_demo(n_dev, device):
    """The model-parallel axis: ONE probabilistic solve with its
    MC-dropout ensemble sharded over the world's ranks (the moment
    match's sums are all-reduced). Scales the fidelity of a solve, not the
    number of solves."""
    from pddp_tpu_torch.encoding import encode
    from pddp_tpu_torch.models.bnn import bnn_dynamics_model_factory
    from pddp_tpu_torch.parallel import particle_sharded_solve

    enc = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    # Production shapes on the card; tiny on the CPU.
    on_card = device.type == "cuda"
    Hp = 25 if on_card else 4
    particles = (128 if on_card else 2) * n_dev
    hidden = [200, 200] if on_card else [16, 16]
    cls = bnn_dynamics_model_factory(4, 1, hidden, angular_indices=(2,),
                                     non_angular_indices=(0, 1, 3))
    model = cls.init(seed=0, n_particles=particles, horizon=Hp + 1,
                     dtype=DTYPE, device=device)
    cost = CartpoleCost(device=device, dtype=DTYPE)
    z0 = encode(torch.zeros(4, dtype=DTYPE, device=device),
                V=1e-2 * torch.ones(4, dtype=DTYPE, device=device),
                encoding=enc)
    U0 = 0.1 * torch.ones((Hp, 1), dtype=DTYPE, device=device)
    opts = ILQROptions(n_iterations=5 if on_card else 1,
                       max_evals=15 if on_card else 3)

    mesh = make_mesh("pp", devices=device.type)

    def solve():
        return particle_sharded_solve(model, cost, z0, U0, opts,
                                      encoding=enc, mesh=mesh)

    solve()
    r, dt = timed(solve, device)
    report(f"  particle-sharded PDDP solve ({particles} particles over "
           f"{n_dev} ranks, H={Hp}): {dt * 1e3:8.1f} ms  "
           f"J {float(r.J_opt):.2f}")
    return r


if __name__ == "__main__":
    main()
