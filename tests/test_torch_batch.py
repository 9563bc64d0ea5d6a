"""Batched solves of the port against pddp_tpu, lane by lane.

``pddp_tpu_torch.parallel.batched_solve`` against
``pddp_tpu.parallel.batched_solve`` in float64 on the CPU: the cartpole at
B=6 under the scan and the parallel (associative-scan) Riccati, with and
without action bounds, and a small belief-state BNN in chunks of two.
JAX's side is stored in tests/golden/batched_solves.npz (its vmapped
solve loops take minutes to compile here; ``python -m
tests.golden.batched_solves`` regenerates it). Each lane's state,
iterations and evaluations are equal to pddp_tpu's, and J, Z, U, K, mu
and delta within 1e-9 of the lane's largest entry (float64; the local
model's sums run in another order).

Also: chunked equal to unchunked, bit for bit; one lane equal to the
port's ``solve``; ``riccati_mode="kernel"`` with ``fused_rollout`` equal
to the scan on the CPU (where the wrappers run their plain versions);
the Riccati backward of each mode with a reg per lane equal to one call
per lane; ``parallel_backward`` against pddp_tpu's and against the
sequential backward; the BNN's ``compute_dtype`` and ``matmul_dtype``
against pddp_tpu's forward.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers.ilqr import (ILQROptions, backward, solve,
                                             solve_lanes)
from pddp_tpu_torch.encoding import StateEncoding, encode
from pddp_tpu_torch.examples.cartpole import CartpoleCost, CartpoleDynamicsModel
from pddp_tpu_torch.ops import backward_kernel as bk
from pddp_tpu_torch.ops import fused_rollout as fr
from pddp_tpu_torch.ops.riccati import parallel_backward
from pddp_tpu_torch.parallel import batched_solve
from tests.golden import batched_solves as g
from tests.golden import bnn_path

torch.set_num_threads(1)

IGN = StateEncoding.IGNORE_UNCERTAINTY
CH = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
REL = 1e-9
VALUES = ("Z", "U", "K", "J_opt", "mu", "delta")
COUNTS = ("state", "iterations", "evals")
CARTPOLE = {"cartpole_scan": {}, "cartpole_parallel":
            {"riccati_mode": "parallel"},
            "cartpole_box": {"u_min": g.BOX[0], "u_max": g.BOX[1]}}


@pytest.fixture(scope="module")
def ref():
    return np.load(g.PATH)


@pytest.fixture(scope="module")
def cartpole():
    model = CartpoleDynamicsModel(dt=g.DT, device="cpu", dtype=torch.float64)
    cost = CartpoleCost(device="cpu", dtype=torch.float64)
    z0s, U0s = (torch.as_tensor(a) for a in g.cartpole_problem())
    return model, cost, z0s, U0s


@pytest.fixture(scope="module")
def cartpole_runs(cartpole):
    """Each cartpole case's unchunked batched solve, run once."""
    model, cost, z0s, U0s = cartpole
    return {name: batched_solve(model, cost, z0s, U0s,
                                ILQROptions(**g.CARTPOLE_OPTS, **kw),
                                encoding=IGN)
            for name, kw in CARTPOLE.items()}


@pytest.fixture(scope="module")
def bnn():
    leaves, buffers = g.bnn_inputs()
    model = convert.bnn(leaves, buffers, bnn_path.STATE, bnn_path.ACTION,
                        bnn_path.HIDDEN, angular_indices=bnn_path.ANGULAR,
                        non_angular_indices=bnn_path.NON_ANGULAR,
                        n_particles=bnn_path.P, horizon=g.BNN_N + 1,
                        chol_jitter=bnn_path.JITTER, device="cpu",
                        dtype=torch.float64)
    m0, v0, offsets, U0s = g.bnn_problem()
    z0 = encode(torch.as_tensor(m0), V=torch.as_tensor(v0), encoding=CH)
    z0s = z0 + torch.as_tensor(offsets)
    cost = CartpoleCost(device="cpu", dtype=torch.float64)
    run = batched_solve(model, cost, z0s, torch.as_tensor(U0s),
                        ILQROptions(**g.BNN_OPTS), encoding=CH,
                        chunk=g.BNN_CHUNK)
    return model, cost, z0s, torch.as_tensor(U0s), run


def _lanes_match(r, ref, name):
    B = ref[name + "_state"].shape[0]
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(r, f).numpy(),
                                      ref["{}_{}".format(name, f)],
                                      err_msg=f)
    for f in VALUES:
        got, want = getattr(r, f).numpy(), ref["{}_{}".format(name, f)]
        assert got.shape == want.shape, (f, got.shape, want.shape)
        for b in range(B):
            err = np.abs(got[b] - want[b]).max()
            assert err <= REL * max(np.abs(want[b]).max(), 1e-300), (
                f, b, err)


def _bit_equal(a, b):
    for f in VALUES + COUNTS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("name", sorted(CARTPOLE))
def test_cartpole_lanes_match_pddp_tpu(cartpole_runs, ref, name):
    """The fixture's lanes end differently, so each lane's own status
    machine is what is held."""
    ends = set(zip(ref[name + "_iterations"], ref[name + "_evals"]))
    assert len(ends) > 2, ends
    _lanes_match(cartpole_runs[name], ref, name)


def test_bnn_lanes_match_pddp_tpu(bnn, ref):
    """Chunks of two, as pddp_tpu's run: three lanes end MAX_REG after 11
    evaluations, one CONVERGED after 2 (the inner loop runs on while
    lanes that accepted wait)."""
    assert sorted(ref["bnn_evals"]) == [2, 11, 11, 11]
    _lanes_match(bnn[4], ref, "bnn")


@pytest.mark.parametrize("case", ["cartpole_scan", "bnn"])
def test_chunked_equals_unchunked(cartpole, cartpole_runs, bnn, case):
    if case == "bnn":
        model, cost, z0s, U0s, chunked = bnn
        whole = batched_solve(model, cost, z0s, U0s,
                              ILQROptions(**g.BNN_OPTS), encoding=CH)
    else:
        model, cost, z0s, U0s = cartpole
        whole = cartpole_runs[case]
        chunked = batched_solve(model, cost, z0s, U0s,
                                ILQROptions(**g.CARTPOLE_OPTS), encoding=IGN,
                                chunk=3)
    _bit_equal(chunked, whole)


@pytest.mark.parametrize("name,lane", [("cartpole_scan", 3),
                                       ("cartpole_parallel", 0),
                                       ("cartpole_box", 0)])
def test_one_lane_equals_solve(cartpole, name, lane):
    """B=1 against the port's unbatched ``solve``: the same end, the same
    mu and delta; the values within 1e-12 (a batched product sums in
    another order than an unbatched one)."""
    model, cost, z0s, U0s = cartpole
    opts = ILQROptions(**g.CARTPOLE_OPTS, **CARTPOLE[name])
    r = solve_lanes(model, cost, z0s[lane:lane + 1], U0s[lane:lane + 1],
                    opts, encoding=IGN)
    s = solve(model, cost, z0s[lane], U0s[lane], opts, encoding=IGN)
    assert (int(r.state[0]), int(r.iterations[0]), int(r.evals[0])) == (
        int(s.state), s.iterations, s.evals)
    assert (float(r.mu[0]), float(r.delta[0])) == (s.mu, s.delta)
    assert float(r.J_opt[0]) == pytest.approx(s.J_opt, rel=1e-12)
    for f in ("Z", "U", "K"):
        got, want = getattr(r, f)[0], getattr(s, f)
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max()), f


def test_kernel_options_equal_scan_on_cpu(cartpole):
    """K1 (a reg per lane) and K2(a)'s wrappers on CPU tensors: their
    plain versions, so the batched solve is the scan's to the bit."""
    model, cost, z0s, U0s = cartpole
    launches = (bk.launches, bk.block_launches, dict(fr.launches))
    scan = batched_solve(model, cost, z0s, U0s,
                         ILQROptions(**g.CARTPOLE_OPTS, cost_in_scan=True),
                         encoding=IGN)
    kern = batched_solve(model, cost, z0s, U0s,
                         ILQROptions(**g.CARTPOLE_OPTS, riccati_mode="kernel",
                                     fused_rollout=True), encoding=IGN)
    assert (bk.launches, bk.block_launches, dict(fr.launches)) == launches
    _bit_equal(kern, scan)


def _riccati_lanes(nz, nu, n, B):
    """B seeded local models stacked as lanes."""
    per = [g.riccati_inputs(nz, nu, n, seed=200 + b) for b in range(B)]
    return [torch.as_tensor(np.stack([p[a] for p in per]))
            for a in g.RICCATI_ARGS]


@pytest.mark.parametrize("mode", ["kernel", "scan", "v_zz_reg",
                                  "constrained", "parallel"])
@pytest.mark.parametrize("nz,nu", [(4, 1), (5, 2)])
def test_reg_per_lane_equals_one_call_per_lane(mode, nz, nu):
    """Distinct regs over five lanes, each lane held to a one-lane call
    with its reg as a float: a reg broadcast against the wrong axis (the
    nu = 1 closed form's (..., 1, 1), the Jacobi's (..., nu), v_zz_reg's
    (..., nz, nz)) would mix the lanes."""
    B = 5
    ins = _riccati_lanes(nz, nu, 7, B)
    regs = torch.tensor([0.0, 1e-3, 0.5, 2.0, 40.0], dtype=torch.float64)
    U = torch.as_tensor(np.random.default_rng(1).uniform(-0.5, 0.5,
                                                         (B, 7, nu)))
    kw = {"v_zz_reg": {"v_zz_reg": True},
          "constrained": {"u_min": torch.tensor(-0.3, dtype=torch.float64),
                          "u_max": torch.tensor(0.3, dtype=torch.float64)},
          }.get(mode, {})

    def run(args, reg, lanes):
        if mode == "kernel":
            return bk.kernel_backward(*args, reg=reg)
        if mode == "parallel":
            return parallel_backward(*args, reg=reg)
        return backward(*args, reg=reg, U=U[lanes], **kw)

    k, K, ok = run(ins, regs, slice(None))
    for b in range(B):
        kb, Kb, okb = run([t[b:b + 1] for t in ins], float(regs[b]),
                          slice(b, b + 1))
        assert torch.equal(k[b], kb[0]) and torch.equal(K[b], Kb[0]), b
        assert bool(ok[b]) == bool(okb[0])
    assert not torch.equal(k[0], k[-1])


@pytest.mark.parametrize("case", range(len(g.RICCATI_CASES)))
def test_parallel_backward_matches_pddp_tpu(ref, case):
    nz, nu, n, reg = g.RICCATI_CASES[case]
    ins = g.riccati_inputs(nz, nu, n, seed=100 + case)
    k, K, ok = parallel_backward(
        *(torch.as_tensor(ins[a]) for a in g.RICCATI_ARGS), reg=reg)
    assert bool(ok) == bool(ref["riccati{}_ok".format(case)])
    for got, name in ((k, "k"), (K, "K")):
        want = ref["riccati{}_{}".format(case, name)]
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-10 * np.abs(want).max(), (name, err)
    if reg == 0.0:
        # Against the sequential backward at reg = 0 (the clamp idle):
        # pddp_tpu/ops/riccati.py:35-36.
        kb, Kb, _ = backward(*(torch.as_tensor(ins[a])
                               for a in g.RICCATI_ARGS), reg=0.0)
        assert float((k - kb).abs().max()) <= 1e-10 * float(kb.abs().max())
        assert float((K - Kb).abs().max()) <= 1e-10 * float(Kb.abs().max())


# compute_dtype rounds every activation to bfloat16: one output may land
# an ulp of bfloat16 (2^-8 relative) off where a sum in another order
# crosses a rounding boundary. matmul_dtype rounds only the products'
# operands, identically on both sides; the bfloat16 products are exact in
# float32, so what is left is float32's order of sums.
BF16_TOL = {"compute_dtype": 2.0**-8, "matmul_dtype": 1e-6}


@pytest.mark.parametrize("knob", sorted(BF16_TOL))
def test_bf16_knobs_match_pddp_tpu(knob):
    """The net's forward in float32 with each knob against pddp_tpu's
    BayesianMLP on the same weights, relative to max |out|; the f32
    forward is farther off than the tolerance, so the knob acts."""
    import jax

    from pddp_tpu.models.bnn.network import BayesianMLP, CDropout, Linear
    leaves, buffers = bnn_path.make_inputs()
    f32 = [jnp.asarray(a, jnp.float32) for a in leaves]
    n = len(bnn_path.HIDDEN) + 1
    jnet = BayesianMLP(
        layers=tuple(Linear(W=f32[2 * i], b=f32[2 * i + 1])
                     for i in range(n)),
        dropouts=tuple(CDropout(*f32[2 * n + 4 * i:2 * n + 4 * i + 4])
                       for i in range(n - 1)),
        **{knob: jnp.bfloat16})
    tm = convert.bnn(leaves, buffers, bnn_path.STATE, bnn_path.ACTION,
                     bnn_path.HIDDEN, angular_indices=bnn_path.ANGULAR,
                     non_angular_indices=bnn_path.NON_ANGULAR,
                     n_particles=bnn_path.P, horizon=bnn_path.N + 1,
                     device="cpu", dtype=torch.float32,
                     **{knob: torch.bfloat16})
    x = np.random.default_rng(3).standard_normal(
        (3, bnn_path.P, 6)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnet(v))(jnp.asarray(x)))
    got = tm.net(torch.as_tensor(x))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= BF16_TOL[knob] * scale
    full = tm.net._like(tm.net.layers, tm.net.dropouts)
    full.compute_dtype = full.matmul_dtype = None
    assert np.abs(full(torch.as_tensor(x)).numpy() - want).max() > (
        BF16_TOL["compute_dtype"] * scale)


def test_batched_solve_rejects_a_ragged_chunk_and_a_mesh(cartpole):
    """A ragged chunk raises, with a mesh or without; a mesh is taken (the
    sharded cases are in tests/test_torch_parallel.py): over a 1-rank
    gloo world in this process, the lanes come back with the bits of the
    unsharded batch."""
    import socket

    import torch.distributed as dist

    from pddp_tpu_torch.parallel import make_mesh
    model, cost, z0s, U0s = cartpole
    for mesh in (None, object()):
        with pytest.raises(ValueError, match="not divisible"):
            batched_solve(model, cost, z0s, U0s, ILQROptions(),
                          encoding=IGN, chunk=4, mesh=mesh)
    opts = ILQROptions(n_iterations=1, max_evals=2)
    whole = batched_solve(model, cost, z0s, U0s, opts, encoding=IGN)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{}".format(
        port), world_size=1, rank=0)
    try:
        sharded = batched_solve(model, cost, z0s, U0s, opts, encoding=IGN,
                                mesh=make_mesh(devices="cpu"), chunk=3)
    finally:
        dist.destroy_process_group()
    for f in g.FIELDS:
        assert torch.equal(getattr(sharded, f), getattr(whole, f)), f
