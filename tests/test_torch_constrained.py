"""The port's box-QP, constrained and V_zz-regularized backward against
pddp_tpu, and the constrained and v_zz_reg golden solves.

``utils.constraint.boxqp`` runs batches of seeded QPs (D = 1..4, bounds
that bind, an all-clamped lane, a lane whose free block is not positive
definite) against JAX's vmapped ``boxqp``: x, the status, the free mask
and the masked factor. The three non-default modes of ``backward``
(v_zz_reg, constrained, both) run at N=8 against JAX's. The golden solves
are held against tests/golden/solver_trajectories.npz at
tests/controllers/test_golden.py's tolerances, with the JAX solves' end
states. Everything in float64 on the CPU; tolerance 1e-12 unless stated.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu.controllers import ilqr as jilqr
from pddp_tpu.utils.constraint import boxqp as j_boxqp
from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers import ilqr as tilqr
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.cartpole import CartpoleCost, CartpoleDynamicsModel
from pddp_tpu_torch.examples.pendulum import PendulumCost, PendulumDynamicsModel
from pddp_tpu_torch.utils.constraint import (BOXQP_RESULTS, boxqp,
                                             chol_solve, masked_cholesky)

torch.set_num_threads(1)

IGN = StateEncoding.IGNORE_UNCERTAINTY
TOL = dict(rtol=1e-12, atol=1e-12)
F64 = dict(device="cpu", dtype=torch.float64)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "solver_trajectories.npz")


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(kw or TOL))


def _qps(D, seed):
    """Six QPs of size D: four seeded PD ones with bounds of +-0.1 to
    +-1e3 (tight ones bind), one all-clamped, one indefinite."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((6, D, D))
    Q = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(D)
    c = 3.0 * rng.standard_normal((6, D))
    half = np.array([0.1, 0.3, 1.0, 1e3, 0.5, 1.0])[:, None] * np.ones(D)
    x0 = rng.uniform(-0.05, 0.05, (6, D))
    Q[4], c[4], x0[4] = np.eye(D), 10.0, 0.0          # all clamped
    Q[5] = np.diag(np.r_[-1.0, np.ones(D - 1)])       # not PD
    c[5], x0[5] = 0.0, 0.0
    return x0, Q, c, -half, half


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_boxqp_matches_jax(D):
    """Every lane of a batch against JAX's vmapped boxqp: x, result, free
    and U_free; the statuses cover 4 or 5 (converged), 6 (all clamped) and
    -1 (not positive definite)."""
    x0, Q, c, lo, hi = _qps(D, D)
    got = boxqp(*(_t(a) for a in (x0, Q, c, lo, hi)))
    want = jax.jit(jax.vmap(j_boxqp))(*(jnp.asarray(a)
                                        for a in (x0, Q, c, lo, hi)))
    _close(got.x, want.x)
    _close(got.U_free, want.U_free)
    np.testing.assert_array_equal(got.result.numpy(), np.asarray(want.result))
    np.testing.assert_array_equal(got.free.numpy(), np.asarray(want.free))
    assert got.result.dtype == torch.int32
    res = got.result.tolist()
    assert res[4] == 6 and res[5] == -1 and all(r >= 1 for r in res[:4])
    assert all(r in BOXQP_RESULTS for r in res)
    assert bool((got.x >= _t(lo)).all() and (got.x <= _t(hi)).all())
    # The tightest box binds: some dimension sits on a bound, clamped.
    assert not bool(got.free[0].all()) or D == 1


def test_masked_cholesky_and_chol_solve():
    """The masked factor solves the free block and leaves clamped entries
    alone; a non-PD free block reports ok=False."""
    rng = np.random.default_rng(9)
    M = rng.standard_normal((4, 4))
    Q = _t(M @ M.T + np.eye(4))
    free = torch.tensor([True, False, True, True])
    U, ok = masked_cholesky(Q, free)
    b = _t(rng.standard_normal(4)) * free
    x = chol_solve(U, b)
    assert bool(ok) and float(x[1]) == 0.0
    idx = [0, 2, 3]
    _close(x[idx], torch.linalg.solve(Q[idx][:, idx], b[idx]), rtol=1e-10,
           atol=1e-10)
    assert not bool(masked_cholesky(-Q, free)[1])


def _riccati_inputs(seed, N, nz, nu):
    """Riccati inputs with a PSD joint Hessian of (z, u) per step."""
    rng = np.random.default_rng(seed)
    n = nz + nu
    F_z = np.eye(nz) + 0.1 * rng.standard_normal((N, nz, nz))
    F_u = 0.3 * rng.standard_normal((N, nz, nu))
    M = rng.standard_normal((N, n, n))
    H = M @ np.swapaxes(M, -1, -2) / n + 0.1 * np.eye(n)
    Mt = rng.standard_normal((nz, nz))
    L_zz = np.concatenate([H[:, :nz, :nz],
                           (Mt @ Mt.T / nz + 0.1 * np.eye(nz))[None]])
    return (np.zeros((N + 1, nz)), F_z, F_u, np.zeros(N + 1),
            3.0 * rng.standard_normal((N + 1, nz)),
            3.0 * rng.standard_normal((N, nu)), L_zz,
            np.ascontiguousarray(H[:, nz:, :nz]),
            np.ascontiguousarray(H[:, nz:, nz:]))


@pytest.mark.parametrize("nu", [1, 2])
@pytest.mark.parametrize("v_zz_reg,constrained", [(True, False),
                                                  (False, True),
                                                  (True, True)],
                         ids=["vzz", "boxqp", "boxqp_vzz"])
def test_backward_modes_match_jax(nu, v_zz_reg, constrained):
    """N=8, nz=4: k, K and ok at 1e-10 (the box-QP's iterates and the
    Cholesky solves compound the order of sums); the bounds bind."""
    ins = _riccati_inputs(nu, 8, 4, nu)
    U = 0.2 * np.random.default_rng(nu).standard_normal((8, nu))
    kw = dict(reg=0.5, v_zz_reg=v_zz_reg)
    lo, hi = -0.4 * np.ones(nu), 0.4 * np.ones(nu)
    if constrained:
        tkw = dict(kw, u_min=_t(lo), u_max=_t(hi), U=_t(U))
        jkw = dict(kw, u_min=jnp.asarray(lo), u_max=jnp.asarray(hi),
                   U=jnp.asarray(U))
    else:
        tkw = jkw = kw
    k, K, ok = tilqr.backward(*(_t(a) for a in ins), **tkw)
    kj, Kj, okj = jilqr.backward(*(jnp.asarray(a) for a in ins), **jkw)
    assert bool(ok) == bool(okj) and bool(ok)
    _close(k, kj, rtol=1e-10, atol=1e-10)
    _close(K, Kj, rtol=1e-10, atol=1e-10)
    if constrained:
        assert bool(((_t(U) + k - _t(hi)).abs() < 1e-12).any()
                    or ((_t(U) + k - _t(lo)).abs() < 1e-12).any())


# The JAX solves' end states (state, accepted iterations, evaluations).
CASES = {
    "cartpole_boxqp": (("CONVERGED", 7, 12), 40,
                       dict(u_min=[-0.75], u_max=[0.75])),
    "pendulum_vzz": (("CONVERGED", 44, 55), 50, dict(v_zz_reg=True)),
    "pendulum_boxqp_vzz": (("ACCEPTED", 50, 68), 50,
                           dict(u_min=[-2.0], u_max=[2.0], v_zz_reg=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_solves(name):
    """The golden case at test_golden.py's tolerances, through the kernel
    options (on the CPU, and by pddp_tpu's gate for K1, the scan
    backward), with the JAX solve's end state; a constrained solve keeps
    its actions within the bounds."""
    outcome, iters, extra = CASES[name]
    if name.startswith("cartpole"):
        model, cost = CartpoleDynamicsModel(dt=0.05, **F64), CartpoleCost(**F64)
        z0 = torch.tensor([0.0, 0.0, 0.1, 0.0], dtype=torch.float64)
    else:
        model, cost = PendulumDynamicsModel(dt=0.1, **F64), PendulumCost(**F64)
        z0 = torch.zeros(2, dtype=torch.float64)
    r = tilqr.solve(model, cost, z0, torch.as_tensor(convert.golden_U0(name)),
                    tilqr.ILQROptions(n_iterations=iters, riccati_mode="kernel",
                                      fused_rollout=True, **extra),
                    encoding=IGN)
    g = np.load(GOLDEN)
    np.testing.assert_allclose(r.J_opt, g[name + "_J"], rtol=1e-6)
    np.testing.assert_allclose(r.Z.numpy(), g[name + "_Z"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(r.U.numpy(), g[name + "_U"], rtol=1e-5,
                               atol=1e-7)
    assert (r.state.name, r.iterations, r.evals) == outcome
    if "u_max" in extra:
        assert float(r.U.max()) <= extra["u_max"][0] + 1e-9
        assert float(r.U.min()) >= extra["u_min"][0] - 1e-9
