"""The port's example problems (pendulum, double cartpole, rendezvous)
against pddp_tpu, and their golden solves.

Each model's ``apply`` under all five codecs and its Jacobians through
``eval_dynamics``, each cost's value and derivatives, the adjugate
``small_inv``/``small_solve``, and the line search per example under
IGNORE_UNCERTAINTY, VARIANCE_ONLY and the Cholesky codec with bounds
(K2(b)/(c)'s plain version, which the wrapper runs on CPU tensors): the
same numpy-seeded inputs go through both packages in float64 on the CPU.
Tolerance 1e-12 unless stated (the same arithmetic; only the order of sums
and each framework's libm differ), 1e-10 for Jacobians. The golden solves
are held against tests/golden/solver_trajectories.npz at
tests/controllers/test_golden.py's tolerances; the JAX solve loop itself
is not run, the npz holds its result.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu.controllers import ilqr as jilqr
from pddp_tpu.encoding import StateEncoding as JEnc
from pddp_tpu.encoding import encode as j_encode
from pddp_tpu.examples import double_cartpole as jdcp
from pddp_tpu.examples import pendulum as jpend
from pddp_tpu.examples import rendezvous as jrdv
from pddp_tpu.utils.evaluation import eval_cost as j_eval_cost
from pddp_tpu.utils.evaluation import eval_dynamics as j_eval_dynamics
from pddp_tpu.utils.linalg import small_inv as j_small_inv
from pddp_tpu.utils.linalg import small_solve as j_small_solve
from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers import ilqr as tilqr
from pddp_tpu_torch.encoding import StateEncoding, encode
from pddp_tpu_torch.examples import double_cartpole as tdcp
from pddp_tpu_torch.examples import pendulum as tpend
from pddp_tpu_torch.examples import rendezvous as trdv
from pddp_tpu_torch.ops import backward_kernel as bk
from pddp_tpu_torch.ops import fused_rollout as fr
from pddp_tpu_torch.utils.evaluation import eval_cost, eval_dynamics
from pddp_tpu_torch.utils.linalg import small_inv, small_solve

torch.set_num_threads(1)

IGN = StateEncoding.IGNORE_UNCERTAINTY
CHOL = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
VAR = StateEncoding.VARIANCE_ONLY
TOL = dict(rtol=1e-12, atol=1e-12)
F64 = dict(device="cpu", dtype=torch.float64)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "solver_trajectories.npz")

# name -> (JAX model, JAX cost, port model, port cost), the golden cases'
# configurations (tests/golden/cases.py).
EXAMPLES = {
    "pendulum": (jpend.PendulumDynamicsModel(dt=0.1), jpend.PendulumCost(),
                 tpend.PendulumDynamicsModel(dt=0.1, **F64),
                 tpend.PendulumCost(**F64)),
    "double_cartpole": (jdcp.DoubleCartpoleDynamicsModel(dt=0.05),
                        jdcp.DoubleCartpoleCost(),
                        tdcp.DoubleCartpoleDynamicsModel(dt=0.05, **F64),
                        tdcp.DoubleCartpoleCost(**F64)),
    "rendezvous": (jrdv.RendezvousDynamicsModel(dt=0.1), jrdv.RendezvousCost(),
                   trdv.RendezvousDynamicsModel(dt=0.1, **F64),
                   trdv.RendezvousCost(**F64)),
}


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(kw or TOL))


def _belief(rng, n, encoding, batch=()):
    """An encoded state (JAX's encode of a seeded mean and a PD
    covariance), as numpy: both packages take the same numbers."""
    x = 0.5 * rng.standard_normal(batch + (n,))
    M = rng.standard_normal(batch + (n, n))
    C = 0.01 * (M @ np.swapaxes(M, -1, -2) / n + 0.1 * np.eye(n))
    return np.asarray(j_encode(jnp.asarray(x), C=jnp.asarray(C),
                               encoding=JEnc(int(encoding))))


# The codecs under which each test differentiates. JAX needs seconds to
# compile a derivative through the Cholesky ladder at n >= 3 (over a
# minute for the double cartpole's augmented cost), so those take
# VARIANCE_ONLY; the golden pendulum_chol solve holds the augmented
# Cholesky cost's derivatives against JAX's result.
JAC_CODECS = {"pendulum": (IGN, VAR, CHOL), "double_cartpole": (IGN,),
              "rendezvous": (IGN, VAR)}
COST_CODEC = {"pendulum": VAR, "double_cartpole": VAR, "rendezvous": CHOL}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_models_match_jax_under_every_codec(name):
    """apply at 1e-12 under all five codecs (a batch of 3 states), and the
    Jacobians F_z, F_u through eval_dynamics at 1e-10 (JAC_CODECS)."""
    jm, _, tm, _ = EXAMPLES[name]
    rng = np.random.default_rng(len(name))
    n, nu = tm.state_size, tm.action_size
    assert (n, nu) == (jm.state_size, jm.action_size)
    for enc in StateEncoding:
        z = _belief(rng, n, enc, (3,))
        u = rng.standard_normal((3, nu))
        je = JEnc(int(enc))
        _close(tm.apply(_t(z), _t(u), 0, (), enc),
               jax.jit(lambda z, u: jm.apply(z, u, 0, (), je))(z, u))
        if enc not in JAC_CODECS[name]:
            continue
        got = eval_dynamics(tm, _t(z[0]), _t(u[0]), 0, enc)
        want = jax.jit(lambda z, u: j_eval_dynamics(jm, z, u, 0, je))(
            z[0], u[0])
        for g, w in zip(got, want):
            _close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_costs_match_jax(name):
    """Value and closed-form derivatives under IGNORE_UNCERTAINTY, stage
    and terminal; the autodiff derivatives with the uncertainty term under
    COST_CODEC (the Cholesky codec for the pendulum and rendezvous)."""
    _, jc, tm, tc = EXAMPLES[name]
    rng = np.random.default_rng(3 + len(name))
    n, nu = tm.state_size, tm.action_size
    x = rng.standard_normal((4, n))
    u = rng.standard_normal((4, nu))
    for terminal in (False, True):
        ut, uj = ((None, None) if terminal
                  else (_t(u), jnp.asarray(u)))
        _close(tc(_t(x), ut, 0, terminal, IGN),
               jc(jnp.asarray(x), uj, 0, terminal, JEnc(4)))
        got = eval_cost(tc, _t(x[0]), None if terminal else ut[0], 0,
                        terminal, IGN)
        want = j_eval_cost(jc, jnp.asarray(x[0]),
                           None if terminal else uj[0], 0, terminal,
                           JEnc(4))
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                _close(g, w)
    enc = COST_CODEC[name]
    je = JEnc(int(enc))
    z = _belief(rng, n, enc)
    got = eval_cost(tc, _t(z), _t(u[0]), 0, False, enc)
    want = jax.jit(lambda z, u: j_eval_cost(jc, z, u, 0, False, je))(
        z, u[0])
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-10, atol=1e-10)


def test_small_inv_and_solve_match_jax():
    """The adjugate forms for n = 1..4, batched, and b as a vector or a
    matrix: the same rounding as pddp_tpu's."""
    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 4):
        A = rng.standard_normal((6, n, n)) + 2.0 * np.eye(n)
        b = rng.standard_normal((6, n))
        B = rng.standard_normal((6, n, 2))
        _close(small_inv(_t(A)), j_small_inv(jnp.asarray(A)),
               rtol=1e-14, atol=1e-14)
        _close(small_solve(_t(A), _t(b)),
               j_small_solve(jnp.asarray(A), jnp.asarray(b)))
        _close(small_solve(_t(A), _t(B)),
               j_small_solve(jnp.asarray(A), jnp.asarray(B)))
        _close(small_solve(_t(A), _t(b)),
               np.linalg.solve(A, b[..., None])[..., 0], rtol=1e-10,
               atol=1e-10)


def _nominal(rng, model, enc, N):
    """A nominal rollout and seeded gains, as numpy."""
    z0 = (_belief(rng, model.state_size, enc) if enc != IGN
          else 0.3 * rng.standard_normal(model.state_size))
    nu, nz = model.action_size, z0.shape[-1]
    U = 0.1 * rng.standard_normal((N, nu))
    Z, _ = tilqr.rollout(model, _t(z0), _t(U), enc)
    k = 0.5 * rng.standard_normal((N, nu))
    K = 0.5 * rng.standard_normal((N, nu, nz)) / nz
    return Z.numpy(), U, k, K


@pytest.mark.parametrize("name", sorted(EXAMPLES))
@pytest.mark.parametrize("enc", [IGN, VAR, CHOL], ids=["ign", "var", "chol"])
def test_line_search_matches_jax(name, enc):
    """K2(b)/(c)'s plain version (the wrapper on CPU tensors) against
    pddp_tpu's control_law at N=12, ten alphas, bounds that bind:
    trajectories and the candidates' costs (the trajectories only for the
    double cartpole under the Cholesky codec, whose cost takes JAX long to
    compile: there the cost is the same post-pass as under VAR)."""
    jm, jc, tm, tc = EXAMPLES[name]
    nu = tm.action_size
    Z, U, k, K = _nominal(np.random.default_rng(int(enc) + len(name)), tm,
                          enc, 12)
    alphas = tilqr.default_fit_alphas(torch.float64)
    lo, hi = -0.2 * np.ones(nu), 0.2 * np.ones(nu)
    assert fr.stage(tm, tc, enc) == ("b" if enc == IGN else "c")
    with_cost = not (name == "double_cartpole" and enc == CHOL)
    n = dict(fr.launches)
    got = fr.fused_control_law(tm, _t(Z), _t(U), _t(k), _t(K), alphas, enc,
                               cost=tc if with_cost else None,
                               u_min=_t(lo), u_max=_t(hi))
    assert fr.launches == n
    je = JEnc(int(enc))
    want = jax.jit(lambda *a: jilqr.control_law(
        jm, *a, jnp.asarray(alphas.numpy()), je, u_min=jnp.asarray(lo),
        u_max=jnp.asarray(hi), cost=jc if with_cost else None))(Z, U, k, K)
    assert len(got) == len(want) == 2 + with_cost
    assert float(got[1].abs().max()) == 0.2
    for g, w in zip(got, want):
        _close(g, w)


# The end states (state, accepted iterations, evaluations) of the JAX
# solves. Rendezvous is linear-quadratic: its first step reaches the
# optimum and every later candidate ties its cost within an ulp or two,
# so the order of sums decides whether one is accepted (CONVERGED after 2
# iterations and 2 to 11 evaluations; JAX: 2 and 2) or none is (MAX_REG
# after 1 and 11; the port on one CPU thread), with the same J, Z and U
# (ROADMAP.md, C).
OUTCOMES = {"pendulum": {("CONVERGED", 49, 58)},
            "double_cartpole": {("ACCEPTED", 25, 52)},
            "rendezvous": {("MAX_REG", 1, 11)} | {("CONVERGED", 2, e)
                                                  for e in range(2, 12)},
            "pendulum_chol": {("ACCEPTED", 25, 36)}}
CASES = {  # (example, x0, iterations, encoding)
    "pendulum": ("pendulum", [0.0, 0.0], 50, IGN),
    "double_cartpole": ("double_cartpole", [0.0, 0.0, 0.05, 0.0, -0.05, 0.0],
                        25, IGN),
    "rendezvous": ("rendezvous", [-10.0, -10.0, 10.0, 10.0, 0.0, -5.0, 5.0,
                                  0.0], 25, IGN),
    "pendulum_chol": ("pendulum", [0.0, 0.0], 25, CHOL),
}


@pytest.mark.parametrize("name,mode,fused", [
    ("pendulum", "scan", False), ("double_cartpole", "scan", False),
    ("rendezvous", "scan", False), ("pendulum_chol", "scan", False),
    ("pendulum_chol", "kernel", True)])
def test_golden_solves(name, mode, fused):
    """The golden case at test_golden.py's tolerances with the end state
    of the JAX solve; once through the kernel options (their plain
    versions on the CPU)."""
    example, x0, iters, enc = CASES[name]
    _, _, model, cost = EXAMPLES[example]
    x0 = torch.tensor(x0, dtype=torch.float64)
    z0 = x0 if enc == IGN else encode(
        x0, C=1e-2 * torch.eye(x0.shape[0], dtype=torch.float64),
        encoding=enc)
    U0 = torch.as_tensor(convert.golden_U0(name))
    n = bk.launches
    r = tilqr.solve(model, cost, z0, U0,
                    tilqr.ILQROptions(n_iterations=iters, riccati_mode=mode,
                                      fused_rollout=fused), encoding=enc)
    assert bk.launches == n
    g = np.load(GOLDEN)
    np.testing.assert_allclose(r.J_opt, g[name + "_J"], rtol=1e-6)
    np.testing.assert_allclose(r.Z.numpy(), g[name + "_Z"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(r.U.numpy(), g[name + "_U"], rtol=1e-5,
                               atol=1e-7)
    assert (r.state.name, r.iterations, r.evals) in OUTCOMES[name]


def test_convert_builds_the_examples():
    """convert.pendulum/double_cartpole/rendezvous from the JAX objects'
    numpy fields give the same models and costs."""
    for name, fn, example in (
            ("pendulum", convert.pendulum, tpend),
            ("double_cartpole", convert.double_cartpole, tdcp),
            ("rendezvous", convert.rendezvous, trdv)):
        jm, jc, tm, tc = EXAMPLES[name]
        params = {k: np.asarray(getattr(jm, k))
                  for k in example.model.PARAM_NAMES}
        costs = {k: np.asarray(getattr(jc, k)) for k in convert.COST_FIELDS}
        m, c = fn(params, costs, device="cpu", dtype=torch.float64)
        assert type(m) is type(tm) and type(c) is type(tc)
        for k in params:
            _close(getattr(m, k), getattr(tm, k), rtol=0, atol=0)
        for k in convert.COST_FIELDS:
            _close(getattr(c, k).expand_as(getattr(tc, k)), getattr(tc, k),
                   rtol=0, atol=0)
    with pytest.raises(TypeError):
        convert.pendulum({"dt": torch.tensor(0.1)}, {}, device="cpu")
