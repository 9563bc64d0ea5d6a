"""The port's controller surface against pddp_tpu: ``GaussianVariable``,
the example envs, ``iLQRController`` (fit, step, forward, MPC, state
dicts) and the module functions it rests on.

The same numpy-seeded inputs go through both packages in float64 on the
CPU. Tolerance 1e-12 unless stated (the same arithmetic; only the order
of sums and each framework's libm differ). ``fit`` is held against the
golden solves of tests/golden/solver_trajectories.npz at
tests/controllers/test_golden.py's tolerances, and ``step``/``forward``
against tests/golden/controller_traces.npz (pddp_tpu's controller; its
solves take minutes to compile on the CPU, so they are stored), at 1e-8:
the port's fit, step and ticks start from its own results, which carry
the solves' rounding forward.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu.controllers import ilqr as jilqr
from pddp_tpu.costs.quadratic import SaturatingQRCost as JSatCost
from pddp_tpu.encoding import StateEncoding as JEnc
from pddp_tpu.examples import cartpole as jcp
from pddp_tpu.examples import double_cartpole as jdcp
from pddp_tpu.examples import pendulum as jpend
from pddp_tpu.examples import rendezvous as jrdv
from pddp_tpu.gaussian_variable import GaussianVariable as JGV
from pddp_tpu.utils.evaluation import linearize_dynamics as j_linearize
from pddp_tpu.utils.evaluation import quadratize_cost as j_quadratize
from pddp_tpu.utils.linalg import psd_inverse_clamped as j_psd_inv
from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers import Controller, iLQRController, iLQRState
from pddp_tpu_torch.controllers import ilqr as tilqr
from pddp_tpu_torch.costs import SaturatingQRCost
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.envs import Env, SimEnv
from pddp_tpu_torch.examples import cartpole as tcp
from pddp_tpu_torch.examples import double_cartpole as tdcp
from pddp_tpu_torch.examples import pendulum as tpend
from pddp_tpu_torch.examples import rendezvous as trdv
from pddp_tpu_torch.gaussian_variable import GaussianVariable
from pddp_tpu_torch.utils.evaluation import (linearize_dynamics,
                                             quadratize_cost)
from pddp_tpu_torch.utils.gaussian_variable import \
    GaussianVariable as AliasGV
from pddp_tpu_torch.utils.linalg import psd_inverse_clamped
from tests.golden import controller_traces as traces

torch.set_num_threads(1)

IGN = StateEncoding.IGNORE_UNCERTAINTY
CHOL = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
TOL = dict(rtol=1e-12, atol=1e-12)
F64 = dict(device="cpu", dtype=torch.float64)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "solver_trajectories.npz")

# name -> (JAX env class, port env class, JAX cost, port cost, x0, dt)
ENVS = {
    "pendulum": (jpend.PendulumEnv, tpend.PendulumEnv, jpend.PendulumCost,
                 tpend.PendulumCost, [0.0, 0.0], 0.1),
    "cartpole": (jcp.CartpoleEnv, tcp.CartpoleEnv, jcp.CartpoleCost,
                 tcp.CartpoleCost, [0.0, 0.0, 0.1, 0.0], 0.05),
    "double_cartpole": (jdcp.DoubleCartpoleEnv, tdcp.DoubleCartpoleEnv,
                        jdcp.DoubleCartpoleCost, tdcp.DoubleCartpoleCost,
                        [0.0, 0.0, 0.05, 0.0, -0.05, 0.0], 0.05),
    "rendezvous": (jrdv.RendezvousEnv, trdv.RendezvousEnv,
                   jrdv.RendezvousCost, trdv.RendezvousCost,
                   [-10.0, -10.0, 10.0, 10.0, 0.0, -5.0, 5.0, 0.0], 0.1),
}


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(kw or TOL))


def _port_env(name, x0=None):
    _, env_cls, _, cost_cls, x0_, dt = ENVS[name]
    env = env_cls(dt=dt, **F64)
    env.set_state(x0_ if x0 is None else x0)
    return env, cost_cls(**F64)


def _psd(rng, n):
    M = rng.standard_normal((n, n))
    return M @ M.T / n + 0.1 * np.eye(n)


@pytest.mark.parametrize("enc", list(StateEncoding)[:5])
def test_gaussian_variable_matches_jax(enc):
    """encode/decode and the derived moments, from each representation."""
    rng = np.random.default_rng(int(enc))
    mean, C = rng.standard_normal(3), _psd(rng, 3)
    V = np.diag(C).copy()
    for kw in ({"_covar": C}, {"_var": V}, {"_std": np.sqrt(V)}):
        j = JGV(jnp.asarray(mean), **{k: jnp.asarray(v)
                                      for k, v in kw.items()})
        t = GaussianVariable(torch.as_tensor(mean), **{
            k: torch.as_tensor(v) for k, v in kw.items()})
        for f in ("mean", "covar", "var", "std"):
            _close(getattr(t, f)(), getattr(j, f)())
        z_t, z_j = t.encode(enc), j.encode(JEnc(int(enc)))
        _close(z_t, z_j)
        d_t = GaussianVariable.decode(z_t, enc)
        d_j = JGV.decode(z_j, JEnc(int(enc)))
        for f in ("mean", "covar", "var", "std"):
            _close(getattr(d_t, f)(), getattr(d_j, f)())
    assert AliasGV is GaussianVariable
    assert repr(t) == "GaussianVariable((3,))"


def test_gaussian_variable_sampling():
    """sample and random draw from a torch.Generator: the same seed gives
    the same draw; the samples have the variable's moments."""
    rng = np.random.default_rng(0)
    mean, C = rng.standard_normal(3), _psd(rng, 3)
    g = GaussianVariable(torch.as_tensor(mean), _covar=torch.as_tensor(C))
    a = g.sample(torch.Generator().manual_seed(1), (20000,))
    b = g.sample(torch.Generator().manual_seed(1), (20000,))
    assert a.shape == (20000, 3) and torch.equal(a, b)
    _close(a.mean(0), mean, rtol=0, atol=0.05)
    _close(torch.cov(a.T), C, rtol=0, atol=0.05)
    s = GaussianVariable(torch.as_tensor(mean),
                         _std=torch.as_tensor([1.0, 2.0, 3.0]))
    _close(s.sample(torch.Generator().manual_seed(2), (20000,)).std(0),
           [1.0, 2.0, 3.0], rtol=0.05, atol=0)
    r = GaussianVariable.random(torch.Generator().manual_seed(3), 4,
                                dtype=torch.float64, device="cpu")
    assert r.shape == (4,) and r.covar().shape == (4, 4)
    assert float(torch.linalg.eigvalsh(r.covar()).min()) >= 0.1 - 1e-12
    c = r.clone()
    assert c.covar() is not r.covar() and torch.equal(c.covar(), r.covar())


@pytest.mark.parametrize("name", list(ENVS))
def test_sim_env_matches_jax(name):
    """step_fn, apply and get_state of each example env against
    pddp_tpu's, eagerly, from the same state (the reset draws differ
    across the two RNGs); the reset's mean and scale."""
    j_cls, _, _, _, x0, dt = ENVS[name]
    rng = np.random.default_rng(len(name))
    x = np.asarray(x0) + 0.1 * rng.standard_normal(len(x0))
    u = rng.standard_normal(4 if name == "rendezvous" else 1)
    jenv = j_cls(dt=dt)
    env, _ = _port_env(name, x)
    assert isinstance(env, SimEnv) and isinstance(env, Env)
    assert (env.state_size, env.action_size) == (jenv.state_size,
                                                 jenv.action_size)
    _close(env.step_fn(torch.as_tensor(x), torch.as_tensor(u)),
           jenv.step_fn(jnp.asarray(x), jnp.asarray(u)))
    # pddp_tpu's apply is its jitted step_fn; its eager step stands in,
    # to spare the compile.
    jenv._x = jenv.step_fn(jnp.asarray(x), jnp.asarray(u))
    env.apply(u)
    for enc in (IGN, CHOL):
        _close(env.get_state().encode(enc),
               jenv.get_state().encode(JEnc(int(enc))))
    env.reset()
    _close(env.get_state().mean(), jenv.reset_mean, rtol=0, atol=0.05)
    with env as e:
        assert e is env


@pytest.mark.parametrize("name,iterations", [("pendulum", 50),
                                             ("cartpole", 40)])
def test_fit_reproduces_golden(name, iterations):
    """iLQRController.fit from the golden case's start (the README's Quick
    start for the pendulum) ends where the golden solve does."""
    env, cost = _port_env(name)
    ctrl = iLQRController(env, env.model, cost)
    seen = []
    Z, U, state = ctrl.fit(convert.golden_U0(name), encoding=IGN,
                           n_iterations=iterations,
                           on_iteration=lambda *a: seen.append(a[0]))
    g = np.load(GOLDEN)
    assert state == iLQRState.CONVERGED
    assert seen == list(range(len(seen))) and len(seen) >= 10
    _close(Z.numpy(), g[name + "_Z"], rtol=1e-5, atol=1e-7)
    _close(U.numpy(), g[name + "_U"], rtol=1e-5, atol=1e-7)
    _close(float(tilqr.trajectory_cost(cost, Z, U, IGN)), g[name + "_J"],
           rtol=1e-6)


def _traced(name):
    """The port's controller at a case of controller_traces, and the
    recorded JAX values of that case."""
    ex, _, x0, _, _, codec = traces.CASES[name]
    env, cost = _port_env(ex, x0)
    g = np.load(traces.PATH)
    rec = {k[len(name) + 1:]: g[k] for k in g.files
           if k.startswith(name + "_")}
    return iLQRController(env, env.model, cost), StateEncoding[codec], rec


@pytest.mark.parametrize("name", list(traces.CASES))
def test_fit_step_forward_match_jax_traces(name):
    """fit, forward (mpc=False, with and without ignore_uncertainty) and
    one warm step, in the order pddp_tpu's trace took them."""
    ctrl, enc, rec = _traced(name)
    _, _, _, _, iters, _ = traces.CASES[name]
    ins = traces.inputs(name)
    Z, U, state = ctrl.fit(ins["U0"], encoding=enc, n_iterations=iters)
    tol = dict(rtol=1e-8, atol=1e-10)
    assert int(state) == int(rec["fit_state"])
    for got, key in ((Z, "fit_Z"), (U, "fit_U"), (ctrl._K, "fit_K")):
        _close(got.numpy(), rec[key], **tol)
    sd = ctrl.state_dict()
    _close([float(sd["mu"]), float(sd["delta"])],
           [rec["fit_mu"], rec["fit_delta"]], **tol)
    z = torch.as_tensor(traces.perturbed(Z[3].numpy(), ins["dx_forward"]))
    _close(ctrl.forward(z, 3, enc).numpy(), rec["forward_ign"], **tol)
    _close(ctrl(z, 3, enc, ignore_uncertainty=False).numpy(),
           rec["forward_full"], **tol)
    st = ctrl.step(torch.as_tensor(traces.perturbed(Z[0].numpy(),
                                                    ins["dx_step"])),
                   encoding=enc)
    assert int(st) == int(rec["step_state"])
    sd = ctrl.state_dict()
    for key in ("Z", "U", "K"):
        _close(sd[{"Z": "Z_nominal", "U": "U_nominal", "K": "K"}[key]],
               rec["step_" + key], **tol)
    _close([float(sd["mu"]), float(sd["delta"])],
           [rec["step_mu"], rec["step_delta"]], **tol)


@pytest.mark.parametrize("name", list(traces.CASES))
@pytest.mark.parametrize("warm", [False, True])
def test_mpc_ticks_match_jax_traces(name, warm):
    """Three forward(mpc=True) ticks from pddp_tpu's fitted state, carried
    across by convert.controller_state, cold and with warm_reg."""
    ctrl, enc, rec = _traced(name)
    fitted = {"Z_nominal": rec["fit_Z"], "U_nominal": rec["fit_U"],
              "K": rec["fit_K"], "mu": np.float64(rec["fit_mu"]),
              "delta": np.float64(rec["fit_delta"])}
    ctrl.load_state_dict(convert.controller_state(fitted, device="cpu"))
    ins = traces.inputs(name)
    tag = "warm" if warm else "cold"
    tol = dict(rtol=1e-8, atol=1e-10)
    for t in range(traces.TICKS):
        z = torch.as_tensor(traces.perturbed(rec["fit_Z"][t],
                                             ins["dx_mpc"][t]))
        u = ctrl.forward(z, t, enc, mpc=True, warm_reg=warm)
        _close(u.numpy(), rec["mpc_{}_u".format(tag)][t], **tol)
        _close(ctrl._U_nominal.numpy(), rec["mpc_{}_U".format(tag)][t],
               **tol)
        _close([ctrl._mu, ctrl._delta],
               [rec["mpc_{}_mu".format(tag)][t],
                rec["mpc_{}_delta".format(tag)][t]], **tol)


@pytest.mark.parametrize("name", list(traces.CASES))
def test_jax_state_dict_gives_the_same_forward(name):
    """pddp_tpu's fitted state, carried across by convert.controller_state,
    gives pddp_tpu's feedback law (mpc=False) on the same state."""
    ctrl, enc, rec = _traced(name)
    ctrl.load_state_dict(convert.controller_state(
        {"Z_nominal": rec["fit_Z"], "U_nominal": rec["fit_U"],
         "K": rec["fit_K"], "mu": rec["fit_mu"],
         "delta": rec["fit_delta"]}, device="cpu"))
    z = torch.as_tensor(traces.perturbed(rec["fit_Z"][3],
                                         traces.inputs(name)["dx_forward"]))
    _close(ctrl.forward(z, 3, enc).numpy(), rec["forward_ign"])
    _close(ctrl.forward(z, 3, enc, ignore_uncertainty=False).numpy(),
           rec["forward_full"])


def test_state_dict_round_trip_and_base_contract():
    """A saved state dict restores the same feedback law; forward needs a
    fit first; the base Controller's train/eval flags and contract."""
    ctrl, enc, rec = _traced("pendulum")
    with pytest.raises(RuntimeError):
        ctrl.forward(torch.zeros(2, dtype=torch.float64), 0, enc)
    ctrl.load_state_dict(convert.controller_state(
        {"Z_nominal": rec["fit_Z"], "U_nominal": rec["fit_U"],
         "K": rec["fit_K"], "mu": rec["fit_mu"],
         "delta": rec["fit_delta"]}, device="cpu"))
    z = torch.as_tensor(rec["fit_Z"][2] + 0.01)
    u = ctrl.forward(z, 2, enc)
    other, _, _ = _traced("pendulum")
    other.load_state_dict(ctrl.state_dict())
    assert torch.equal(other.forward(z, 2, enc), u)
    assert torch.equal(other.state_dict()["mu"], ctrl.state_dict()["mu"])
    with pytest.raises(TypeError):
        convert.controller_state({"K": torch.zeros(1)}, device="cpu")
    base = Controller()
    assert base.training and not base.eval().training
    assert base.train().training
    with pytest.raises(NotImplementedError):
        base(None, 0)
    with pytest.raises(NotImplementedError):
        base.fit(None)


def test_module_functions_match_jax():
    """ilqr.forward, linear_control_law, quadratize_cost,
    linearize_dynamics and psd_inverse_clamped against pddp_tpu's, on a
    5-step pendulum: forward under IGNORE_UNCERTAINTY, the derivatives
    under VARIANCE_ONLY (autodiff), bounds on the linear law."""
    rng = np.random.default_rng(5)
    N, dt, var = 5, 0.1, StateEncoding.VARIANCE_ONLY
    jm, jc = jpend.PendulumDynamicsModel(dt=dt), jpend.PendulumCost()
    tm = tpend.PendulumDynamicsModel(dt=dt, **F64)
    tc = tpend.PendulumCost(**F64)
    z0 = torch.tensor([0.1, 0.0], **F64)
    U = 0.1 * rng.standard_normal((N, 1))
    got = tilqr.forward(z0, torch.as_tensor(U), tm, tc, IGN)
    want = jax.jit(lambda z, u: jilqr.forward(z, u, jm, jc, JEnc(int(IGN))))(
        jnp.asarray(z0.numpy()), jnp.asarray(U))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-10, atol=1e-12)
    Z = got[0]
    Zv = GaussianVariable(Z[:-1], _var=torch.full((N, 2), 1e-2, **F64)
                          ).encode(var)
    Zj, Uj = jnp.asarray(Zv.numpy()), jnp.asarray(U)
    _close(quadratize_cost(tc, Zv, torch.as_tensor(U), var)[3],
           jax.jit(lambda z, u: j_quadratize(jc, z, u, JEnc(int(var))))(
               Zj, Uj)[3], rtol=1e-10, atol=1e-12)
    _close(linearize_dynamics(tm, Zv, torch.as_tensor(U), (), var)[1],
           jax.jit(lambda z, u: j_linearize(jm, z, u, (), JEnc(int(var))))(
               Zj, Uj)[1], rtol=1e-10, atol=1e-12)
    nz = Z.shape[-1]
    k = 0.1 * rng.standard_normal((N, 1))
    K = 0.1 * rng.standard_normal((N, 1, nz))
    alphas = np.array([1.0, 0.5, 0.1])
    t_args = [Z, torch.as_tensor(U), got[1], got[2], torch.as_tensor(k),
              torch.as_tensor(K), torch.as_tensor(alphas)]
    j_args = [jnp.asarray(np.asarray(a)) for a in t_args]
    for b in (None, 0.12):
        bt = {} if b is None else dict(u_min=torch.tensor([-b], **F64),
                                       u_max=torch.tensor([b], **F64))
        bj = {} if b is None else dict(u_min=jnp.asarray([-b]),
                                       u_max=jnp.asarray([b]))
        got_l = tilqr.linear_control_law(*t_args, **bt)
        want_l = jilqr.linear_control_law(*j_args, **bj)
        assert got_l[0].shape == (N + 1, 3, nz)
        for g, w in zip(got_l, want_l):
            _close(g, w)
    for n in (1, 3):
        Q = _psd(rng, n) - 0.5 * np.eye(n)   # a negative eigenvalue
        _close(psd_inverse_clamped(torch.as_tensor(Q), extra=0.3),
               j_psd_inv(jnp.asarray(Q), extra=0.3), rtol=1e-10,
               atol=1e-12)


@pytest.mark.parametrize("enc", [IGN, CHOL, StateEncoding.VARIANCE_ONLY])
def test_saturating_qr_cost_matches_jax(enc):
    """SaturatingQRCost's value, running and terminal, batched."""
    rng = np.random.default_rng(int(enc) + 10)
    n, nu = 3, 2
    Q, R = _psd(rng, n), _psd(rng, nu)
    goal = rng.standard_normal(n)
    jc = JSatCost(jnp.asarray(Q), jnp.asarray(R), x_goal=jnp.asarray(goal))
    tc = SaturatingQRCost(Q, R, x_goal=goal, **F64)
    x = rng.standard_normal((4, n))
    z = GaussianVariable(torch.as_tensor(x), _covar=torch.as_tensor(
        np.stack([_psd(rng, n) for _ in range(4)]))).encode(enc)
    u = rng.standard_normal((4, nu))
    for terminal in (False, True):
        _close(tc(z, torch.as_tensor(u), 0, terminal, enc),
               jc(jnp.asarray(z.numpy()), jnp.asarray(u), 0, terminal,
                  JEnc(int(enc))))
