"""The particle model and the action constraints of the port against
pddp_tpu, in float64 on the CPU.

``ParticleDynamicsModel`` (``utils/particles.py``) over the cartpole and
the pendulum with pddp_tpu's noise carried across (``convert.
particle_model``): each step's next state, noise and rolling state,
``apply`` on the recorded noise, ``__call__``, ``init_state``,
``aux_zero``, ``resample`` on pddp_tpu's draws and ``fit``, under all
five codecs (P=8, H=6), live against pddp_tpu's compiled step; without
noise inference; with a non-finite rolling state, where the step falls
back to the episode noise lane by lane. Against
tests/golden/particle_solves.npz (pddp_tpu's side, stored: JAX compiles
a solve for a minute on the CPU, and ``python -m
tests.golden.particle_solves`` regenerates the file): the local model and
its Jacobians on one trajectory (N=20), and the cartpole particle solves
(P=8, N=20, each belief codec and a constrained one). K1's gate on the
particle model. ``constrain_model`` and ``constrain_env`` on the cartpole
against pddp_tpu's.

Tolerances (float64, max abs difference over entries of order one): the
states, particles and Jacobians 1e-12 (the same arithmetic in another
order of sums); the inferred noise 1e-10 (a triangular solve through the
covariance factor, which IGNORE_UNCERTAINTY sets to 1e-3 I, so it scales
the states' rounding by 1e3); the solves as tests/test_torch_batch.py's,
state, iterations and evaluations equal, J, Z, U, K, mu and delta within
1e-9 of each array's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu.encoding import StateEncoding as JEnc
from pddp_tpu.encoding import encode as j_encode
from pddp_tpu.examples import cartpole as jcp
from pddp_tpu.examples import pendulum as jpend
from pddp_tpu.utils import constraint as jconstraint
from pddp_tpu.utils import particles as jparticles
from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers.ilqr import (ILQROptions, local_model,
                                             rollout, solve)
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples import cartpole as tcp
from pddp_tpu_torch.examples import pendulum as tpend
from pddp_tpu_torch.ops import backward_kernel as bk
from pddp_tpu_torch.ops import fused_rollout as fr
from pddp_tpu_torch.utils.constraint import constrain_env, constrain_model
from pddp_tpu_torch.utils.particles import (ParticleDynamicsModel,
                                            particulate_model)
from tests.golden import particle_solves as g

torch.set_num_threads(1)

P, H = 8, 6
ATOL, ATOL_EPS, REL = 1e-12, 1e-10, 1e-9
INNER = {"cartpole": (jcp.CartpoleDynamicsModel, tcp.CartpoleDynamicsModel,
                      tcp.model.PARAM_NAMES, np.array([0.1, -0.2, 0.4, 0.3])),
         "pendulum": (jpend.PendulumDynamicsModel,
                      tpend.PendulumDynamicsModel, tpend.model.PARAM_NAMES,
                      np.array([0.5, -0.3]))}
CH = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
VAR = StateEncoding.VARIANCE_ONLY


def _pair(name, key=0, infer=True):
    """(pddp_tpu's particle model, the port's over the same noise)."""
    j_cls, t_cls, names, _ = INNER[name]
    j_inner = j_cls(dt=0.05)
    jm = jparticles.particulate_model(
        j_inner, jax.random.PRNGKey(key), n_particles=P, horizon=H,
        infer_noise_variables=infer, dtype=jnp.float64)
    t_inner = t_cls(*(np.asarray(getattr(j_inner, n)) for n in names),
                    device="cpu", dtype=torch.float64)
    return jm, convert.particle_model(t_inner, np.asarray(jm.eps),
                                      infer_noise_variables=infer)


def _start(name, enc):
    """z0 of both packages: the inner model's test mean with variances
    1e-2 to 4e-2 and one correlation."""
    mean = INNER[name][3]
    n = mean.shape[0]
    C = np.diag(1e-2 * np.arange(1, n + 1)) + 2e-3 * np.eye(n)[::-1]
    z = j_encode(jnp.asarray(mean), C=jnp.asarray(C), encoding=JEnc(int(enc)))
    return z, torch.as_tensor(np.array(z))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


def _u(i, nu):
    return np.full((nu,), 0.4 * i - 0.9)


@pytest.mark.parametrize("enc", list(StateEncoding)[:5],
                         ids=lambda e: e.name)
@pytest.mark.parametrize("name", sorted(INNER))
def test_particle_model_matches_jax(name, enc):
    """H steps of ``step``, each step's noise replayed by the port's
    ``apply`` (pddp_tpu's contract: ``step(...)[0] == apply(z, u, i,
    aux)``), then ``__call__`` (in pddp_tpu: ``step`` from
    ``init_state()``), ``init_state`` and ``aux_zero``. pddp_tpu's step is
    compiled once, its index traced: run eagerly, its Cholesky ladder
    compiles anew at every step."""
    jm, tm = _pair(name)
    je = JEnc(int(enc))
    j_step = jax.jit(lambda z, u, i, s: jm.step(z, u, i, s, je))
    zj, zt = _start(name, enc)
    sj, st = jm.init_state(), tm.init_state()
    assert tm.state_size == jm.state_size and tm.n_particles == P
    for i in range(H):
        u = _u(i, tm.action_size)
        z_prev = zt
        zj, sj, aj = j_step(zj, jnp.asarray(u), i, sj)
        zt, st, at = tm.step(zt, torch.as_tensor(u), i, st, enc)
        _close(zt, zj)
        _close(st.prev_output, sj.prev_output)
        _close(at, aj, ATOL_EPS)
        _close(tm.apply(z_prev, torch.as_tensor(u), i, at, enc), zj)
    u = _u(2, tm.action_size)
    _close(tm(zt, torch.as_tensor(u), 2, enc),
           j_step(zj, jnp.asarray(u), 2, jm.init_state())[0])
    lanes = tm.init_state((3,)).prev_output
    assert lanes.shape == (3, P, tm.state_size) and not lanes.any()
    _close(tm.aux_zero(), jm.aux_zero())


def test_without_noise_inference_each_step_takes_the_episode_noise():
    jm, tm = _pair("cartpole", key=1, infer=False)
    zj, zt = _start("cartpole", VAR)
    sj, st = jm.init_state(), tm.init_state()
    for i in range(3):
        zj, sj, aj = jm.step(zj, jnp.asarray(_u(i, 1)), i, sj, JEnc(int(VAR)))
        zt, st, at = tm.step(zt, torch.as_tensor(_u(i, 1)), i, st, VAR)
        assert torch.equal(at, tm.eps[i])
        _close(at, aj)
        _close(zt, zj)


def test_non_finite_rolling_state_falls_back_lane_by_lane():
    """A NaN particle in the rolling state makes the whole step take
    ``eps[i]``, as pddp_tpu's blend does, in that lane only."""
    jm, tm = _pair("cartpole", key=2)
    zj, zt = _start("cartpole", VAR)
    _, sj, _ = jm.step(zj, jnp.asarray(_u(0, 1)), 0, jm.init_state(),
                       JEnc(int(VAR)))
    bad = np.array(sj.prev_output)
    bad[3, 1] = np.nan
    u = jnp.asarray(_u(1, 1))
    j_good = jm.step(zj, u, 1, sj, JEnc(int(VAR)))
    j_bad = jm.step(zj, u, 1, type(sj)(prev_output=jnp.asarray(bad)),
                    JEnc(int(VAR)))
    # Two lanes: the finite rolling state, then the one with a NaN.
    prev = torch.stack([torch.as_tensor(np.array(sj.prev_output)),
                        torch.as_tensor(bad)])
    z2, s2, a2 = tm.step(zt.expand(2, -1), torch.as_tensor(_u(1, 1)).expand(
        2, -1), 1, type(tm.init_state())(prev_output=prev), VAR)
    assert torch.equal(a2[1], tm.eps[1]) and not torch.equal(a2[0], tm.eps[1])
    for lane, (zj_, sj_, aj_) in enumerate((j_good, j_bad)):
        _close(a2[lane], aj_, ATOL_EPS)
        _close(z2[lane], zj_)
        _close(s2.prev_output[lane], sj_.prev_output)


def test_resample_on_jax_draws_and_fit_match_jax():
    jm, tm = _pair("pendulum", key=3)
    key = jax.random.PRNGKey(11)
    raw = jax.random.normal(key, jm.eps.shape, jm.eps.dtype)
    jr = jm.resample(key)
    tr = tm.resample(noise={"eps": np.asarray(raw)})
    _close(tr.eps, jr.eps)
    assert tr.inner is tm.inner and torch.equal(tm.eps, _pair("pendulum",
                                                             key=3)[1].eps)
    X = np.zeros((5, 2))
    fitted = tm.fit(torch.as_tensor(X), torch.zeros(5, 1),
                    torch.as_tensor(X))
    assert isinstance(fitted, ParticleDynamicsModel)
    assert fitted.inner is tm.inner and fitted.eps is tm.eps
    assert isinstance(jm.fit(jnp.asarray(X), jnp.zeros((5, 1)),
                             jnp.asarray(X)), jparticles.ParticleDynamicsModel)


def test_create_from_a_generator():
    inner = tcp.CartpoleDynamicsModel(device="cpu", dtype=torch.float64)
    a = particulate_model(inner, torch.Generator().manual_seed(5),
                          n_particles=P, horizon=H)
    b = particulate_model(inner, torch.Generator().manual_seed(5),
                          n_particles=P, horizon=H)
    assert torch.equal(a.eps, b.eps) and a.eps.dtype == torch.float64
    assert a.eps.shape == (H, P, 4) and a.horizon == H
    _close(a.eps.mean(dim=1), np.zeros((H, 4)))
    _close(a.eps.std(dim=1), np.ones((H, 4)))
    with pytest.raises(ValueError):
        particulate_model(inner, eps=np.zeros((H, P, 3)), n_particles=P,
                          horizon=H)


@pytest.fixture(scope="module")
def golden():
    return np.load(g.PATH)


def _golden_model(ref, name, constrained):
    cls = tcp.CartpoleDynamicsModel
    if constrained:
        cls = constrain_model(-g.U_MAX, g.U_MAX)(cls)
    return convert.particle_model(cls(dt=g.DT, device="cpu",
                                      dtype=torch.float64), ref[name + "_eps"])


def test_local_model_matches_jax(golden):
    """The local model (the cost's derivatives and the Jacobians F_z, F_u
    through the generic ``vmap(jacfwd)`` path, each step's noise
    replayed) on the rollout of the golden Cholesky case's U0, against
    pddp_tpu's ``local_model`` stored in the fixture."""
    model = _golden_model(golden, "cholesky", False)
    cost = tcp.CartpoleCost(device="cpu", dtype=torch.float64)
    Z, AUX = rollout(model, torch.as_tensor(golden["cholesky_z0"]),
                     torch.as_tensor(g.U0()), CH)
    derivs = local_model(Z, torch.as_tensor(g.U0()), AUX, model, cost, CH)
    for f, t in zip(g.LOCAL, derivs):
        _close(t, golden["local_" + f])


@pytest.mark.parametrize("name", list(g.CASES))
def test_golden_particle_solves(golden, name):
    codec, constrained = g.CASES[name]
    model = _golden_model(golden, name, constrained)
    r = solve(model, tcp.CartpoleCost(device="cpu", dtype=torch.float64),
              torch.as_tensor(golden[name + "_z0"]), torch.as_tensor(g.U0()),
              ILQROptions(**g.OPTS), encoding=StateEncoding[codec])
    for f in ("state", "iterations", "evals"):
        assert int(getattr(r, f)) == int(golden[name + "_" + f]), f
    for f in ("Z", "U", "K", "J_opt", "mu", "delta"):
        ref = golden[name + "_" + f]
        got = getattr(r, f)
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=REL * max(np.abs(ref).max(), 1e-300),
            err_msg=f)


@pytest.mark.parametrize("codec", ["VARIANCE_ONLY", "FULL_COVARIANCE_MATRIX"])
def test_particle_solve_sends_every_backward_to_k1(golden, codec,
                                                   monkeypatch):
    """``riccati_mode="kernel"`` sends every backward of a particle solve
    to K1's wrapper (on CPU tensors its plain version), and the line
    search stays on the scan: the model is stateful, as in pddp_tpu."""
    calls = []
    real = bk.kernel_backward

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(bk, "kernel_backward", counted)
    name = "variance" if codec == "VARIANCE_ONLY" else "full"
    model = _golden_model(golden, name, False)
    r = solve(model, tcp.CartpoleCost(device="cpu", dtype=torch.float64),
              torch.as_tensor(golden[name + "_z0"]),
              torch.as_tensor(g.U0()[:6]),
              ILQROptions(n_iterations=2, max_evals=4, riccati_mode="kernel",
                          fused_rollout=True),
              encoding=StateEncoding[codec])
    nz = golden[name + "_z0"].shape[0]
    assert len(calls) == r.evals >= 1 and calls[0] == (6, nz, nz)
    assert not fr.supports_fused_rollout(model, None, StateEncoding[codec])


def test_constrain_model_matches_jax():
    j_cls = jconstraint.constrain_model(-1.5, 2.0)(jcp.CartpoleDynamicsModel)
    t_cls = constrain_model(-1.5, 2.0)(tcp.CartpoleDynamicsModel)
    assert t_cls.__name__ == j_cls.__name__ == "ConstrainedCartpoleDynamicsModel"
    jm = j_cls(dt=0.05)
    tm = t_cls(dt=0.05, device="cpu", dtype=torch.float64)
    assert isinstance(tm, tcp.CartpoleDynamicsModel)
    assert fr.stage(tm, None, StateEncoding.IGNORE_UNCERTAINTY) == "a"
    u = np.array([[-4.0], [0.3], [7.0]])
    _close(tm.constrain(torch.as_tensor(u)), jm.constrain(jnp.asarray(u)))
    for enc in (StateEncoding.IGNORE_UNCERTAINTY, StateEncoding.VARIANCE_ONLY):
        zj, zt = _start("cartpole", enc)
        for row in u:
            _close(tm.apply(zt, torch.as_tensor(row), 0, (), enc),
                   jm.apply(zj, jnp.asarray(row), 0, (), JEnc(int(enc))))


def test_constrain_env_matches_jax():
    j_env = jconstraint.constrain_env(-1.0, 1.0)(jcp.CartpoleEnv)(dt=0.05)
    t_env = constrain_env(-1.0, 1.0)(tcp.CartpoleEnv)(dt=0.05, device="cpu",
                                                        dtype=torch.float64)
    assert type(t_env).__name__ == type(j_env).__name__
    x0 = np.array([0.0, 0.1, 0.2, -0.1])
    j_env._x = jnp.asarray(x0)
    t_env.set_state(x0)
    for u in (np.array([3.0]), np.array([-0.5]), np.array([10.0])):
        j_env.apply(u)
        t_env.apply(u)
        _close(t_env.get_state().mean(), j_env.get_state().mean())
