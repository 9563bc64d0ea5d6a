"""The port's iLQR (pddp_tpu_torch.controllers.ilqr) against pddp_tpu.

One iteration of the main path at N=20 (local model, backward, every
line-search candidate) against the JAX functions on the same inputs, and
the golden cartpole solve through the port's kernel options on the CPU,
where the wrappers run their plain versions, against
tests/golden/solver_trajectories.npz. The JAX solve loop itself is not
run: the npz holds its result.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu.controllers import ilqr as jilqr
from pddp_tpu.encoding import StateEncoding as JEnc
from pddp_tpu.examples.cartpole import CartpoleCost as JCost
from pddp_tpu.examples.cartpole import CartpoleDynamicsModel as JModel
from pddp_tpu_torch.controllers import ilqr as tilqr
from pddp_tpu_torch.convert import golden_cartpole_U0
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.cartpole import CartpoleCost, CartpoleDynamicsModel
from pddp_tpu_torch.ops import backward_kernel as bk
from pddp_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)

IGN = StateEncoding.IGNORE_UNCERTAINTY
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "solver_trajectories.npz")
F64 = dict(device="cpu", dtype=torch.float64)


def test_one_iteration_matches_jax():
    """N=20 cartpole: derivatives, k/K and Z/U/J per candidate agree to
    1e-10 (the same closed forms; reg=10 keeps Q_uu positive so the gains
    are finite at this first iterate)."""
    N, reg = 20, 10.0
    rng = np.random.default_rng(11)
    z0 = np.array([0.0, 0.0, 0.1, 0.0])
    U = 0.1 + 0.05 * rng.standard_normal((N, 1))
    jm, jc = JModel(dt=0.05), JCost()
    tm, tc = CartpoleDynamicsModel(dt=0.05, **F64), CartpoleCost(**F64)

    Zj, AUXj = jilqr.rollout(jm, jnp.asarray(z0), jnp.asarray(U), JEnc(4))
    dj = jilqr.local_model(Zj, jnp.asarray(U), AUXj, jm, jc, JEnc(4))
    kj, Kj, okj = jilqr.backward(*dj, reg=reg)
    outj = jilqr.control_law(jm, dj[0], jnp.asarray(U), kj, Kj,
                             jilqr.default_fit_alphas(jnp.float64), JEnc(4),
                             cost=jc)

    Zt, AUXt = tilqr.rollout(tm, torch.as_tensor(z0), torch.as_tensor(U),
                             IGN)
    dt = tilqr.local_model(Zt, torch.as_tensor(U), AUXt, tm, tc, IGN)
    kt, Kt, okt = bk.kernel_backward(*dt, reg=reg)
    outt = fr.fused_control_law(tm, dt[0], torch.as_tensor(U), kt, Kt,
                                tilqr.default_fit_alphas(torch.float64),
                                IGN, cost=tc)
    assert bool(okj) and bool(okt)
    for got, want in zip(dt + (kt, Kt) + outt, dj + (kj, Kj) + outj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-10)


def test_default_alphas_match_jax():
    """To a few ulps: numpy's and XLA's pow and linspace round apart."""
    np.testing.assert_allclose(
        tilqr.default_fit_alphas(torch.float64).numpy(),
        np.asarray(jilqr.default_fit_alphas(jnp.float64)), rtol=2e-15)
    np.testing.assert_allclose(
        tilqr.default_step_alphas(torch.float64).numpy(),
        np.asarray(jilqr.default_step_alphas(jnp.float64)), rtol=2e-15)


@pytest.mark.parametrize("mode,fused", [("kernel", True), ("scan", False)])
def test_golden_cartpole_solve(mode, fused):
    """The golden case at test_golden.py's tolerances: CONVERGED after 14
    accepted iterations and 25 evaluations, as the JAX solve."""
    model = CartpoleDynamicsModel(dt=0.05, **F64)
    cost = CartpoleCost(**F64)
    z0 = torch.tensor([0.0, 0.0, 0.1, 0.0], dtype=torch.float64)
    U0 = torch.as_tensor(golden_cartpole_U0())
    seen = []
    r = tilqr.solve(model, cost, z0, U0,
                    tilqr.ILQROptions(n_iterations=40, riccati_mode=mode,
                                      fused_rollout=fused),
                    encoding=IGN,
                    on_iteration=lambda i, s, Z, U, J: seen.append((i, s)))
    g = np.load(GOLDEN)
    np.testing.assert_allclose(r.J_opt, g["cartpole_J"], rtol=1e-6)
    np.testing.assert_allclose(r.Z.numpy(), g["cartpole_Z"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(r.U.numpy(), g["cartpole_U"], rtol=1e-5,
                               atol=1e-7)
    assert r.state == tilqr.iLQRState.CONVERGED
    assert (r.iterations, r.evals) == (14, 25)
    assert seen[-1] == (13, tilqr.iLQRState.CONVERGED)
    assert tuple(r.K.shape) == (60, 1, 4)


def test_step_once_takes_one_iteration():
    model = CartpoleDynamicsModel(dt=0.05, **F64)
    cost = CartpoleCost(**F64)
    z0 = torch.tensor([0.0, 0.0, 0.1, 0.0], dtype=torch.float64)
    U0 = torch.as_tensor(golden_cartpole_U0())
    r = tilqr.step_once(model, cost, z0, U0, tilqr.ILQROptions(),
                        encoding=IGN)
    assert r.iterations == 1 and r.state == tilqr.iLQRState.ACCEPTED
    assert r.J_opt < float(tilqr.trajectory_cost(
        cost, tilqr.rollout(model, z0, U0, IGN)[0], U0, IGN))


def test_max_reg_and_eval_budget():
    """With max_reg below the first increase every evaluation is
    rejected into MAX_REG; a budget of 3 evaluations stops after 3."""
    model = CartpoleDynamicsModel(dt=0.05, **F64)
    cost = CartpoleCost(**F64)
    z0 = torch.tensor([0.0, 0.0, 0.1, 0.0], dtype=torch.float64)
    U0 = torch.as_tensor(golden_cartpole_U0())
    r = tilqr.solve(model, cost, z0, U0,
                    tilqr.ILQROptions(max_reg=1e-7), encoding=IGN)
    assert r.state == tilqr.iLQRState.MAX_REG and r.evals == 1
    r = tilqr.solve(model, cost, z0, U0,
                    tilqr.ILQROptions(max_evals=3), encoding=IGN)
    assert r.evals == 3


@pytest.mark.parametrize("opts", [
    dict(u_min=[-1.0], u_max=[1.0]), dict(v_zz_reg=True),
    dict(riccati_mode="parallel")])
def test_options_outside_the_slice_raise(opts):
    model = CartpoleDynamicsModel(**F64)
    cost = CartpoleCost(**F64)
    with pytest.raises(NotImplementedError):
        tilqr.solve(model, cost, torch.zeros(4, dtype=torch.float64),
                    torch.zeros(5, 1, dtype=torch.float64),
                    tilqr.ILQROptions(**opts), encoding=IGN)


def test_solve_promotes_to_the_widest_parameter_dtype():
    """float32 inputs against a float64 model solve in float64."""
    model = CartpoleDynamicsModel(dt=0.05, **F64)
    cost = CartpoleCost(device="cpu", dtype=torch.float32)
    r = tilqr.solve(model, cost, torch.tensor([0.0, 0.0, 0.1, 0.0]),
                    torch.full((10, 1), 0.1), tilqr.ILQROptions(
                        n_iterations=2), encoding=IGN)
    assert r.Z.dtype == torch.float64 and r.U.dtype == torch.float64
