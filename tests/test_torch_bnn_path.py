"""The belief-state BNN slice end to end against pddp_tpu, and the model
options, the trained weights and the reference dump around it.

One PDDP iteration (the rollout, the local model through the BNN's
structured Jacobians and the cost's autodiff at the Cholesky codec, the
Riccati backward at reg=1, the ten-candidate line search through K2
stage (d)'s wrapper with the cost as a batched post-pass, the masked
argmin) and a 2-iteration ``solve`` with ``riccati_mode="kernel"``, on
the seeded inputs of tests/golden/bnn_path.py (P=8, hidden [16, 16],
N=5, float64). On the CPU the wrappers run their plain versions.

pddp_tpu's side is stored in tests/golden/bnn_path.npz, made by that
module from the same inputs: its local model and solve loop take minutes
to compile on the CPU. Its line search there is ``control_law`` and its
backward ``backward``, the plain references that tests/ops pins its
Pallas kernels to. Tolerance 1e-9 relative to each array's largest
entry (float64; the local model's Hessians sum in another order).

Also against live pddp_tpu (1e-12): the particle model and one belief
step under each model option; ``load_bnn_npz`` on the trained net against
pddp_tpu's loader. And the port's rollout and Jacobians against the
original torch reference's dump, tests/golden/bnn_parity.npz.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu.encoding import StateEncoding as JEnc
from pddp_tpu.models.bnn import load_bnn_npz as j_load_bnn_npz
from pddp_tpu.models.bnn.model import _BNNState
from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers import ilqr
from pddp_tpu_torch.controllers.ilqr import rollout
from pddp_tpu_torch.encoding import StateEncoding, encode
from pddp_tpu_torch.examples.cartpole import CartpoleCost
from pddp_tpu_torch.models.bnn import (BNNState, CDropout, Linear,
                                       bnn_dynamics_model_factory,
                                       load_bnn_npz)
from pddp_tpu_torch.ops import backward_kernel as bk
from pddp_tpu_torch.ops import fused_bnn_rollout as fb
from pddp_tpu_torch.ops.fused_rollout import fused_control_law
from pddp_tpu_torch.utils.evaluation import eval_dynamics
from tests.golden import bnn_path
from tests.test_torch_bnn import GOLDEN, TOL, _belief, _np, _t

torch.set_num_threads(1)

CH = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
REL = 1e-9
DERIVS = ("Z", "F_z", "F_u", "L", "L_z", "L_u", "L_zz", "L_uz", "L_uu")


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL * max(np.abs(want).max(), 1.0), (what, err)


@pytest.fixture(scope="module")
def problem():
    leaves, buffers = bnn_path.make_inputs()
    model = convert.bnn(leaves, buffers, bnn_path.STATE, bnn_path.ACTION,
                        bnn_path.HIDDEN, angular_indices=bnn_path.ANGULAR,
                        non_angular_indices=bnn_path.NON_ANGULAR,
                        n_particles=bnn_path.P, horizon=bnn_path.N + 1,
                        chol_jitter=bnn_path.JITTER, device="cpu",
                        dtype=torch.float64)
    cost = CartpoleCost(device="cpu", dtype=torch.float64)
    m0, v0, U0 = bnn_path.problem()
    z0 = encode(torch.as_tensor(m0), V=torch.as_tensor(v0), encoding=CH)
    return model, cost, z0, torch.as_tensor(U0), np.load(bnn_path.PATH)


def test_one_iteration_matches_jax_per_candidate(problem):
    model, cost, z0, U0, ref = problem
    Z, AUX = ilqr.rollout(model, z0, U0, CH)
    derivs = ilqr.local_model(Z, U0, AUX, model, cost, CH)
    for name, got in zip(DERIVS, derivs):
        _close(got, ref["derivs_" + name], name)
    k, K, ok = bk.kernel_backward(*derivs, reg=bnn_path.REG)
    assert bool(ok)
    _close(k, ref["k"], "k")
    _close(K, ref["K"], "K")
    alphas = ilqr.default_fit_alphas(torch.float64)
    n = dict(fb.launches)
    Z_b, U_b, AUX_b = fused_control_law(model, derivs[0], U0, k, K, alphas,
                                        CH, with_aux=True)
    J_b = ilqr.trajectory_cost(cost, Z_b, U_b, CH)
    assert fb.launches == n  # CPU tensors: the plain version
    for a in range(alphas.shape[0]):
        _close(Z_b[:, a], ref["Z_b"][:, a], "Z candidate {}".format(a))
        _close(U_b[:, a], ref["U_b"][:, a], "U candidate {}".format(a))
        _close(AUX_b[:, a], ref["AUX_b"][:, a], "AUX candidate {}".format(a))
        _close(J_b[a], ref["J_b"][a], "J candidate {}".format(a))
    J_masked = torch.where(torch.isfinite(J_b), J_b, torch.inf)
    assert int(torch.argmin(J_masked)) == int(np.argmin(np.where(
        np.isfinite(ref["J_b"]), ref["J_b"], np.inf)))


def test_two_iteration_solve_matches_jax(problem):
    """JAX's gate holds: the stateful model's line search is the scan, so
    K2(d) is not called; K1 is asked for (plain on the CPU)."""
    model, cost, z0, U0, ref = problem
    n = dict(fb.launches)
    r = ilqr.solve(model, cost, z0, U0,
                   ilqr.ILQROptions(n_iterations=2, max_evals=15,
                                    riccati_mode="kernel"), encoding=CH)
    assert fb.launches == n
    assert r.iterations == int(ref["solve_iterations"])
    assert r.evals == int(ref["solve_evals"])
    assert int(r.state) == int(ref["solve_state"])
    _close(r.Z, ref["solve_Z"], "Z")
    _close(r.U, ref["solve_U"], "U")
    _close(np.asarray(r.J_opt), ref["solve_J"], "J")
    assert r.mu == pytest.approx(float(ref["solve_mu"]), rel=1e-12)


@pytest.mark.parametrize("option", ["particles", "no_inference",
                                    "no_input_sampling", "constrained"])
def test_model_options_match_jax(option):
    """The particle model's forward pass; one belief step at i=1 with
    noise inference off, with input sampling off, and with the tanh
    action constraint."""
    kwargs = {"particles": ({"particles": True}, {}),
              "no_inference": ({}, {"infer_noise_variables": False}),
              "no_input_sampling": ({}, {"sample_input_distribution": False}),
              "constrained": ({"constrain_min": -0.5, "constrain_max": 0.5},
                              {})}[option]
    rng = np.random.default_rng(13)
    u = np.array([0.7])
    if option == "particles":
        from pddp_tpu_torch.models.bnn import ParticlesBNNDynamicsModel
        leaves, buffers = bnn_path.make_inputs()
        jm = bnn_path.jax_model(leaves, buffers, factory_kwargs=kwargs[0])
        tm = bnn_dynamics_model_factory(
            4, 1, bnn_path.HIDDEN, angular_indices=(2,),
            non_angular_indices=(0, 1, 3), particles=True).init(
                n_particles=bnn_path.P, horizon=bnn_path.N + 1,
                dtype=torch.float64, device="cpu")
        assert type(tm) is ParticlesBNNDynamicsModel
        tm = tm.replace(net=tm.net.with_leaves([_t(a) for a in leaves]),
                        **{k: _t(buffers[k]) for k in (
                            "X_mean", "X_std", "dX_mean", "dX_std",
                            "eps_out")})
        X = rng.standard_normal((bnn_path.P, 4))
        np.testing.assert_allclose(
            _np(tm.apply(_t(X), _t(u), 1)),
            _np(jm.apply(jnp.asarray(X), jnp.asarray(u), 1, ())), **TOL)
        return
    args = dict(kwargs[0])
    if option == "constrained":
        args = {k: np.array(v) for k, v in args.items()}
    leaves, buffers = bnn_path.make_inputs()
    jm = bnn_path.jax_model(leaves, buffers, factory_kwargs=kwargs[0],
                            **kwargs[1])
    tm = convert.bnn(leaves, buffers, 4, 1, bnn_path.HIDDEN,
                     angular_indices=(2,), non_angular_indices=(0, 1, 3),
                     n_particles=bnn_path.P, horizon=bnn_path.N + 1,
                     chol_jitter=bnn_path.JITTER, device="cpu",
                     dtype=torch.float64, **args, **kwargs[1])
    z = _belief(rng)
    prev = rng.standard_normal((bnn_path.P, 4))
    enc = JEnc.UPPER_TRIANGULAR_CHOLESKY
    want = jax.jit(lambda z, u, p: jm.step(z, u, 1, _BNNState(prev_output=p),
                                           enc))(jnp.asarray(z),
                                                 jnp.asarray(u),
                                                 jnp.asarray(prev))
    got = tm.step(_t(z), _t(u), 1, BNNState(prev_output=_t(prev)), CH)
    for g, w in ((got[0], want[0]), (got[1].prev_output,
                                      want[1].prev_output),
                 (got[2], want[2])):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_load_bnn_npz_matches_jax_loader():
    """The trained cartpole net (float32 file, float64 models): the same
    MLP output and normalizers as pddp_tpu's loader."""
    from pddp_tpu.models.bnn import bnn_dynamics_model_factory as jfactory
    path = os.path.join(GOLDEN, "trained_bnn_cartpole.npz")
    args = (4, 1, [200, 200])
    kw = dict(angular_indices=(2,), non_angular_indices=(0, 1, 3))
    jm = j_load_bnn_npz(jfactory(*args, **kw).init(
        jax.random.PRNGKey(0), n_particles=100, horizon=2,
        dtype=jnp.float64), path)
    tm = load_bnn_npz(bnn_dynamics_model_factory(*args, **kw).init(
        n_particles=100, horizon=2, dtype=torch.float64, device="cpu"), path)
    x = np.random.default_rng(10).standard_normal((100, 6))
    np.testing.assert_allclose(_np(tm.net(_t(x))),
                               _np(jm.net(jnp.asarray(x))), **TOL)
    for k in ("X_mean", "X_std", "dX_mean", "dX_std"):
        np.testing.assert_array_equal(_np(getattr(tm, k)),
                                      _np(getattr(jm, k)))
    with pytest.raises(ValueError):
        load_bnn_npz(bnn_dynamics_model_factory(4, 1, [16]).init(
            n_particles=100, horizon=2, device="cpu"), path)


@pytest.mark.parametrize("case", ["default", "predstd"])
def test_rollout_and_jacobians_match_reference_dump(case):
    """bnn_parity.npz: the original torch reference's weights, masks and
    noise, and its (Z, F_z, F_u) over the episode (float64)."""
    data = np.load(os.path.join(GOLDEN, "bnn_parity.npz"))

    def arr(key):
        return _t(data["{}_{}".format(case, key)])

    U = arr("U")
    horizon = U.shape[0]
    kwargs = json.loads(data["meta_json"].tobytes().decode())[
        "cases"][case]["kwargs"]
    model = bnn_dynamics_model_factory(
        4, 1, [16, 16], angular_indices=(2,),
        non_angular_indices=(0, 1, 3)).init(
            n_particles=8, horizon=horizon, dtype=torch.float64,
            device="cpu", **kwargs)
    names = ["fc_0", "fc_1", "fc_out"]
    layers = [Linear(arr("sd.model.{}.weight".format(nm)).T.contiguous(),
                     arr("sd.model.{}.bias".format(nm))) for nm in names]
    drops = [CDropout(arr("drop.drop_{}.logit_p".format(i)),
                      arr("drop.drop_{}.temperature".format(i)),
                      _t(1.0), arr("drop.drop_{}.noise".format(i)))
             for i in range(2)]
    net = type(model.net)(layers, drops)
    fields = dict(net=net, X_mean=arr("X_mean"), X_std=arr("X_std"),
                  dX_mean=arr("dX_mean"), dX_std=arr("dX_std"),
                  eps_in=arr("eps_in"))
    if kwargs.get("use_predicted_std"):
        fields["eps_out"] = arr("eps_out")
    model = model.replace(**fields)
    Z, AUX = rollout(model, arr("z0"), U, CH)
    np.testing.assert_allclose(_np(Z), data[case + "_Z"], **TOL)
    for i in range(horizon):
        _, F_z, F_u = eval_dynamics(model, Z[i], U[i], i, encoding=CH,
                                    aux=AUX[i])
        np.testing.assert_allclose(_np(F_z), data[case + "_F_z"][i], **TOL)
        np.testing.assert_allclose(_np(F_u), data[case + "_F_u"][i], **TOL)
