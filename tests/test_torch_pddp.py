"""The port's PDDP loop (``PDDPController``) against pddp_tpu's.

The loop is replayed against ``tests/golden/pddp_trace.npz``, pddp_tpu's
``PDDPController.fit`` at a tiny size (pendulum, BNN hidden [16, 16],
P=8, N=6, Cholesky codec, float64; see ``tests/golden/pddp_trace.py``):
the port starts from the same model arrays and the same env resets, and
takes pddp_tpu's draws (exploration actions, training batches and noise,
episode noise) as explicit arrays. Every trial, the first model fit and
the iLQR fit are held against the trace within 1e-9 (relative and
absolute; the same float64 arithmetic in another order of sums). The
MPC trial amplifies rounding: some of its twelve cold-started ticks turn
a 1e-14 change of their state into a 1e-8 change of their control (tick
4 ends MAX_REG). So each tick of the loop's MPC trial starts from
pddp_tpu's recorded state and controller state, after the loop's own
state and tick index are held against them within 1e-9; the control,
the shifted nominal actions, mu and delta it leaves are held against
pddp_tpu's. The fit after the trial is replayed on pddp_tpu's dataset.

Also: eval mode runs one plain iLQR fit, the dataset's FIFO cap, the
padding of ``n_valid`` models, and the loop from the generator.
"""

import inspect

import numpy as np
import pytest
import torch

from pddp_tpu.controllers import pddp as jpddp
from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers import PDDPController, iLQRController
from pddp_tpu_torch.controllers import pddp as tpddp
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.pendulum import (PendulumCost,
                                              PendulumDynamicsModel,
                                              PendulumEnv)
from pddp_tpu_torch.models.bnn import (bnn_dynamics_model_factory,
                                       trainable_mask)
from tests.golden import pddp_trace as tr

torch.set_num_threads(1)

TRACE_TOL = dict(rtol=1e-9, atol=1e-9)
F64 = dict(device="cpu", dtype=torch.float64)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _model(trace):
    """The trace's initial BNN, carried across by convert.bnn."""
    n_leaves = sum(k.startswith("init_net_") for k in trace)
    leaves = [trace["init_net_{}".format(i)] for i in range(n_leaves)]
    buffers = {k: trace["init_" + k] for k in convert.BNN_BUFFERS}
    return convert.bnn(leaves, buffers, tr.STATE, tr.ACTION, tr.HIDDEN,
                       angular_indices=tr.ANGULAR,
                       non_angular_indices=tr.NON_ANGULAR, n_particles=tr.P,
                       horizon=2 * tr.N + 1, **F64)


@pytest.fixture(scope="module")
def replay():
    """The port's loop on the trace's model, resets and draws, with what
    pddp_tpu's generator recorded collected alike; each MPC tick from
    pddp_tpu's recorded inputs, with the loop's own recorded beside
    them."""
    trace = tr.load()
    env = PendulumEnv(dt=tr.DT, seed=0, **F64)
    resets = iter(trace["resets"])
    env.reset = lambda: env.set_state(next(resets))
    ctrl = PDDPController(env, _model(trace), PendulumCost(**F64),
                          training_opts=tr.TRAINING, draws=trace["draws"])
    got = {"trials": [], "fits": [], "solves": []}

    apply_controller = ctrl._apply_controller

    def recording_apply(*args, **kwargs):
        if kwargs.get("mpc"):
            got["mpc_model"] = ctrl.model
        data, J = apply_controller(*args, **kwargs)
        got["trials"].append((data, float(J)))
        return data, J

    fit_model = ctrl._fit_model

    def recording_fit_model(*args, **kwargs):
        m = fit_model(*args, **kwargs)
        got["fits"].append(m)
        return m

    ctrl._apply_controller = recording_apply
    ctrl._fit_model = recording_fit_model
    solve = ctrl._solve

    def recording_solve(z0, U, opts, *args, **kwargs):
        result = solve(z0, U, opts, *args, **kwargs)
        if opts.n_iterations != 1 or opts.max_evals != 64:   # not a tick
            got["solves"].append(result)
        return result

    ctrl._solve = recording_solve
    forward = ctrl.forward
    got["ticks"] = []

    def replaying_forward(z, i, encoding, **kwargs):
        t = len(got["ticks"])
        rec = {k[len("tick{}_".format(t)):]: v for k, v in trace.items()
               if k.startswith("tick{}_".format(t))}
        ctrl.load_state_dict(convert.controller_state(
            {k[len("before_"):]: v for k, v in rec.items()
             if k.startswith("before_")}, device="cpu"))
        u = forward(torch.as_tensor(rec["z"]), i, encoding, **kwargs)
        got["ticks"].append({
            "rec": rec, "z": z, "i": i, "u": u, "kwargs": kwargs,
            "U_nominal": ctrl._U_nominal.clone(), "mu": ctrl._mu,
            "delta": ctrl._delta, "state": int(ctrl.last_result.state)})
        return u

    ctrl.forward = replaying_forward
    umax = torch.tensor([tr.UMAX], dtype=torch.float64)
    Z, U, state = ctrl.fit(torch.as_tensor(tr.U0()),
                           encoding=StateEncoding[tr.ENCODING], quiet=True,
                           u_min=-umax, u_max=umax, **tr.FIT)
    got.update(Z=Z, U=U, state=state, ctrl=ctrl)
    return trace, got


def test_replay_collects_the_same_trials(replay):
    trace, got = replay
    assert len(got["trials"]) == int(trace["n_trials"]) == 3
    for t, ((X, U, dX), J) in enumerate(got["trials"]):
        for name, a in (("X", X), ("U", U), ("dX", dX)):
            np.testing.assert_allclose(
                _np(a), trace["trial{}_{}".format(t, name)], **TRACE_TOL)
        np.testing.assert_allclose(J, trace["trial_J"][t], **TRACE_TOL)
    assert got["trials"][-1][0][0].shape[0] == 2 * tr.N


def test_mpc_ticks_match_from_jax_inputs(replay):
    """Each MPC tick of the loop: its state and index against pddp_tpu's,
    and from pddp_tpu's state and controller state, the control, the
    shifted nominal actions, the solve's end, mu and delta."""
    trace, got = replay
    n = int(trace["n_ticks"])
    assert n == 2 * tr.N == len(got["ticks"])
    for tick in got["ticks"]:
        rec = tick["rec"]
        np.testing.assert_allclose(_np(tick["z"]), rec["z"], **TRACE_TOL)
        assert tick["i"] == int(rec["i"])
        assert tick["kwargs"]["mpc"]
        assert tick["kwargs"]["n_iterations"] == tr.FIT["n_iterations"]
        for bound, sign in (("u_min", -1.0), ("u_max", 1.0)):
            np.testing.assert_array_equal(_np(tick["kwargs"][bound]),
                                          [sign * tr.UMAX])
        np.testing.assert_allclose(_np(tick["u"]), rec["u"], **TRACE_TOL)
        np.testing.assert_allclose(_np(tick["U_nominal"]),
                                   rec["after_U_nominal"], **TRACE_TOL)
        assert tick["state"] == int(rec["state"])
        np.testing.assert_allclose(tick["mu"], rec["after_mu"], rtol=1e-12)
        np.testing.assert_allclose(tick["delta"], rec["after_delta"],
                                   rtol=1e-12)


def test_replay_trains_the_same_models(replay):
    """The first fit in the loop; the fit after the MPC trial on
    pddp_tpu's dataset (its three trials) and the loop's resampled
    model."""
    trace, got = replay
    assert len(got["fits"]) == int(trace["n_fits"]) == 2
    data = tuple(torch.as_tensor(np.concatenate(
        [trace["trial{}_{}".format(t, k)] for t in range(3)]))
        for k in ("X", "U", "dX"))
    ctrl = got["ctrl"]
    ctrl.model = got["mpc_model"]
    ctrl._draws = iter([trace["draws"][-1]])
    refit = tpddp.PDDPController._fit_model(ctrl, data, 1000, True)
    for f, m in enumerate((got["fits"][0], refit)):
        arrays = m.net.leaves() + [getattr(m, k) for k in
                                   ("X_mean", "X_std", "dX_mean", "dX_std")]
        for i, a in enumerate(arrays):
            np.testing.assert_allclose(
                _np(a), trace["fit{}_{}".format(f, i)], **TRACE_TOL)
    # The noise leaves are the resampled episode masks, not trained.
    assert not torch.equal(got["fits"][1].net.dropouts[0].noise,
                           got["fits"][0].net.dropouts[0].noise)


def test_replay_fits_the_same_trajectories(replay):
    trace, got = replay
    assert len(got["solves"]) == int(trace["n_solves"]) == 1
    for s, r in enumerate(got["solves"]):
        np.testing.assert_allclose(_np(r.Z), trace["solve{}_Z".format(s)],
                                   **TRACE_TOL)
        np.testing.assert_allclose(_np(r.U), trace["solve{}_U".format(s)],
                                   **TRACE_TOL)
        np.testing.assert_allclose(r.J_opt, trace["solve{}_J".format(s)],
                                   **TRACE_TOL)
        assert int(r.state) == int(trace["solve{}_state".format(s)])
    np.testing.assert_allclose(_np(got["Z"]), trace["Z"], **TRACE_TOL)
    np.testing.assert_allclose(_np(got["U"]), trace["U"], **TRACE_TOL)
    assert int(got["state"]) == int(trace["state"])


def test_eval_mode_is_one_plain_ilqr_fit():
    """eval() without training on start or resampling: one iLQR fit on the
    model as it is, the model untouched."""
    trace = tr.load()
    model = _model(trace)
    env = PendulumEnv(dt=tr.DT, seed=0, **F64)
    ctrl = PDDPController(env, model, PendulumCost(**F64)).eval()
    U0 = torch.as_tensor(tr.U0())
    Z, U, state = ctrl.fit(U0, encoding=StateEncoding[tr.ENCODING],
                           max_trials=5, train_on_start=False,
                           resample_model=False, n_iterations=1)
    assert ctrl.model is model
    env = PendulumEnv(dt=tr.DT, seed=0, **F64)
    env.reset()   # the episode's reset, as the loop's
    ref = iLQRController(env, model, PendulumCost(**F64))
    Z_ref, U_ref, state_ref = ref.fit(U0,
                                      encoding=StateEncoding[tr.ENCODING],
                                      n_iterations=1)
    assert torch.equal(Z, Z_ref) and torch.equal(U, U_ref)
    assert state == state_ref


def test_concat_datasets_keeps_the_newest_rows_as_jax():
    rng = np.random.default_rng(0)
    a, b = ([rng.standard_normal((n, k)) for k in (2, 1, 2)]
            for n in (5, 4))
    got = tpddp._concat_datasets(tuple(torch.as_tensor(x) for x in a),
                                 tuple(torch.as_tensor(x) for x in b), 6)
    want = jpddp._concat_datasets(tuple(a), tuple(b), 6)
    for g, w in zip(got, want):
        assert g.shape[0] == 6
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert tpddp._concat_datasets(None, got) is got
    assert tpddp._concat_datasets(got, None) is got


def test_fit_model_pads_only_n_valid_models():
    """BNN models get the dataset padded to max_dataset_size with n_valid;
    a model whose fit takes no n_valid gets the rows as they are."""
    calls = []

    class Recording(PendulumDynamicsModel):
        def fit(self, X, U, dX, **kwargs):
            calls.append((X.shape[0], kwargs.get("n_valid")))
            return self

    class RecordingBNN(Recording):
        supports_n_valid = True

    env = PendulumEnv(dt=tr.DT, **F64)
    data = tuple(torch.ones(3, k, dtype=torch.float64) for k in (2, 1, 2))
    for cls in (Recording, RecordingBNN):
        ctrl = PDDPController(env, cls(**F64), PendulumCost(**F64))
        ctrl._fit_model(data, 10, True)
    assert calls == [(3, None), (10, 3)]
    assert "n_valid" in inspect.signature(
        bnn_dynamics_model_factory(2, 1, [4]).init(
            n_particles=2, horizon=2, **F64).fit).parameters


def test_loop_from_the_generator_is_reproducible():
    """Without explicit draws every site draws from the seeded generator:
    the same seed gives the same loop, trained weights included (the
    variance codec, cheaper than the replay's Cholesky one)."""
    def run(seed):
        env = PendulumEnv(dt=tr.DT, seed=0, **F64)
        cls = bnn_dynamics_model_factory(
            tr.STATE, tr.ACTION, [8], angular_indices=tr.ANGULAR,
            non_angular_indices=tr.NON_ANGULAR)
        model = cls.init(seed=0, n_particles=4, horizon=5, **F64)
        ctrl = PDDPController(env, model, PendulumCost(**F64), seed=seed,
                              training_opts={"n_iter": 2, "batch_size": 4})
        Z, U, _ = ctrl.fit(0.1 * torch.ones(2, 1, dtype=torch.float64),
                           encoding=StateEncoding.VARIANCE_ONLY,
                           max_trials=1, n_iterations=1,
                           u_min=torch.tensor([-1.0], dtype=torch.float64),
                           u_max=torch.tensor([1.0], dtype=torch.float64))
        return Z, U, ctrl.model
    (Z1, U1, m1), (Z2, U2, m2), (_, _, m3) = run(0), run(0), run(1)
    assert torch.equal(Z1, Z2) and torch.equal(U1, U2)
    assert bool(torch.isfinite(Z1).all())
    same = [torch.equal(a, b) for a, b in zip(m1.net.leaves(),
                                              m2.net.leaves())]
    assert all(same)
    differ = [not torch.equal(a, b) for a, b, t in zip(
        m1.net.leaves(), m3.net.leaves(), trainable_mask(m1.net)) if t]
    assert any(differ)
    with pytest.raises(ValueError):
        env = PendulumEnv(dt=tr.DT, **F64)
        PDDPController(env, PendulumDynamicsModel(**F64),
                       PendulumCost(**F64),
                       draws=[("fit", {})]).fit(
            torch.zeros(2, 1, dtype=torch.float64), max_trials=1)
