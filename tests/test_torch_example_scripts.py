"""The ``examples_torch`` scripts, the port's versions of ``examples/``,
on the CPU.

``tests/golden/example_scripts.npz`` (written by ``JAX_PLATFORMS=cpu
python -m tests.golden.example_scripts``; this file reads only it) holds
``pddp_tpu``'s ``examples/known_dynamics.py`` (the pendulum, N=10, two
iterations) and ``examples/experiment.py`` (the pendulum, N=4, hidden
[16, 16], P=8, five training steps, one trial of MPC, two iterations a
fit) run in float64 with their draws taken from numpy as the port's
scripts take them, each env reset's state recorded, and the experiment's
initial BNN and its key chain's draws. The port's scripts run here with
the same constants (set on the module), the same env resets and, for the
experiment, the same model and draws.

Tolerances (relative, and absolute at the values' scale): the same
float64 arithmetic in another order of sums, 1e-9 (``tests/
test_torch_pddp.py``'s for the same loop). Not compared: the MPC trial's
cost and the final policy execution's, which start from the MPC trial's
end (that trial turns 1e-14 into 1e-8, ``tests/test_torch_pddp.py``).
"""

import functools
import sys

import numpy as np
import pytest
import torch

from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers import ilqr
from pddp_tpu_torch.envs.base import SimEnv
from pddp_tpu_torch.examples.problems import SampleProblems
from tests.golden import example_scripts as g

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-9)
SCRIPTS = ("known_dynamics", "experiment", "cartpole", "pendulum",
           "double_cartpole", "parallel_solves", "animation",
           "mpc_animation")


@pytest.fixture(scope="module")
def golden():
    return g.load()


@pytest.fixture
def replay(monkeypatch):
    """Records every iLQR fit's J; ``resets(states)`` replays recorded
    env resets. matplotlib cannot be imported."""
    J = []
    fit = ilqr.iLQRController.fit

    def recording(self, U, *args, on_iteration=None, **kwargs):
        def on_it(i, state, Z, U_, J_):
            J.append(float(J_))
            if on_iteration is not None:
                on_iteration(i, state, Z, U_, J_)
        return fit(self, U, *args, on_iteration=on_it, **kwargs)

    monkeypatch.setattr(ilqr.iLQRController, "fit", recording)
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    def resets(states):
        it = iter(states)
        monkeypatch.setattr(SimEnv, "reset",
                            lambda self: self.set_state(next(it)))
    return J, resets


def test_known_dynamics_matches_pddp_tpu(golden, replay, monkeypatch):
    from examples_torch import known_dynamics as kd
    J, resets = replay
    resets(golden["kd_resets"])
    monkeypatch.setattr(kd, "N", g.KNOWN["N"])
    monkeypatch.setattr(kd, "DTYPE", torch.float64)
    Z, U, state = kd.run(SampleProblems[g.KNOWN["problem"]],
                         n_iterations=g.KNOWN["n_iterations"],
                         device="cpu")
    np.testing.assert_allclose(J, golden["kd_J"], **TOL)
    np.testing.assert_allclose(Z.numpy(), golden["kd_Z"], **TOL)
    np.testing.assert_allclose(U.numpy(), golden["kd_U"], **TOL)
    assert int(state) == int(golden["kd_state"])


class _Factory:
    """``bnn_dynamics_model_factory``'s stand-in: its ``init`` returns
    pddp_tpu's initial model, carried across by ``convert.bnn``."""

    def __init__(self, golden):
        self.golden = golden

    def init(self, seed, n_particles, horizon, dtype, device):
        d = self.golden
        n = sum(k.startswith("exp_init_net_") for k in d)
        leaves = [d["exp_init_net_{}".format(i)] for i in range(n)]
        buffers = {k: d["exp_init_" + k] for k in convert.BNN_BUFFERS}
        return convert.bnn(leaves, buffers, g.STATE, g.ACTION,
                           g.EXPERIMENT["HIDDEN"],
                           angular_indices=g.ANGULAR,
                           non_angular_indices=g.NON_ANGULAR,
                           n_particles=n_particles, horizon=horizon,
                           device=device, dtype=dtype)


def test_experiment_matches_pddp_tpu(golden, replay, monkeypatch):
    from examples_torch import experiment as ex
    J, resets = replay
    resets(golden["exp_resets"])
    for k in ("N", "HIDDEN", "N_PARTICLES", "TRAIN_N_ITER"):
        monkeypatch.setattr(ex, k, g.EXPERIMENT[k])
    monkeypatch.setattr(ex, "DTYPE", torch.float64)
    monkeypatch.setattr(ex, "PLOT", False)
    monkeypatch.setattr(ex, "bnn_dynamics_model_factory",
                        lambda *a, **k: _Factory(golden))
    monkeypatch.setattr(ex, "PDDPController", functools.partial(
        ex.PDDPController, draws=golden["exp_draws"]))
    Z, U, state, J_hist, trial_costs = ex.run(
        SampleProblems[g.EXPERIMENT["problem"]],
        max_trials=g.EXPERIMENT["max_trials"],
        n_iterations=g.EXPERIMENT["n_iterations"], quiet=True,
        device="cpu")
    assert J_hist == J
    np.testing.assert_allclose(J, golden["exp_J"], **TOL)
    np.testing.assert_allclose(Z.numpy(), golden["exp_Z"], **TOL)
    np.testing.assert_allclose(U.numpy(), golden["exp_U"], **TOL)
    assert int(state) == int(golden["exp_state"])
    costs = np.array([c for _, c in trial_costs])
    assert len(costs) == len(golden["exp_trial_costs"]) == 3
    np.testing.assert_allclose(costs[:2], golden["exp_trial_costs"][:2],
                               **TOL)


def _run_tiny(name, monkeypatch):
    """Script ``name``'s main with --device cpu at a tiny size."""
    import importlib
    mod = importlib.import_module("examples_torch." + name)
    from examples_torch import experiment, known_dynamics
    monkeypatch.setattr(known_dynamics, "N", 4)
    for k, v in (("N", 2), ("HIDDEN", [4]), ("N_PARTICLES", 2),
                 ("TRAIN_N_ITER", 1)):
        monkeypatch.setattr(experiment, k, v)
    monkeypatch.setattr(experiment, "run", functools.partial(
        experiment.run, max_trials=1, n_iterations=1, quiet=True))
    if hasattr(mod, "ITERATIONS"):
        monkeypatch.setattr(mod, "ITERATIONS", 2)
    args = {"known_dynamics": ["pendulum", "1"],
            "parallel_solves": ["2", "4"]}.get(name, [])
    return mod.main(args + ["--device", "cpu"])


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_runs_without_matplotlib(name, monkeypatch, capsys):
    """Each script runs on the CPU where matplotlib cannot be imported: it
    prints its numbers and says that no figure was written (the parallel
    solves draw none)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _run_tiny(name, monkeypatch)
    out = capsys.readouterr().out
    if name == "parallel_solves":
        assert "solves/s" in out and "1 ranks" in out
    else:
        assert "no figure written" in out


@pytest.mark.parametrize("name", ["known_dynamics", "animation"])
def test_script_defaults_to_cuda(name):
    """Without --device a script runs on the card, and without a card it
    raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib
    mod = importlib.import_module("examples_torch." + name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["pendulum", "1"] if name == "known_dynamics" else [])


def test_double_cartpole_exploration_leaves_float32_as_pddp_tpu():
    """The double cartpole's env under the experiment's first exploration
    actions (dt = 0.1, uniform in [-20, 20], float32) leaves float32's
    range at the same step as ``pddp_tpu``'s (``tests/golden/
    double_cartpole_explore.npz``), from ``pddp_tpu``'s reset state and
    from the port's own (seed 0). From the same state the states agree
    within 1e-5 of each step's largest over the first nine steps: float32's
    rounding, which the unstable dynamics grow to 1e-4 by the tenth."""
    from tests.golden import double_cartpole_explore as dce
    with np.load(dce.PATH) as f:
        want = {k: f[k] for k in f.files}
    np.testing.assert_array_equal(want["U"], dce.actions())
    first = int(want["first_nonfinite"])
    assert 0 < first < dce.N
    env, _, _ = SampleProblems.DOUBLE_CARTPOLE.setup(
        dce.DT, seed=dce.SEED, device="cpu", dtype=torch.float32)
    runs = []
    for x in (torch.as_tensor(want["x0"]), env._x):
        X = [x]
        for u in torch.as_tensor(want["U"]):
            X.append(env.step_fn(X[-1], u))
        runs.append(torch.stack(X).numpy())
    for X in (want["X"], *runs):
        finite = np.isfinite(X).all(axis=1)
        assert finite[:first].all() and not finite[first:].any()
    for got, ref in zip(runs[0][:9], want["X"][:9]):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
