"""``pddp_tpu``'s ``examples/known_dynamics.py`` and
``examples/experiment.py`` run at a tiny size, for
``tests/test_torch_example_scripts.py``.

Each script's own ``run`` runs, in float64 on the CPU (the experiment's
BNN too: its factory's ``init`` is given float64), with its module
constants cut (``KNOWN``, ``EXPERIMENT``) and its draws taken from numpy
as the port's scripts take them: the script module's ``jax`` is replaced
(here, not in the script) by a stand-in whose ``random.normal`` /
``random.uniform`` return numpy's draws at the scripts' seeds. Recorded:
every env reset's state (``SimEnv.reset`` wrapped), the J of every iLQR
iteration, the end Z, U and state, and for the experiment the initial
BNN's arrays and the draws of every site of ``PDDPController``'s key
chain (``tests/golden/pddp_trace.py``'s expansion), each trial's env cost
and the final policy execution's cost.

    JAX_PLATFORMS=cpu python -m tests.golden.example_scripts
"""

import os
import sys
import types

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "example_scripts.npz")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

KNOWN = {"problem": "PENDULUM", "N": 10, "n_iterations": 2}
EXPERIMENT = {"problem": "PENDULUM", "N": 4, "HIDDEN": [16, 16],
              "N_PARTICLES": 8, "TRAIN_N_ITER": 5, "max_trials": 1,
              "n_iterations": 2}
# The pendulum's BNN sizes and angles (pddp_tpu's PendulumDynamicsModel).
STATE, ACTION, ANGULAR, NON_ANGULAR = 2, 1, (0,), (1,)


def known_U0(N, nu):
    """known_dynamics.py's draw before its 0.5 scale."""
    return np.random.default_rng(0).standard_normal((N, nu))


def experiment_U0(N, nu, seed=0):
    """experiment.py's uniform draw (seed SEED + 1)."""
    return np.random.default_rng(seed + 1).random((N, nu))


def _stand_in(jax, **random):
    """A stand-in for a script's ``jax`` with ``random`` functions
    replaced."""
    rnd = types.SimpleNamespace(**{k: getattr(jax.random, k)
                                   for k in ("PRNGKey", "split")})
    for k, fn in random.items():
        setattr(rnd, k, fn)
    return types.SimpleNamespace(random=rnd,
                                 default_backend=jax.default_backend)


def load():
    """The npz as a dict; ``exp_draws`` a list of (site, arrays) as
    ``PDDPController``'s ``draws`` takes them."""
    with np.load(PATH) as f:
        data = {k: f[k] for k in f.files}
    draws = []
    for j, site in enumerate(str(s) for s in data["exp_sites"]):
        pre = "exp_draw{}_".format(j)
        if site == "explore":
            draws.append((site, data[pre + "U"]))
        elif site == "fit":
            draws.append((site, {
                "batch_idx": data[pre + "batch_idx"],
                "noise": [data[pre + "noise_{}".format(i)]
                          for i in range(len(EXPERIMENT["HIDDEN"]))]}))
        else:
            draws.append((site, {
                "eps_out": data[pre + "eps_out"],
                "eps_in": data[pre + "eps_in"],
                "net": [data[pre + "net_{}".format(i)]
                        for i in range(len(EXPERIMENT["HIDDEN"]))]}))
    data["exp_draws"] = draws
    return data


def main():
    os.environ["PDDP_FORCE_CPU"] = "1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pddp_tpu.controllers import ilqr as jilqr
    from pddp_tpu.controllers.pddp import PDDPController
    from pddp_tpu.envs.base import SimEnv
    from pddp_tpu.models.bnn.model import BNNDynamicsModel
    from tests.golden import pddp_trace as tr

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import experiment as exp
    import known_dynamics as kd

    out, resets, J_hist = {}, [], []
    reset = SimEnv.reset

    def recording_reset(self):
        reset(self)
        resets.append(np.asarray(self._x))

    SimEnv.reset = recording_reset
    fit = jilqr.iLQRController.fit

    def recording_fit(self, U, *args, on_iteration=None, **kwargs):
        def on_it(i, state, Z, U_, J):
            J_hist.append(float(J))
            if on_iteration is not None:
                on_iteration(i, state, Z, U_, J)
        return fit(self, U, *args, on_iteration=on_it, **kwargs)

    jilqr.iLQRController.fit = recording_fit

    # known_dynamics.py
    kd.N = KNOWN["N"]
    kd.jax = _stand_in(jax, normal=lambda key, shape: jnp.asarray(
        known_U0(*shape)))
    kd.finish_figure = lambda *a, **k: None
    Z, U, state = kd.run(kd.SampleProblems[KNOWN["problem"]],
                         n_iterations=KNOWN["n_iterations"])
    out.update(kd_resets=np.stack(resets), kd_J=np.array(J_hist),
               kd_Z=np.asarray(Z), kd_U=np.asarray(U),
               kd_state=np.array(int(state)))

    # experiment.py
    del resets[:], J_hist[:]
    for k in ("N", "HIDDEN", "N_PARTICLES", "TRAIN_N_ITER"):
        setattr(exp, k, EXPERIMENT[k])
    exp.PLOT = False
    make_factory = exp.bnn_dynamics_model_factory

    def float64_factory(*args, **kwargs):
        """The script's factory, its model in float64 (its init's default
        is float32, beside the float64 env and cost)."""
        cls = make_factory(*args, **kwargs)
        return types.SimpleNamespace(init=lambda key, **kw: cls.init(
            key, dtype=jnp.float64, **kw))

    exp.bnn_dynamics_model_factory = float64_factory
    exp.jax = _stand_in(jax, uniform=lambda key, shape: jnp.asarray(
        experiment_U0(*shape, seed=exp.SEED)), PRNGKey=jax.random.PRNGKey)
    keys, sites = [], {}
    widths = EXPERIMENT["HIDDEN"]
    batch = 128

    class Recording(PDDPController):
        def __init__(self, env, model, cost, **kwargs):
            super().__init__(env, model, cost, **kwargs)
            out.update({"exp_init_net_{}".format(i): np.asarray(a)
                        for i, a in enumerate(
                            jax.tree_util.tree_leaves(model.net))})
            for k in ("X_mean", "X_std", "dX_mean", "dX_std", "eps_in",
                      "eps_out"):
                out["exp_init_" + k] = np.asarray(getattr(model, k))
            next_key = self._next_key

            def recording_next_key():
                k = next_key()
                keys.append(k)
                return k

            self._next_key = recording_next_key

    orig_fit, orig_resample = BNNDynamicsModel.fit, BNNDynamicsModel.resample

    def fit_model(self, X, U, dX, key=None, n_valid=None, **kwargs):
        sites[len(keys) - 1] = ("fit", tr.fit_draws(
            key, EXPERIMENT["TRAIN_N_ITER"], kwargs.get("batch_size", batch),
            X.shape[0] if n_valid is None else n_valid, widths, X.dtype))
        return orig_fit(self, X, U, dX, key=key, n_valid=n_valid, **kwargs)

    def resample(self, key):
        sites[len(keys) - 1] = ("resample", tr.resample_draws(key, self))
        return orig_resample(self, key)

    BNNDynamicsModel.fit, BNNDynamicsModel.resample = fit_model, resample
    exp.PDDPController = Recording
    printed = []
    real_print = print
    exp.print = lambda *a, **k: (printed.append(" ".join(map(str, a))),
                                 real_print(*a, **k))
    try:
        Z, U, state, _, trial_costs = exp.run(
            exp.SampleProblems[EXPERIMENT["problem"]],
            max_trials=EXPERIMENT["max_trials"],
            n_iterations=EXPERIMENT["n_iterations"], quiet=True)
    finally:
        BNNDynamicsModel.fit, BNNDynamicsModel.resample = (orig_fit,
                                                           orig_resample)
        jilqr.iLQRController.fit = fit
        SimEnv.reset = reset
    names = []
    for j, k in enumerate(keys):
        site, arrays = sites.get(j, ("explore", {"U": tr.explore_draws(
            k, (EXPERIMENT["N"], ACTION), jnp.float64)}))
        names.append(site)
        out.update(tr._flat("exp_draw{}".format(j), arrays))
    final = next(p for p in printed if p.startswith("final policy"))
    out.update(exp_sites=np.array(names), exp_resets=np.stack(resets),
               exp_J=np.array(J_hist), exp_Z=np.asarray(Z),
               exp_U=np.asarray(U), exp_state=np.array(int(state)),
               exp_trial_costs=np.array([J for _, J in trial_costs]),
               exp_final_cost=np.array(float(final.split(":")[1])))
    np.savez(PATH, **out)
    print("wrote", PATH, "sites", names, "known J", out["kd_J"],
          "experiment J", out["exp_J"])


if __name__ == "__main__":
    main()
