"""``pddp_tpu``'s PDDP loop, recorded for the port's replay
(``tests/test_torch_pddp.py``), and the JAX draws of each of its sites.

One ``PDDPController.fit`` at a tiny size: the pendulum, a BNN with
hidden [16, 16] and P=8 particles, N=6, the Cholesky codec, actions in
[-2.5, 2.5], two initial rollouts, training ``TRAINING`` (5 AMSGrad
steps), ``max_trials`` 1 (so one MPC trial of 2N ticks) and 2 iLQR
iterations a fit, in float64. ``_next_key`` is wrapped here (not in
``pddp_tpu``) so that every key of the chain is recorded, and each is
expanded into the arrays ``pddp_tpu`` draws from it at its site
(``explore_draws``, ``fit_draws``, ``resample_draws``): the port replays
the loop with those arrays. Also recorded: the initial model's arrays,
each env reset's state, each trial's (X, U, dX) and cost, each model fit's
leaves and normalizers, each iLQR fit's Z, U, end state and J, and each
MPC tick's input (the encoded state and the controller's state dict) and
output (the control, the controller's state dict after it).

Compiling this loop takes pddp_tpu minutes on the CPU, past the test
budget, so the trace is stored in ``pddp_trace.npz``. Regenerate it with

    JAX_PLATFORMS=cpu python -m tests.golden.pddp_trace
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "pddp_trace.npz")

STATE, ACTION, ANGULAR, NON_ANGULAR = 2, 1, (0,), (1,)
HIDDEN, P, N, DT, UMAX = [16, 16], 8, 6, 0.1, 2.5
TRAINING = {"n_iter": 5, "learning_rate": 1e-3, "batch_size": 8}
FIT = {"max_trials": 1, "n_initial_sample_trajectories": 2,
       "n_iterations": 2}
ENCODING = "UPPER_TRIANGULAR_CHOLESKY"


def U0():
    return 0.1 * np.ones((N, ACTION))


def explore_draws(key, shape, dtype):
    """The uniform [0, 1) actions ``PDDPController.fit`` draws from key."""
    import jax
    return np.asarray(jax.random.uniform(key, shape, dtype))


def fit_draws(key, n_iter, batch_size, n_valid, widths, dtype):
    """``fit_bnn``'s draws from key: ``batch_idx`` (n_iter, batch_size)
    in [0, n_valid), and per hidden layer (concrete dropout) the uniform
    noise (n_iter, batch_size, width) of every step."""
    import jax
    k_batch, k_noise = jax.random.split(key)
    batch_idx = jax.random.randint(k_batch, (n_iter, batch_size), 0,
                                   n_valid)
    noise = [[] for _ in widths]
    for nkey in jax.random.split(k_noise, n_iter):
        for i, k in enumerate(jax.random.split(nkey, len(widths))):
            noise[i].append(jax.random.uniform(
                k, (batch_size, widths[i]), dtype, 1e-5, 1.0 - 1e-5))
    return {"batch_idx": np.asarray(batch_idx),
            "noise": [np.stack([np.asarray(a) for a in n]) for n in noise]}


def resample_draws(key, model):
    """``BNNDynamicsModel.resample``'s raw draws from key: ``eps_out`` and
    ``eps_in`` (standard normal, before the standardization) and the
    concrete dropout noise of each hidden layer."""
    import jax
    k1, k2 = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    dtype = model.eps_out.dtype
    drops = model.net.dropouts
    keys = jax.random.split(kb, max(len(drops), 1))
    return {"eps_out": np.asarray(jax.random.normal(
                ka, model.eps_out.shape, dtype)),
            "eps_in": np.asarray(jax.random.normal(
                k2, model.eps_in.shape, dtype)),
            "net": [np.asarray(jax.random.uniform(
                k, d.noise.shape, d.noise.dtype, 1e-5, 1.0 - 1e-5))
                for d, k in zip(drops, keys)]}


def _flat(prefix, d):
    """A draw's arrays as flat npz entries."""
    out = {}
    for k, v in d.items():
        if isinstance(v, list):
            for i, a in enumerate(v):
                out["{}_{}_{}".format(prefix, k, i)] = a
        else:
            out["{}_{}".format(prefix, k)] = v
    return out


def load():
    """The trace as a dict: ``draws`` a list of (site, arrays) as
    ``PDDPController``'s ``draws`` takes them, the rest numpy arrays."""
    with np.load(PATH) as f:
        data = {k: f[k] for k in f.files}
    sites = [str(s) for s in data["sites"]]
    draws = []
    for j, site in enumerate(sites):
        pre = "draw{}_".format(j)
        if site == "explore":
            draws.append((site, data[pre + "U"]))
        elif site == "fit":
            draws.append((site, {
                "batch_idx": data[pre + "batch_idx"],
                "noise": [data[pre + "noise_{}".format(i)]
                          for i in range(len(HIDDEN))]}))
        else:
            draws.append((site, {
                "eps_out": data[pre + "eps_out"],
                "eps_in": data[pre + "eps_in"],
                "net": [data[pre + "net_{}".format(i)]
                        for i in range(len(HIDDEN))]}))
    data["draws"] = draws
    return data


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pddp_tpu.controllers import ilqr as jilqr
    from pddp_tpu.controllers.pddp import PDDPController
    from pddp_tpu.encoding import StateEncoding
    from pddp_tpu.examples.pendulum import PendulumCost, PendulumEnv
    from pddp_tpu.models.bnn import bnn_dynamics_model_factory
    from pddp_tpu.models.bnn.model import BNNDynamicsModel

    enc = StateEncoding[ENCODING]
    env = PendulumEnv(dt=DT, seed=0)
    cls = bnn_dynamics_model_factory(STATE, ACTION, HIDDEN,
                                     angular_indices=ANGULAR,
                                     non_angular_indices=NON_ANGULAR)
    model = cls.init(jax.random.PRNGKey(0), n_particles=P,
                     horizon=2 * N + 1, dtype=jnp.float64)
    out = {"init_net_{}".format(i): np.asarray(a) for i, a in
           enumerate(jax.tree_util.tree_leaves(model.net))}
    for k in ("X_mean", "X_std", "dX_mean", "dX_std", "eps_in", "eps_out"):
        out["init_" + k] = np.asarray(getattr(model, k))
    ctrl = PDDPController(env, model, PendulumCost(), training_opts=TRAINING,
                          seed=0)

    keys, sites = [], {}
    next_key = ctrl._next_key

    def recording_next_key():
        k = next_key()
        keys.append(k)
        return k

    ctrl._next_key = recording_next_key
    resets = []
    reset = env.reset

    def recording_reset():
        reset()
        resets.append(np.asarray(env._x))

    env.reset = recording_reset

    fits, solves, trial_J = [], [], []
    orig_fit = BNNDynamicsModel.fit
    orig_resample = BNNDynamicsModel.resample
    orig_solve_fit = jilqr.iLQRController.fit
    orig_store = jilqr.iLQRController._store
    orig_apply = PDDPController._apply_controller
    orig_forward = jilqr.iLQRController.forward
    widths = HIDDEN
    ticks = []

    def state_dict(ctrl_):
        return {k: np.asarray(v) for k, v in ctrl_.state_dict().items()}

    def forward(self, z, i, *args, mpc=False, **kwargs):
        before = state_dict(self)
        u = orig_forward(self, z, i, *args, mpc=mpc, **kwargs)
        if mpc:
            ticks.append({"z": np.asarray(z), "i": np.array(i),
                          "u": np.asarray(u), "state": np.array(
                              int(self._last_state)),
                          **{"before_" + k: v for k, v in before.items()},
                          **{"after_" + k: v for k, v in
                             state_dict(self).items()}})
        return u

    def fit(self, X, U, dX, key=None, n_valid=None, **kwargs):
        sites[len(keys) - 1] = ("fit", fit_draws(
            key, TRAINING["n_iter"], TRAINING["batch_size"],
            X.shape[0] if n_valid is None else n_valid, widths, X.dtype))
        m = orig_fit(self, X, U, dX, key=key, n_valid=n_valid, **kwargs)
        fits.append([np.asarray(a) for a in jax.tree_util.tree_leaves(m.net)]
                    + [np.asarray(getattr(m, k)) for k in
                       ("X_mean", "X_std", "dX_mean", "dX_std")])
        return m

    def resample(self, key):
        sites[len(keys) - 1] = ("resample", resample_draws(key, self))
        return orig_resample(self, key)

    def store(self, result):
        self._last_J = float(result.J_opt)
        self._last_state = int(result.state)
        return orig_store(self, result)

    def solve_fit(self, U, *args, **kwargs):
        Z, U_, state = orig_solve_fit(self, U, *args, **kwargs)
        solves.append((np.asarray(Z), np.asarray(U_), int(state),
                       self._last_J))
        return Z, U_, state

    def apply_controller(self, controller, H, *args, **kwargs):
        data, J = orig_apply(self, controller, H, *args, **kwargs)
        trials.append(data)
        trial_J.append(float(J))
        return data, J

    BNNDynamicsModel.fit = fit
    BNNDynamicsModel.resample = resample
    jilqr.iLQRController.fit = solve_fit
    jilqr.iLQRController._store = store
    PDDPController._apply_controller = apply_controller
    jilqr.iLQRController.forward = forward
    trials = []
    umax = jnp.array([UMAX])
    try:
        Z, U, state = ctrl.fit(
            jnp.asarray(U0()), encoding=enc, quiet=True, u_min=-umax,
            u_max=umax, **FIT)
    finally:
        BNNDynamicsModel.fit = orig_fit
        BNNDynamicsModel.resample = orig_resample
        jilqr.iLQRController.fit = orig_solve_fit
        jilqr.iLQRController._store = orig_store
        PDDPController._apply_controller = orig_apply
        jilqr.iLQRController.forward = orig_forward

    names = []
    for j, k in enumerate(keys):
        site, arrays = sites.get(j, ("explore", {"U": explore_draws(
            k, (N, ACTION), jnp.float64)}))
        names.append(site)
        out.update(_flat("draw{}".format(j), arrays))
    out["sites"] = np.array(names)
    out["resets"] = np.stack(resets)
    out["trial_J"] = np.array(trial_J)
    for t, data in enumerate(trials):
        for name, a in zip(("X", "U", "dX"), data):
            out["trial{}_{}".format(t, name)] = np.asarray(a)
    for f, leaves in enumerate(fits):
        for i, a in enumerate(leaves):
            out["fit{}_{}".format(f, i)] = a
    for s, (Z_, U_, st, J) in enumerate(solves):
        out.update({"solve{}_Z".format(s): Z_, "solve{}_U".format(s): U_,
                    "solve{}_state".format(s): np.array(st),
                    "solve{}_J".format(s): np.array(J)})
    for t, rec in enumerate(ticks):
        out.update({"tick{}_{}".format(t, k): v for k, v in rec.items()})
    out.update(n_ticks=np.array(len(ticks)), n_trials=np.array(len(trials)), n_fits=np.array(len(fits)),
               n_solves=np.array(len(solves)), Z=np.asarray(Z),
               U=np.asarray(U), state=np.array(int(state)))
    np.savez(PATH, **out)
    print("wrote", PATH, "sites", names, "trials", len(trials), "fits",
          len(fits), "solves", len(solves), "J", trial_J)


if __name__ == "__main__":
    main()
