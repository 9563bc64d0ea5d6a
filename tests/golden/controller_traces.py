"""``pddp_tpu``'s ``iLQRController`` traces that the port's controller is
held against (``tests/test_torch_controller.py``).

Two cases at a short horizon: the pendulum under IGNORE_UNCERTAINTY (the
README's Quick start) and the cartpole under the Cholesky codec. Each
records, from one start state and seeded numpy inputs:

 * ``fit`` (Z, U, K, end state, mu, delta);
 * ``forward`` with ``mpc=False``, ``ignore_uncertainty`` on and off, at a
   perturbed state of step 3;
 * one warm ``step`` from a perturbed start;
 * three ``forward(mpc=True)`` ticks from the fitted state, cold and with
   ``warm_reg``: the control, the shifted nominal actions, mu and delta.

Compiling these solves takes pddp_tpu minutes on the CPU, past the test
budget, so the results are stored in ``controller_traces.npz``.
Regenerate it with

    JAX_PLATFORMS=cpu python -m tests.golden.controller_traces
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "controller_traces.npz")

#: name -> (example, dt, x0, N, fit iterations, encoding name)
CASES = {
    "pendulum": ("pendulum", 0.1, [0.0, 0.0], 20, 10,
                 "IGNORE_UNCERTAINTY"),
    "cartpole_chol": ("cartpole", 0.05, [0.0, 0.0, 0.1, 0.0], 12, 4,
                      "UPPER_TRIANGULAR_CHOLESKY"),
}
TICKS = 3


def inputs(name):
    """Seeded numpy inputs of case ``name``: U0 (N, nu), and the mean
    perturbations of the forward, step and MPC states."""
    _, _, x0, N, _, _ = CASES[name]
    n = len(x0)
    rng = np.random.default_rng(7)
    return {"U0": 0.1 * rng.standard_normal((N, 1)),
            "dx_forward": 1e-2 * rng.standard_normal(n),
            "dx_step": 1e-2 * rng.standard_normal(n),
            "dx_mpc": 1e-2 * rng.standard_normal((TICKS, n))}


def perturbed(z, dx):
    """z with its mean (the first len(dx) entries) moved by dx."""
    z = np.array(z, dtype=np.float64)
    z[:len(dx)] += dx
    return z


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pddp_tpu.controllers.ilqr import iLQRController
    from pddp_tpu.encoding import StateEncoding
    from pddp_tpu.examples import cartpole, pendulum

    examples = {"pendulum": (pendulum.PendulumEnv, pendulum.PendulumCost),
                "cartpole": (cartpole.CartpoleEnv, cartpole.CartpoleCost)}
    out = {}
    for name, (ex, dt, x0, N, iters, codec) in CASES.items():
        enc = StateEncoding[codec]
        env_cls, cost_cls = examples[ex]
        env = env_cls(dt=dt)
        env._x = jnp.asarray(x0, jnp.float64)
        ctrl = iLQRController(env, env.model, cost_cls())
        ins = inputs(name)
        Z, U, state = ctrl.fit(jnp.asarray(ins["U0"]), encoding=enc,
                               n_iterations=iters)
        fitted = ctrl.state_dict()
        rec = {"fit_Z": Z, "fit_U": U, "fit_K": fitted["K"],
               "fit_state": int(state), "fit_mu": fitted["mu"],
               "fit_delta": fitted["delta"]}
        Zf = np.asarray(Z)
        z_fwd = perturbed(Zf[3], ins["dx_forward"])
        rec["forward_ign"] = ctrl.forward(jnp.asarray(z_fwd), 3, enc)
        rec["forward_full"] = ctrl.forward(jnp.asarray(z_fwd), 3, enc,
                                           ignore_uncertainty=False)
        st = ctrl.step(jnp.asarray(perturbed(Zf[0], ins["dx_step"])),
                       encoding=enc)
        s = ctrl.state_dict()
        rec.update(step_state=int(st), step_Z=s["Z_nominal"],
                   step_U=s["U_nominal"], step_K=s["K"], step_mu=s["mu"],
                   step_delta=s["delta"])
        for tag, warm in (("cold", False), ("warm", True)):
            ctrl.load_state_dict(fitted)
            us, Us, mus, deltas = [], [], [], []
            for t in range(TICKS):
                z = jnp.asarray(perturbed(Zf[t], ins["dx_mpc"][t]))
                us.append(ctrl.forward(z, t, enc, mpc=True, warm_reg=warm))
                s = ctrl.state_dict()
                Us.append(s["U_nominal"])
                mus.append(s["mu"])
                deltas.append(s["delta"])
            rec.update({"mpc_{}_u".format(tag): np.stack(us),
                        "mpc_{}_U".format(tag): np.stack(Us),
                        "mpc_{}_mu".format(tag): np.stack(mus),
                        "mpc_{}_delta".format(tag): np.stack(deltas)})
        for k, v in rec.items():
            out["{}_{}".format(name, k)] = np.asarray(v, dtype=np.float64)
        print(name, "fit", iLQRController.__name__, int(state),
              "step", int(st), flush=True)
    np.savez(PATH, **out)
    print("wrote", PATH)


if __name__ == "__main__":
    main()
