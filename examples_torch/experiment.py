"""Problem-switchable PDDP experiment (port of ``examples/experiment.py``):
the full PDDP loop (episodic data collection, BNN training, trajectory
optimization on the learned belief model, MPC) on any problem of the
``SampleProblems`` registry, with loss and path plots per trial and a
final policy execution.

As in ``pddp_tpu``, the PDDP loop's iLQR runs the scan backward and the
scan line search.

Usage:
    python examples_torch/experiment.py
        [cartpole|pendulum|double_cartpole|rendezvous] [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _root not in _sys.path:
    _sys.path.insert(0, _root)

import time

import numpy as np
import torch

from examples_torch.utils import (device_parser, figure_path, finish_figure,
                                  no_figure, plot_path, pyplot, rollout)
from pddp_tpu_torch.controllers import PDDPController
from pddp_tpu_torch.device import resolve_device
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.problems import SampleProblems
from pddp_tpu_torch.models.bnn import bnn_dynamics_model_factory

N = 25            # Horizon length.
DT = 0.1          # Time step (s).
DTYPE = torch.float32
PLOT = True
ENCODING = StateEncoding.DEFAULT
MAX_TRIALS = 5
HIDDEN = [200, 200]
N_PARTICLES = 100
TRAIN_N_ITER = 500
SEED = 0

# Action bounds per problem.
UMAX = {
    SampleProblems.CARTPOLE: 10.0,
    SampleProblems.DOUBLE_CARTPOLE: 20.0,
    SampleProblems.PENDULUM: 2.5,
    SampleProblems.RENDEZVOUS: 10.0,
}


def initial_actions(action_size, umin, umax):
    """Uniform in the bounds (numpy's generator at SEED + 1)."""
    u = np.random.default_rng(SEED + 1).random((N, action_size))
    return (umax - umin) * u + umin


def run(problem: SampleProblems, max_trials=MAX_TRIALS, n_iterations=50,
        quiet=False, device=None):
    device = resolve_device(device)
    env, cost, _ = problem.setup(DT, seed=SEED, device=device, dtype=DTYPE)
    model_class = problem.get_model_class()
    real_model = model_class(dt=DT, device=device, dtype=DTYPE)

    umax = UMAX[problem] * np.ones(env.action_size)
    umin = -umax

    factory = bnn_dynamics_model_factory(
        env.state_size, env.action_size, HIDDEN,
        model_class.angular_indices, model_class.non_angular_indices)
    model = factory.init(seed=SEED, n_particles=N_PARTICLES,
                         horizon=2 * N + 1, dtype=DTYPE, device=device)

    controller = PDDPController(
        env, model, cost,
        model_opts={},
        training_opts={"n_iter": TRAIN_N_ITER, "learning_rate": 1e-3},
        seed=SEED)

    J_hist = []
    trial_costs = []  # real-environment cost of each collected trajectory
    t0 = time.time()
    plt = pyplot() if PLOT else None
    if PLOT and plt is None:
        no_figure("{}_*.png".format(problem.name.lower()))

    def on_iteration(iteration, state, Z, U, J_opt):
        J_hist.append(float(J_opt))
        if not quiet and (iteration % 10 == 9 or iteration == 0):
            print("  iter {:3d}  J = {:.4f}  state = {}".format(
                iteration + 1, float(J_opt), state.name))

    def _trial_cost(X, U):
        """Cost of a collected (real-env) trajectory on the raw states
        with IGNORE_UNCERTAINTY: the learning-progress metric."""
        IGN = StateEncoding.IGNORE_UNCERTAINTY
        J = 0.0
        for i in range(U.shape[0]):
            J += float(cost(X[i], U[i], i, terminal=False, encoding=IGN))
        return J

    def on_trial(trial, X, U):
        Jt = _trial_cost(X, U)
        trial_costs.append((X.shape[0], Jt))
        if not quiet:
            print("trial {}  collected {} transitions  env cost {:.2f}  "
                  "({:.1f}s)".format(trial + 1, X.shape[0], Jt,
                                     time.time() - t0))
        if plt is not None:
            plt.figure(figsize=(10, 4))
            plt.title("{} trial {}".format(problem.name.lower(), trial + 1))
            plot_path(plt, X, encoding=StateEncoding.IGNORE_UNCERTAINTY,
                      horizon=X.shape[0] - 1)
            finish_figure(plt, figure_path("{}_trial{}.png".format(
                problem.name.lower(), trial + 1)))
            plt.close()

    U0 = torch.as_tensor(initial_actions(env.action_size, umin, umax),
                         dtype=DTYPE, device=device)
    u_min, u_max = (torch.as_tensor(b, dtype=DTYPE, device=device)
                    for b in (umin, umax))

    controller.train()
    Z, U, state = controller.fit(
        U0, encoding=ENCODING, n_iterations=n_iterations,
        on_iteration=on_iteration, on_trial=on_trial, max_trials=max_trials,
        u_min=u_min, u_max=u_max)

    if plt is not None:
        plt.figure(figsize=(8, 4))
        plt.plot(J_hist)
        plt.xlabel("Iteration")
        plt.ylabel("Total loss")
        plt.title("{} loss path".format(problem.name.lower()))
        finish_figure(plt, figure_path("{}_loss.png".format(
            problem.name.lower())))
        plt.close()

        plt.figure(figsize=(10, 4))
        real_Z = rollout(real_model, Z[0], U, ENCODING)
        plot_path(plt, Z, encoding=ENCODING, reality=real_Z, horizon=N)
        plt.title("{} optimized path (dashed = ground truth)".format(
            problem.name.lower()))
        finish_figure(plt, figure_path("{}_path.png".format(
            problem.name.lower())))
        plt.close()

    # Final policy execution on the real environment.
    env.reset()
    J_real = 0.0
    for i in range(N):
        z = env.get_state().encode(ENCODING)
        u = controller(z, i, ENCODING)
        J_real += float(cost(z, u, i, terminal=False, encoding=ENCODING))
        env.apply(u)
    z = env.get_state().encode(ENCODING)
    J_real += float(cost(z, None, N, terminal=True, encoding=ENCODING))
    print("final policy execution cost: {:.4f}".format(J_real))

    if not quiet and trial_costs:
        print("per-trial env costs (len, J):", trial_costs)

    env.close()
    return Z, U, state, J_hist, trial_costs


def main(argv=None, problem=None):
    parser = device_parser("The PDDP experiment on a sample problem.")
    if problem is None:
        parser.add_argument("problem", nargs="?", default="cartpole")
    args = parser.parse_args(argv)
    name = (args.problem if problem is None else problem).upper()
    if name not in SampleProblems.__members__:
        raise SystemExit("Unknown problem {!r}; choose from: {}".format(
            name.lower(), ", ".join(m.lower() for m in
                                    SampleProblems.__members__)))
    return run(SampleProblems[name], device=args.device)


if __name__ == "__main__":
    main()
