"""Known-dynamics iLQR on the whole problem suite (port of
``examples/known_dynamics.py``): solves each sample problem with its exact
analytic model, prints the cost and end state, and plots the loss path
and the optimized trajectory.

On the card the line search runs in K2 (``fused_rollout``), which takes
the action bounds; the bounded backward is the plain constrained one.

Usage:
    python examples_torch/known_dynamics.py [problem] [n_iterations]
        [--device cpu]
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
                                  no_figure, plot_path, pyplot, sync)
from pddp_tpu_torch.controllers import iLQRController
from pddp_tpu_torch.device import resolve_device
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.problems import SampleProblems

DT = 0.05
N = 100
DTYPE = torch.float32
ENCODING = StateEncoding.IGNORE_UNCERTAINTY
UMAX = {
    SampleProblems.CARTPOLE: 10.0,
    SampleProblems.DOUBLE_CARTPOLE: 30.0,
    SampleProblems.PENDULUM: 5.0,
    SampleProblems.RENDEZVOUS: 10.0,
}


def initial_actions(action_size):
    """0.5-scale normal excitation (numpy's generator at seed 0): at 0.1
    the swing-up can stall in the hanging-rest local minimum."""
    return 0.5 * np.random.default_rng(0).standard_normal((N, action_size))


def run(problem: SampleProblems, n_iterations=100, device=None):
    device = resolve_device(device)
    env, cost, model = problem.setup(DT, seed=0, device=device, dtype=DTYPE)
    umax = UMAX[problem] * torch.ones(env.action_size, dtype=DTYPE,
                                      device=device)
    controller = iLQRController(env, model, cost,
                                fused_rollout=device.type == "cuda")
    U0 = torch.as_tensor(initial_actions(model.action_size), dtype=DTYPE,
                         device=device)

    J_hist = []

    def on_iteration(iteration, state, Z, U, J):
        J_hist.append(float(J))

    sync(device)
    t0 = time.time()
    Z, U, state = controller.fit(U0, encoding=ENCODING,
                                 n_iterations=n_iterations,
                                 on_iteration=on_iteration,
                                 u_min=-umax, u_max=umax)
    sync(device)
    wall = time.time() - t0
    print("{}: J = {:.4f}  state = {}  ({} iters, {:.2f}s)".format(
        problem.name.lower(), J_hist[-1] if J_hist else float("nan"),
        state.name, len(J_hist), wall))

    name = "{}_known.png".format(problem.name.lower())
    plt = pyplot()
    if plt is None:
        no_figure(name)
        return Z, U, state
    plt.figure(figsize=(10, 6))
    plt.subplot(2, 1, 1)
    plt.plot(J_hist)
    plt.yscale("log")
    plt.ylabel("Total loss")
    plt.title("{} (known dynamics)".format(problem.name.lower()))
    plt.subplot(2, 1, 2)
    plot_path(plt, Z, encoding=ENCODING, horizon=N, legend=False)
    plt.xlabel("Time step")
    finish_figure(plt, figure_path(name))
    plt.close()
    return Z, U, state


def main(argv=None):
    parser = device_parser("Known-dynamics iLQR on the sample problems.")
    parser.add_argument("problem", nargs="?", default=None,
                        help="one of: " + ", ".join(
                            m.lower() for m in SampleProblems.__members__))
    parser.add_argument("n_iterations", nargs="?", type=int, default=100)
    args = parser.parse_args(argv)
    if args.problem is None:
        problems = list(SampleProblems)
    else:
        name = args.problem.upper()
        if name not in SampleProblems.__members__:
            raise SystemExit("Unknown problem {!r}; choose from: {}".format(
                args.problem, ", ".join(m.lower() for m in
                                        SampleProblems.__members__)))
        problems = [SampleProblems[name]]
    return [run(p, n_iterations=args.n_iterations, device=args.device)
            for p in problems]


if __name__ == "__main__":
    main()
