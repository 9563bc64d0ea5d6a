"""Receding-horizon MPC animation of the cartpole with known dynamics
(port of ``examples/mpc_animation.py``): each frame takes one real
environment step driven by ``controller(z, i, mpc=True)`` (a
warm-started single iLQR iteration) and plots the current nominal
trajectory's phase plot into a GIF. On the card the line search runs in
K2.

Usage:
    python examples_torch/mpc_animation.py [show] [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _root not in _sys.path:
    _sys.path.insert(0, _root)

import os

import numpy as np
import torch

from examples_torch.animation import phase_plot
from examples_torch.utils import device_parser, figure_path, no_figure, \
    pyplot
from pddp_tpu_torch.controllers import iLQRController
from pddp_tpu_torch.device import resolve_device
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.cartpole import (CartpoleCost,
                                              CartpoleDynamicsModel,
                                              CartpoleEnv)

DT = 0.1
N = 25
ITERATIONS = 50
U_MAX = 10.0
DTYPE = torch.float32
ENCODING = StateEncoding.IGNORE_UNCERTAINTY


def main(argv=None, save_path=None):
    parser = device_parser("Receding-horizon MPC animation (cartpole).")
    parser.add_argument("show", nargs="?", default=None)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    save_path = save_path or figure_path("mpc.gif")
    cost = CartpoleCost(device=device, dtype=DTYPE)
    model = CartpoleDynamicsModel(dt=DT, device=device, dtype=DTYPE)
    env = CartpoleEnv(dt=DT, device=device, dtype=DTYPE)
    u_max = torch.full((1,), U_MAX, dtype=DTYPE, device=device)

    controller = iLQRController(env, model, cost,
                                fused_rollout=device.type == "cuda")
    U = torch.as_tensor(
        0.1 * np.random.default_rng(0).standard_normal(
            (N, model.action_size)), dtype=DTYPE, device=device)
    controller.fit(U, encoding=ENCODING, n_iterations=1, tol=0.0,
                   u_min=-u_max, u_max=u_max)

    # The frames: one MPC tick each, the nominal path after it.
    env.reset()
    frames, actions = [], []
    for i in range(ITERATIONS):
        z0 = env.get_state().encode(ENCODING).to(DTYPE)
        u = controller(z0, i, ENCODING, mpc=True, u_min=-u_max,
                       u_max=u_max)
        env.apply(u)
        actions.append(float(u[0]))
        frames.append(controller._Z_nominal.detach().cpu())
    x = env.get_state().mean().detach().cpu()
    print("{} MPC ticks; end state {}".format(len(frames),
                                              np.round(x.numpy(), 4)))

    plt = pyplot()
    if plt is None:
        no_figure(os.path.basename(save_path))
        return frames, actions
    from matplotlib.animation import FuncAnimation, PillowWriter
    fig, ax = plt.subplots(figsize=(8, 6), dpi=100)
    anim = FuncAnimation(fig, lambda i: phase_plot(ax, frames[i], i),
                         frames=np.arange(len(frames)), interval=100)
    if args.show == "show" and os.environ.get("DISPLAY"):
        plt.show()
    else:
        anim.save(save_path, writer=PillowWriter(fps=10))
        print("saved", save_path)
    plt.close(fig)
    return frames, actions


if __name__ == "__main__":
    main()
