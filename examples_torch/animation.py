"""Known-dynamics iLQR phase-plot animation of the cartpole (port of
``examples/animation.py``): records the nominal trajectory after every
iLQR iteration and animates the (theta, theta-dot) phase plot across
iterations into a GIF. On the card the line search runs in K2.

Usage:
    python examples_torch/animation.py [show] [--device cpu]
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

from examples_torch.utils import device_parser, figure_path, no_figure, \
    pyplot
from pddp_tpu_torch.controllers import iLQRController
from pddp_tpu_torch.controllers.ilqr import forward
from pddp_tpu_torch.device import resolve_device
from pddp_tpu_torch.encoding import StateEncoding, decode_mean
from pddp_tpu_torch.examples.cartpole import (CartpoleCost,
                                              CartpoleDynamicsModel,
                                              CartpoleEnv)

DT = 0.1
N = 25
ITERATIONS = 100
U_MAX = 10.0
DTYPE = torch.float32

# Known dynamics: uncertainty disabled.
ENCODING = StateEncoding.IGNORE_UNCERTAINTY


def phase_plot(ax, Z, iteration):
    X = decode_mean(torch.as_tensor(Z).detach().cpu(), ENCODING).numpy()
    theta = np.unwrap(X[:, 2])
    theta_dot = X[:, 3]
    ax.clear()
    ax.scatter(-np.pi, 0, marker="*", color="r")
    ax.scatter(np.pi, 0, marker="*", color="r")
    ax.plot(theta, theta_dot)
    ax.set_xlim(-3 * np.pi, 3 * np.pi)
    ax.set_ylim(-4 * np.pi, 4 * np.pi)
    ax.set_xlabel("Orientation (rad)")
    ax.set_ylabel("Angular velocity (rad/s)")
    ax.set_title("Iteration {}".format(iteration))
    return (ax,)


def main(argv=None, save_path=None):
    parser = device_parser("iLQR phase-plot animation (cartpole).")
    parser.add_argument("show", nargs="?", default=None)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    save_path = save_path or figure_path("ilqr.gif")
    cost = CartpoleCost(device=device, dtype=DTYPE)
    model = CartpoleDynamicsModel(dt=DT, device=device, dtype=DTYPE)
    env = CartpoleEnv(dt=DT, device=device, dtype=DTYPE)
    u_max = torch.full((1,), U_MAX, dtype=DTYPE, device=device)

    controller = iLQRController(env, model, cost,
                                fused_rollout=device.type == "cuda")
    U = torch.as_tensor(
        0.1 * np.random.default_rng(0).standard_normal(
            (N, model.action_size)), dtype=DTYPE, device=device)

    z0 = env.get_state().encode(ENCODING).to(DTYPE)
    Zs = [forward(z0, U, model, cost, ENCODING)[0].detach().cpu()]

    def on_iteration(iteration, state, Z, U, J_opt):
        Zs.append(Z.detach().cpu())

    controller.fit(U, encoding=ENCODING, n_iterations=ITERATIONS,
                   on_iteration=on_iteration, tol=0.0, u_min=-u_max,
                   u_max=u_max)
    print("{} nominal trajectories recorded; theta_T = {:.4f}".format(
        len(Zs), float(decode_mean(Zs[-1], ENCODING)[-1, 2])))

    plt = pyplot()
    if plt is None:
        no_figure(os.path.basename(save_path))
        return Zs
    from matplotlib.animation import FuncAnimation, PillowWriter
    fig, ax = plt.subplots(figsize=(8, 6), dpi=100)
    anim = FuncAnimation(fig, lambda i: phase_plot(ax, Zs[i], i),
                         frames=np.arange(len(Zs)), interval=1000)
    if args.show == "show" and os.environ.get("DISPLAY"):
        plt.show()
    else:
        anim.save(save_path, writer=PillowWriter(fps=2))
        print("saved", save_path)
    plt.close(fig)
    return Zs


if __name__ == "__main__":
    main()
