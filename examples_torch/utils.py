"""Shared helpers of the example scripts (port of ``examples/utils.py``).

``rollout`` is the port's ``controllers.ilqr.rollout``. The figures need
matplotlib, which is imported only where a figure is drawn
(``pyplot``): without it a script prints its numbers and one line saying
that no figure was written. Figures go to the temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from pddp_tpu_torch.controllers.ilqr import rollout as _rollout
from pddp_tpu_torch.encoding import StateEncoding, decode_mean, decode_std


def rollout(model, z0, U, encoding: StateEncoding):
    """Open-loop replay of U through the model: Z (N+1, nz)."""
    return _rollout(model, z0, U, encoding)[0]


def device_parser(description):
    """An argument parser that takes ``--device`` (default: the card)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs "
                             "the plain versions on the CPU)")
    return parser


def pyplot():
    """``matplotlib.pyplot`` (the Agg backend without a display), or None
    where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def no_figure(name):
    print("no figure written ({}): matplotlib is not installed".format(
        name))


def figure_path(name):
    """Where figure ``name`` is saved: the temporary directory."""
    return os.path.join(tempfile.gettempdir(), name)


def plot_path(plt, Z, encoding=StateEncoding.DEFAULT, indices=None,
              labels=None, reality=None, std_scale=1.0, legend=True,
              horizon=None):
    """State path with 1/2/3-sigma uncertainty bands."""
    Z = torch.as_tensor(Z).detach().cpu()
    mean_ = decode_mean(Z, encoding).numpy()
    std_ = decode_std(Z, encoding).numpy()
    if reality is not None:
        real_mean = decode_mean(torch.as_tensor(reality).detach().cpu(),
                                encoding).numpy()
    if indices is None:
        indices = list(range(mean_.shape[-1]))
    if labels is None:
        labels = ["State {}".format(i) for i in indices]
    colors = ["C{}".format(i % 10) for i in range(mean_.shape[-1])]
    t = range(Z.shape[0])
    for label, index in zip(labels, indices):
        mean, std = mean_[:, index], std_[:, index]
        if reality is not None:
            plt.plot(t, real_mean[:, index], color=colors[index],
                     linestyle="dashed")
        plt.plot(t, mean, label=label, color=colors[index])
        for i in range(1, 4):
            j = std_scale * i
            plt.gca().fill_between(t, mean - j * std, mean + j * std,
                                   color=colors[index], alpha=1.0 / (i + 1))
    if legend:
        plt.legend(bbox_to_anchor=(0.0, 1.0, 1.0, 0.7), loc="upper left",
                   ncol=len(indices), mode="expand", borderaxespad=0.0)
    if horizon is not None:
        plt.xlim(0, horizon)
    plt.axhline(0, linestyle="--", color="#333333", linewidth=0.25)


def finish_figure(plt, path):
    """Saves the current figure to ``path``."""
    plt.tight_layout()
    plt.savefig(path, dpi=120)
    print("saved", path)


def sync(device):
    """Waits for the card, so that a host clock around it reads its work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
