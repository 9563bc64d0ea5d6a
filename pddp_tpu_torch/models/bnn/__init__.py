"""Bayesian neural network dynamics (port of ``pddp_tpu.models.bnn``)."""

from .model import (BNNDynamicsModel, BNNState, ParticlesBNNDynamicsModel,
                    bnn_dynamics_model_factory, infer_eps, load_bnn_npz,
                    moment_match)
from .network import (BDropout, BayesianMLP, CDropout, Linear, TLNDropout,
                      bayesian_mlp)

__all__ = ["BNNDynamicsModel", "BNNState", "ParticlesBNNDynamicsModel",
           "bnn_dynamics_model_factory", "infer_eps", "load_bnn_npz",
           "moment_match",
           "BDropout", "BayesianMLP", "CDropout", "Linear", "TLNDropout",
           "bayesian_mlp"]
