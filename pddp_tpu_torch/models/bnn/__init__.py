"""Bayesian neural network dynamics (port of ``pddp_tpu.models.bnn``)."""

from .losses import gaussian_log_likelihood
from .model import (BNNDynamicsModel, BNNState, ParticlesBNNDynamicsModel,
                    bnn_dynamics_model_factory, fit_bnn, infer_eps,
                    load_bnn_npz, moment_match, save_bnn_npz, training_loss)
from .network import (TRAINABLE_FIELDS, BDropout, BayesianMLP, CDropout,
                      Linear, TLNDropout, bayesian_mlp, trainable_mask)

# ``pddp_tpu``'s reference-name aliases.
BSequential = BayesianMLP
bayesian_model = bayesian_mlp

__all__ = ["BSequential", "bayesian_model", "BNNDynamicsModel", "BNNState",
           "ParticlesBNNDynamicsModel", "bnn_dynamics_model_factory",
           "fit_bnn", "gaussian_log_likelihood", "infer_eps", "load_bnn_npz",
           "moment_match", "save_bnn_npz", "training_loss",
           "TRAINABLE_FIELDS", "BDropout", "BayesianMLP", "CDropout",
           "Linear", "TLNDropout", "bayesian_mlp", "trainable_mask"]
