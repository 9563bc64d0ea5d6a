"""Sample problem registry (port of ``pddp_tpu/examples/problems.py``):
the canonical (env, cost, model) triple of each bundled example."""

from __future__ import annotations

from enum import IntEnum

import torch

from . import cartpole, double_cartpole, pendulum, rendezvous

__all__ = ["SampleProblems"]


class SampleProblems(IntEnum):
    """Sample problem enum."""

    CARTPOLE = 1
    DOUBLE_CARTPOLE = 2
    PENDULUM = 3
    RENDEZVOUS = 4

    def setup(self, dt, render=False, seed=0, *, device=None,
              dtype=torch.float32, **kwargs):
        """The problem's env, cost and model, on ``device`` (default
        ``cuda``) in ``dtype``; ``kwargs`` go to the model's constructor,
        and the env simulates a model of its own built the same way.

        Returns:
            Tuple (env, cost, model).
        """
        model_class = self.get_model_class()

        def make_model():
            return model_class(dt=dt, device=device, dtype=dtype, **kwargs)

        model = make_model()
        cost = self.get_cost_class()(device=device, dtype=dtype)
        env = self.get_env_class()(dt=dt, model=make_model(), render=render,
                                   seed=seed)
        return env, cost, model

    def get_env_class(self):
        return {
            SampleProblems.CARTPOLE: cartpole.CartpoleEnv,
            SampleProblems.DOUBLE_CARTPOLE: double_cartpole.DoubleCartpoleEnv,
            SampleProblems.PENDULUM: pendulum.PendulumEnv,
            SampleProblems.RENDEZVOUS: rendezvous.RendezvousEnv,
        }[self]

    def get_cost_class(self):
        return {
            SampleProblems.CARTPOLE: cartpole.CartpoleCost,
            SampleProblems.DOUBLE_CARTPOLE: double_cartpole.DoubleCartpoleCost,
            SampleProblems.PENDULUM: pendulum.PendulumCost,
            SampleProblems.RENDEZVOUS: rendezvous.RendezvousCost,
        }[self]

    def get_model_class(self):
        return {
            SampleProblems.CARTPOLE: cartpole.CartpoleDynamicsModel,
            SampleProblems.DOUBLE_CARTPOLE:
                double_cartpole.DoubleCartpoleDynamicsModel,
            SampleProblems.PENDULUM: pendulum.PendulumDynamicsModel,
            SampleProblems.RENDEZVOUS: rendezvous.RendezvousDynamicsModel,
        }[self]
