"""The port's float32 particle cartpole under the Cholesky codec against
``pddp_tpu``'s, on the CPU, at the size and seeds of ``chip_smoke.py``'s
phase 17 (P=100, N=50 of a horizon of 100, numpy seeds 17 and 18).

``tests/golden/particle_f32.npz`` (written by ``JAX_PLATFORMS=cpu python -m
tests.golden.particle_f32``; this file reads only it) holds
``pddp_tpu``'s float32 rollout of U0 and whether its plain backward's gains
on that rollout's local model are finite at each reg of phase 17's
``PARTICLE_K1_REGS``: at every one. The port's float32 rollout on the CPU
is held against it, and its gains are finite at the same regs (the
overflow that phase 17 reports on the H100 is the card's: ROADMAP.md C).

Tolerances: float32's rounding over 50 steps in another order of sums,
the states within 2e-6 (measured 5.7e-7 of values up to 0.72), the noise
that the step infers through the covariance factor 1e-4 (measured
1.2e-5; the solve scales the states' rounding by the factor's inverse).
"""

import numpy as np
import pytest
import torch

from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers.ilqr import backward, local_model, rollout
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.cartpole import (CartpoleCost,
                                              CartpoleDynamicsModel)
from tests.golden import particle_f32 as g

torch.set_num_threads(1)

ATOL_Z, ATOL_AUX = 2e-6, 1e-4
CH = StateEncoding.UPPER_TRIANGULAR_CHOLESKY


@pytest.fixture(scope="module")
def problem():
    """(stored arrays, the port's rollout of U0, its local model)."""
    with np.load(g.PATH) as npz:
        data = dict(npz)
    f32 = torch.float32
    model = convert.particle_model(
        CartpoleDynamicsModel(dt=g.DT, device="cpu", dtype=f32), data["eps"])
    cost = CartpoleCost(device="cpu", dtype=f32)
    z0, U0 = torch.as_tensor(data["z0"]), torch.as_tensor(data["U0"])
    Z, AUX = rollout(model, z0, U0, CH)
    return data, (Z, AUX), local_model(Z, U0, AUX, model, cost, CH)


def test_inputs_are_phase_17s(problem):
    """The stored noise and actions are the numpy draws phase 17 makes
    (the noise standardized over the particles in float32)."""
    data, _, _ = problem
    raw, U0 = g.draws()
    np.testing.assert_array_equal(data["U0"], U0.astype(np.float32))
    eps = torch.as_tensor(raw, dtype=torch.float32)
    eps = ((eps - eps.mean(dim=1, keepdim=True))
           / eps.std(dim=1, keepdim=True, correction=1))
    np.testing.assert_allclose(data["eps"], eps.numpy(), rtol=0, atol=1e-6)


def test_f32_rollout_matches_pddp_tpu(problem):
    data, (Z, AUX), _ = problem
    assert Z.dtype == torch.float32 and bool(torch.isfinite(Z).all())
    np.testing.assert_allclose(Z.numpy(), data["Z"], rtol=0, atol=ATOL_Z)
    np.testing.assert_allclose(AUX.numpy(), data["AUX"], rtol=0,
                               atol=ATOL_AUX)


@pytest.mark.parametrize("i", range(len(g.REGS)))
def test_f32_gains_finite_where_pddp_tpu_s_are(problem, i):
    """At each reg, the port's float32 gains are finite where
    ``pddp_tpu``'s are (at every reg of PARTICLE_K1_REGS)."""
    data, _, derivs = problem
    assert float(data["regs"][i]) == g.REGS[i]
    k, K, ok = backward(*derivs, reg=g.REGS[i])
    assert bool(ok) == bool(data["ok"][i])
    assert bool(torch.isfinite(k).all()) == bool(data["ok"][i])
