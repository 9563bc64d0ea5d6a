"""The port's CUDA kernels against their plain versions on a card.

Marked ``gpu``: without a CUDA device each test skips (decided in a
fixture). The file imports neither JAX nor pddp_tpu, so it also runs
where JAX is not installed; tests/conftest.py imports JAX, hence
``--noconftest`` there:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from pddp_tpu_torch.controllers.ilqr import (backward, control_law,
                                             default_fit_alphas, local_model,
                                             rollout)
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.cartpole import CartpoleCost, CartpoleDynamicsModel
from pddp_tpu_torch.ops import backward_kernel as bk
from pddp_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)

IGN = StateEncoding.IGNORE_UNCERTAINTY


@pytest.fixture
def cuda():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _riccati_inputs(seed, N, nz, nu, indefinite=False):
    """Numpy Riccati inputs with a PSD joint Hessian of (z, u) per step;
    ``indefinite`` shifts L_uu of the last three steps down by 2 I so the
    eigen clamp of Q_uu acts there."""
    rng = np.random.default_rng(seed)
    n = nz + nu
    F_z = np.eye(nz) + 0.1 * rng.standard_normal((N, nz, nz))
    F_u = 0.1 * rng.standard_normal((N, nz, nu))
    M = rng.standard_normal((N, n, n))
    H = M @ np.swapaxes(M, -1, -2) / n + 0.1 * np.eye(n)
    Mt = rng.standard_normal((nz, nz))
    L_zz = np.concatenate([H[:, :nz, :nz],
                           (Mt @ Mt.T / nz + 0.1 * np.eye(nz))[None]])
    L_uu = H[:, nz:, nz:].copy()
    if indefinite:
        L_uu[-3:] -= 2.0 * np.eye(nu)
    return (np.zeros((N + 1, nz)), F_z, F_u, np.zeros(N + 1),
            rng.standard_normal((N + 1, nz)), rng.standard_normal((N, nu)),
            L_zz, np.ascontiguousarray(H[:, nz:, :nz]), L_uu)


def _rollout_inputs(N, seed=0):
    """Nominal cartpole trajectory and gains of one reg=10 backward pass
    (at this first iterate reg <= 1 gives non-finite gains)."""
    rng = np.random.default_rng(seed)
    model = CartpoleDynamicsModel(dt=0.05, device="cpu", dtype=torch.float64)
    cost = CartpoleCost(device="cpu", dtype=torch.float64)
    z0 = torch.tensor([0.0, 0.0, 0.1, 0.0], dtype=torch.float64)
    U = torch.as_tensor(0.1 + 0.05 * rng.standard_normal((N, 1)))
    Z, AUX = rollout(model, z0, U, IGN)
    k, K, ok = backward(*local_model(Z, U, AUX, model, cost, IGN), reg=10.0)
    assert bool(ok)
    return model, cost, Z, U, k, K


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("nz,nu,indefinite,reg", [(4, 1, False, 0.0),
                                                  (14, 1, False, 0.0),
                                                  (8, 4, True, 10.0)])
def test_k1_kernel_matches_plain_on_card(cuda, dtype, tol, nz, nu,
                                         indefinite, reg):
    """Relative to the largest gain: float32 over 40 steps keeps ~1e-6."""
    ins = [torch.as_tensor(a, dtype=dtype, device=cuda)
           for a in _riccati_inputs(3, 40, nz, nu, indefinite)]
    n = bk.launches
    k_k, K_k, ok_k = bk.kernel_backward(*ins, reg=reg)
    k_p, K_p, ok_p = backward(*ins, reg=reg)
    torch.cuda.synchronize()
    assert bk.launches == n + 1
    assert bool(ok_k) and bool(ok_p)
    for a, b in ((k_k, k_p), (K_k, K_p)):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("bounds", [None, (-0.1, 0.1)])
def test_k2_kernel_matches_plain_on_card(cuda, dtype, tol, bounds):
    """Relative to the largest value of each output, over 200 steps."""
    model, cost, Z, U, k, K = _rollout_inputs(200)
    model = CartpoleDynamicsModel(dt=0.05, device=cuda, dtype=dtype)
    cost = CartpoleCost(device=cuda, dtype=dtype)
    Z, U, k, K = (t.to(device=cuda, dtype=dtype) for t in (Z, U, k, K))
    alphas = default_fit_alphas(dtype, cuda)
    b = (None, None) if bounds is None else tuple(
        torch.tensor([v], dtype=dtype, device=cuda) for v in bounds)
    n = fr.launches
    got = fr.fused_control_law(model, Z, U, k, K, alphas, IGN, cost=cost,
                               u_min=b[0], u_max=b[1])
    want = control_law(model, Z, U, k, K, alphas, IGN, u_min=b[0],
                       u_max=b[1], cost=cost, cost_in_scan=True)
    torch.cuda.synchronize()
    assert fr.launches == n + 1
    for a, w in zip(got, want):
        assert bool(torch.isfinite(w).all())
        assert float((a - w).abs().max()) <= tol * float(w.abs().max())
