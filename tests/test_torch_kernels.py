"""K1 and K2 of the port: their plain versions against the Pallas kernels
of pddp_tpu, which run in interpret mode.

On the CPU the wrappers run the plain versions, because the tensors lie
on the CPU. The kernels themselves are held against the plain versions on
a card by tests/test_torch_gpu.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu.controllers.ilqr import default_fit_alphas as j_alphas
from pddp_tpu.encoding import StateEncoding as JEnc
from pddp_tpu.examples.cartpole import CartpoleCost as JCost
from pddp_tpu.examples.cartpole import CartpoleDynamicsModel as JModel
from pddp_tpu.ops.backward_kernel import pallas_backward
from pddp_tpu.ops.fused_rollout import fused_control_law as j_fused
from pddp_tpu_torch.controllers.ilqr import (ILQROptions, control_law,
                                             default_fit_alphas, solve)
from pddp_tpu_torch.encoding import StateEncoding, infer_encoded_state_size
from pddp_tpu_torch.examples.cartpole import CartpoleCost, CartpoleDynamicsModel
from pddp_tpu_torch.ops import backward_kernel as bk
from pddp_tpu_torch.ops import fused_rollout as fr
from tests.test_torch_gpu import _riccati_inputs, _rollout_inputs

torch.set_num_threads(1)

IGN = StateEncoding.IGNORE_UNCERTAINTY


def _min_eig_last_Q_uu(ins):
    F_u, L_zz, L_uu = ins[2][-1], ins[6][-1], ins[8][-1]
    return np.linalg.eigvalsh(L_uu + F_u.T @ L_zz @ F_u).min()


# (nz, nu, indefinite L_uu, reg). Tolerances: 1e-10 for nu=1, where both
# sides take the closed-form clamp and differ only in the order of sums;
# 1e-8 for nu=4, where both run the same fixed-sweep Jacobi but rounding
# in the rotations is amplified by the eigenvector conditioning.
K1_CASES = [(4, 1, False, 0.0, 1e-10), (4, 1, True, 10.0, 1e-10),
            (6, 4, False, 0.0, 1e-8), (6, 4, True, 10.0, 1e-8)]


@pytest.mark.parametrize("nz,nu,indefinite,reg,tol", K1_CASES)
def test_k1_plain_matches_pallas(nz, nu, indefinite, reg, tol):
    ins = _riccati_inputs(7, 12, nz, nu, indefinite)
    if indefinite:
        assert _min_eig_last_Q_uu(ins) < 0    # the clamp acts
    k_j, K_j, ok_j = pallas_backward(*map(jnp.asarray, ins), reg=reg,
                                     interpret=True)
    k_t, K_t, ok_t = bk.kernel_backward(
        *(torch.as_tensor(a) for a in ins), reg=reg)
    assert bool(ok_j) and bool(ok_t)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=tol,
                               atol=tol)


# Tolerance 1e-12: the same closed-loop arithmetic in the same order; the
# model's sin/cos come from each framework's libm.
@pytest.mark.parametrize("bounds", [None, (-0.1, 0.1)])
def test_k2_plain_matches_pallas(bounds):
    N = 12
    model, cost, Z, U, k, K = _rollout_inputs(N)
    alphas = default_fit_alphas(torch.float64)
    b = (None, None) if bounds is None else tuple(
        torch.tensor([v], dtype=torch.float64) for v in bounds)
    got = fr.fused_control_law(model, Z, U, k, K, alphas, IGN, cost=cost,
                               u_min=b[0], u_max=b[1])
    jb = (None, None) if bounds is None else tuple(
        jnp.asarray([v]) for v in bounds)
    want = j_fused(JModel(dt=0.05), *(jnp.asarray(t.numpy())
                                      for t in (Z, U, k, K)),
                   j_alphas(jnp.float64), JEnc(4), cost=JCost(),
                   u_min=jb[0], u_max=jb[1], interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
    if bounds is not None:
        assert float(got[1].abs().max()) <= 0.1
        assert float(got[1].abs().max()) == pytest.approx(0.1)  # binds


def test_k2_post_pass_matches_in_loop_cost():
    """control_law's batched post-pass cost equals the in-loop sum."""
    model, cost, Z, U, k, K = _rollout_inputs(10, seed=1)
    alphas = default_fit_alphas(torch.float64)
    a = control_law(model, Z, U, k, K, alphas, IGN, cost=cost)
    b = control_law(model, Z, U, k, K, alphas, IGN, cost=cost,
                    cost_in_scan=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_supports_gates():
    model = CartpoleDynamicsModel(device="cpu")
    cost = CartpoleCost(device="cpu")
    assert fr.supports_fused_rollout(model, cost, IGN)
    assert fr.stage(model, cost, StateEncoding.VARIANCE_ONLY) == "c"
    # An aggregate cost is not carried by the kernel under
    # IGNORE_UNCERTAINTY; under a belief codec it is a post-pass.
    assert not fr.supports_fused_rollout(model, cost + cost, IGN)
    assert fr.supports_fused_rollout(model, cost + cost,
                                     StateEncoding.VARIANCE_ONLY)

    class Other(CartpoleDynamicsModel):
        pass

    assert not fr.supports_fused_rollout(Other(device="cpu"), cost, IGN)
    with pytest.raises(ValueError):
        fr.fused_control_law(Other(device="cpu"), None, None, None, None,
                             None, IGN, cost=cost)
    assert bk.supports_kernel_backward(torch.zeros(3, 4), torch.zeros(3, 16,
                                                                      16))
    assert not bk.supports_kernel_backward(torch.zeros(3, 5),
                                           torch.zeros(3, 4, 4))
    assert not bk.supports_kernel_backward(torch.zeros(3, 1),
                                           torch.zeros(3, 17, 17))


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    n1, n2 = bk.launches, dict(fr.launches)
    ins = _riccati_inputs(0, 5, 4, 1)
    bk.kernel_backward(*(torch.as_tensor(a) for a in ins))
    model, cost, Z, U, k, K = _rollout_inputs(5)
    fr.fused_control_law(model, Z, U, k, K, default_fit_alphas(
        torch.float64), IGN, cost=cost)
    assert (bk.launches, fr.launches) == (n1, n2)


def test_k1_instances():
    """The shapes K1 admits are exactly the CUDA source's dispatch table."""
    src = (Path(bk.__file__).parent.parent / "csrc"
           / "backward_kernel.cu").read_text()
    table = re.search(r"#define PDDP_K1_SHAPES\(X\)(.*?)\n\n", src,
                      re.S).group(1)
    assert {(int(a), int(b)) for a, b in re.findall(
        r"X\((\d+), (\d+)\)", table)} == set(bk.INSTANCES)
    for nz in range(1, 18):
        for nu in range(1, 6):
            assert bk.supports_kernel_backward(
                torch.zeros(2, nu), torch.zeros(2, nz, nz)) == (
                    (nz, nu) in bk.INSTANCES)


def _alphas(A):
    """A step sizes from 1 down to 1e-3."""
    return torch.logspace(0.0, -3.0, A, dtype=torch.float64)


def test_k2_many_alphas_matches_pallas():
    """More candidates than a warp has lanes: the wrapper (on the CPU, its
    plain version) against the Pallas kernel, as test_k2_plain_matches_pallas."""
    model, cost, Z, U, k, K = _rollout_inputs(8, seed=2)
    alphas = _alphas(40)
    got = fr.fused_control_law(model, Z, U, k, K, alphas, IGN, cost=cost)
    want = j_fused(JModel(dt=0.05), *(jnp.asarray(t.numpy())
                                      for t in (Z, U, k, K)),
                   jnp.asarray(alphas.numpy()), JEnc(4), cost=JCost(),
                   interpret=True)
    assert got[0].shape == (9, 40, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("A", [10, 40])
def test_solve_line_search_takes_k2_at_any_alpha_count(monkeypatch, A):
    """solve with fused_rollout sends every line search of an admitted
    model to fused_control_law whatever the number of candidates, and
    ends where the plain line search does."""
    model, cost, Z, U, _, _ = _rollout_inputs(10, seed=3)
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[5].shape[0])
        return fused(*args, **kwargs)

    fused = fr.fused_control_law
    monkeypatch.setattr(fr, "fused_control_law", counted)
    opts = ILQROptions(n_iterations=3, alphas=_alphas(A),
                       riccati_mode="kernel")
    r_k = solve(model, cost, Z[0], U, ILQROptions(
        **{**opts.__dict__, "fused_rollout": True}), encoding=IGN)
    r_p = solve(model, cost, Z[0], U, opts, encoding=IGN)
    assert calls and set(calls) == {A}
    assert (r_k.iterations, r_k.evals) == (r_p.iterations, r_p.evals)
    np.testing.assert_allclose(r_k.U.numpy(), r_p.U.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("nan", [False, True])
def test_k1_ok_matches_pallas(nan):
    """kernel_backward's ok (on the CPU, the plain version's) equals
    pallas_backward's, for finite inputs and with a NaN in one step."""
    ins = list(_riccati_inputs(11, 6, 4, 1))
    if nan:
        ins[8] = ins[8].copy()
        ins[8][2, 0, 0] = np.nan
    _, _, ok_j = pallas_backward(*map(jnp.asarray, ins), interpret=True)
    _, _, ok_t = bk.kernel_backward(*(torch.as_tensor(a) for a in ins))
    assert bool(ok_t) == bool(ok_j) == (not nan)
