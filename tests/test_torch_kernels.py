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

from chip_smoke import clamp_as_built
from pddp_tpu.controllers.ilqr import default_fit_alphas as j_alphas
from pddp_tpu.encoding import StateEncoding as JEnc
from pddp_tpu.examples.cartpole import CartpoleCost as JCost
from pddp_tpu.examples.cartpole import CartpoleDynamicsModel as JModel
from pddp_tpu.ops.backward_kernel import pallas_backward
from pddp_tpu.ops.fused_rollout import fused_control_law as j_fused
from pddp_tpu.utils.linalg import psd_inverse_clamped, small_eigh
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
# in the rotations is amplified by the eigenvector conditioning. (27, 1)
# and (44, 4) are the double cartpole and rendezvous under the Cholesky
# codec, shapes of K1's block kernel on the card, at N=6.
K1_CASES = [(4, 1, False, 0.0, 1e-10), (4, 1, True, 10.0, 1e-10),
            (6, 4, False, 0.0, 1e-8), (6, 4, True, 10.0, 1e-8),
            (27, 1, True, 10.0, 1e-10), (44, 4, True, 10.0, 1e-8)]


@pytest.mark.parametrize("nz,nu,indefinite,reg,tol", K1_CASES)
def test_k1_plain_matches_pallas(nz, nu, indefinite, reg, tol):
    ins = _riccati_inputs(7, 12 if nz < 16 else 6, nz, nu, indefinite)
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
    # An aggregate cost is not carried by K2(a) under IGNORE_UNCERTAINTY:
    # K2(f) traces it; under a belief codec it is a post-pass, so the
    # hand-written stage (c) keeps the call.
    assert fr.supports_fused_rollout(model, cost + cost, IGN)
    assert fr.stage(model, cost + cost, IGN) == "f"
    assert fr.supports_fused_rollout(model, cost + cost,
                                     StateEncoding.VARIANCE_ONLY)
    assert fr.stage(model, cost + cost, StateEncoding.VARIANCE_ONLY) == "c"

    class Other(CartpoleDynamicsModel):
        pass

    # Another subclass may change the arithmetic K2(a) carries: K2(f)
    # traces its own code.
    assert fr.supports_fused_rollout(Other(device="cpu"), cost, IGN)
    assert fr.stage(Other(device="cpu"), cost, IGN) == "f"

    class Refused(CartpoleDynamicsModel):
        def apply(self, z, u, i, aux, encoding=StateEncoding.DEFAULT,
                  **kwargs):
            return super().apply(z, torch.erf(u), i, aux, encoding)

    # An op outside K2(f)'s table: refused, as fused_control_law says.
    assert not fr.supports_fused_rollout(Refused(device="cpu"), cost, IGN)
    with pytest.raises(ValueError):
        fr.fused_control_law(Refused(device="cpu"), None, None, None, None,
                             None, IGN, cost=cost)
    # K1 takes pddp_tpu's shapes: any nz with nu <= 4.
    assert bk.supports_kernel_backward(torch.zeros(3, 4), torch.zeros(3, 16,
                                                                      16))
    assert not bk.supports_kernel_backward(torch.zeros(3, 5),
                                           torch.zeros(3, 4, 4))
    assert bk.supports_kernel_backward(torch.zeros(3, 1),
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
    """The warp kernel's instances are exactly the CUDA source's dispatch
    table; K1 admits pddp_tpu's gate, any nz at nu <= 4 (the block kernel
    takes the shapes without an instance), and refuses nu = 5."""
    src = (Path(bk.__file__).parent.parent / "csrc"
           / "backward_kernel.cu").read_text()
    table = re.search(r"#define PDDP_K1_SHAPES\(X\)(.*?)\n\n", src,
                      re.S).group(1)
    assert {(int(a), int(b)) for a, b in re.findall(
        r"X\((\d+), (\d+)\)", table)} == set(bk.INSTANCES)
    for nz in list(range(1, 18)) + [27, 44, 72, 100]:
        for nu in range(1, 6):
            assert bk.supports_kernel_backward(
                torch.zeros(2, nu), torch.zeros(2, nz, nz)) == (nu <= 4)


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


def test_solve_sends_every_shape_to_k1(monkeypatch):
    """solve(riccati_mode="kernel") on an unconstrained problem at nz=27
    (the double cartpole under the Cholesky codec, a shape of the block
    kernel) calls kernel_backward on every evaluation and never the scan
    backward; on the CPU the wrapper runs its plain version."""
    from pddp_tpu_torch.controllers import ilqr as tilqr
    from pddp_tpu_torch.encoding import encode
    from pddp_tpu_torch.examples import double_cartpole as tdcp
    calls, scan = [], []

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return kernel(*args, **kwargs)

    kernel = bk.kernel_backward
    monkeypatch.setattr(bk, "kernel_backward", counted)
    monkeypatch.setattr(tilqr, "backward", lambda *a, **k: scan.append(1))
    f64 = dict(device="cpu", dtype=torch.float64)
    model = tdcp.DoubleCartpoleDynamicsModel(dt=0.05, **f64)
    cost = tdcp.DoubleCartpoleCost(**f64)
    x0 = torch.tensor([0.0, 0.0, 0.05, 0.0, -0.05, 0.0], **f64)
    enc = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    z0 = encode(x0, C=1e-2 * torch.eye(6, **f64), encoding=enc)
    r = tilqr.solve(model, cost, z0, torch.full((3, 1), 0.1, **f64),
                    ILQROptions(n_iterations=1, riccati_mode="kernel"),
                    encoding=enc)
    assert z0.shape == (27,) and r.evals >= 1
    assert calls == [(3, 27, 27)] * r.evals and not scan


def _clamped_inverse(e, E, reg):
    """E diag(1 / (max(e, 1e-12) + reg)) E^T over a batch, in e's type."""
    w = e.dtype.type(1) / (np.where(e < 0, e.dtype.type(1e-12), e)
                           + e.dtype.type(reg))
    return (E * w[..., None, :]) @ np.swapaxes(E, -1, -2)


def _clamp_inputs(nu, rng):
    """Symmetric Q_uu of each kind, {kind: (n, nu, nu)}: positive definite
    at three scales, indefinite, rank-deficient (of rank nu - 1, and with a
    zero last row and column, whose zero eigenvalue is exact), and with
    every eigenvalue within a few 1e-12 of zero (the floor decides), signs
    mixed."""
    def spectral(e):
        E = np.linalg.qr(rng.standard_normal((len(e), nu, nu)))[0]
        return (E * e[:, None, :]) @ np.swapaxes(E, -1, -2)
    M = rng.standard_normal((6, nu, nu))
    pd = M @ np.swapaxes(M, -1, -2) / nu + 0.1 * np.eye(nu)
    sign = np.where(np.arange(nu) % 2 == 0, -1.0, 1.0)
    R = rng.standard_normal((4, nu, nu - 1))
    zero_row = pd[:3].copy()
    zero_row[:, -1, :] = zero_row[:, :, -1] = 0.0
    return {
        "definite": np.concatenate([pd[:2], 1e6 * pd[2:4], 1e-6 * pd[4:]]),
        "indefinite": spectral(sign * rng.uniform(0.1, 3.0, (4, nu))),
        "rank_deficient": R @ np.swapaxes(R, -1, -2),
        "zero_row": zero_row,
        "near_floor": spectral(sign * rng.uniform(0.3e-12, 3e-12, (4, nu)))}


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-8), (np.float32, 1e-4)])
@pytest.mark.parametrize("nu", [2, 3, 4])
def test_k1_clamp_as_built_matches_pddp_tpu(nu, dtype, tol):
    """The block kernel's clamped inverse of Q_uu, modelled in numpy
    (chip_smoke.clamp_as_built, whose sweep counts set K1's bound there),
    against pddp_tpu's: psd_inverse_clamped (eigh) and the
    small_eigh Jacobi, relative to the largest entry. reg in {0, 1e-6,
    10}, but where the function itself is ill-posed: a zero eigenvalue
    (rank-deficient) is computed as +-eps |Q| in either implementation, and
    its sign moves the clamped value by 1e-12, so a rotated rank-deficient
    Q_uu takes reg = 10 only (there 1e-13 relative) and the exact zero of
    a zero row reg > 0 (1 / 0 at reg = 0)."""
    inputs = _clamp_inputs(nu, np.random.default_rng(nu))
    kinds = [k for k, Qs in inputs.items() for _ in Qs]
    Qs = np.concatenate(list(inputs.values())).astype(dtype)
    e, E, sweeps = clamp_as_built(Qs, np.dtype(dtype).name)
    assert e.dtype == E.dtype == dtype
    e_j, E_j = small_eigh(jnp.asarray(Qs), sort=False)
    e_j, E_j = np.asarray(e_j, np.float64), np.asarray(E_j, np.float64)
    for reg in (0.0, 1e-6, 10.0):
        keep = np.array([not (k == "rank_deficient" and reg < 10.0
                              or k == "zero_row" and reg == 0.0)
                         for k in kinds])
        got = _clamped_inverse(e, E, reg)[keep]
        for ref in (np.asarray(psd_inverse_clamped(jnp.asarray(Qs),
                                                   extra=reg)),
                    _clamped_inverse(e_j, E_j, reg)):
            ref = ref[keep]
            scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
            err = (np.abs(got - ref) / scale).max(axis=(-1, -2))
            assert err.max() <= tol, (reg, kinds[int(np.argmax(err))],
                                      float(err.max()))
    # The exit takes effect: some inputs converge before the last sweep.
    assert min(sweeps) < (8 if dtype == np.float64 else 5)
