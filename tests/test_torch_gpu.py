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
from pddp_tpu_torch.encoding import (StateEncoding, encode,
                                     infer_encoded_state_size)
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
    n = fr.launches["a"]
    got = fr.fused_control_law(model, Z, U, k, K, alphas, IGN, cost=cost,
                               u_min=b[0], u_max=b[1])
    want = control_law(model, Z, U, k, K, alphas, IGN, u_min=b[0],
                       u_max=b[1], cost=cost, cost_in_scan=True)
    torch.cuda.synchronize()
    assert fr.launches["a"] == n + 1
    for a, w in zip(got, want):
        assert bool(torch.isfinite(w).all())
        assert float((a - w).abs().max()) <= tol * float(w.abs().max())


def _bnn(cuda, dtype, N, P=16, hidden=(32, 32), gains=True, enc=None):
    """A seeded untrained BNN, its start belief, and finite gains of one
    reg=1 backward pass around U = 0.1 (computed on the CPU; none
    without ``gains``), under the codec ``enc`` (the Cholesky codec's by
    default)."""
    from pddp_tpu_torch.encoding import encode
    from pddp_tpu_torch.models.bnn import bnn_dynamics_model_factory
    cls = bnn_dynamics_model_factory(4, 1, list(hidden), angular_indices=(2,),
                                     non_angular_indices=(0, 1, 3))
    if not gains:
        return cls.init(seed=3, n_particles=P, horizon=N + 1, dtype=dtype,
                        device=cuda, chol_jitter=(1e-12, 1e-6)), None
    m = cls.init(seed=3, n_particles=P, horizon=N + 1, dtype=torch.float64,
                 device="cpu", chol_jitter=(1e-12, 1e-6))
    enc = CH if enc is None else enc
    z0 = encode(torch.zeros(4, dtype=torch.float64),
                V=1e-2 * torch.ones(4, dtype=torch.float64), encoding=enc)
    U = torch.full((N, 1), 0.1, dtype=torch.float64)
    Z, AUX = rollout(m, z0, U, enc)
    cost = CartpoleCost(device="cpu", dtype=torch.float64)
    k, K, ok = backward(*local_model(Z, U, AUX, m, cost, enc), reg=1.0)
    assert bool(ok)
    m_dev = cls.init(seed=3, n_particles=P, horizon=N + 1, dtype=dtype,
                     device=cuda, chol_jitter=(1e-12, 1e-6))
    return m_dev, [t.to(device=cuda, dtype=dtype) for t in (Z, U, k, K)]


CH = StateEncoding.UPPER_TRIANGULAR_CHOLESKY


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("P", [16, 37])
@pytest.mark.parametrize("A", [10, 40])
@pytest.mark.parametrize("bounds", [None, (-0.05, 0.05)])
def test_k2d_bnn_kernel_matches_plain_on_card(cuda, dtype, tol, B, P, A,
                                              bounds):
    """K2(d) against control_law with the same model, two steps, relative
    to each output's largest value: P=37 is no multiple of a cluster's
    CTAs, A=40 more candidates than a warp's lanes, and B and A change
    the planned cluster size; the bounds clamp u."""
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    model, (Z, U, k, K) = _bnn(cuda, dtype, 2, P=P)
    if B > 1:
        Z, U, k, K = (t.expand((B,) + t.shape).contiguous()
                      for t in (Z, U, k, K))
    alphas = (default_fit_alphas(dtype, cuda) if A == 10 else
              torch.logspace(0.0, -3.0, A, dtype=dtype, device=cuda))
    lo, hi = (None, None) if bounds is None else (
        torch.tensor([v], dtype=dtype, device=cuda) for v in bounds)
    n = fb.launches["rollout"]
    got = fb.fused_bnn_control_law(model, Z, U, k, K, alphas, CH, u_min=lo,
                                   u_max=hi)
    want = control_law(model, Z, U, k, K, alphas, CH, u_min=lo, u_max=hi,
                       with_aux=True)
    torch.cuda.synchronize()
    assert fb.launches["rollout"] == n + 1
    assert fb.launch_plan(model, B * A, dtype, CH)["cluster"] >= 1
    for a, w in zip(got, want):
        assert bool(torch.isfinite(w).all())
        assert float((a - w).abs().max()) <= tol * float(w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("G", [10, 640])
def test_bnn_mlp_groups_on_card(cuda, dtype, tol, G):
    """F3 at the bench net's widths (6-200-200-8, 100 particles) for 10
    groups (a cluster each, the weights in shared memory) and 640 (a CTA
    each, the widest layer read from L2), against the net's own call,
    relative to the output's largest value."""
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    model, _ = _bnn(cuda, dtype, 2, P=100, hidden=(200, 200),
                    gains=False)
    x = torch.as_tensor(np.random.default_rng(G).standard_normal(
        (G, 100, 6)), dtype=dtype, device=cuda)
    n = fb.launches["mlp"]
    got = fb.mlp(model.net, x)
    want = model.net(x)
    torch.cuda.synchronize()
    assert fb.launches["mlp"] == n + 1
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_bnn_fragments_match_plain_on_card(cuda, dtype, tol):
    """F1 (with and without the fallback), F2 and F3 against their plain
    versions, relative to each output's largest value."""
    from pddp_tpu_torch.models.bnn import infer_eps
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    model, _ = _bnn(cuda, dtype, 2)
    rng = np.random.default_rng(5)
    G, P, n = 4, model.n_particles, 4

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    Uc = t(np.triu(rng.standard_normal((G, n, n))) + 2.0 * np.eye(n))
    Uc[1, 2, 2] = 0.0                  # group 1 falls back to eps0
    D = t(rng.standard_normal((G, P, n)))
    eps0 = model.eps_in[1].contiguous()
    before = dict(fb.launches)
    pairs = [(fb.infer_eps(Uc, D, eps0, first),
              infer_eps(Uc, D, eps0, first)) for first in (False, True)]
    assert bool((pairs[0][0][1] == eps0).all())
    particles = t(rng.standard_normal((G, P, n)))
    pairs += list(zip(fb.moment_match(particles, (1e-12, 1e-6)),
                      fb.moment_match(particles.cpu(), (1e-12, 1e-6))))
    x = t(rng.standard_normal((G, P, 6)))
    pairs.append((fb.mlp(model.net, x), model.net(x)))
    torch.cuda.synchronize()
    assert fb.launches["infer_eps"] == before["infer_eps"] + 2
    assert fb.launches["moment_match"] == before["moment_match"] + 1
    assert fb.launches["mlp"] == before["mlp"] + 1
    for a, w in pairs:
        a, w = a.cpu(), w.cpu()
        assert float((a - w).abs().max()) <= tol * float(w.abs().max())


def _example_inputs(name, enc, N=12, B=2, seed=0):
    """An example (model, cost) pair of the golden configurations and a
    batch of B nominal rollouts under ``enc`` with seeded gains, built on
    the CPU in float64."""
    import importlib

    from pddp_tpu_torch.encoding import encode
    mod, model_cls, cost_cls, dt = {
        "cartpole": ("cartpole", "CartpoleDynamicsModel", "CartpoleCost",
                     0.05),
        "pendulum": ("pendulum", "PendulumDynamicsModel", "PendulumCost",
                     0.1),
        "double_cartpole": ("double_cartpole", "DoubleCartpoleDynamicsModel",
                            "DoubleCartpoleCost", 0.05),
        "rendezvous": ("rendezvous", "RendezvousDynamicsModel",
                       "RendezvousCost", 0.1)}[name]
    m = importlib.import_module("pddp_tpu_torch.examples." + mod)
    rng = np.random.default_rng(seed)
    model = getattr(m, model_cls)(dt=dt, device="cpu", dtype=torch.float64)
    n, nu = model.state_size, model.action_size
    x0 = torch.as_tensor(0.3 * rng.standard_normal((B, n)))
    z0 = x0 if enc == IGN else encode(
        x0, C=1e-2 * torch.eye(n, dtype=torch.float64), encoding=enc)
    U = torch.as_tensor(0.1 * rng.standard_normal((B, N, nu)))
    Z, _ = rollout(model, z0, U, enc)
    nz = Z.shape[-1]
    k = torch.as_tensor(0.5 * rng.standard_normal((B, N, nu)))
    K = torch.as_tensor(0.5 * rng.standard_normal((B, N, nu, nz)) / nz)
    return m, (model_cls, cost_cls, dt), (Z, U, k, K)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("name,enc", [
    ("pendulum", IGN), ("double_cartpole", IGN), ("rendezvous", IGN),
    ("pendulum", StateEncoding.UPPER_TRIANGULAR_CHOLESKY),
    ("rendezvous", StateEncoding.UPPER_TRIANGULAR_CHOLESKY),
    ("double_cartpole", StateEncoding.VARIANCE_ONLY),
    ("cartpole", StateEncoding.FULL_COVARIANCE_MATRIX),
    ("rendezvous", StateEncoding.STANDARD_DEVIATION_ONLY)])
def test_k2bc_kernel_matches_plain_on_card(cuda, dtype, tol, name, enc):
    """K2 stages (b) and (c) against control_law, B=2, N=12, bounds that
    bind, relative to each output's largest value; the cost in the kernel
    under IGNORE_UNCERTAINTY, a post-pass under the belief codecs."""
    m, (model_cls, cost_cls, dt), ins = _example_inputs(name, enc)
    model = getattr(m, model_cls)(dt=dt, device=cuda, dtype=dtype)
    cost = getattr(m, cost_cls)(device=cuda, dtype=dtype)
    Z, U, k, K = (t.to(device=cuda, dtype=dtype).contiguous() for t in ins)
    alphas = default_fit_alphas(dtype, cuda)
    nu = model.action_size
    lo = torch.full((nu,), -0.2, dtype=dtype, device=cuda)
    hi = torch.full((nu,), 0.2, dtype=dtype, device=cuda)
    st = fr.stage(model, cost, enc)
    assert st == ("b" if enc == IGN else "c")
    n = fr.launches[st]
    got = fr.fused_control_law(model, Z, U, k, K, alphas, enc, cost=cost,
                               u_min=lo, u_max=hi)
    want = control_law(model, Z, U, k, K, alphas, enc, u_min=lo, u_max=hi,
                       cost=cost, cost_in_scan=enc == IGN)
    torch.cuda.synchronize()
    assert fr.launches[st] == n + 1
    assert bool((want[1].abs() == 0.2).any())
    for a, w in zip(got, want):
        assert bool(torch.isfinite(w).all())
        assert float((a - w).abs().max()) <= tol * float(w.abs().max())


# (B, N) of the batched kernel cases: one solve of one step, a ragged
# block of three, and a full batch at the bench horizon.
BATCHES = [(1, 1), (3, 37), (64, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("nz,nu", sorted(bk.INSTANCES))
def test_k1_every_instance_on_card(cuda, dtype, tol, nz, nu):
    """K1 against backward at every (nz, nu) instance and B, N of
    BATCHES, with Q_uu indefinite in the last three steps (reg=10, the
    clamp acting), relative to the largest gain; ok from the kernel."""
    for seed, (B, N) in enumerate(BATCHES):
        solves = [_riccati_inputs(100 * seed + b, N, nz, nu, indefinite=True)
                  for b in range(B)]
        ins = [torch.as_tensor(np.stack(a), dtype=dtype, device=cuda)
               for a in zip(*solves)]
        n = bk.launches
        k_k, K_k, ok_k = bk.kernel_backward(*ins, reg=10.0)
        k_p, K_p, ok_p = backward(*ins, reg=10.0)
        torch.cuda.synchronize()
        assert bk.launches == n + 1
        assert ok_k.shape == (B,) and bool(ok_k.all()) and bool(ok_p.all())
        for a, w in ((k_k, k_p), (K_k, K_p)):
            assert float((a - w).abs().max()) <= tol * float(w.abs().max())


# (nz, nu, dtype) of K1's block kernel: shapes without a warp instance,
# nu = 1-4, up to rendezvous under the full covariance (72, 4), in both
# types; (100, 2) in float64 does not fit shared memory and runs on the
# scratch buffer (in float32 these inputs overflow the recursion at
# nz = 100, the plain version's too).
K1_BLOCK_CASES = [(nz, nu, dtype) for nz, nu in [
    (3, 2), (10, 3), (20, 1), (27, 1), (42, 1), (44, 4), (72, 4)]
    for dtype in (torch.float64, torch.float32)] + [(100, 2, torch.float64)]


@pytest.mark.gpu
@pytest.mark.parametrize("nz,nu,dtype", K1_BLOCK_CASES)
def test_k1_block_kernel_on_card(cuda, dtype, nz, nu):
    """K1's block kernel against backward at the B, N of BATCHES, with
    Q_uu indefinite in the last three steps (reg=10), relative to the
    largest gain. float64: 1e-10 at nu=1 (the closed-form clamp), 1e-8
    at nu > 1 (the same Jacobi, whose rounding the eigenvector
    conditioning amplifies). float32 against the float64 plain version,
    within the larger of 1e-4 and twice the float32 plain version's own
    error: at these widths the float32 recursion itself strays up to
    ~3e-4 from float64 over 200 steps (nz = 42). That own error, and the
    kernel's distance to the float32 plain version, must stay under 1e-3,
    so the derived tolerance cannot widen past 2e-3."""
    tol = 1e-4 if dtype == torch.float32 else 1e-10 if nu == 1 else 1e-8
    assert (nz, nu) not in bk.INSTANCES
    plan = bk.launch_plan(nz, nu, dtype)
    assert plan["kernel"] == "block"
    assert (plan["scratch_elems"] > 0) == (nz == 100
                                           and dtype == torch.float64)
    for seed, (B, N) in enumerate(BATCHES):
        solves = [_riccati_inputs(100 * seed + b, N, nz, nu, indefinite=True)
                  for b in range(B)]
        ins = [torch.as_tensor(np.stack(a), dtype=dtype, device=cuda)
               for a in zip(*solves)]
        n, nb = bk.launches, bk.block_launches
        k_k, K_k, ok_k = bk.kernel_backward(*ins, reg=10.0)
        k_p, K_p, ok_p = backward(*ins, reg=10.0)
        torch.cuda.synchronize()
        assert (bk.launches, bk.block_launches) == (n, nb + 1)
        assert ok_k.shape == (B,) and bool(ok_k.all()) and bool(ok_p.all())
        want = (k_p, K_p)
        if dtype == torch.float32:
            want = backward(*(t.double() for t in ins), reg=10.0)[:2]
            plain = max(float((p.double() - w).abs().max() / w.abs().max())
                        for p, w in zip((k_p, K_p), want))
            assert plain <= 1e-3
            for a, p in zip((k_k, K_k), (k_p, K_p)):
                assert float((a - p).abs().max()) <= 1e-3 * float(
                    p.abs().max())
            tol = max(1e-4, 2.0 * plain)
        for a, w in zip((k_k, K_k), want):
            assert float((a.double() - w).abs().max()) <= tol * float(
                w.abs().max())


# (nz, nu, cluster): K1's block kernel with a plan other than the
# library's, so that every nu runs both one CTA a solve and a thread-block
# cluster (chip_smoke.K1_BLOCK_FORCED).
K1_BLOCK_PLANS = [(20, 1, 2), (27, 1, 4), (42, 1, 1), (3, 2, 2), (10, 3, 2),
                  (44, 4, 1), (72, 4, 1), (72, 4, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nz,nu,cluster", K1_BLOCK_PLANS)
def test_k1_block_kernel_plans_on_card(cuda, nz, nu, cluster, dtype):
    """K1's block kernel with the cluster asked for, against backward as
    test_k1_block_kernel_on_card holds the library's plan (the same
    tolerances), and ok on a NaN in one solve."""
    tol = 1e-4 if dtype == torch.float32 else 1e-10 if nu == 1 else 1e-8
    for seed, (B, N) in enumerate(BATCHES):
        solves = [_riccati_inputs(100 * seed + b, N, nz, nu, indefinite=True)
                  for b in range(B)]
        ins = [torch.as_tensor(np.stack(a), dtype=dtype, device=cuda)
               for a in zip(*solves)]
        assert bk.launch_plan(nz, nu, dtype, B, _cluster=cluster)["cluster"] == cluster
        nb = bk.block_launches
        k_k, K_k, ok_k = bk.kernel_backward(*ins, reg=10.0, _cluster=cluster)
        k_p, K_p, ok_p = backward(*ins, reg=10.0)
        torch.cuda.synchronize()
        assert bk.block_launches == nb + 1
        assert bool(ok_k.all()) and bool(ok_p.all())
        want = (k_p, K_p)
        if dtype == torch.float32:
            want = backward(*(t.double() for t in ins), reg=10.0)[:2]
            plain = max(float((p.double() - w).abs().max() / w.abs().max())
                        for p, w in zip((k_p, K_p), want))
            assert plain <= 1e-3
            for a, p in zip((k_k, K_k), (k_p, K_p)):
                assert float((a - p).abs().max()) <= 1e-3 * float(
                    p.abs().max())
            tol = max(1e-4, 2.0 * plain)
        for a, w in zip((k_k, K_k), want):
            assert float((a.double() - w).abs().max()) <= tol * float(
                w.abs().max())
    ins = [torch.as_tensor(np.stack([a] * 3), dtype=dtype, device=cuda)
           for a in _riccati_inputs(4, 20, nz, nu)]
    ins[8][1, 7] = float("nan")
    assert bk.kernel_backward(*ins, _cluster=cluster)[2].tolist() == [
        True, False, True]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_block_ok_false_on_nan_on_card(cuda, dtype):
    """The block kernel's ok, as the warp kernel's, at nz = 27."""
    ins = [torch.as_tensor(np.stack([a] * 5), dtype=dtype, device=cuda)
           for a in _riccati_inputs(4, 20, 27, 1)]
    ins[8][1, 7] = float("nan")     # L_uu of solve 1, step 7
    ins[1][3, 0, 2, 1] = float("nan")   # F_z of solve 3, step 0
    _, _, ok_k = bk.kernel_backward(*ins)
    _, _, ok_p = backward(*ins)
    assert ok_k.tolist() == ok_p.tolist() == [True, False, True, False,
                                              True]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_ok_false_on_nan_on_card(cuda, dtype):
    """The kernel's ok is False exactly for the solves with a NaN input,
    as backward's."""
    ins = [torch.as_tensor(np.stack([a] * 5), dtype=dtype, device=cuda)
           for a in _riccati_inputs(4, 20, 4, 1)]
    ins[8][1, 7] = float("nan")     # L_uu of solve 1, step 7
    ins[1][3, 0, 2, 1] = float("nan")   # F_z of solve 3, step 0
    _, _, ok_k = bk.kernel_backward(*ins)
    _, _, ok_p = backward(*ins)
    assert ok_k.tolist() == ok_p.tolist() == [True, False, True, False,
                                              True]


_EXAMPLES = {
    "cartpole": ("cartpole", "CartpoleDynamicsModel", "CartpoleCost",
                 [0.0, 0.0, 0.1, 0.0], 0.05),
    "pendulum": ("pendulum", "PendulumDynamicsModel", "PendulumCost",
                 [0.0, 0.0], 0.1),
    "double_cartpole": ("double_cartpole", "DoubleCartpoleDynamicsModel",
                        "DoubleCartpoleCost",
                        [0.0, 0.0, 0.05, 0.0, -0.05, 0.0], 0.05),
    "rendezvous": ("rendezvous", "RendezvousDynamicsModel", "RendezvousCost",
                   [-10.0, -10.0, 10.0, 10.0, 0.0, -5.0, 5.0, 0.0], 0.1)}


def _path_inputs(name, enc, B, N, seed=0):
    """An example of the golden configurations with gains that hold its
    closed loop over 200 steps (one backward around U = 0.1 at the least
    reg of 0.1, 1, ... that makes them finite and |K| <= 50; the belief
    columns small seeded values), perturbed per solve, and B nominal
    rollouts of perturbed actions from the golden start under ``enc``;
    built on the CPU in float64. Gains of reg >= 10 leave the pendulum's
    closed loop unstable over 200 steps: it then amplifies a rounding
    difference some 1e4-fold."""
    import importlib
    mod, model_cls, cost_cls, x0, dt = _EXAMPLES[name]
    m = importlib.import_module("pddp_tpu_torch.examples." + mod)
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    model = getattr(m, model_cls)(dt=dt, device="cpu", dtype=f64)
    cost = getattr(m, cost_cls)(device="cpu", dtype=f64)
    n, nu = model.state_size, model.action_size
    nz = infer_encoded_state_size(n, enc)
    x0 = torch.tensor(x0, dtype=f64)
    U1 = torch.full((N, nu), 0.1, dtype=f64)
    Z1, AUX = rollout(model, x0, U1, IGN)
    derivs = local_model(Z1, U1, AUX, model, cost, IGN)
    for reg in 10.0**np.arange(-1, 7):
        k1, K1, ok = backward(*derivs, reg=float(reg))
        if bool(ok) and float(K1.abs().max()) <= 50.0:
            break
    assert bool(ok)

    def t(a):
        return torch.as_tensor(a, dtype=f64)

    K1 = torch.cat([K1, t(0.01 * rng.standard_normal((N, nu, nz - n)))], -1)
    z0 = x0.expand(B, n) if enc == IGN else encode(
        x0.expand(B, n), C=1e-2 * torch.eye(n, dtype=f64), encoding=enc)
    Z, _ = rollout(model, z0, U1 + t(0.05 * rng.standard_normal((B, N, nu))),
                   enc)
    U = U1 + t(0.05 * rng.standard_normal((B, N, nu)))
    k = k1 * t(1.0 + 0.01 * rng.standard_normal((B, N, nu)))
    K = K1 * t(1.0 + 0.01 * rng.standard_normal((B, N, nu, nz)))
    return m, (model_cls, cost_cls, dt), (Z, U, k, K)


_CODECS = (IGN, StateEncoding.VARIANCE_ONLY,
           StateEncoding.UPPER_TRIANGULAR_CHOLESKY,
           StateEncoding.FULL_COVARIANCE_MATRIX)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,enc", [(n, e) for n in _EXAMPLES
                                      for e in _CODECS])
def test_k2_batches_on_card(cuda, dtype, name, enc):
    """K2 stages (a)-(c) against control_law for every example and codec
    of chip_smoke.py's phase 10 at B, N of BATCHES, ten candidates,
    relative to each output's largest value: f64 1e-12 (1e-10 for the
    cartpole's stage (a)), f32 1e-4."""
    for seed, (B, N) in enumerate(BATCHES):
        m, (model_cls, cost_cls, dt), ins = _path_inputs(name, enc, B, N,
                                                         seed)
        model = getattr(m, model_cls)(dt=dt, device=cuda, dtype=dtype)
        cost = getattr(m, cost_cls)(device=cuda, dtype=dtype)
        Z, U, k, K = (t.to(device=cuda, dtype=dtype).contiguous()
                      for t in ins)
        alphas = default_fit_alphas(dtype, cuda)
        st = fr.stage(model, cost, enc)
        n = fr.launches[st]
        got = fr.fused_control_law(model, Z, U, k, K, alphas, enc,
                                   cost=cost)
        want = control_law(model, Z, U, k, K, alphas, enc, cost=cost,
                           cost_in_scan=enc == IGN)
        torch.cuda.synchronize()
        assert fr.launches[st] == n + 1
        tol = ((1e-10 if st == "a" else 1e-12) if dtype == torch.float64
               else 1e-4)
        for a, w in zip(got, want):
            assert bool(torch.isfinite(w).all())
            assert float((a - w).abs().max()) <= tol * float(w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("A", [40, 64])
def test_k2_many_alphas_on_card(cuda, dtype, A):
    """More candidates than a warp has lanes (a warp per 32 of a solve's
    candidates): K2 against control_law at B, N = (1, 37) and (3, 200),
    relative to each output's largest value (f64 1e-10, f32 1e-4), and a
    solve with A step sizes whose line searches all launch K2."""
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    alphas = torch.logspace(0.0, -3.0, A, dtype=dtype, device=cuda)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for seed, (B, N) in enumerate([(1, 37), (3, 200)]):
        m, (model_cls, cost_cls, dt), ins = _path_inputs("cartpole", IGN, B,
                                                         N, seed)
        model = getattr(m, model_cls)(dt=dt, device=cuda, dtype=dtype)
        cost = getattr(m, cost_cls)(device=cuda, dtype=dtype)
        Z, U, k, K = (t.to(device=cuda, dtype=dtype).contiguous()
                      for t in ins)
        n = fr.launches["a"]
        got = fr.fused_control_law(model, Z, U, k, K, alphas, IGN,
                                   cost=cost)
        want = control_law(model, Z, U, k, K, alphas, IGN, cost=cost,
                           cost_in_scan=True)
        torch.cuda.synchronize()
        assert fr.launches["a"] == n + 1
        assert got[0].shape == (B, N + 1, A, 4)
        for a, w in zip(got, want):
            assert bool(torch.isfinite(w).all())
            assert float((a - w).abs().max()) <= tol * float(w.abs().max())
    n = fr.launches["a"]
    r = solve(model, cost, Z[0, 0], U[0], ILQROptions(
        n_iterations=3, alphas=alphas, riccati_mode="kernel",
        fused_rollout=True), encoding=IGN)
    assert r.evals >= 1 and fr.launches["a"] - n == r.evals


@pytest.mark.gpu
def test_controller_fit_and_mpc_tick_on_card(cuda):
    """iLQRController.fit and one forward(mpc=True) tick on rendezvous
    under the Cholesky codec (nz = 44, K1's block kernel; K2 stage (c)),
    float64 on the card through the kernels against the CPU's plain
    versions, at the golden tests' tolerances (J rtol 1e-6, Z/U rtol 1e-5,
    atol 1e-7). K1 and K2 launch on every evaluation."""
    from pddp_tpu_torch.controllers import iLQRController
    from pddp_tpu_torch.examples.rendezvous import (RendezvousCost,
                                                    RendezvousEnv)
    enc = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    x0 = [-10.0, -10.0, 10.0, 10.0, 0.0, -5.0, 5.0, 0.0]
    U0 = 0.1 * np.random.default_rng(0).standard_normal((40, 4))
    out = {}
    for dev, kernels in ((cuda, True), ("cpu", False)):
        env = RendezvousEnv(device=dev, dtype=torch.float64)
        env.set_state(x0)
        ctrl = iLQRController(env, env.model, RendezvousCost(
            device=dev, dtype=torch.float64),
            riccati_mode="kernel" if kernels else "scan",
            fused_rollout=kernels)
        n = (bk.block_launches, sum(fr.launches.values()))
        Z, U, _ = ctrl.fit(torch.as_tensor(U0, device=dev), encoding=enc,
                           n_iterations=3)
        evals = ctrl.last_result.evals
        u = ctrl.forward(env.get_state().encode(enc), 0, enc, mpc=True)
        evals += ctrl.last_result.evals
        if kernels:
            assert Z.shape[-1] == 44
            assert (bk.block_launches - n[0],
                    sum(fr.launches.values()) - n[1]) == (evals, evals)
        out[kernels] = (Z.cpu(), U.cpu(), u.cpu(), ctrl.last_result.J_opt)
    for a, b in zip(out[True][:3], out[False][:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(out[True][3], out[False][3], rtol=1e-6)


@pytest.mark.gpu
def test_fit_bnn_on_card(cuda):
    """fit_bnn on the card against the CPU, float64, on the same numpy
    draws (5 AMSGrad steps of batch 8 on 64 rows, 24 of them padding):
    the losses, every leaf and the normalizers within 1e-10."""
    from pddp_tpu_torch.models.bnn import bnn_dynamics_model_factory, fit_bnn
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, 4))
    U = 3.0 * rng.standard_normal((64, 1))
    dX = 0.1 * rng.standard_normal((64, 4)) + 0.05 * X
    draws = {"batch_idx": rng.integers(0, 40, (5, 8)),
             "noise": [rng.uniform(1e-5, 1.0 - 1e-5, (5, 8, 32))
                       for _ in range(2)]}
    cls = bnn_dynamics_model_factory(4, 1, [32, 32], angular_indices=(2,),
                                     non_angular_indices=(0, 1, 3))
    out = []
    for dev in (cuda, "cpu"):
        model = cls.init(seed=0, n_particles=8, horizon=3,
                         dtype=torch.float64, device=dev)
        out.append(fit_bnn(
            model, *(torch.as_tensor(a, device=dev) for a in (X, U, dX)),
            n_iter=5, batch_size=8, learning_rate=1e-2, return_losses=True,
            n_valid=40, **draws))
    (m_card, l_card), (m_cpu, l_cpu) = out
    np.testing.assert_allclose(l_card.cpu().numpy(), l_cpu.numpy(),
                               rtol=1e-10, atol=1e-10)
    for a, b in zip(m_card.net.leaves() + [m_card.X_std, m_card.dX_mean],
                    m_cpu.net.leaves() + [m_cpu.X_std, m_cpu.dX_mean]):
        assert a.device.type == torch.device(cuda).type
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.gpu
def test_pddp_loop_on_card(cuda):
    """The loop of tests/golden/pddp_trace.npz (pendulum, BNN [16, 16],
    P=8, N=6, Cholesky codec, float64, pddp_tpu's draws) on the card
    against the CPU: the initial trials, the first model fit and the iLQR
    fit within 1e-9; the MPC trial within the spread that a 1e-14 change
    of its start gives the port itself on the CPU (X 1.1e-7, U 8.2e-5,
    dX 2.5e-5, J 8.5e-6 relative, rounded up here): some of its ticks
    turn a 1e-14 change of their state into a 1e-8 change of their
    control."""
    from pddp_tpu_torch import convert
    from pddp_tpu_torch.controllers import PDDPController
    from pddp_tpu_torch.examples.pendulum import PendulumCost, PendulumEnv
    from tests.golden import pddp_trace as tr
    trace = tr.load()
    runs = []
    for dev in (cuda, "cpu"):
        leaves = [trace["init_net_{}".format(i)] for i in range(14)]
        model = convert.bnn(
            leaves, {k: trace["init_" + k] for k in convert.BNN_BUFFERS},
            tr.STATE, tr.ACTION, tr.HIDDEN, angular_indices=tr.ANGULAR,
            non_angular_indices=tr.NON_ANGULAR, n_particles=tr.P,
            horizon=2 * tr.N + 1, device=dev, dtype=torch.float64)
        env = PendulumEnv(dt=tr.DT, device=dev, dtype=torch.float64)
        resets = iter(trace["resets"])
        env.reset = lambda env=env: env.set_state(next(resets))
        ctrl = PDDPController(env, model, PendulumCost(
            device=dev, dtype=torch.float64), training_opts=tr.TRAINING,
            draws=trace["draws"])
        trials, fits = [], []
        apply_controller, fit_model = ctrl._apply_controller, ctrl._fit_model

        def rec_apply(*args, apply_controller=apply_controller,
                      trials=trials, **kwargs):
            data, J = apply_controller(*args, **kwargs)
            trials.append([a.cpu() for a in data] + [float(J)])
            return data, J

        def rec_fit(*args, fit_model=fit_model, fits=fits, **kwargs):
            m = fit_model(*args, **kwargs)
            fits.append([a.cpu() for a in m.net.leaves()])
            return m
        ctrl._apply_controller, ctrl._fit_model = rec_apply, rec_fit
        umax = torch.tensor([tr.UMAX], dtype=torch.float64, device=dev)
        Z, U, _ = ctrl.fit(torch.as_tensor(tr.U0(), device=dev),
                           encoding=StateEncoding[tr.ENCODING], quiet=True,
                           u_min=-umax, u_max=umax, **tr.FIT)
        runs.append((trials, fits, Z.cpu(), U.cpu()))
    (t_card, f_card, Z_card, U_card), (t_cpu, f_cpu, Z_cpu, U_cpu) = runs
    tight = dict(rtol=1e-9, atol=1e-9)
    for a, b in zip(t_card[:2], t_cpu[:2]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tight)
    for x, y in zip(f_card[0], f_cpu[0]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **tight)
    np.testing.assert_allclose(Z_card.numpy(), Z_cpu.numpy(), **tight)
    np.testing.assert_allclose(U_card.numpy(), U_cpu.numpy(), **tight)
    for x, y, atol in zip(t_card[2][:3], t_cpu[2][:3], (2e-7, 1e-4, 5e-5)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(t_card[2][3], t_cpu[2][3], rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("nz,nu", [(4, 1), (8, 4), (20, 1)])
def test_k1_reg_per_lane_on_card(cuda, nz, nu):
    """K1 (warp kernel at (4, 1) and (8, 4), block kernel at nz = 20) with
    a reg per lane, 10^U(-6, 2) over 64 lanes, against the plain
    backward's broadcast of the same (B,) reg in float64 (1e-10 at nu = 1,
    1e-8 through the Jacobi); and each of three lanes bit for bit the
    lane of a launch where every lane takes that lane's reg as a float."""
    B, N = 64, 60
    solves = [_riccati_inputs(500 + b, N, nz, nu) for b in range(B)]
    ins = [torch.as_tensor(np.stack(a), dtype=torch.float64, device=cuda)
           for a in zip(*solves)]
    regs = torch.as_tensor(10.0**np.random.default_rng(5).uniform(-6, 2, B),
                           device=cuda)
    n = bk.launches + bk.block_launches
    k_k, K_k, ok_k = bk.kernel_backward(*ins, reg=regs)
    k_p, K_p, ok_p = backward(*ins, reg=regs)
    torch.cuda.synchronize()
    assert bk.launches + bk.block_launches == n + 1
    assert bool(ok_k.all()) and bool(ok_p.all())
    tol = 1e-10 if nu == 1 else 1e-8
    for b in range(B):
        for a, w in ((k_k[b], k_p[b]), (K_k[b], K_p[b])):
            assert float((a - w).abs().max()) <= tol * float(w.abs().max())
    for b in (0, 17, 63):
        k1, K1, _ = bk.kernel_backward(*ins, reg=float(regs[b]))
        assert torch.equal(k1[b], k_k[b]) and torch.equal(K1[b], K_k[b])


@pytest.mark.gpu
def test_batched_solve_kernels_on_card(cuda):
    """A B=16 cartpole batched_solve (N=60, float64) through K1 (a reg per
    lane) and K2(a) against the scan with the cost in the loop, lane by
    lane: the same state, iterations and evaluations, J within 1e-10; K1
    and K2(a) each launched once per evaluation of the batch."""
    from pddp_tpu_torch.controllers import ilqr
    from pddp_tpu_torch.controllers.ilqr import ILQROptions
    from pddp_tpu_torch.parallel import batched_solve
    model = CartpoleDynamicsModel(dt=0.05, device=cuda, dtype=torch.float64)
    cost = CartpoleCost(device=cuda, dtype=torch.float64)
    rng = np.random.default_rng(0)
    z0s = torch.as_tensor(0.05 * rng.standard_normal((16, 4)), device=cuda)
    U0s = torch.full((16, 60, 1), 0.1, dtype=torch.float64, device=cuda)
    base = dict(n_iterations=5, max_evals=15)
    scan = batched_solve(model, cost, z0s, U0s,
                         ILQROptions(**base, cost_in_scan=True), encoding=IGN)
    n1, n2, ne = bk.launches, fr.launches["a"], ilqr.lane_evaluations
    kern = batched_solve(model, cost, z0s, U0s,
                         ILQROptions(**base, riccati_mode="kernel",
                                     fused_rollout=True), encoding=IGN)
    evals = ilqr.lane_evaluations - ne
    assert evals >= 1
    assert bk.launches - n1 == evals and fr.launches["a"] - n2 == evals
    for f in ("state", "iterations", "evals"):
        assert torch.equal(getattr(kern, f), getattr(scan, f)), f
    rel = ((kern.J_opt - scan.J_opt).abs() / scan.J_opt.abs()).max()
    assert float(rel) <= 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["VARIANCE_ONLY", "FULL_COVARIANCE_MATRIX"])
def test_particle_solve_through_k1_on_card(cuda, codec):
    """A cartpole ``particulate_model`` solve (P=100, N=30, float64)
    through K1 (the warp kernel at nz = 8, the block kernel at nz = 20)
    against the same solve through the plain backward: the same state,
    iterations and evaluations, J within 1e-10 relative and Z, U within
    1e-8 of their largest entry (the same arithmetic in another order of
    sums); K1 launched once per evaluation, the line search on the scan
    (the model is stateful)."""
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.utils.particles import particulate_model
    enc = StateEncoding[codec]
    inner = CartpoleDynamicsModel(dt=0.05, device=cuda, dtype=torch.float64)
    eps = np.random.default_rng(1).standard_normal((30, 100, 4))
    model = particulate_model(inner, eps=eps, n_particles=100, horizon=30)
    cost = CartpoleCost(device=cuda, dtype=torch.float64)
    z0 = encode(torch.tensor([0.0, 0.0, 0.1, 0.0], dtype=torch.float64,
                             device=cuda),
                V=1e-2 * torch.ones(4, dtype=torch.float64, device=cuda),
                encoding=enc)
    U0 = torch.as_tensor(0.1 * np.random.default_rng(2).standard_normal(
        (30, 1)), device=cuda)
    base = dict(n_iterations=3, max_evals=8)
    plain = solve(model, cost, z0, U0, ILQROptions(**base), encoding=enc)
    n = (bk.launches, bk.block_launches, sum(fr.launches.values()))
    kern = solve(model, cost, z0, U0,
                 ILQROptions(**base, riccati_mode="kernel",
                             fused_rollout=True), encoding=enc)
    counts = (bk.launches - n[0], bk.block_launches - n[1],
              sum(fr.launches.values()) - n[2])
    block = codec == "FULL_COVARIANCE_MATRIX"
    assert counts == ((0, kern.evals, 0) if block else (kern.evals, 0, 0))
    assert (kern.state, kern.iterations, kern.evals) == (
        plain.state, plain.iterations, plain.evals)
    assert abs(kern.J_opt - plain.J_opt) <= 1e-10 * abs(plain.J_opt)
    for a, b in ((kern.Z, plain.Z), (kern.U, plain.U)):
        assert float((a - b).abs().max()) <= 1e-8 * float(b.abs().max())


@pytest.fixture(scope="module")
def nccl_world():
    """A 1-rank NCCL world in this process on cuda:0 (the machine's one
    card) and its 1-D mesh ``dp``; skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import torch.distributed as dist

    from pddp_tpu_torch.parallel import make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:{}".format(
        port), world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        yield make_mesh("dp")
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_batched_solve_on_card(nccl_world):
    """The B=16 cartpole batch (N=60, float64) sharded over a 1-rank NCCL
    mesh through K1 and K2(a): the bits of the unsharded batch, K1 and
    K2(a) each launched once per evaluation; in chunks of 8, the same
    ends and J within 1e-10 (the local model's batched products may take
    another order of sums at another batch size)."""
    from pddp_tpu_torch.controllers import ilqr
    from pddp_tpu_torch.controllers.ilqr import ILQROptions
    from pddp_tpu_torch.parallel import batched_solve
    cuda = torch.device("cuda")
    model = CartpoleDynamicsModel(dt=0.05, device=cuda, dtype=torch.float64)
    cost = CartpoleCost(device=cuda, dtype=torch.float64)
    rng = np.random.default_rng(0)
    z0s = torch.as_tensor(0.05 * rng.standard_normal((16, 4)), device=cuda)
    U0s = torch.full((16, 60, 1), 0.1, dtype=torch.float64, device=cuda)
    opts = ILQROptions(n_iterations=5, max_evals=15, riccati_mode="kernel",
                       fused_rollout=True)
    whole = batched_solve(model, cost, z0s, U0s, opts, encoding=IGN)
    n1, n2, ne = bk.launches, fr.launches["a"], ilqr.lane_evaluations
    sharded = batched_solve(model, cost, z0s, U0s, opts, encoding=IGN,
                            mesh=nccl_world)
    evals = ilqr.lane_evaluations - ne
    assert evals >= 1
    assert bk.launches - n1 == evals and fr.launches["a"] - n2 == evals
    for f in ("Z", "U", "K", "J_opt", "state", "iterations", "evals"):
        assert torch.equal(getattr(sharded, f), getattr(whole, f)), f
    chunked = batched_solve(model, cost, z0s, U0s, opts, encoding=IGN,
                            mesh=nccl_world, chunk=8)
    for f in ("state", "iterations", "evals"):
        assert torch.equal(getattr(chunked, f), getattr(whole, f)), f
    rel = ((chunked.J_opt - whole.J_opt).abs() / whole.J_opt.abs()).max()
    assert float(rel) <= 1e-10


@pytest.mark.gpu
def test_particle_sharded_solve_on_card(nccl_world):
    """A BNN (hidden [32, 32], P=16, N=10, float64, the Cholesky codec)
    solved with its particles sharded over a 1-rank NCCL mesh through K1
    (the moment match's all-reduces on the card): the unsharded solve's
    ends, J within 1e-9, Z and U within 1e-7 (tests/parallel/
    test_particles.py:48-51); K1 once an evaluation."""
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.models.bnn import bnn_dynamics_model_factory
    from pddp_tpu_torch.parallel import particle_sharded_solve
    cuda = torch.device("cuda")
    enc = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    model = bnn_dynamics_model_factory(
        4, 1, [32, 32], angular_indices=(2,),
        non_angular_indices=(0, 1, 3)).init(
            seed=3, n_particles=16, horizon=11, dtype=torch.float64,
            device=cuda)
    cost = CartpoleCost(device=cuda, dtype=torch.float64)
    z0 = encode(torch.zeros(4, dtype=torch.float64, device=cuda),
                V=1e-2 * torch.ones(4, dtype=torch.float64, device=cuda),
                encoding=enc)
    U0 = torch.full((10, 1), 0.1, dtype=torch.float64, device=cuda)
    opts = ILQROptions(n_iterations=3, max_evals=8, riccati_mode="kernel")
    ref = solve(model, cost, z0, U0, opts, encoding=enc)
    n1 = bk.launches
    r = particle_sharded_solve(model, cost, z0, U0, opts, encoding=enc,
                               mesh=nccl_world, axis_name="dp")
    assert bk.launches - n1 == r.evals >= 1
    assert (r.state, r.iterations, r.evals) == (ref.state, ref.iterations,
                                                ref.evals)
    assert abs(r.J_opt - ref.J_opt) <= 1e-9 * abs(ref.J_opt)
    for a, b in ((r.Z, ref.Z), (r.U, ref.U)):
        assert float(((a - b).abs() - 1e-7 * b.abs()).max()) <= 1e-10


def _f32_held(got, want, ref):
    """float32 against its plain version ``want`` by chip_smoke.py's rule
    (``f32_derived``, phase 19's floor): each output within the larger of
    the floor and twice the float32 plain version's own distance to the
    float64 plain version ``ref`` on the same inputs, relative to its
    largest value."""
    from chip_smoke import REST_F32_FLOOR, f32_derived, rel_err
    for a, w, r in zip(got, want, ref):
        assert bool(torch.isfinite(a).all())
        assert f32_derived(rel_err(a.double(), r)[1],
                           rel_err(w.double(), r)[1], rel_err(a, w)[1],
                           REST_F32_FLOOR)["held"]


def _cast(model, dtype):
    """The particle model with its noise and the inner model's parameters
    cast to ``dtype`` (a ``constrain_model`` subclass stays one)."""
    from pddp_tpu_torch.ops._examples import PARAM_NAMES, example_of
    names = PARAM_NAMES[example_of(model.inner)[0]]
    inner = type(model.inner)(*(getattr(model.inner, n).to(dtype)
                                for n in names),
                              device=model.eps.device, dtype=dtype)
    return model.replace(inner=inner, eps=model.eps.to(dtype))


_K2E_PROBLEMS: dict = {}


def _k2e_problem(cuda, ex, codec, P, infer, constrained, N, x0):
    """(float64 particle model, cost, Z, U, k, K) of a ``_k2e_check`` case,
    made once for every dtype and batch that shares it."""
    import importlib

    from pddp_tpu_torch.utils.constraint import constrain_model
    from pddp_tpu_torch.utils.particles import particulate_model
    key = (ex, codec, P, infer, constrained, N, tuple(x0))
    if key in _K2E_PROBLEMS:
        return _K2E_PROBLEMS[key]
    mod, model_cls, cost_cls, _, dt = _EXAMPLES[ex]
    m = importlib.import_module("pddp_tpu_torch.examples." + mod)
    cls = getattr(m, model_cls)
    if constrained:
        cls = constrain_model(-10.0, 10.0)(cls)
    enc, f64 = StateEncoding[codec], torch.float64
    rng = np.random.default_rng(5)
    inner = cls(dt=dt, device=cuda, dtype=f64)
    n, nu = inner.state_size, inner.action_size
    m64 = particulate_model(inner, eps=rng.standard_normal((N + 1, P, n)),
                            n_particles=P, horizon=N + 1,
                            infer_noise_variables=infer)
    cost = getattr(m, cost_cls)(device=cuda, dtype=f64)
    x = torch.tensor(x0, dtype=f64, device=cuda)
    z0 = x if enc == IGN else encode(x, V=1e-2 * torch.ones_like(x),
                                     encoding=enc)
    U = torch.as_tensor(0.1 + 0.05 * rng.standard_normal((N, nu)),
                        device=cuda)
    Z, AUX = rollout(m64, z0, U, enc)
    derivs = local_model(Z, U, AUX, m64, cost, enc)
    for reg in 10.0**np.arange(1, 11):
        k, K, ok = backward(*derivs, reg=float(reg))
        if bool(ok):
            break
    assert bool(ok)
    _K2E_PROBLEMS[key] = (m64, cost, Z, U, k, K)
    return _K2E_PROBLEMS[key]


def _k2e_check(cuda, dtype, ex, codec, P, B, infer=True, bounds=None,
               constrained=False, N=12, x0=None):
    """K2(e) through ``fused_control_law`` against ``control_law`` with
    the particle model over example ``ex`` (``constrain_model(-10, 10)``'s
    subclass where ``constrained``), P particles, N steps, ten alphas, B
    solves (the gains perturbed by 1 % each), noise inference on or off,
    the actions clamped to ``bounds`` where given, from ``x0`` (by
    default the example's start in ``_EXAMPLES``) with variances 1e-2:
    float64 each output within 1e-10 of its largest value, float32 by
    ``_f32_held``; one launch. The gains are the plain backward's on the
    float64 local model of a rollout, at the first reg of 10, 100, ...
    that keeps them finite (``_k2e_problem``)."""
    from pddp_tpu_torch.ops import fused_particle_rollout as fpr
    m64, cost, Z, U, k, K = _k2e_problem(
        cuda, ex, codec, P, infer, constrained, N,
        _EXAMPLES[ex][3] if x0 is None else x0)
    enc, f64 = StateEncoding[codec], torch.float64
    rng = np.random.default_rng(6)
    ins = [t.to(dtype) for t in (Z, U, k, K)]
    if B > 1:
        ins = [(t * torch.as_tensor(1.0 + 0.01 * rng.standard_normal(
            (B,) + t.shape), dtype=dtype, device=cuda)).contiguous()
            for t in ins]
    lo, hi = (None, None) if bounds is None else (
        torch.tensor(b, dtype=dtype, device=cuda) for b in bounds)
    model = _cast(m64, dtype)
    cost_t = type(cost)(device=cuda, dtype=dtype)
    alphas = default_fit_alphas(dtype, cuda)
    n_launch = fpr.launches["rollout"]
    got = fr.fused_control_law(model, *ins, alphas, enc, cost=cost_t,
                               u_min=lo, u_max=hi, with_aux=True)
    torch.cuda.synchronize()
    assert fpr.launches["rollout"] == n_launch + 1

    def plain(mm, c, ts, a, b_lo, b_hi):
        return control_law(mm, *ts, a, enc, cost=c, u_min=b_lo, u_max=b_hi,
                           with_aux=True)
    want = plain(model, cost_t, ins, alphas, lo, hi)
    if dtype == f64:
        for a, w in zip(got, want):
            assert bool(torch.isfinite(w).all())
            assert float((a - w).abs().max()) <= 1e-10 * float(
                w.abs().max())
    else:
        ref = plain(_cast(model, f64), cost, [t.double() for t in ins],
                    alphas.double(), *(None if b is None else b.double()
                                       for b in (lo, hi)))
        _f32_held(got, want, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("codec", ["FULL_COVARIANCE_MATRIX",
                                   "VARIANCE_ONLY",
                                   "UPPER_TRIANGULAR_CHOLESKY",
                                   "STANDARD_DEVIATION_ONLY",
                                   "IGNORE_UNCERTAINTY"])
@pytest.mark.parametrize("B", [1, 3])
def test_k2e_particle_kernel_matches_plain_on_card(cuda, dtype, codec, B):
    """K2(e) with the particle model over the cartpole (P=37, N=12, ten
    alphas) under each codec, one solve and three (``_k2e_check``), the
    pole started at 0.8 rad. The gains swing the pole through 0 rad;
    started at 0.1 or 0.2 rad, a step lands close to 0 rad, where the
    cost's float32 variance of the pole's cosine (about v sin^2(theta))
    cancels below its rounding, so that STANDARD_DEVIATION_ONLY's square
    root of it is NaN for the kernel's or the plain version's states
    alike (PERF.md §7)."""
    _k2e_check(cuda, dtype, "cartpole", codec, 37, B,
               x0=[0.0, 0.0, 0.8, 0.0])


# K2(e) at the shapes its launch bounds, staging and belief warp must
# survive: (example, codec, P, noise inference, bounds, constrained).
K2E_SHAPES = [
    ("rendezvous", "FULL_COVARIANCE_MATRIX", 37, True, None, False),
    ("cartpole", "VARIANCE_ONLY", 2, True, None, False),
    ("cartpole", "UPPER_TRIANGULAR_CHOLESKY", 1024, True, None, False),
    ("rendezvous", "FULL_COVARIANCE_MATRIX", 1024, True, None, False),
    ("cartpole", "UPPER_TRIANGULAR_CHOLESKY", 37, False, None, False),
    ("cartpole", "UPPER_TRIANGULAR_CHOLESKY", 37, True, (-0.05, 0.05),
     False),
    ("cartpole", "UPPER_TRIANGULAR_CHOLESKY", 37, True, None, True),
    ("double_cartpole", "VARIANCE_ONLY", 200, False, (-0.5, 0.5), True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ex,codec,P,infer,bounds,constrained", K2E_SHAPES)
def test_k2e_particle_kernel_shapes_on_card(cuda, dtype, ex, codec, P, infer,
                                            bounds, constrained):
    """K2(e) against its plain version (``_k2e_check``, two solves) at
    the rendezvous under the full covariance (nz = 72, the widest staged
    step and the 8 x 8 ladder), 2 and 1024 particles (the smallest block
    and the 1024-thread instance), noise inference off, the actions
    clamped, and a ``constrain_model`` inner model."""
    _k2e_check(cuda, dtype, ex, codec, P, 2, infer=infer, bounds=bounds,
               constrained=constrained)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("codec", ["FULL_COVARIANCE_MATRIX",
                                   "VARIANCE_ONLY"])
def test_k2d_bnn_kernel_other_codecs_on_card(cuda, dtype, codec):
    """K2(d) under the full covariance and VARIANCE_ONLY against
    control_law with the same model, three steps, P=37: float64 each
    output within 1e-10 of its largest value, float32 by ``_f32_held``
    against the float64 model's plain version; one launch."""
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    enc = StateEncoding[codec]
    model, ins = _bnn(cuda, dtype, 3, P=37, enc=enc)
    alphas = default_fit_alphas(dtype, cuda)
    n = fb.launches["rollout"]
    got = fb.fused_bnn_control_law(model, *ins, alphas, enc)
    torch.cuda.synchronize()
    assert fb.launches["rollout"] == n + 1
    want = control_law(model, *ins, alphas, enc, with_aux=True)
    if dtype == torch.float64:
        for a, w in zip(got, want):
            assert bool(torch.isfinite(w).all())
            assert float((a - w).abs().max()) <= 1e-10 * float(
                w.abs().max())
    else:
        m64, _ = _bnn(cuda, torch.float64, 3, P=37, gains=False)
        ref = control_law(m64, *(t.double() for t in ins), alphas.double(),
                          enc, with_aux=True)
        _f32_held(got, want, ref)


@pytest.mark.gpu
def test_constrained_k2a_solve_on_card(cuda):
    """``solve(..., riccati_mode="kernel", fused_rollout=True)`` on
    constrain_model's cartpole (actions squashed into [-10, 10]), float64,
    H=60, against the CPU's plain solve: the same state, iterations and
    evaluations, J within 1e-10 relative; K2(a) and K1 launched once an
    evaluation."""
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.utils.constraint import constrain_model
    cls = constrain_model(-10.0, 10.0)(CartpoleDynamicsModel)
    runs = {}
    for dev in ("cpu", cuda):
        model = cls(dt=0.05, device=dev, dtype=torch.float64)
        cost = CartpoleCost(device=dev, dtype=torch.float64)
        z0 = torch.tensor([0.0, 0.0, 0.1, 0.0], dtype=torch.float64,
                          device=dev)
        U0 = torch.full((60, 1), 0.1, dtype=torch.float64, device=dev)
        opts = (ILQROptions(n_iterations=10, cost_in_scan=True) if dev == "cpu"
                else ILQROptions(n_iterations=10, riccati_mode="kernel",
                                 fused_rollout=True))
        n = (bk.launches, fr.launches["a"])
        runs[str(dev)] = solve(model, cost, z0, U0, opts, encoding=IGN)
        counts = (bk.launches - n[0], fr.launches["a"] - n[1])
    kern, plain = runs[str(cuda)], runs["cpu"]
    assert counts == (kern.evals, kern.evals)
    assert (kern.state, kern.iterations, kern.evals) == (
        plain.state, plain.iterations, plain.evals)
    assert abs(kern.J_opt - plain.J_opt) <= 1e-10 * abs(plain.J_opt)


@pytest.mark.gpu
def test_particle_f32_chol_local_model_on_card_matches_cpu(cuda):
    """L_z and L_zz of the float32 local model of phase 17's Cholesky
    particle cartpole row (P=100, N=50, numpy seeds 17 and 18) on the card
    against the CPU's: finite, within 1e-4 of the largest value (the
    other arrays of that local model agree to ~1e-6). On an H100 the
    first rung of the cost's augmented 5 x 5 covariance fails at step 4
    (its last pivot -4.18e-12), so the ladder takes a later one there, and
    L_z and L_zz stay finite only while that failed rung carries no
    derivative (``utils.linalg.safe_cholesky``)."""
    import chip_smoke as cs
    CH = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    derivs = {}
    for device in ("cpu", cuda):
        model, cost, z0, U0 = cs.particle_problem("cartpole_chol", device,
                                                  torch.float32)
        Z, AUX = rollout(model, z0, U0, CH)
        derivs[str(device)] = local_model(Z, U0, AUX, model, cost, CH)
    for name in ("L_z", "L_zz"):
        i = cs.LOCAL_NAMES.index(name)
        got = derivs["cuda"][i].cpu().double()
        want = derivs["cpu"][i].double()
        assert bool(torch.isfinite(want).all())
        assert bool(torch.isfinite(got).all()), name
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("knob", ["compute_dtype", "matmul_dtype"])
@pytest.mark.parametrize("B", [1, 64])
def test_k2d_bf16_knob_on_card(cuda, dtype, knob, B):
    """K2(d)'s bfloat16 instances (float32 on the tensor cores) at the
    bench net's widths (6-200-200-8, P=100), three steps, against
    control_law over the same knob's net: float64 each output within
    1e-10 of its largest value (the same roundings, the float64 sums in
    another order); float32 by ``chip_smoke.bf16_derived`` against the
    float64 plain version of the float32 net on the same inputs, which
    the full-precision K2(d) must fail; one launch."""
    from chip_smoke import BF16_F32_FLOOR, bf16_derived, cast_tree, knob_model
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    full, ins = _bnn(cuda, dtype, 3, P=100, hidden=(200, 200))
    if B > 1:
        ins = [t.expand((B,) + t.shape).contiguous() for t in ins]
    model = knob_model(full, knob)
    alphas = default_fit_alphas(dtype, cuda)
    n = fb.launches["rollout"]
    got = fb.fused_bnn_control_law(model, *ins, alphas, CH)
    torch.cuda.synchronize()
    assert fb.launches["rollout"] == n + 1
    want = control_law(model, *ins, alphas, CH, with_aux=True)
    if dtype == torch.float64:
        for a, w in zip(got, want):
            assert bool(torch.isfinite(w).all())
            err = float((a - w).abs().max()) / float(w.abs().max())
            assert err <= 1e-10
        return
    ref = control_law(cast_tree(model, torch.float64),
                      *[t.double() for t in ins], alphas.double(), CH,
                      with_aux=True)
    full_out = fb.fused_bnn_control_law(full, *ins, alphas, CH)
    for a, w, r in zip(got, want, ref):
        assert bool(torch.isfinite(r).all())
        assert bf16_derived(a, w, r, BF16_F32_FLOOR)["held"]
    assert not all(bf16_derived(a, w, r, BF16_F32_FLOOR)["held"]
                   for a, w, r in zip(full_out, want, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("knob", ["compute_dtype", "matmul_dtype"])
@pytest.mark.parametrize("G", [10, 640])
def test_bnn_mlp_bf16_knob_on_card(cuda, dtype, knob, G):
    """F3's bfloat16 instances at the bench net's widths for 10 groups
    (a cluster each) and 640 (a CTA each) against the knob net's own
    call: float64 within 1e-10, float32 by ``chip_smoke.bf16_derived``
    against the float64 plain forward of the float32 net, which the
    full-precision F3 must fail; one launch."""
    from chip_smoke import BF16_F32_FLOOR, bf16_derived, cast_tree, knob_model
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    full, _ = _bnn(cuda, dtype, 2, P=100, hidden=(200, 200), gains=False)
    net = knob_model(full, knob).net
    x = torch.as_tensor(np.random.default_rng(G).standard_normal(
        (G, 100, 6)), dtype=dtype, device=cuda)
    n = fb.launches["mlp"]
    got = fb.mlp(net, x)
    want = net(x)
    torch.cuda.synchronize()
    assert fb.launches["mlp"] == n + 1
    if dtype == torch.float64:
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= 1e-10
        return
    ref = cast_tree(net, torch.float64)(x.double())
    assert bf16_derived(got, want, ref, BF16_F32_FLOOR)["held"]
    assert not bf16_derived(fb.mlp(full.net, x), want, ref,
                            BF16_F32_FLOOR)["held"]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("row", ["G1", "G2", "G3", "E1", "E2"])
def test_stateful_traced_kernels_on_card(cuda, row, B):
    """K2(g) (a user's stateful model) and K2(e) over a traced inner step
    (tests/traced_models.py's stateful rows, N=6, P=8) against
    ``control_law`` on the card in float64: Z, U and the aux within
    1e-10, J 1e-8 (relative), one launch of the row's kernel."""
    from pddp_tpu_torch.ops import fused_particle_rollout as fpr
    from pddp_tpu_torch.ops import traced_rollout as tro
    from tests import traced_models as tm
    f64, N = torch.float64, 6
    model, cost, enc, bounds = tm.make_stateful_row(row, N, cuda, f64, P=8)
    n, nu = model.state_size, model.action_size
    nz = infer_encoded_state_size(n, enc)
    name = tm.example_name(tm.STATEFUL_ROWS[row][0])
    z0 = encode(torch.tensor(tm.STARTS[name][1], dtype=f64, device=cuda),
                V=1e-2 * torch.ones(n, dtype=f64, device=cuda), encoding=enc)
    U, k, K = (torch.as_tensor(a, dtype=f64, device=cuda)
               for a in tm.stateful_inputs(row, N, nz, nu))
    Z = rollout(model, z0, U, enc)[0]
    ins = [t.expand((B,) + t.shape).contiguous() for t in (Z, U, k, K)]
    lo, hi = (None, None) if bounds is None else (
        torch.tensor(b, dtype=f64, device=cuda) for b in bounds)
    alphas = default_fit_alphas(f64, cuda)
    counts = tro.launches if row[0] == "G" else fpr.launches
    key = "stateful" if row[0] == "G" else "traced"
    n_launch = counts[key]
    got = fr.fused_control_law(model, *ins, alphas, enc, cost=cost,
                               u_min=lo, u_max=hi, with_aux=True)
    torch.cuda.synchronize()
    assert counts[key] == n_launch + 1
    want = control_law(model, *ins, alphas, enc, cost=cost, u_min=lo,
                       u_max=hi, with_aux=True,
                       cost_in_scan=enc == IGN)
    for a, w, tol in zip(got, want, (1e-10, 1e-10, 1e-8, 1e-10)):
        assert a.shape == w.shape
        assert float((a - w).abs().max()) <= tol * float(w.abs().max())
