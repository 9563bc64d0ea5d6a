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


def _bnn(cuda, dtype, N, P=16, hidden=(32, 32)):
    """A seeded untrained BNN, its start belief, and finite gains of one
    reg=1 backward pass around U = 0.1 (computed on the CPU)."""
    from pddp_tpu_torch.encoding import encode
    from pddp_tpu_torch.models.bnn import bnn_dynamics_model_factory
    cls = bnn_dynamics_model_factory(4, 1, list(hidden), angular_indices=(2,),
                                     non_angular_indices=(0, 1, 3))
    m = cls.init(seed=3, n_particles=P, horizon=N + 1, dtype=torch.float64,
                 device="cpu", chol_jitter=(1e-12, 1e-6))
    z0 = encode(torch.zeros(4, dtype=torch.float64),
                V=1e-2 * torch.ones(4, dtype=torch.float64), encoding=CH)
    U = torch.full((N, 1), 0.1, dtype=torch.float64)
    Z, AUX = rollout(m, z0, U, CH)
    cost = CartpoleCost(device="cpu", dtype=torch.float64)
    k, K, ok = backward(*local_model(Z, U, AUX, m, cost, CH), reg=1.0)
    assert bool(ok)
    m_dev = cls.init(seed=3, n_particles=P, horizon=N + 1, dtype=dtype,
                     device=cuda, chol_jitter=(1e-12, 1e-6))
    return m_dev, [t.to(device=cuda, dtype=dtype) for t in (Z, U, k, K)]


CH = StateEncoding.UPPER_TRIANGULAR_CHOLESKY


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("B", [1, 3])
def test_k2d_bnn_kernel_matches_plain_on_card(cuda, dtype, tol, B):
    """K2(d) against control_law with the same model, two steps, relative
    to each output's largest value."""
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    model, (Z, U, k, K) = _bnn(cuda, dtype, 2)
    if B > 1:
        Z, U, k, K = (t.expand((B,) + t.shape).contiguous()
                      for t in (Z, U, k, K))
    alphas = default_fit_alphas(dtype, cuda)
    n = fb.launches["rollout"]
    got = fb.fused_bnn_control_law(model, Z, U, k, K, alphas, CH)
    want = control_law(model, Z, U, k, K, alphas, CH, with_aux=True)
    torch.cuda.synchronize()
    assert fb.launches["rollout"] == n + 1
    for a, w in zip(got, want):
        assert bool(torch.isfinite(w).all())
        assert float((a - w).abs().max()) <= tol * float(w.abs().max())


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
