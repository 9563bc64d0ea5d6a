"""The port's belief-state BNN modules against pddp_tpu, module by module.

The same numpy-seeded float64 inputs (tests/golden/bnn_path.py: P=8
particles, hidden [16, 16], cartpole sizes) go through both packages on
the CPU: the triangular solves and the Cholesky ladder, the
moment-matched angular augmentation, the cartpole cost at the Cholesky
codec, the MLP with each dropout class, the noise inference with its
fallback, the moment match, one model step and the structured
Jacobians; and the fused line search's gate and CPU wrappers.

Tolerance 1e-12 (absolute and relative) unless stated: both packages do
the same float64 arithmetic, apart from the order of sums and each
framework's libm.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu.encoding import StateEncoding as JEnc
from pddp_tpu.encoding import encode as jencode
from pddp_tpu.examples.cartpole import CartpoleCost as JCost
from pddp_tpu.models.bnn import load_bnn_npz as j_load_bnn_npz
from pddp_tpu.models.bnn.model import _BNNState
from pddp_tpu.utils import angular as jang
from pddp_tpu.utils import linalg as jlinalg
from pddp_tpu.utils.evaluation import eval_dynamics as j_eval_dynamics
from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers.ilqr import rollout
from pddp_tpu_torch.encoding import StateEncoding, encode
from pddp_tpu_torch.examples.cartpole import CartpoleCost, CartpoleDynamicsModel
from pddp_tpu_torch.models.bnn import (BNNDynamicsModel, BNNState, CDropout,
                                       Linear, bnn_dynamics_model_factory,
                                       load_bnn_npz)
from pddp_tpu_torch.ops import fused_bnn_rollout as fb
from pddp_tpu_torch.ops.fused_rollout import (fused_control_law,
                                              supports_fused_rollout)
from pddp_tpu_torch.utils import angular as tang
from pddp_tpu_torch.utils import linalg as tlinalg
from pddp_tpu_torch.utils.evaluation import eval_dynamics
from tests.golden import bnn_path

torch.set_num_threads(1)

CH = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
TOL = dict(rtol=1e-12, atol=1e-12)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _pair(factory_kwargs=None, **init_kwargs):
    """(pddp_tpu model, port model) holding the same seeded arrays."""
    factory_kwargs = factory_kwargs or {}
    leaves, buffers = bnn_path.make_inputs()
    jm = bnn_path.jax_model(leaves, buffers, factory_kwargs=factory_kwargs,
                            **init_kwargs)
    tm = convert.bnn(leaves, buffers, bnn_path.STATE, bnn_path.ACTION,
                     bnn_path.HIDDEN, angular_indices=bnn_path.ANGULAR,
                     non_angular_indices=bnn_path.NON_ANGULAR,
                     n_particles=bnn_path.P, horizon=bnn_path.N + 1,
                     chol_jitter=bnn_path.JITTER, device="cpu",
                     dtype=torch.float64, **factory_kwargs, **init_kwargs)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


def _belief(rng, batch=()):
    """Encoded Cholesky beliefs with a well-conditioned covariance."""
    m = rng.standard_normal(batch + (4,))
    A = rng.standard_normal(batch + (4, 4))
    C = 0.05 * (A @ np.swapaxes(A, -1, -2)) + 0.01 * np.eye(4)
    return np.array(jencode(jnp.asarray(m), C=jnp.asarray(C),
                            encoding=JEnc.UPPER_TRIANGULAR_CHOLESKY))


def _upper(rng, batch, n):
    return (np.triu(rng.standard_normal(batch + (n, n)))
            + 2.0 * np.eye(n))


@pytest.mark.parametrize("n", [4, 10])
def test_triangular_solves_match_jax(n):
    """Unrolled up to SMALL_N=8, torch.linalg past it, as in pddp_tpu."""
    rng = np.random.default_rng(n)
    U = _upper(rng, (3,), n)
    D = rng.standard_normal((3, 7, n))
    np.testing.assert_allclose(
        _np(tlinalg.tria_solve_right(_t(U), _t(D))),
        _np(jlinalg.tria_solve_right(jnp.asarray(U), jnp.asarray(D))), **TOL)
    B = rng.standard_normal((3, n, 2))
    for trans in (False, True):
        np.testing.assert_allclose(
            _np(tlinalg.tria_solve(_t(U), _t(B), trans=trans)),
            _np(jlinalg.tria_solve(jnp.asarray(U), jnp.asarray(B),
                                   trans=trans)), **TOL)


def test_safe_cholesky_ladder_matches_jax():
    """The smallest finite rung wins, the diagonal fallback, and the zero
    last pivot that pddp_tpu's unrolled Crout accepts (LAPACK rejects it:
    the port's first safe_cholesky fell back to the diagonal there)."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((4, 4, 4))
    C = A @ np.swapaxes(A, -1, -2) + 1e-3 * np.eye(4)
    C[1] = -np.eye(4)                      # every rung fails: fallback
    C[2] = np.diag([1.0, 1.0, 1.0, -1e-9])  # only the 1e-6 rung factors
    want = jax.jit(jlinalg.safe_cholesky)(jnp.asarray(C))
    np.testing.assert_allclose(_np(tlinalg.safe_cholesky(_t(C))), _np(want),
                               **TOL)
    singular = np.ones((2, 2))
    got = _np(tlinalg.safe_cholesky(_t(singular), (0.0,)))
    np.testing.assert_array_equal(
        got, _np(jlinalg.safe_cholesky(jnp.asarray(singular), (0.0,))))
    np.testing.assert_array_equal(got, [[1.0, 1.0], [0.0, 0.0]])


def test_psd_clamp_matches_jax():
    rng = np.random.default_rng(3)
    Q = rng.standard_normal((2, 3, 3))
    Q = Q + np.swapaxes(Q, -1, -2)
    got = tlinalg.psd_clamp(_t(Q), extra=0.5)[0]
    want = jlinalg.psd_clamp(jnp.asarray(Q), extra=0.5)[0]
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_augment_covar_and_reduce_match_jax():
    rng = np.random.default_rng(5)
    m = rng.standard_normal((6, 4))
    A = rng.standard_normal((6, 4, 4))
    c = 0.1 * A @ np.swapaxes(A, -1, -2)
    args = ((2,), (0, 1, 3))
    wants = jax.jit(lambda m, c: jang._augment_covar(m, c, *args))(
        jnp.asarray(m), jnp.asarray(c))
    for got, want in zip(tang._augment_covar(_t(m), _t(c), *args), wants):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    x_ = tang.augment_state(_t(m), *args)
    np.testing.assert_allclose(_np(tang.reduce_state(x_, *args)),
                               _np(jang.reduce_state(jnp.asarray(_np(x_)),
                                                     *args)), **TOL)


def test_cartpole_cost_at_cholesky_codec_matches_jax():
    """The stage cost, batched over (N, A); its derivatives through eval_cost
    are held in test_torch_bnn_path.py (local_model's L_z, L_zz)."""
    rng = np.random.default_rng(6)
    z = _belief(rng, (3, 2))
    u = rng.standard_normal((3, 2, 1))
    tc = CartpoleCost(device="cpu", dtype=torch.float64)
    jc = JCost()
    enc = JEnc.UPPER_TRIANGULAR_CHOLESKY
    got = tc(_t(z), _t(u), 0, False, CH)
    want = jax.jit(lambda z, u: jc(z, u, 0, False, enc))(jnp.asarray(z),
                                                         jnp.asarray(u))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mlp_matches_jax(models):
    jm, tm = models
    x = np.random.default_rng(7).standard_normal((3, bnn_path.P, 6))
    np.testing.assert_allclose(_np(tm.net(_t(x))),
                               _np(jm.net(jnp.asarray(x))), **TOL)
    for got, drop in zip(tm.net.eval_masks(), jm.net.dropouts):
        np.testing.assert_allclose(_np(got), _np(drop.eval_mask()), **TOL)


@pytest.mark.parametrize("name", ["BDropout", "TLNDropout"])
def test_other_dropouts_match_jax(name):
    """Binary and truncated log-normal masks (CDropout: test_mlp...)."""
    from pddp_tpu.models.bnn import network as jnet
    from pddp_tpu_torch.models.bnn import network as tnet
    jnetwork = jnet.bayesian_mlp(jax.random.PRNGKey(1), 6, 8, [16, 16],
                                 n_particles=8,
                                 dropout_class=getattr(jnet, name),
                                 dtype=jnp.float64)
    leaves = [_t(a) for a in jax.tree_util.tree_leaves(jnetwork)]
    tnetwork = tnet.bayesian_mlp(6, 8, [16, 16], n_particles=8,
                                 dropout_class=getattr(tnet, name),
                                 dtype=torch.float64,
                                 device="cpu").with_leaves(leaves)
    x = np.random.default_rng(12).standard_normal((2, 8, 6))
    np.testing.assert_allclose(_np(tnetwork(_t(x))),
                               _np(jnetwork(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("i,singular", [(0, False), (2, False), (2, True)])
def test_effective_eps_matches_jax(models, i, singular):
    """Inferred noise at i > 0, the drawn noise at i == 0, and the whole
    (P, n) fallback when the factor is singular (a zero pivot)."""
    jm, tm = models
    rng = np.random.default_rng(8 + i)
    z = _belief(rng)
    if singular:
        z[4 + 4 + 3] = 0.0        # U[1, 1] of the flattened factor
    prev = rng.standard_normal((bnn_path.P, 4))
    j_eps = jax.jit(lambda z, prev: jm._effective_eps(
        z, i, _BNNState(prev_output=prev),
        JEnc.UPPER_TRIANGULAR_CHOLESKY)[0])(jnp.asarray(z),
                                            jnp.asarray(prev))
    t_eps = tm._effective_eps(_t(z), i, BNNState(prev_output=_t(prev)),
                              CH)[0]
    np.testing.assert_allclose(_np(t_eps), _np(j_eps), **TOL)
    fell_back = np.array_equal(_np(t_eps), _np(tm.eps_in[i]))
    assert fell_back == (i == 0 or singular)


def test_step_moment_match_and_jacobians_match_jax(models):
    """Two steps from the bench's start (the second infers its noise),
    the moment match alone, and the structured Jacobians with the
    recorded aux, against eval_dynamics of pddp_tpu."""
    jm, tm = models
    enc = JEnc.UPPER_TRIANGULAR_CHOLESKY
    m0, v0, _ = bnn_path.problem()
    z = jencode(jnp.asarray(m0), V=jnp.asarray(v0), encoding=enc)
    zt = _t(z)
    js, ts = jm.init_state(), tm.init_state()
    j_step = jax.jit(lambda z, u, st, i: jm.step(z, u, i, st, enc))
    for i, u in enumerate((0.3, -0.2)):
        uj, ut = jnp.asarray([u]), _t([u])
        z, js, j_aux = j_step(z, uj, js, i)
        zt, ts, t_aux = tm.step(zt, ut, i, ts, CH)
        np.testing.assert_allclose(_np(zt), _np(z), **TOL)
        np.testing.assert_allclose(_np(t_aux), _np(j_aux), **TOL)
        np.testing.assert_allclose(_np(ts.prev_output), _np(js.prev_output),
                                   **TOL)
    out = np.random.default_rng(9).standard_normal((bnn_path.P, 4))
    want = jax.jit(lambda o: jm._moment_match(o, enc, jnp.float64))(
        jnp.asarray(out))
    np.testing.assert_allclose(_np(tm._moment_match(_t(out), CH)),
                               _np(want), **TOL)

    u = jnp.asarray([0.1])
    want = jax.jit(lambda z, u, a: j_eval_dynamics(
        jm, z, u, 2, encoding=enc, aux=a))(z, u, j_aux)
    got = eval_dynamics(tm, zt, _t(u), 2, encoding=CH, aux=t_aux)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_fused_gate_and_cpu_wrappers(models):
    """pddp_tpu's gate: the stateful BNN runs in K2 only with
    allow_stateful, under any codec; on CPU tensors K2(d) and F1-F3 run
    their plain versions, and launch nothing."""
    _, tm = models
    tc = CartpoleCost(device="cpu", dtype=torch.float64)
    assert not supports_fused_rollout(tm, tc, CH)
    assert supports_fused_rollout(tm, tc, CH, allow_stateful=True)
    assert supports_fused_rollout(
        tm, tc, StateEncoding.VARIANCE_ONLY, allow_stateful=True)
    assert not supports_fused_rollout(
        tm, tc, StateEncoding.VARIANCE_ONLY)
    assert supports_fused_rollout(
        CartpoleDynamicsModel(device="cpu"), CartpoleCost(device="cpu"),
        StateEncoding.IGNORE_UNCERTAINTY)
    assert isinstance(tm, BNNDynamicsModel)

    rng = np.random.default_rng(11)
    m0, v0, U = bnn_path.problem()
    z0 = encode(_t(m0), V=_t(v0), encoding=CH)
    Z, _ = rollout(tm, z0, _t(U), CH)
    k = _t(0.1 * rng.standard_normal((bnn_path.N, 1)))
    K = _t(0.1 * rng.standard_normal((bnn_path.N, 1, 14)))
    alphas = _t([1.0, 0.5])
    before = dict(fb.launches)
    Z_b, U_b, J_b, AUX_b = fused_control_law(tm, Z, _t(U), k, K, alphas, CH,
                                             cost=tc, with_aux=True)
    from pddp_tpu_torch.controllers.ilqr import control_law
    want = control_law(tm, Z, _t(U), k, K, alphas, CH, cost=tc,
                       with_aux=True)
    for g, w in zip((Z_b, U_b, J_b, AUX_b), want):
        np.testing.assert_array_equal(_np(g), _np(w))
    Uc = _t(_upper(rng, (2,), 4))
    D = _t(rng.standard_normal((2, bnn_path.P, 4)))
    eps = fb.infer_eps(Uc, D, tm.eps_in[1], False)
    assert tuple(eps.shape) == (2, bnn_path.P, 4)
    z, Ud = fb.moment_match(D, bnn_path.JITTER)
    np.testing.assert_array_equal(_np(z), _np(tm._moment_match(D, CH)))
    assert tuple(Ud.shape) == (2, 4, 4)
    x = _t(rng.standard_normal((2, bnn_path.P, 6)))
    np.testing.assert_array_equal(_np(fb.mlp(tm.net, x)), _np(tm.net(x)))
    assert fb.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packed_parameters_start_on_16_bytes(dtype):
    """K2(d) and F3 stage each weight with a bulk copy, which needs every
    part of the packed parameter buffer (and its length) on a 16-byte
    boundary; the kernel checks the buffer's own address. A net of odd
    widths with masks on both hidden layers, and the action bounds."""
    from pddp_tpu_torch.models.bnn import bnn_dynamics_model_factory
    cls = bnn_dynamics_model_factory(3, 1, [7, 5], angular_indices=(1,),
                                     non_angular_indices=(0, 2),
                                     constrain_min=-1.0, constrain_max=1.0)
    model = cls.init(seed=2, n_particles=13, horizon=3, dtype=dtype,
                     device="cpu", chol_jitter=(1e-12, 1e-6, 1e-3))
    assert fb.supports(model, StateEncoding.UPPER_TRIANGULAR_CHOLESKY)
    pk = fb._pack(model, dtype, "cpu",
                  StateEncoding.UPPER_TRIANGULAR_CHOLESKY)
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert pk.cfg["constrained"] == 1 and min(pk.cfg["m_off"]) >= 0
    assert all(s * itemsize % 16 == 0 for s in pk.starts)
    assert pk.size * itemsize % 16 == 0
    offsets = (pk.cfg["w_off"] + pk.cfg["b_off"] + pk.cfg["m_off"]
               + [pk.cfg[k] for k in ("x_mean_off", "x_std_off",
                                      "dx_mean_off", "dx_std_off",
                                      "u_min_off", "u_max_off",
                                      "jitter_off")])
    assert sorted(o for o in offsets if o >= 0) == sorted(pk.starts)
    buf, cfg = pk.done()
    assert buf.numel() == pk.size and len(cfg) == sum(
        c for _, c in fb._CONFIG_FIELDS)
