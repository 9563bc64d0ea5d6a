"""Modules of the port's main path against pddp_tpu, module by module.

Angular augmentation, the closed-form QR-cost derivatives, the cost
algebra, the Jacobi eigensolver, the cartpole model with its Jacobians
through ``eval_dynamics``, and ``local_model`` over a short horizon: the
same numpy-seeded inputs go through both packages in float64 on the CPU.
Tolerance 1e-12 unless stated: the closed forms are the same, only the
order of sums and the libm of each framework differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu.controllers import ilqr as jilqr
from pddp_tpu.costs.quadratic import \
    augmented_qr_derivatives as j_aug_qr
from pddp_tpu.encoding import StateEncoding as JEnc
from pddp_tpu.examples.cartpole import CartpoleCost as JCost
from pddp_tpu.examples.cartpole import CartpoleDynamicsModel as JModel
from pddp_tpu.utils import angular as jang
from pddp_tpu.utils.evaluation import eval_dynamics as j_eval_dynamics
from pddp_tpu.utils.linalg import small_eigh as j_small_eigh
from pddp_tpu_torch.controllers import ilqr as tilqr
from pddp_tpu_torch.costs import AggregateCost, QRCost
from pddp_tpu_torch.costs.quadratic import \
    augmented_qr_derivatives as t_aug_qr
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.cartpole import CartpoleCost, CartpoleDynamicsModel
from pddp_tpu_torch.utils import angular as tang
from pddp_tpu_torch.utils.constraint import clamp, constrain
from pddp_tpu_torch.utils.evaluation import eval_cost, eval_dynamics
from pddp_tpu_torch.utils.linalg import small_eigh

torch.set_num_threads(1)

IGN = StateEncoding.IGNORE_UNCERTAINTY
TOL = dict(rtol=1e-12, atol=1e-12)
F64 = dict(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(kw or TOL))


def test_augment_state_matches_jax():
    x = np.random.default_rng(0).standard_normal((5, 4))
    args = ((2,), (0, 1, 3))
    _close(tang.augment_state(_t(x), *args),
           jang.augment_state(jnp.asarray(x), *args))
    _close(tang.augment_encoded_state(_t(x), *args, IGN, 4),
           jang.augment_encoded_state(jnp.asarray(x), *args, JEnc(4), 4))
    assert tang.infer_augmented_state_size(*args) == 5


def test_belief_augmentation_not_ported_yet():
    """Ported since: the variance codec's moment-matched augmentation
    matches pddp_tpu (the Cholesky codec is held in test_torch_bnn.py)."""
    rng = np.random.default_rng(4)
    z = np.concatenate([rng.standard_normal((3, 4)),
                        0.1 + rng.random((3, 4))], axis=-1)
    got = tang.augment_encoded_state(_t(z), (2,), (0, 1, 3),
                                     StateEncoding.VARIANCE_ONLY, 4)
    want = jang.augment_encoded_state(jnp.asarray(z), (2,), (0, 1, 3),
                                      JEnc.VARIANCE_ONLY, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("terminal", [False, True])
def test_augmented_qr_derivatives_match_jax(terminal):
    rng = np.random.default_rng(1)
    Q = rng.standard_normal((5, 5))
    R = np.abs(rng.standard_normal((1, 1)))
    x_goal = rng.standard_normal(5)
    x = rng.standard_normal((6, 4))
    u = rng.standard_normal((6, 1))
    ai, nai = (2,), (0, 1, 3)
    got = t_aug_qr(_t(Q), _t(R), _t(x_goal), _t(0.0), _t(x), _t(u),
                   terminal, ai, nai)
    want = j_aug_qr(jnp.asarray(Q), jnp.asarray(R), jnp.asarray(x_goal),
                    jnp.asarray(0.0), jnp.asarray(x), jnp.asarray(u),
                    terminal, ai, nai)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w)


def test_cost_call_and_algebra():
    rng = np.random.default_rng(2)
    z = rng.standard_normal((3, 4))
    u = rng.standard_normal((3, 1))
    jc, tc = JCost(), CartpoleCost(**F64)
    for terminal in (False, True):
        uu = None if terminal else u
        want = jc(jnp.asarray(z), None if terminal else jnp.asarray(u), 0,
                  terminal, JEnc(4))
        _close(tc(_t(z), None if uu is None else _t(uu), 0, terminal, IGN),
               want)
    agg = 2.0 * tc + tc - 1.0
    assert isinstance(agg, AggregateCost)
    _close(agg(_t(z), _t(u), 0, False, IGN),
           3.0 * tc(_t(z), _t(u), 0, False, IGN).numpy() - 1.0)
    # A plain QRCost takes the closed form; a subclass that changes
    # __call__ without declaring it does not.
    q = QRCost(np.eye(4), np.eye(1), **F64)
    assert q.eval_derivatives(_t(z), _t(u), 0, encoding=IGN) is not None

    class Custom(QRCost):
        def __call__(self, z, u, i, terminal=False, encoding=IGN, **kw):
            return 2.0 * super().__call__(z, u, i, terminal, encoding)

    c = Custom(np.eye(4), np.eye(1), **F64)
    assert c.eval_derivatives(_t(z), _t(u), 0, encoding=IGN) is None
    # eval_cost then differentiates __call__ by autodiff.
    l, l_z, l_u, l_zz, l_uz, l_uu = eval_cost(c, _t(z[0]), _t(u[0]), 0,
                                              encoding=IGN)
    _close(l_zz, 4.0 * np.eye(4))
    _close(l_uu, 4.0 * np.eye(1))


def test_small_eigh_matches_jax():
    """Same rotation sequence: eigenpairs agree to rounding (1e-10)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((5, 4, 4))
    A = A + np.swapaxes(A, -1, -2)
    e_t, E_t = small_eigh(_t(A), sort=False)
    e_j, E_j = j_small_eigh(jnp.asarray(A), sort=False)
    _close(e_t, e_j, rtol=1e-10, atol=1e-10)
    _close(E_t, E_j, rtol=1e-10, atol=1e-10)
    e_s, _ = small_eigh(_t(A))
    _close(e_s, np.linalg.eigvalsh(A), rtol=1e-10, atol=1e-10)


def test_clamp_and_constrain():
    u = torch.tensor([-3.0, 0.2, 5.0, float("nan")], dtype=torch.float64)
    lo, hi = torch.tensor(-1.0, dtype=u.dtype), torch.tensor(2.0,
                                                              dtype=u.dtype)
    out = clamp(u, lo, hi)
    _close(out[:3], [-1.0, 0.2, 2.0])
    assert torch.isnan(out[3])
    c = constrain(torch.tensor([0.0, 50.0], dtype=u.dtype), lo, hi)
    _close(c, [0.5, 2.0])


def test_cartpole_model_and_jacobians_match_jax():
    rng = np.random.default_rng(4)
    jm = JModel(dt=0.05)
    tm = CartpoleDynamicsModel(dt=0.05, **F64)
    for _ in range(3):
        z = rng.standard_normal(4)
        u = rng.standard_normal(1)
        want = j_eval_dynamics(jm, jnp.asarray(z), jnp.asarray(u), 0,
                               encoding=JEnc(4))
        got = eval_dynamics(tm, _t(z), _t(u), 0, encoding=IGN)
        for g, w in zip(got, want):
            _close(g, w)
        _close(tm(_t(z), _t(u), 0, IGN),
               jm(jnp.asarray(z), jnp.asarray(u), 0, JEnc(4)))


@pytest.mark.parametrize("approximate", [False, True])
def test_local_model_matches_jax(approximate):
    """Closed-form cost derivatives, or with ``approximate_hessians`` the
    Gauss-Newton outer products by autodiff, and vmapped Jacobians."""
    N = 20
    rng = np.random.default_rng(5)
    jm, jc = JModel(dt=0.05), JCost()
    tm, tc = CartpoleDynamicsModel(dt=0.05, **F64), CartpoleCost(**F64)
    z0 = np.array([0.0, 0.0, 0.1, 0.0])
    U = 0.3 * rng.standard_normal((N, 1))
    Zj, AUXj = jilqr.rollout(jm, jnp.asarray(z0), jnp.asarray(U), JEnc(4))
    Zt, AUXt = tilqr.rollout(tm, _t(z0), _t(U), IGN)
    _close(Zt, Zj)
    want = jilqr.local_model(Zj, jnp.asarray(U), AUXj, jm, jc, JEnc(4),
                             approximate_hessians=approximate)
    got = tilqr.local_model(Zt, _t(U), AUXt, tm, tc, IGN,
                            approximate_hessians=approximate)
    for g, w in zip(got, want):
        _close(g, w)
