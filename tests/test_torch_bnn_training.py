"""The port's BNN training against pddp_tpu: the likelihood, each dropout
class's training forward and regularizer, the trainable leaves,
``resample`` on JAX's draws, ``fit_bnn`` (a few AMSGrad steps on JAX's
batch indices and noise, with and without padding), ``save_bnn_npz``
files read by both packages, the problem registry and the trajectory
utilities.

The same numpy-seeded float64 inputs go through both packages on the
CPU. Tolerance 1e-12 (absolute and relative) unless stated: the same
arithmetic apart from the order of sums and each framework's libm;
``fit_bnn`` 1e-10, over five optimizer steps of autodiff gradients.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu.examples import problems as jproblems
from pddp_tpu.gaussian_variable import GaussianVariable as JGV
from pddp_tpu.models.bnn import bnn_dynamics_model_factory as j_factory
from pddp_tpu.models.bnn import fit_bnn as j_fit_bnn
from pddp_tpu.models.bnn import load_bnn_npz as j_load_bnn_npz
from pddp_tpu.models.bnn import losses as jlosses
from pddp_tpu.models.bnn import network as jnet
from pddp_tpu.utils import trajectory as jtraj
from pddp_tpu_torch import convert
from pddp_tpu_torch.examples.pendulum import PendulumDynamicsModel
from pddp_tpu_torch.examples.problems import SampleProblems
from pddp_tpu_torch.gaussian_variable import GaussianVariable
from pddp_tpu_torch.models.bnn import (BDropout, CDropout, TLNDropout,
                                       bnn_dynamics_model_factory, fit_bnn,
                                       gaussian_log_likelihood, load_bnn_npz,
                                       save_bnn_npz, trainable_mask)
from pddp_tpu_torch.models.bnn import network as tnet
from pddp_tpu_torch.utils import trajectory as ttraj
from tests.golden import pddp_trace

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
FIT_TOL = dict(rtol=1e-10, atol=1e-10)
F64 = dict(device="cpu", dtype=torch.float64)
TRAINED = os.path.join(os.path.dirname(__file__), "golden",
                       "trained_bnn_cartpole.npz")
DROPOUTS = {"B": (jnet.BDropout, BDropout), "C": (jnet.CDropout, CDropout),
            "TLN": (jnet.TLNDropout, TLNDropout)}


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _nets(kind, in_f=5, out_f=4, hidden=(16, 16), P=4):
    """(pddp_tpu net, port net) holding the same JAX-initialized arrays."""
    jn = jnet.bayesian_mlp(jax.random.PRNGKey(3), in_f, out_f, list(hidden),
                           n_particles=P, dropout_class=DROPOUTS[kind][0],
                           dtype=jnp.float64)
    tn = tnet.bayesian_mlp(in_f, out_f, list(hidden), n_particles=P,
                           dropout_class=DROPOUTS[kind][1], **F64)
    return jn, tn.with_leaves(
        [_t(a) for a in jax.tree_util.tree_leaves(jn)])


def _training_noise(jn, key, batch):
    """The fresh noise pddp_tpu's training forward draws from key, per
    hidden layer (BayesianMLP.__call__ and each class's apply)."""
    keys = jax.random.split(key, len(jn.dropouts))
    out = []
    for layer, d, k in zip(jn.layers, jn.dropouts, keys):
        shape = (batch, layer.W.shape[1])
        if isinstance(d, jnet.BDropout):
            out.append(np.asarray(jax.random.bernoulli(k, d.p, shape),
                                  np.float64))
        else:
            out.append(np.asarray(jax.random.uniform(
                k, shape, jnp.float64, 1e-5, 1.0 - 1e-5)))
    return out


@pytest.mark.parametrize("with_stds", [False, True])
def test_gaussian_log_likelihood_matches_jax(with_stds):
    rng = np.random.default_rng(0)
    y, m = rng.standard_normal((2, 6, 3))
    s = 0.5 + rng.random((6, 3)) if with_stds else None
    got = gaussian_log_likelihood(_t(y), _t(m),
                                  None if s is None else _t(s))
    want = jlosses.gaussian_log_likelihood(
        jnp.asarray(y), jnp.asarray(m), None if s is None else jnp.asarray(s))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("kind", ["B", "C", "TLN"])
def test_training_forward_and_regularization_match_jax(kind):
    """The forward on JAX's fresh noise, the eval-mode forward on the
    episode masks, and the regularizer (their gradients meet JAX's in
    test_fit_bnn_matches_jax)."""
    jn, tn = _nets(kind)
    x = np.random.default_rng(1).standard_normal((7, 5))
    xp = x[:4]   # eval mode: one row per particle's episode mask
    key = jax.random.PRNGKey(11)
    j_out, j_reg, j_eval = jax.jit(lambda net: (
        net(jnp.asarray(x), key=key), net.regularization(),
        net(jnp.asarray(xp))))(jn)
    np.testing.assert_allclose(
        _np(tn(_t(x), noise=_training_noise(jn, key, 7))), _np(j_out),
        **TOL)
    np.testing.assert_allclose(float(tn.regularization()), float(j_reg),
                               **TOL)
    np.testing.assert_allclose(_np(tn(_t(xp))), _np(j_eval), **TOL)


@pytest.mark.parametrize("kind", ["B", "C", "TLN"])
def test_trainable_mask_and_resample_match_jax(kind):
    jn, tn = _nets(kind)
    assert trainable_mask(tn) == jax.tree_util.tree_leaves(
        jnet.trainable_mask(jn))
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, len(jn.dropouts))
    want = jn.resample(key)
    noise = [np.asarray(d.resample(k).noise) for d, k in
             zip(jn.dropouts, keys)]
    got = tn.resample(noise=noise)
    for a, b in zip(got.leaves(), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(_np(a), _np(b))
    # From a generator: the same draws from the same seed, masks of the
    # stored shape, B's a 0/1 mask, the others inside (0, 1).
    g1 = tn.resample(torch.Generator().manual_seed(0))
    g2 = tn.resample(torch.Generator().manual_seed(0))
    for d1, d2, d0 in zip(g1.dropouts, g2.dropouts, tn.dropouts):
        assert torch.equal(d1.noise, d2.noise)
        assert d1.noise.shape == d0.noise.shape
        assert not torch.equal(d1.noise, d0.noise)
        if kind == "B":
            assert set(d1.noise.unique().tolist()) <= {0.0, 1.0}
        else:
            assert float(d1.noise.min()) > 0 and float(d1.noise.max()) < 1


@functools.lru_cache(maxsize=None)
def _bnn_pair(particles=False, hidden=(16, 16), P=4, horizon=3):
    """(pddp_tpu model, port model): cartpole sizes, constrained actions,
    the JAX factory's arrays carried across by convert.bnn."""
    kw = dict(angular_indices=(2,), non_angular_indices=(0, 1, 3),
              constrain_min=[-3.0], constrain_max=[3.0])
    jm = j_factory(4, 1, list(hidden), particles=particles, **kw).init(
        jax.random.PRNGKey(0), n_particles=P, horizon=horizon,
        dtype=jnp.float64)
    buffers = {k: np.asarray(getattr(jm, k)) for k in convert.BNN_BUFFERS
               if not (particles and k == "eps_in")}
    tm = convert.bnn([np.asarray(a) for a in
                      jax.tree_util.tree_leaves(jm.net)], buffers, 4, 1,
                     list(hidden), particles=particles, n_particles=P,
                     horizon=horizon, **kw, **F64)
    return jm, tm


@pytest.mark.parametrize("particles", [False, True])
def test_model_resample_on_jax_draws_matches_jax(particles):
    jm, tm = _bnn_pair(particles)
    key = jax.random.PRNGKey(9)
    want = jm.resample(key)
    # The particles model splits its key into eps_out's and the net's;
    # the belief model splits k1 so, and draws eps_in from k2.
    k1, k2 = jax.random.split(key)
    ka, kb = (k1, k2) if particles else jax.random.split(k1)
    noise = {"eps_out": np.asarray(jax.random.normal(
        ka, jm.eps_out.shape, jnp.float64)),
        "net": [np.asarray(d.noise) for d in jm.net.resample(kb).dropouts]}
    if not particles:
        noise["eps_in"] = np.asarray(jax.random.normal(
            k2, jm.eps_in.shape, jnp.float64))
        assert {k: [np.asarray(a) for a in v] if isinstance(v, list) else v
                for k, v in pddp_trace.resample_draws(key, jm).items()
                }.keys() == noise.keys()
    got = tm.resample(noise=noise)
    for name in ("eps_out",) + (() if particles else ("eps_in",)):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(getattr(want, name)), **TOL)
    for a, b in zip(got.net.leaves(), jax.tree_util.tree_leaves(want.net)):
        np.testing.assert_array_equal(_np(a), _np(b))
    fresh = tm.resample(torch.Generator().manual_seed(1))
    eps = fresh.eps_out
    np.testing.assert_allclose(_np(eps.mean(dim=1)), 0.0, atol=1e-12)
    np.testing.assert_allclose(_np(eps.std(dim=1)), 1.0, rtol=1e-12)


def _data(rng, n):
    X = rng.standard_normal((n, 4)) * [1.0, 2.0, 3.0, 4.0]
    U = 4.0 * rng.standard_normal((n, 1))
    dX = 0.1 * rng.standard_normal((n, 4)) + 0.05 * X
    return X, U, dX


@pytest.mark.parametrize("n_valid", [None, 40])
def test_fit_bnn_matches_jax(n_valid):
    """Five AMSGrad steps, batch 8, on 64 rows (the last 24 padding with
    n_valid): JAX's batch indices and noise from its key, the losses,
    every leaf of the net and the normalizers within 1e-10."""
    jm, tm = _bnn_pair()
    X, U, dX = _data(np.random.default_rng(4), 64)
    if n_valid is not None:
        for a in (X, U, dX):
            a[n_valid:] = 0.0
    key = jax.random.PRNGKey(21)
    opts = dict(n_iter=5, batch_size=8, learning_rate=1e-2,
                return_losses=True, n_valid=n_valid)
    jm2, jl = j_fit_bnn(jm, jnp.asarray(X), jnp.asarray(U), jnp.asarray(dX),
                        key, **opts)
    d = pddp_trace.fit_draws(key, 5, 8, 64 if n_valid is None else n_valid,
                             [16, 16], jnp.float64)
    tm2, tl = fit_bnn(tm, _t(X), _t(U), _t(dX), **d, **opts)
    np.testing.assert_allclose(_np(tl), _np(jl), **FIT_TOL)
    moved = 0
    for a, b, c, m in zip(tm2.net.leaves(),
                          jax.tree_util.tree_leaves(jm2.net),
                          tm.net.leaves(), trainable_mask(tm.net)):
        np.testing.assert_allclose(_np(a), _np(b), **FIT_TOL)
        assert not a.requires_grad
        if not m:
            assert torch.equal(a, c)
        moved += int(m and not torch.equal(a, c))
    assert moved == 8
    for k in ("X_mean", "X_std", "dX_mean", "dX_std"):
        np.testing.assert_allclose(_np(getattr(tm2, k)),
                                   _np(getattr(jm2, k)), **TOL)


def test_fit_from_a_generator_is_reproducible():
    _, tm = _bnn_pair()
    X, U, dX = (_t(a) for a in _data(np.random.default_rng(5), 32))
    runs = [tm.fit(X, U, dX, generator=torch.Generator().manual_seed(3),
                   n_iter=3, batch_size=4, return_losses=True)
            for _ in range(2)]
    torch.testing.assert_close(runs[0][1], runs[1][1], rtol=0, atol=0)
    assert bool(torch.isfinite(runs[0][1]).all())
    for a, b in zip(runs[0][0].net.leaves(), runs[1][0].net.leaves()):
        assert torch.equal(a, b)
    # Without a generator, the draws must be explicit.
    with pytest.raises(ValueError):
        tm.fit(X, U, dX, n_iter=1, batch_size=4)
    # convert.bnn's requires_grad marks exactly the trainable leaves.
    _, tg = _bnn_pair()
    leaves = [np.asarray(t) for t in tg.net.leaves()]
    buffers = {k: _np(getattr(tg, k)) for k in convert.BNN_BUFFERS}
    m = convert.bnn(leaves, buffers, 4, 1, [16, 16], angular_indices=(2,),
                    non_angular_indices=(0, 1, 3), n_particles=4, horizon=3,
                    requires_grad=True, **F64)
    assert [t.requires_grad for t in m.net.leaves()] == \
        trainable_mask(m.net)


def test_save_bnn_npz_round_trips_and_loads_in_jax(tmp_path):
    """The trained fixture loads, saves and reloads bit-identically, with
    its meta; a file the port writes loads in pddp_tpu's load_bnn_npz."""
    cls = bnn_dynamics_model_factory(4, 1, [200, 200], angular_indices=(2,),
                                     non_angular_indices=(0, 1, 3))
    model = load_bnn_npz(cls.init(n_particles=100, horizon=2, device="cpu"),
                         TRAINED)
    src = np.load(TRAINED)
    meta = json.loads(bytes(src["meta_json"]).decode())
    path = str(tmp_path / "port.npz")
    save_bnn_npz(model, path, meta)
    out = np.load(path)
    assert sorted(out.files) == sorted(src.files)
    for k in src.files:
        assert out[k].dtype == src[k].dtype
        np.testing.assert_array_equal(out[k], src[k])
    again = load_bnn_npz(model, path)
    for a, b in zip(again.net.leaves(), model.net.leaves()):
        assert torch.equal(a, b)
    _, tm = _bnn_pair()
    tm = tm.resample(torch.Generator().manual_seed(2))
    save_bnn_npz(tm, str(tmp_path / "small.npz"))
    jm, _ = _bnn_pair()
    jl = j_load_bnn_npz(jm, str(tmp_path / "small.npz"))
    for a, b in zip(jax.tree_util.tree_leaves(jl.net), tm.net.leaves()):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    np.testing.assert_array_equal(np.asarray(jl.dX_std), _np(tm.dX_std))


def test_reset_parameters():
    _, tm = _bnn_pair()
    g = torch.Generator().manual_seed(0)
    fresh = tm.reset_parameters(g)
    for a, b, m in zip(fresh.net.leaves(), tm.net.leaves(),
                       trainable_mask(tm.net)):
        assert a.shape == b.shape
        if a.dim() == 2 and a.shape[0] != 4:   # weights and masks
            assert not torch.equal(a, b)
    W = fresh.net.layers[1].W
    assert abs(float(W.std()) - np.sqrt(2.0) * np.sqrt(2.0 / 32)) < 0.05
    assert not torch.equal(fresh.eps_in, tm.eps_in)
    analytic = PendulumDynamicsModel(**F64)
    assert analytic.fit(None, None, None) is analytic
    assert analytic.resample(g) is analytic
    assert analytic.reset_parameters(g) is analytic


@pytest.mark.parametrize("problem", list(SampleProblems))
def test_sample_problems_setup_matches_jax(problem):
    """The registry's classes are pddp_tpu's counterparts, the model's
    parameters and the cost's are pddp_tpu's defaults at this dt, and the
    env simulates a model of its own built alike."""
    env, cost, model = problem.setup(0.05, seed=0, **F64)
    jp = jproblems.SampleProblems[problem.name]
    for ours, theirs in ((env, jp.get_env_class()),
                         (cost, jp.get_cost_class()),
                         (model, jp.get_model_class())):
        assert type(ours).__name__ == theirs.__name__
    assert type(env) is problem.get_env_class()
    jmodel, jcost = jp.get_model_class()(dt=0.05), jp.get_cost_class()()
    for name, v in vars(model).items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_allclose(_np(v),
                                       np.asarray(getattr(jmodel, name)),
                                       **TOL)
            assert torch.equal(getattr(env.model, name), v)
    for name in convert.COST_FIELDS:
        np.testing.assert_allclose(_np(getattr(cost, name)),
                                   np.asarray(getattr(jcost, name)), **TOL)
    assert env.model is not model and env.dt == 0.05
    assert env.get_state().mean().dtype == torch.float64


def test_trajectory_utilities_match_jax():
    rng = np.random.default_rng(6)
    means, vars_ = rng.standard_normal((5, 3)), 0.1 + rng.random((5, 3))
    ours = [GaussianVariable(_t(m), _var=_t(v)) for m, v in zip(means,
                                                                 vars_)]
    theirs = [JGV(jnp.asarray(m), _var=jnp.asarray(v))
              for m, v in zip(means, vars_)]
    np.testing.assert_array_equal(_np(ttraj.mean_trajectory(ours)),
                                  _np(jtraj.mean_trajectory(theirs)))
    U = rng.standard_normal((4, 2))
    for a, b in zip(ttraj.trajectory_to_training_data(_t(means), _t(U)),
                    jtraj.trajectory_to_training_data(jnp.asarray(means),
                                                      jnp.asarray(U))):
        np.testing.assert_array_equal(_np(a), _np(b))
    # One draw per variable, in order, from the generator.
    got = ttraj.sample_trajectory(ours, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    want = torch.stack([x.sample(g) for x in ours])
    assert torch.equal(got, want) and got.shape == (5, 3)
    assert jtraj.sample_trajectory(theirs, jax.random.PRNGKey(0)).shape == \
        (5, 3)
