"""The port's ``fused_control_law`` over the rest of ``pddp_tpu``'s
fused-rollout gate, against ``pddp_tpu``'s stored results, in float64 on
the CPU.

``tests/golden/stateful_rollouts.npz`` (written by ``JAX_PLATFORMS=cpu
python -m tests.golden.stateful_rollouts``; this file reads only it)
holds ``pddp_tpu``'s ``fused_control_law(..., interpret=True,
with_aux=True)`` with a cost, and its inputs, for: the particle model over
the cartpole under all five codecs, over the rendezvous and over the
constrained cartpole under the Cholesky codec (K2(e)); the BNN under
VARIANCE_ONLY, STANDARD_DEVIATION_ONLY, FULL_COVARIANCE_MATRIX and
IGNORE_UNCERTAINTY (K2(d)); ``constrain_model`` of the cartpole and the
double cartpole under IGNORE_UNCERTAINTY and of the pendulum under the
Cholesky codec (K2(a)-(c)). Where ``pddp_tpu``'s interpret mode cannot take
a case (the ``constrain_model`` ones) the npz holds its scan
``control_law``. On CPU tensors the port runs its plain version, so these
hold the wrapper's domain, layout and post-pass cost, and launch nothing.
The particle model over a bare subclass of the cartpole (K2(e) over a
traced inner step) is held against the stored particle cartpole, the
same arithmetic.

Tolerances: ``pddp_tpu``'s own for the kernel against the scan
(``tests/ops/test_fused_rollout.py``), Z, U and AUX 1e-10, J 1e-8
(relative and absolute).
"""

import copy

import numpy as np
import pytest
import torch

from pddp_tpu_torch import convert
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples import (cartpole, double_cartpole, pendulum,
                                     rendezvous)
from pddp_tpu_torch.ops import fused_bnn_rollout as fb
from pddp_tpu_torch.ops import fused_particle_rollout as fpr
from pddp_tpu_torch.ops import fused_rollout as fr
from pddp_tpu_torch.utils.constraint import constrain_model
from pddp_tpu_torch.utils.particles import ParticleDynamicsModel
from tests.golden import bnn_path
from tests.golden import stateful_rollouts as g

torch.set_num_threads(1)

F64 = torch.float64
TOL = {"rtol": 1e-10, "atol": 1e-10}
J_TOL = {"rtol": 1e-8, "atol": 1e-8}
EXAMPLES = {"cartpole": cartpole, "pendulum": pendulum,
            "double_cartpole": double_cartpole, "rendezvous": rendezvous}
#: the stage each kind of case takes.
STAGES = {"particle": "e", "particle_constrained": "e", "bnn": "d",
          "constrained": {"cartpole": "a", "double_cartpole": "b",
                          "pendulum": "c"}}


@pytest.fixture(scope="module")
def data():
    with np.load(g.PATH) as npz:
        return dict(npz)


def _classes(ex):
    mod = EXAMPLES[ex]
    stem = "".join(w.capitalize() for w in ex.split("_"))
    return getattr(mod, stem + "DynamicsModel"), getattr(mod, stem + "Cost")


def _case(data, case):
    """(model, cost, inputs, encoding, bounds, stage) of ``case``, built
    from the npz alone."""
    kind, ex, codec, bounded = g.CASES[case]
    model_cls, cost_cls = _classes(ex)
    if kind == "bnn":
        n_leaves = sum(1 for k in data if k.startswith(case + "_leaf"))
        leaves = [data["{}_leaf{}".format(case, i)] for i in range(n_leaves)]
        buffers = {k: data["{}_{}".format(case, k)] for k in convert.BNN_BUFFERS}
        model = convert.bnn(leaves, buffers, bnn_path.STATE, bnn_path.ACTION,
                            g.BNN_HIDDEN, angular_indices=bnn_path.ANGULAR,
                            non_angular_indices=bnn_path.NON_ANGULAR,
                            n_particles=g.P, horizon=g.N + 1,
                            chol_jitter=bnn_path.JITTER, device="cpu",
                            dtype=F64)
    else:
        if kind != "particle":
            model_cls = constrain_model(-g.U_MAX, g.U_MAX)(model_cls)
        names = EXAMPLES[ex].model.PARAM_NAMES
        model = model_cls(*(data["{}_param_{}".format(case, n)]
                            for n in names), device="cpu", dtype=F64)
        if kind.startswith("particle"):
            model = convert.particle_model(model, data[case + "_eps"])
    stage = STAGES[kind]
    stage = stage[ex] if isinstance(stage, dict) else stage
    ins = tuple(torch.as_tensor(data["{}_{}".format(case, k)])
                for k in ("Z", "U", "k", "K"))
    bounds = ((torch.tensor(g.U_LO, dtype=F64), torch.tensor(g.U_HI,
                                                             dtype=F64))
              if bounded else (None, None))
    return (model, cost_cls(device="cpu", dtype=F64), ins,
            StateEncoding[codec], bounds, stage)


def _launches():
    return (dict(fr.launches), dict(fb.launches), dict(fpr.launches))


@pytest.mark.parametrize("case", list(g.CASES))
def test_fused_control_law_matches_pddp_tpu(data, case):
    model, cost, ins, enc, (lo, hi), _ = _case(data, case)
    alphas = torch.as_tensor(data["alphas"])
    before = _launches()
    Z, U, J, AUX = fr.fused_control_law(model, *ins, alphas, enc, cost=cost,
                                        u_min=lo, u_max=hi, with_aux=True)
    assert _launches() == before  # CPU tensors: the plain version
    np.testing.assert_allclose(Z.numpy(), data[case + "_Z_out"], **TOL)
    np.testing.assert_allclose(U.numpy(), data[case + "_U_out"], **TOL)
    np.testing.assert_allclose(J.numpy(), data[case + "_J_out"], **J_TOL)
    want_aux = data[case + "_AUX_out"]
    if want_aux.size == 0:
        assert AUX == ()
    else:
        np.testing.assert_allclose(AUX.numpy(), want_aux, **TOL)


@pytest.mark.parametrize("case", list(g.CASES))
def test_gate_admits_the_case(data, case):
    """Cases (i)-(iii): the constrained examples in stages (a)-(c) with or
    without ``allow_stateful``; the BNN (d) and the particle model (e)
    only with it, as ``pddp_tpu``'s gate."""
    model, cost, _, enc, _, stage = _case(data, case)
    assert fr.supports_fused_rollout(model, cost, enc, allow_stateful=True)
    if stage in "abc":
        assert fr.stage(model, cost, enc) == stage
        assert fr.supports_fused_rollout(model, cost, enc)
    else:
        assert fr.stage(model, cost, enc) is None
        assert fr.stateful_stage(model, enc) == stage
        assert not fr.supports_fused_rollout(model, cost, enc)


def _subclass(which):
    """A subclass of ``constrain_model``'s cartpole, or ``constrain_model``
    of a subclass of the cartpole: no hand-written stage carries either,
    K2(f) traces both."""
    if which == "subclass_of_constrained":
        cls = constrain_model(-g.U_MAX, g.U_MAX)(
            cartpole.CartpoleDynamicsModel)
        return type("Other", (cls,), {})(device="cpu", dtype=F64)
    assert which == "constrained_subclass"
    other = type("Other", (cartpole.CartpoleDynamicsModel,), {})
    return constrain_model(-g.U_MAX, g.U_MAX)(other)(device="cpu",
                                                     dtype=F64)


@pytest.mark.parametrize("which", ["subclass_of_constrained",
                                   "constrained_subclass"])
def test_subclasses_reach_stage_f(data, which):
    """Subclasses the hand-written stages refuse reach K2(f), stage "f",
    whose plain version is the stored ``control_law`` of the constrained
    cartpole (the same arithmetic)."""
    model = _subclass(which)
    cost = cartpole.CartpoleCost(device="cpu", dtype=F64)
    enc = StateEncoding.IGNORE_UNCERTAINTY
    assert fr.stage(model, cost, enc) == "f"
    assert fr.supports_fused_rollout(model, cost, enc)
    case = "constrained_cartpole_ignore"
    ref, _, ins, enc, bounds, _ = _case(data, case)
    for name in cartpole.model.PARAM_NAMES:
        setattr(model, name, getattr(ref, name))
    Z, U, J, AUX = fr.fused_control_law(
        model, *ins, torch.as_tensor(data["alphas"]), enc, cost=cost,
        u_min=bounds[0], u_max=bounds[1], with_aux=True)
    for name, got in (("Z_out", Z), ("U_out", U), ("J_out", J)):
        np.testing.assert_allclose(got.numpy(), data[case + "_" + name],
                                   **TOL)


#: a bare subclass of the cartpole, made once (the trace is keyed on the
#: model's type).
_OtherCartpole = type("Other", (cartpole.CartpoleDynamicsModel,), {})


def test_particle_over_subclass_matches_pddp_tpu(data):
    """The particle model over a bare subclass of the cartpole (K2(e) over
    a traced inner step) against the stored line search of the particle
    cartpole under the Cholesky codec (the same arithmetic), with its
    parameters and noise."""
    case = "particle_cartpole_chol"
    ref, cost, ins, enc, (lo, hi), _ = _case(data, case)
    inner = _OtherCartpole(*(getattr(ref.inner, n)
                             for n in cartpole.model.PARAM_NAMES),
                           device="cpu", dtype=F64)
    model = convert.particle_model(inner, data[case + "_eps"])
    assert fr.stage(model, cost, enc) is None
    assert fr.stateful_stage(model, enc) == "e"
    assert fr.supports_fused_rollout(model, cost, enc, allow_stateful=True)
    before = _launches()
    Z, U, J, AUX = fr.fused_control_law(
        model, *ins, torch.as_tensor(data["alphas"]), enc, cost=cost,
        u_min=lo, u_max=hi, with_aux=True)
    assert _launches() == before  # CPU tensors: the plain version
    for name, got in (("Z_out", Z), ("U_out", U), ("AUX_out", AUX)):
        np.testing.assert_allclose(got.numpy(), data[case + "_" + name],
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(J.numpy(), data[case + "_J_out"], **J_TOL)


def _refused(data, which):
    """A model each of whose kinds the kernels still refuse."""
    if which == "particle_past_max_particles":
        eps = np.random.default_rng(16).standard_normal(
            (g.N + 1, 2 * fpr.MAX_PARTICLES, 4))
        return convert.particle_model(
            cartpole.CartpoleDynamicsModel(device="cpu", dtype=F64), eps)
    model = _case(data, "bnn_variance")[0]
    if which == "bnn_float16_compute":
        net = copy.copy(model.net)
        net.compute_dtype = torch.float16
        return model.replace(net=net)
    if which == "bnn_particle_sharded":
        return model.replace(particle_group=object(), n_particles_global=16)
    assert which == "particle_over_bnn"
    return ParticleDynamicsModel(model, model.eps_in, n_particles=g.P,
                                 horizon=g.N + 1)


@pytest.mark.parametrize("which", [
    "particle_past_max_particles", "bnn_float16_compute",
    "bnn_particle_sharded", "particle_over_bnn"])
def test_refused_cases_still_raise(data, which):
    """What no kernel carries stays refused, each by the ValueError of
    ``fused_control_law``: a particle model of more than
    ``MAX_PARTICLES`` particles (2048: K2(e) runs a thread a particle),
    the BNN under a float16 knob (its bfloat16 knobs run in K2(d)) or
    with its particles sharded, a particle model over the BNN."""
    model = _refused(data, which)
    cost = cartpole.CartpoleCost(device="cpu", dtype=F64)
    ins = _case(data, "particle_cartpole_variance")[2]
    enc = StateEncoding.VARIANCE_ONLY
    assert not fr.supports_fused_rollout(model, cost, enc,
                                         allow_stateful=True)
    with pytest.raises(ValueError):
        fr.fused_control_law(model, *ins, torch.as_tensor(data["alphas"]),
                             enc, cost=cost, with_aux=True)
