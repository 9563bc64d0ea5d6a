"""K2(d) under the BNN's bfloat16 knobs (``compute_dtype`` or
``matmul_dtype`` = ``torch.bfloat16``), on the CPU.

``tests/golden/bf16_rollouts.npz`` (written by ``JAX_PLATFORMS=cpu
python -m tests.golden.bf16_rollouts``; this file reads only it) holds
``pddp_tpu``'s ``fused_control_law(..., interpret=True, with_aux=True)``
of a BNN (hidden [16, 16], P=8, N=6, ten step sizes) under each knob and
each of the five codecs, in float64 and float32, and its inputs. On CPU
tensors the port's ``fused_control_law`` runs its plain version
(``control_law`` over the knob's net), so these hold the semantics the
kernel's bfloat16 instances reproduce, the gate, and the layout the
wrapper packs for them. Also here: the float32 cartpole cost under
STANDARD_DEVIATION_ONLY near 0 rad against ``tests/golden/
std_cost_f32.npz``.
"""

import numpy as np
import pytest
import torch

from pddp_tpu_torch import convert
from pddp_tpu_torch.controllers.ilqr import control_law
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.cartpole import CartpoleCost
from pddp_tpu_torch.ops import fused_bnn_rollout as fb
from pddp_tpu_torch.ops import fused_rollout as fr
from pddp_tpu_torch.utils.angular import _augment_var
from tests.golden import bf16_rollouts as g
from tests.golden import bnn_path
from tests.golden import std_cost_f32

torch.set_num_threads(1)

CASES = [(c, d, k) for c in g.CODECS for d in g.DTYPES for k in g.KNOBS]

# Relative to max |output| of each of Z, U and AUX. float64: both sides
# round the same operands at the same points and sum the exact bfloat16
# products in float64 in another order; a rounding lands elsewhere only
# where that order moves a sum across a rounding boundary (measured: none,
# up to 3.3e-15). float32: compute_dtype's roundings would put an ulp of
# bfloat16 (2^-8 of a value) wherever another order of the float32 sums
# moved one across a boundary, which the later steps carry on; at this
# size none does (measured up to 9.7e-7, and the same with every product
# summed in float64 or in reverse order instead), so what is left is
# float32's order of sums, as under matmul_dtype (measured up to 1.4e-6,
# FULL's AUX). The fixture's jitted float32 forward rounds each bfloat16
# operation as written (tests/golden/bf16_rollouts.py).
TOL = {("float64", "compute_dtype"): 1e-10,
       ("float64", "matmul_dtype"): 1e-10,
       ("float32", "compute_dtype"): 1e-5,
       ("float32", "matmul_dtype"): 1e-5}


@pytest.fixture(scope="module")
def data():
    with np.load(g.PATH) as npz:
        return dict(npz)


def _model(data, codec, dtype, **net):
    """The case's BNN from the npz (its arrays rounded to ``dtype``)."""
    n = sum(1 for k in data if k.startswith(codec + "_leaf"))
    leaves = [np.asarray(data["{}_leaf{}".format(codec, i)], dtype)
              for i in range(n)]
    buffers = {k: data["{}_{}".format(codec, k)] for k in convert.BNN_BUFFERS}
    return convert.bnn(leaves, buffers, bnn_path.STATE, bnn_path.ACTION,
                       g.HIDDEN, angular_indices=bnn_path.ANGULAR,
                       non_angular_indices=bnn_path.NON_ANGULAR,
                       n_particles=g.P, horizon=g.N + 1,
                       chol_jitter=bnn_path.JITTER, device="cpu",
                       dtype=getattr(torch, dtype), **net)


def _inputs(data, codec, dtype):
    td = getattr(torch, dtype)
    return (tuple(torch.as_tensor(data["{}_{}".format(codec, k)]).to(td)
                  for k in ("Z", "U", "k", "K")),
            torch.as_tensor(data["alphas"]).to(td))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("codec,dtype,knob", CASES)
def test_bf16_rollout_matches_pddp_tpu(data, codec, dtype, knob):
    model = _model(data, codec, dtype, **{knob: torch.bfloat16})
    ins, alphas = _inputs(data, codec, dtype)
    before = dict(fb.launches)
    out = fr.fused_control_law(model, *ins, alphas, StateEncoding[codec],
                               with_aux=True)
    assert fb.launches == before   # CPU tensors: the plain version
    for name, got in zip(g.OUTPUTS, out):
        assert got.dtype == getattr(torch, dtype)
        want = data[g.key(codec, dtype, knob, name)]
        assert _rel(got.numpy(), want) <= TOL[(dtype, knob)], name


@pytest.mark.parametrize("codec,dtype,knob", CASES)
def test_full_precision_lies_outside_the_tolerance(data, codec, dtype,
                                                   knob):
    """The knob acts: the net at full precision on the same inputs is
    farther from pddp_tpu's knob rollout than the tolerance (Z)."""
    model = _model(data, codec, dtype)
    ins, alphas = _inputs(data, codec, dtype)
    Z = control_law(model, *ins, alphas, StateEncoding[codec],
                    with_aux=True)[0]
    want = data[g.key(codec, dtype, knob, "Z_out")]
    assert _rel(Z.numpy(), want) > TOL[(dtype, knob)]


@pytest.mark.parametrize("codec", g.CODECS)
@pytest.mark.parametrize("knob", g.KNOBS)
def test_gate_admits_each_knob_and_refuses_others(data, codec, knob):
    """Each bfloat16 knob takes stage (d) under every codec; a float16
    knob, or both knobs at once, stays refused."""
    enc = StateEncoding[codec]
    cost = CartpoleCost(device="cpu", dtype=torch.float64)
    model = _model(data, codec, "float64", **{knob: torch.bfloat16})
    assert fr.supports_fused_rollout(model, cost, enc, allow_stateful=True)
    assert fr.stateful_stage(model, enc) == "d"
    assert not fr.supports_fused_rollout(model, cost, enc)
    for net in ({knob: torch.float16},
                {"compute_dtype": torch.bfloat16,
                 "matmul_dtype": torch.bfloat16}):
        other = _model(data, codec, "float64", **net)
        assert not fr.supports_fused_rollout(other, cost, enc,
                                             allow_stateful=True)
        ins, alphas = _inputs(data, codec, "float64")
        with pytest.raises(ValueError):
            fr.fused_control_law(other, *ins, alphas, enc, with_aux=True)


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16).to(a.dtype)


def _packed_forward(net, dtype, x):
    """The MLP as the bfloat16 instances compute it, from what the
    wrapper packs for them (``_Packer.net``): float32's W^T read back from
    its bfloat16 bits (padding checked zero), float64's rounded W; each
    product of the rounded operands summed in float64 here."""
    pk = fb._Packer(dtype, "cpu")
    pk.net(net, x.shape[0], 4)
    buf, _ = pk.done()
    cfg, widths = pk.cfg, pk.cfg["width"]
    compute = cfg["knob"] == 1
    h = _bf16(x)
    for l in range(cfg["n_layers"]):
        K, O = widths[l], widths[l + 1]
        if dtype == torch.float32:
            S, O8 = fb._bf16_stride(K), -(-O // 8) * 8
            off = cfg["w_off"][l]
            Wt = buf[off:off + O8 * S // 2].view(torch.bfloat16)
            Wt = Wt.reshape(O8, S).to(torch.float64)
            assert not Wt[O:].any() and not Wt[:, K:].any()
            W = Wt[:O, :K].T
        else:
            W = buf[cfg["w_off"][l]:cfg["w_off"][l] + K * O].reshape(K, O)
            assert torch.equal(W, _bf16(W))
        b = buf[cfg["b_off"][l]:cfg["b_off"][l] + O]
        acc = (h.double() @ W.double()).to(dtype)
        last = l == cfg["n_layers"] - 1
        if compute:
            h = _bf16(_bf16(acc) + b)
        else:
            h = acc + b
        if last:
            return h
        m = cfg["m_off"][l]
        if m >= 0:
            mask = buf[m:m + x.shape[0] * O].reshape(x.shape[0], O)
            h = _bf16(h * mask) if compute else h * mask
        h = torch.relu(h)
        if not compute:
            h = _bf16(h)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("knob", g.KNOBS)
def test_mlp_packing_matches_plain_forward(data, dtype, knob):
    """F3 (``fused_bnn_rollout.mlp``) under each knob: on the CPU the
    net's plain forward; the arrays packed for the bfloat16 instances,
    put through the same roundings, give it back (float64: the same
    arithmetic; float32: the order of float32 sums, which under
    compute_dtype may move a rounding by an ulp of bfloat16)."""
    model = _model(data, "VARIANCE_ONLY", dtype, **{knob: torch.bfloat16})
    td = getattr(torch, dtype)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (g.P, 6)), dtype=td)
    plain = model.net(x)
    assert torch.equal(fb.mlp(model.net, x[None])[0], plain)
    got = _packed_forward(model.net, td, x)
    tol = 1e-12 if dtype == "float64" else (
        2.0**-8 if knob == "compute_dtype" else 1e-6)
    assert _rel(got.numpy(), plain.numpy()) <= tol


def test_std_cost_f32_near_zero_rad_as_pddp_tpu():
    """The float32 cartpole cost under STANDARD_DEVIATION_ONLY at states
    near 0 rad (std_cost_f32.npz): J is NaN exactly where the
    moment-matched variance of cos(theta) rounds below 0, in both
    packages alike (the same formula); both are NaN at more such states
    than only one is, and where only one is, that variance is within float32's rounding of
    its terms of 0 on both sides; finite J agree within float32's."""
    with np.load(std_cost_f32.PATH) as f:
        Z, J_jax, var_jax = f["Z"], f["J"], f["var_cos"]
    z = torch.as_tensor(Z)
    cost = CartpoleCost(device="cpu", dtype=torch.float32)
    J = cost(z, torch.zeros(len(Z), 1), 0, terminal=False,
             encoding=StateEncoding.STANDARD_DEVIATION_ONLY).numpy()
    var = _augment_var(z[:, :4], z[:, 4:] ** 2, (2,), (0, 1, 3))[1][:, -1]
    var = var.numpy()
    assert np.array_equal(np.isnan(J), var < 0)
    assert np.array_equal(np.isnan(J_jax), var_jax < 0)
    both = np.isnan(J) & np.isnan(J_jax)
    only = np.isnan(J) ^ np.isnan(J_jax)
    assert both.sum() > only.sum() > 0
    # The terms 1 - e^{-v} and e^{-2v} - e^{-v} round within 2^-24 of 1.
    assert np.abs(var[only]).max() <= 2.0**-22
    assert np.abs(var_jax[only]).max() <= 2.0**-22
    fin = np.isfinite(J) & np.isfinite(J_jax)
    assert np.abs(J[fin] - J_jax[fin]).max() <= 1e-6 * np.abs(J_jax[fin]).max()
