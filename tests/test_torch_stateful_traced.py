"""K2(g), the line search of a user's stateful model traced from its
torch code, and K2(e) over a traced inner step (``ops/_trace.py``,
``_scalar.py``, ``traced_rollout.py``, ``fused_particle_rollout.py``; the
kernels ``csrc/traced_rollout.cuh`` and ``csrc/fused_particle_rollout.cuh``
run only on a card, ``chip_smoke.py`` phase 22).

On the CPU, in float64, for the rows G1-G3 and E1-E2 of
``tests/traced_models.py`` (STATEFUL_ROWS): (a) ``fused_control_law`` with
``allow_stateful``'s stages on CPU tensors (their plain version) against
``pddp_tpu``'s ``fused_control_law(..., interpret=True, with_aux=True)``
stored in ``tests/golden/stateful_traced.npz`` (``python -m
tests.golden.stateful_traced``): Z, U and AUX within 1e-10, J within 1e-8
(``pddp_tpu``'s own tolerances for its stateful kernel); (b) the traced
programs' interpreter against the model's ``step`` (K2(g)) or the inner
model's ``apply`` (K2(e)); (c) the printed structs built by ``g++``
(skipped without it) against the same; (d) the gate; (e) what stays
refused.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pddp_tpu_torch.encoding import StateEncoding, encode
from pddp_tpu_torch.ops import _trace
from pddp_tpu_torch.ops import fused_bnn_rollout as fb
from pddp_tpu_torch.ops import fused_particle_rollout as fpr
from pddp_tpu_torch.ops import fused_rollout as fr
from pddp_tpu_torch.ops import traced_rollout as tro
from tests import traced_models as tm
from tests.golden import stateful_traced as g

F64 = torch.float64
IGN = StateEncoding.IGNORE_UNCERTAINTY
ROWS = list(tm.STATEFUL_ROWS)
TOL = {"rtol": 1e-10, "atol": 1e-10}
J_TOL = {"rtol": 1e-8, "atol": 1e-8}
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pddp_tpu_torch", "csrc")
#: the step of (b) and (c): not the trace's.
STEP = 4


@pytest.fixture(scope="module")
def data():
    with np.load(g.PATH) as f:
        return {k: f[k] for k in f.files}


def _row(row):
    """(model, cost, encoding, bounds) of a row at the fixture's sizes."""
    return tm.make_stateful_row(row, g.N, P=g.P)


def _traced(row):
    """(traced, the leaves its programs read): K2(g)'s TracedRollout, or
    the TracedInner of K2(e)'s inner model."""
    model, cost, enc, _ = _row(row)
    if row.startswith("E"):
        return (fpr.inner_step(model.inner, F64, "cpu"),
                _trace.leaves_of(model.inner)[0])
    tr = tro.traced(model, cost, enc, F64, "cpu", allow_stateful=True)
    leaves = _trace.leaves_of(model)[0]
    return tr, leaves + (_trace.leaves_of(cost)[0] if tr.has_cost else [])


def _samples(row, model, enc, tr):
    """Three seeded inputs of a row: (z, u, s) for K2(g) (z encoded under
    its codec), (X, u) for the inner step."""
    rng = np.random.default_rng(40 + ROWS.index(row))
    name = tm.example_name(tm.STATEFUL_ROWS[row][0])
    mean = torch.as_tensor(tm.STARTS[name][1]) + torch.as_tensor(
        0.1 * rng.standard_normal((3, len(tm.STARTS[name][1]))))
    base = tm.HOVER if name == "quadrotor" else 0.0
    u = torch.as_tensor(base + 0.3 * rng.standard_normal((3, tr.nu)))
    if row.startswith("E"):
        return mean, u, None
    z = encode(mean, V=1e-2 * torch.ones_like(mean), encoding=enc)
    s = torch.as_tensor(0.2 * rng.standard_normal((3, tr.n_state)))
    return z, u, s


@pytest.mark.parametrize("row", ROWS)
def test_fused_control_law_matches_pddp_tpu(data, row):
    """(a) The plain path of K2(g) or K2(e) (CPU tensors) against
    ``pddp_tpu``'s fused line search, the aux in ``control_law``'s
    layout, no kernel launched."""
    model, cost, enc, bounds = _row(row)
    t = [torch.as_tensor(data["{}_{}".format(row, k)])
         for k in ("Z", "U", "k", "K")]
    lo, hi = ((torch.tensor(b, dtype=F64) for b in bounds)
              if bounds is not None else (None, None))
    before = (dict(tro.launches), dict(fpr.launches), dict(fb.launches))
    Z, U, J, AUX = fr.fused_control_law(
        model, *t, torch.as_tensor(data["alphas"]), enc, cost=cost,
        u_min=lo, u_max=hi, with_aux=True)
    assert (dict(tro.launches), dict(fpr.launches),
            dict(fb.launches)) == before
    for name, got in (("Z_out", Z), ("U_out", U), ("AUX_out", AUX)):
        np.testing.assert_allclose(got.numpy(), data[row + "_" + name],
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(J.numpy(), data[row + "_J_out"], **J_TOL)


@pytest.mark.parametrize("row", ROWS)
def test_interpreter_matches_step(row):
    """(b) ``Program.run`` of the traced stateful step equals the model's
    ``step`` (its next z, next state and aux, one output each), and that
    of the traced inner step the inner model's ``apply``."""
    model, _, enc, _ = _row(row)
    tr, leaves = _traced(row)
    x, u, s = _samples(row, model, enc, tr)
    if row.startswith("E"):
        want = model.inner.apply(x, u, STEP, (), IGN)
        got = tr.step.run(leaves, x, u, STEP)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-13)
        return
    z_next, s_next, aux = model.step(x, u, STEP, s, enc)
    got = tr.step.run(leaves, x, u, STEP, s)
    assert len(got) == 3 and tr.step.sizes == [tr.nz, tr.n_state, tr.n_aux]
    for a, b in zip(got, (z_next, s_next, aux)):
        np.testing.assert_allclose(a.numpy(), b.reshape(3, -1).numpy(),
                                   rtol=0, atol=1e-13)


@pytest.fixture(scope="module")
def gxx_build(tmp_path_factory):
    """Starts g++ on every row's printed struct (one library: r_step
    calls row r's step, r_stage/r_terminal its costs); None without
    g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    parts = ['#include "traced_rollout.cuh"\n']
    for row in ROWS:
        tr = _traced(row)[0]
        parts.append("namespace {} {{\n{}\n}}\n".format(row, tr.source))
        st = "TracedInner" if row.startswith("E") else "Traced"
        if row.startswith("E"):
            parts.append(
                'extern "C" void {0}_step(const double* p, const double* w, '
                "const double* z, const double* u, int i, const double* s, "
                "double* zn, double* sn, double* an) "
                "{{ {0}::{1}::step(p, w, z, u, i, zn); }}\n".format(row, st))
            continue
        parts.append(
            'extern "C" void {0}_step(const double* p, const double* w, '
            "const double* z, const double* u, int i, const double* s, "
            "double* zn, double* sn, double* an) "
            "{{ {0}::{1}::step(p, w, z, u, i, s, zn, sn, an); }}\n".format(
                row, st))
        if tr.has_cost:
            parts.append(
                'extern "C" double {0}_stage(const double* p, const '
                "double* w, const double* z, const double* u, int i) "
                "{{ return {0}::Traced::stage_cost(p, w, z, u, i); }}\n"
                .format(row))
    d = tmp_path_factory.mktemp("stateful_traced")
    src, lib = d / "stateful.cpp", d / "libstateful.so"
    src.write_text("".join(parts))
    proc = subprocess.Popen([gxx, "-O1", "-ffp-contract=off", "-std=c++17",
                             "-shared", "-fPIC", "-I", CSRC, "-o", str(lib),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, lib
    proc.wait()


@pytest.fixture(scope="module")
def gxx_library(gxx_build):
    if gxx_build is None:
        pytest.skip("no g++ on this host")
    proc, lib = gxx_build
    out, _ = proc.communicate()
    assert proc.returncode == 0, out
    return ctypes.CDLL(str(lib))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("row", ROWS)
def test_printed_struct_built_by_gxx_matches(gxx_library, row):
    """(c) The printed C++ (g++, no contraction) against the interpreter:
    K2(g)'s stateful step and stage cost, K2(e)'s inner step."""
    model, cost, enc, _ = _row(row)
    tr, leaves = _traced(row)
    if row.startswith("E"):
        p, w = tr.buffers(model.inner, F64, "cpu")
    else:
        p, w = tr.buffers(model, cost if tr.has_cost else None, F64, "cpu")
    x, u, s = _samples(row, model, enc, tr)
    want = tr.step.run(leaves, x, u, STEP, s)
    want = torch.cat(want, dim=-1) if isinstance(want, tuple) else want
    step = getattr(gxx_library, row + "_step")
    n_state, n_aux = (0, 0) if row.startswith("E") else (tr.n_state,
                                                         tr.n_aux)
    n_out = want.shape[-1]
    for a in range(3):
        sa = (s[a] if s is not None else torch.zeros(1, dtype=F64)) \
            .contiguous()
        out = torch.empty(n_out + 1, dtype=F64)
        zn, sn, an = (out[:n_out - n_state - n_aux],
                      out[n_out - n_state - n_aux:n_out - n_aux],
                      out[n_out - n_aux:])
        step(_ptr(p), _ptr(w), _ptr(x[a].contiguous()),
             _ptr(u[a].contiguous()), ctypes.c_int(STEP), _ptr(sa),
             _ptr(zn), _ptr(sn), _ptr(an))
        np.testing.assert_allclose(out[:n_out].numpy(), want[a].numpy(),
                                   rtol=0, atol=1e-13)
        if row.startswith("G") and tr.has_cost:
            stage = getattr(gxx_library, row + "_stage")
            stage.restype = ctypes.c_double
            c = stage(_ptr(p), _ptr(w), _ptr(x[a].contiguous()),
                      _ptr(u[a].contiguous()), ctypes.c_int(STEP))
            np.testing.assert_allclose(
                c, float(tr.stage.run(leaves, x[a:a + 1], u[a:a + 1],
                                      STEP)[0, 0]), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("row", ROWS)
def test_gate_admits_the_row_only_with_allow_stateful(row):
    """(d) As ``pddp_tpu``'s gate: each stateful row runs in a kernel only
    with ``allow_stateful`` (K2(g) for the user's models, K2(e) for the
    particle models), never in a stateless stage."""
    model, cost, enc, _ = _row(row)
    assert fr.stage(model, cost, enc) is None
    assert not fr.supports_fused_rollout(model, cost, enc)
    assert fr.supports_fused_rollout(model, cost, enc, allow_stateful=True)
    assert fr.stateful_stage(model, enc, cost) == ("g" if row[0] == "G"
                                                    else "e")
    assert tro.supports(model, cost, enc, allow_stateful=True) == (
        row[0] == "G")
    assert not tro.supports(model, cost, enc)


def test_stateless_model_still_takes_stage_f():
    """(d) A stateless user model stays in K2(f), with or without
    ``allow_stateful``, its trace the stateless one."""
    model, cost, enc, _ = tm.make_row("R5", g.N)
    assert fr.stage(model, cost, enc) == "f"
    assert fr.supports_fused_rollout(model, cost, enc, allow_stateful=True)
    tr = tro.traced(model, cost, enc, F64, "cpu", allow_stateful=True)
    assert not tr.stateful and tr.step.sizes == [tr.nz]
    assert "n_state" not in tr.source


class _CountingCartpole(tm.LaggedCartpoleModel):
    """A state that is not a floating tensor: a step counter."""

    def init_state(self, batch_shape=()):
        return torch.zeros(tuple(batch_shape) + (1,), dtype=torch.int64)


class _NumberLag(tm.LaggedCartpoleModel):
    """A next state that is not a function of the traced inputs: a
    Python number."""

    def step(self, z, u, i, state, encoding=StateEncoding.DEFAULT, **kw):
        z_next, _, aux = super().step(z, u, i, state, encoding)
        return z_next, 0.0, aux


class _NestedLag(tm.LaggedCartpoleModel):
    """The lag with a nested state (f, {"g": f twice}) and aux."""

    def init_state(self, batch_shape=()):
        f = super().init_state(batch_shape)
        return (f, {"g": torch.cat([f, f], dim=-1)})

    def aux_zero(self):
        return {"f": super().aux_zero(), "pair": (super().aux_zero(),)}

    def step(self, z, u, i, state, encoding=StateEncoding.DEFAULT, **kw):
        f, rest = state
        z_next, f_next, aux = super().step(z, u, i, f, encoding)
        g_next = rest["g"] * 0.5 + f_next
        return (z_next, (f_next, {"g": g_next}),
                {"f": aux, "pair": (rest["g"][..., :1],)})


@pytest.mark.parametrize("which", ["integer_state", "number_state"])
def test_refused_states_still_raise(data, which):
    """(e) A state leaf that is not a floating tensor, and a next state
    that is not a tensor, stay refused, by the ValueError of
    ``fused_control_law``."""
    cls = _CountingCartpole if which == "integer_state" else _NumberLag
    model = cls(dt=0.05, device="cpu", dtype=F64)
    cost = tm.cartpole.CartpoleCost(device="cpu", dtype=F64)
    assert not fr.supports_fused_rollout(model, cost, IGN,
                                         allow_stateful=True)
    t = [torch.as_tensor(data["G1_" + k]) for k in ("Z", "U", "k", "K")]
    with pytest.raises(ValueError):
        fr.fused_control_law(model, *t, torch.as_tensor(data["alphas"]),
                             IGN, cost=cost, with_aux=True)


def test_nested_state_and_aux(data):
    """(b, d) A state and an aux of tuples and dicts: traced leaf by leaf,
    the interpreter against ``step``, and K2(g)'s AUX buffer (B, N, A,
    n_aux) unflattened into ``control_law``'s nest and layout."""
    model = _NestedLag(dt=0.05, device="cpu", dtype=F64)
    cost = tm.cartpole.CartpoleCost(device="cpu", dtype=F64)
    tr = tro.traced(model, cost, IGN, F64, "cpu", allow_stateful=True)
    assert (tr.n_state, tr.n_aux) == (3, 2)
    assert tr.step.sizes == [4, 1, 2, 1, 1]
    leaves = _trace.leaves_of(model)[0] + _trace.leaves_of(cost)[0]
    z, u, _ = _samples("G1", model, IGN, tr)
    s = torch.as_tensor(np.random.default_rng(3).standard_normal((3, 3)))
    state = (s[:, :1], {"g": s[:, 1:]})
    z_next, s_next, aux = model.step(z, u, STEP, state, IGN)
    got = tr.step.run(leaves, z, u, STEP, s)
    want = [z_next, *_trace.flatten(s_next)[0], *_trace.flatten(aux)[0]]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.reshape(3, -1).numpy(),
                                   rtol=0, atol=1e-13)
    t = [torch.as_tensor(data["G1_" + k]) for k in ("Z", "U", "k", "K")]
    alphas = torch.as_tensor(data["alphas"])
    plain = fr.fused_control_law(model, *t, alphas, IGN, cost=cost,
                                 with_aux=True)[3]
    flat = torch.cat([a.reshape(1, g.N, 3, -1)
                      for a in _trace.flatten(plain)[0]], dim=-1)
    rebuilt = tro._aux_tree(tr, flat, unbatched=True)
    assert _trace.flatten(rebuilt)[1] == _trace.flatten(plain)[1]
    for a, b in zip(_trace.flatten(rebuilt)[0], _trace.flatten(plain)[0]):
        assert torch.equal(a, b)
    rows = tro._state_rows(model, (2, 3), F64, "cpu")
    assert rows.shape == (2, 3, 3) and not rows.any()
