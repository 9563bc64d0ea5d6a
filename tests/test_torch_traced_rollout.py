"""K2(f), the line search of any stateless model and cost, traced from its
torch code (``pddp_tpu_torch/ops/_trace.py``, ``_scalar.py``,
``traced_rollout.py``; the kernel ``csrc/traced_rollout.cuh`` runs only on
a card, ``chip_smoke.py`` phase 21).

On the CPU, in float64, for the rows R1-R8 of ``tests/traced_models.py``:
(a) the scalar program's interpreter against the model's ``apply`` and
the cost, 1e-13; (b) the plain path through ``fused_control_law`` against
``pddp_tpu``'s results stored in ``tests/golden/traced_rollouts.npz``
(``python -m tests.golden.traced_rollouts``), 1e-10; (c) the printed
header built by ``g++ -O1 -ffp-contract=off`` (skipped without ``g++``),
1e-13; (d) the gate; (e) the trace at one candidate's shapes against
``apply`` over a candidate axis.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pddp_tpu_torch.controllers.ilqr import (ILQROptions, _solver_steps,
                                             control_law, solve)
from pddp_tpu_torch.encoding import StateEncoding
from pddp_tpu_torch.examples.cartpole import (CartpoleCost,
                                              CartpoleDynamicsModel)
from pddp_tpu_torch.examples.double_cartpole import (
    DoubleCartpoleCost, DoubleCartpoleDynamicsModel)
from pddp_tpu_torch.examples.pendulum import (PendulumCost,
                                              PendulumDynamicsModel)
from pddp_tpu_torch.examples.rendezvous import (RendezvousCost,
                                                RendezvousDynamicsModel)
from pddp_tpu_torch.ops import _trace
from pddp_tpu_torch.ops import fused_rollout as fr
from pddp_tpu_torch.ops import traced_rollout as tro
from pddp_tpu_torch.utils.constraint import constrain_model
from tests import traced_models as tm
from tests.golden import traced_rollouts as golden

F64 = torch.float64
IGN = StateEncoding.IGNORE_UNCERTAINTY
ROWS = list(tm.ROWS)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pddp_tpu_torch", "csrc")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module on one CPU thread, restored after it: the plain
    versions' small batched products (an 8 x 8 factor's, ten candidates)
    take milliseconds each on a pool of threads and microseconds on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    with np.load(golden.PATH) as f:
        return {k: f[k] for k in f.files}


def _row(row):
    """(model, cost, encoding, bounds, traced rollout, leaves) of a row at
    the fixture's horizon; leaves those the programs read (the model's,
    then the cost's where the kernel carries it)."""
    model, cost, enc, bounds = tm.make_row(row, golden.N)
    tr = tro.traced(model, cost, enc, F64, "cpu")
    leaves = _trace.leaves_of(model)[0]
    if tr.has_cost:
        leaves = leaves + _trace.leaves_of(cost)[0]
    return model, cost, enc, bounds, tr, leaves


@pytest.fixture(scope="module")
def rows():
    """Every row's ``_row``, built and traced once for the module."""
    return {r: _row(r) for r in ROWS}


#: the step of the three samples of (a) and (c): not the trace's.
STEP = 11


def _samples(data, row):
    """Three inputs of the row: states of its nominal trajectory, actions
    near its nominal ones."""
    rng = np.random.default_rng(7 + ROWS.index(row))
    steps = [3, STEP, golden.N - 1]
    Z = torch.as_tensor(data[row + "_Z"][steps])
    U = data[row + "_U"][steps]
    U = torch.as_tensor(U + 0.1 * rng.standard_normal(U.shape))
    return Z, U


@pytest.mark.parametrize("row", ROWS)
def test_interpreter_matches_model_and_cost(data, rows, gxx_build, row):
    """(a) The scalar programs' interpreter against ``apply`` and the
    cost, at three inputs (one vectorised run) and a nonzero step."""
    model, cost, enc, _, tr, leaves = rows[row]
    Z, U = _samples(data, row)
    want = torch.stack([model.apply(z, u, STEP, (), enc)
                        for z, u in zip(Z, U)])
    np.testing.assert_allclose(tr.step.run(leaves, Z, U, STEP).numpy(),
                               want.numpy(), rtol=0, atol=1e-13)
    if tr.has_cost:
        for got, terminal, i in ((tr.stage.run(leaves, Z, U, STEP), False,
                                  STEP),
                                 (tr.terminal.run(leaves, Z, None, golden.N),
                                  True, golden.N)):
            want = torch.stack([cost(z, None if terminal else u, i,
                                     terminal=terminal, encoding=enc)
                                for z, u in zip(Z, U)])
            np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(),
                                       rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("row", ROWS)
def test_plain_path_matches_pddp_tpu(data, rows, row):
    """(b) ``fused_control_law`` on CPU tensors (stage (f)'s plain
    version) against ``pddp_tpu``'s fused line search (R8: its scan)."""
    model, cost, enc, bounds, _, _ = rows[row]
    t = {k: torch.as_tensor(data["{}_{}".format(row, k)])
         for k in ("Z", "U", "k", "K")}
    lo, hi = ((torch.tensor(b, dtype=F64) for b in bounds)
              if bounds is not None else (None, None))
    Z, U, J, AUX = fr.fused_control_law(
        model, t["Z"], t["U"], t["k"], t["K"], torch.as_tensor(
            data["alphas"]), enc, cost=cost, u_min=lo, u_max=hi,
        with_aux=True)
    assert AUX == ()
    for name, got in (("Z_out", Z), ("U_out", U), ("J_out", J)):
        want = data["{}_{}".format(row, name)]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10, err_msg=name)


@pytest.fixture(scope="module")
def gxx_build(tmp_path_factory, rows):
    """Starts g++ on the printed structs of every row (one library: for
    row r, r_step, r_stage and r_terminal call its Traced's functions);
    the tests of (c) wait for it. None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    parts = ['#include "traced_rollout.cuh"\n']
    for row in ROWS:
        tr = rows[row][4]
        parts.append("namespace {} {{\n{}\n}}\n".format(row, tr.source))
        parts.append(
            'extern "C" void {0}_step(const double* p, const double* w, '
            "const double* z, const double* u, int i, double* zn) "
            "{{ {0}::Traced::step(p, w, z, u, i, zn); }}\n".format(row))
        if tr.has_cost:
            parts.append(
                'extern "C" double {0}_stage(const double* p, const '
                "double* w, const double* z, const double* u, int i) "
                "{{ return {0}::Traced::stage_cost(p, w, z, u, i); }}\n"
                'extern "C" double {0}_terminal(const double* p, const '
                "double* w, const double* z, int i) "
                "{{ return {0}::Traced::terminal_cost(p, w, z, i); }}\n"
                .format(row))
    d = tmp_path_factory.mktemp("traced")
    src, lib = d / "traced.cpp", d / "libtraced.so"
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
def test_printed_header_built_by_gxx_matches(data, rows, gxx_library,
                                            row):
    """(c) The printed C++ (g++, no contraction) against ``apply`` and
    the cost."""
    model, cost, enc, _, tr, _ = rows[row]
    p, w = tr.buffers(model, cost if tr.has_cost else None, F64, "cpu")
    Z, U = _samples(data, row)
    step = getattr(gxx_library, row + "_step")
    i = STEP
    for z, u in zip(Z, U):
        z, u = z.contiguous(), u.contiguous()
        zn = torch.empty(tr.nz, dtype=F64)
        step(_ptr(p), _ptr(w), _ptr(z), _ptr(u), ctypes.c_int(i), _ptr(zn))
        want = model.apply(z, u, i, (), enc)
        np.testing.assert_allclose(zn.numpy(), want.numpy(), rtol=0,
                                   atol=1e-13)
        if tr.has_cost:
            stage = getattr(gxx_library, row + "_stage")
            terminal = getattr(gxx_library, row + "_terminal")
            stage.restype = terminal.restype = ctypes.c_double
            c = stage(_ptr(p), _ptr(w), _ptr(z), _ptr(u), ctypes.c_int(i))
            np.testing.assert_allclose(
                c, float(cost(z, u, i, terminal=False, encoding=enc)),
                rtol=1e-13, atol=1e-13)
            c = terminal(_ptr(p), _ptr(w), _ptr(z), ctypes.c_int(golden.N))
            np.testing.assert_allclose(
                c, float(cost(z, None, golden.N, terminal=True,
                              encoding=enc)), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("row", ROWS)
def test_gate_takes_the_row_in_stage_f(row):
    """(d) Every row passes ``pddp_tpu``'s gate into stage (f)."""
    model, cost, enc, _ = tm.make_row(row, golden.N)
    assert fr.stage(model, cost, enc) == "f"
    assert fr.supports_fused_rollout(model, cost, enc)


def test_gate_keeps_the_hand_written_stages():
    """(d) The exact examples stay in stages (a)-(c)."""
    def ex(cls, cost_cls):
        return cls(device="cpu", dtype=F64), cost_cls(device="cpu",
                                                      dtype=F64)
    m, c = ex(CartpoleDynamicsModel, CartpoleCost)
    assert fr.stage(m, c, IGN) == "a"
    for cls, cost_cls in ((PendulumDynamicsModel, PendulumCost),
                          (DoubleCartpoleDynamicsModel, DoubleCartpoleCost),
                          (RendezvousDynamicsModel, RendezvousCost)):
        m, c = ex(cls, cost_cls)
        assert fr.stage(m, c, IGN) == "b"
        assert fr.stage(m, c, StateEncoding.VARIANCE_ONLY) == "c"
    m = constrain_model(-1.0, 1.0)(CartpoleDynamicsModel)(device="cpu",
                                                         dtype=F64)
    assert fr.stage(m, CartpoleCost(device="cpu", dtype=F64), IGN) == "a"


class _ValueBranch(CartpoleDynamicsModel):
    def apply(self, z, u, i, aux, encoding=StateEncoding.DEFAULT, **kw):
        if bool((z[..., 0] > 100.0).any()):
            u = 2.0 * u
        return super().apply(z, u, i, aux, encoding)


class _StepBranch(CartpoleDynamicsModel):
    def apply(self, z, u, i, aux, encoding=StateEncoding.DEFAULT, **kw):
        if i < 3:
            u = 2.0 * u
        return super().apply(z, u, i, aux, encoding)


class _Erf(CartpoleDynamicsModel):
    def apply(self, z, u, i, aux, encoding=StateEncoding.DEFAULT, **kw):
        return super().apply(z, torch.erf(u), i, aux, encoding)


def test_gate_refuses_a_branch_on_a_value_and_solve_takes_the_scan(data):
    """(d) A Python branch on a tensor's value cannot be traced: refused,
    and the line search of ``solve(fused_rollout=True)`` runs the plain
    ``control_law``."""
    model = _ValueBranch(dt=0.05, device="cpu", dtype=F64)
    cost = CartpoleCost(device="cpu", dtype=F64)
    assert fr.stage(model, cost, IGN) is None
    assert not fr.supports_fused_rollout(model, cost, IGN)
    with pytest.raises(ValueError):
        fr.fused_control_law(model, None, None, None, None, None, IGN,
                             cost=cost)
    t = [torch.as_tensor(data["R5_" + k]) for k in ("Z", "U", "k", "K")]
    alphas = torch.as_tensor(data["alphas"])
    line_search = _solver_steps(model, cost, ILQROptions(fused_rollout=True),
                                IGN, None, None, None, None, alphas)[2]
    got = line_search(*t)
    want = control_law(model, *t, alphas, IGN, cost=cost, with_aux=True)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


class _ScaledCost(CartpoleCost):
    """A cost that takes a keyword option, as a user's may."""

    def __call__(self, z, u, i, terminal=False,
                 encoding=StateEncoding.DEFAULT, scale=1.0, **kw):
        return scale * super().__call__(z, u, i, terminal, encoding)


_OptsCartpole = type("OptsCartpole", (CartpoleDynamicsModel,), {})


def test_gate_reads_the_cost_options_and_solve_takes_the_scan(data):
    """(d) The gate traces the cost with the options the solve passes: a
    number is baked into stage (f); a tensor option is refused at the
    gate, and ``solve(fused_rollout=True)`` runs the plain ``control_law``
    to its end, as the scan's solve does."""
    model = _OptsCartpole(dt=0.05, device="cpu", dtype=F64)
    cost = _ScaledCost(device="cpu", dtype=F64)
    assert fr.stage(model, cost, IGN, {"scale": 2.0}) == "f"
    opts = {"scale": torch.tensor(2.0, dtype=F64)}
    assert fr.stage(model, cost, IGN, opts) is None
    assert not fr.supports_fused_rollout(model, cost, IGN, cost_opts=opts)
    z0 = torch.as_tensor(data["R5_Z"][0])
    U0 = torch.as_tensor(data["R5_U"])
    got, want = (solve(model, cost, z0, U0, ILQROptions(
        n_iterations=2, fused_rollout=fused), encoding=IGN, cost_opts=opts)
        for fused in (True, False))
    assert (got.state, got.iterations, got.evals) == (
        want.state, want.iterations, want.evals)
    assert got.J_opt == want.J_opt
    np.testing.assert_array_equal(got.U.numpy(), want.U.numpy())


def test_gate_refuses_a_branch_on_the_step():
    """(d) ``if i < 3`` leaves a guard on the step index beyond the index
    bounds: refused, also beside a per-step table."""
    model = _StepBranch(dt=0.05, device="cpu", dtype=F64)
    cost = CartpoleCost(device="cpu", dtype=F64)
    assert not tro.supports(model, cost, IGN)
    quad = tm.PlanarQuadrotorModel(tm.wind(golden.N))
    quad.__class__ = type("StepBranchQuadrotor", (tm.PlanarQuadrotorModel,),
                          {"apply": _StepBranch.apply})
    assert not tro.supports(quad, None, StateEncoding.VARIANCE_ONLY)


def test_gate_refuses_an_op_outside_the_table():
    """(d) An op the lowering has no instruction for refuses the model."""
    model = _Erf(dt=0.05, device="cpu", dtype=F64)
    with pytest.raises(_trace.Unsupported, match="erf"):
        tro.traced(model, None, IGN, F64, "cpu")
    assert not fr.supports_fused_rollout(model, None, IGN)


def test_wind_is_read_at_the_run_time_step(rows):
    """(d) The quadrotor's ``w[i]`` is read at the step the program is
    given, first and last, not at the sample step of the trace; and the
    table bounds the horizon."""
    model, cost, enc, _, tr, leaves = rows["R1"]
    z = torch.tensor([[0.5, -0.3, 0.1, 0.0, 0.2, 0.0]], dtype=F64)
    u = torch.full((1, 2), tm.HOVER, dtype=F64)
    outs = []
    for i in (0, golden.N - 1):
        got = tr.step.run(leaves, z, u, i)[0]
        np.testing.assert_allclose(
            got.numpy(), model.apply(z[0], u[0], i, (), enc).numpy(),
            rtol=0, atol=1e-15)
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])
    assert tr.max_horizon == golden.N


def test_trace_is_cached():
    """(d) The second gate call of the same (model, cost, encoding) takes
    no trace, also after a leaf's value changed, which the buffers read
    afresh; a static attribute's change is a new trace."""
    cls = type("CachedCartpole", (CartpoleDynamicsModel,), {})
    model = cls(dt=0.05, device="cpu", dtype=F64)
    cost = CartpoleCost(device="cpu", dtype=F64)
    assert fr.supports_fused_rollout(model, cost, IGN)
    first = tro.traced(model, cost, IGN)
    model.dt = torch.tensor(0.1, dtype=F64)
    assert fr.supports_fused_rollout(model, cost, IGN)
    assert tro.traced(model, cost, IGN) is first
    p, _ = first.buffers(model, cost, F64, "cpu")
    assert float(p[first.layout[_leaf_index(model, "dt")][1]]) == 0.1
    model.extra = 2.0
    assert tro.traced(model, cost, IGN) is not first


def _leaf_index(model, name):
    leaves = _trace.leaves_of(model)[0]
    return next(k for k, t in enumerate(leaves) if t is getattr(model, name))


@pytest.mark.parametrize("row", ["R1", "R4"])
def test_trace_equals_apply_over_candidates(data, rows, row):
    """(e) The trace at one candidate's shapes equals ``apply`` at (A,
    nz): the model is elementwise over leading dims, as ``pddp_tpu``'s
    contract requires."""
    model, _, enc, _, tr, leaves = rows[row]
    Z = torch.as_tensor(data[row + "_Z_out"][5])      # (A, nz)
    U = torch.as_tensor(data[row + "_U_out"][5])      # (A, nu)
    np.testing.assert_allclose(tr.step.run(leaves, Z, U, 5).numpy(),
                               model.apply(Z, U, 5, (), enc).numpy(),
                               rtol=0, atol=1e-13)
