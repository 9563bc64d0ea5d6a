"""K2(f)'s trace: a model's step and a cost from their own torch code.

Pallas traced any model's and cost's jnp code into ``pddp_tpu``'s fused
line search (``pddp_tpu/ops/fused_rollout.py:114-261``). The port does the
same for K2(f): ``make_fx`` of ``functionalize(f)`` at one candidate's
shapes, ``(nz,)`` and ``(nu,)``, records the aten ops of

* the step, ``model.step(z, u, i, (), encoding)[0]``, the function
  ``controllers.ilqr.control_law`` calls (the base class's is ``apply``);
* under IGNORE_UNCERTAINTY the stage cost ``cost(z, u, i, terminal=False,
  encoding=...)`` and the terminal cost ``cost(z, None, N,
  terminal=True, ...)``, as ``control_law`` calls them.

``ops/_scalar.py`` lowers each graph to a scalar program and prints it.
No inductor, no ``torch.compile``: ``make_fx`` only traces.

The leaves. The model's and the cost's tensor attributes, found through
tuples, lists, dicts and nested objects (``AggregateCost``'s two costs),
are the trace's inputs, as a pytree's leaves are the Pallas kernel's
(``_pack``): a shallow copy of each object carries the placeholders, and
the wrapper reads the live values at every call. Everything else (Python
numbers, index tuples, class-level closures such as ``constrain_model``'s
bounds) is static and baked into the trace.

The step index. ``i`` is a Python int that the trace turns into a
``SymInt`` (tensor shapes stay static). A ``TorchFunctionMode`` turns an
index of a tensor by it (``w[i]``, ``w[i, 0]``) into ``torch.select(w, d,
i)``, so that the graph keeps the select and the kernel reads row ``i`` at
run time (without it, tracing bakes the sample step into the graph).

The guards decide. A Python branch on the step index (``if i < 3``) is
specialized by the trace without a word, except for the guard it leaves
on the index's symbol. The only guards allowed are those that hold for
every step at which every run-time read is in bounds (``0 <= i < len``
for ``w[i]``); anything else refuses the model. So does a trace that
raises: a Python branch on a tensor's value (a data-dependent guard), a
tensor that is not a collected leaf, an op outside the lowering's table.

Stateful models (K2(g), only under ``allow_stateful``, as ``pddp_tpu``'s
gate has it): the step ``model.step(z, u, i, state, encoding)`` is traced
with the leaves of ``init_state()`` as inputs besides z, u and i, and its
outputs are the next z, the leaves of the next state and the leaves of
the aux (``Program.sizes``), as the Pallas kernel threads the state
through its ``fori_loop`` carry and writes the aux out. The state and the
aux are tensors or tuples, lists and dicts of them (the nests
``controllers.ilqr.control_law`` stacks); refused: a state or aux leaf
that is not a floating tensor, and a step whose next state or aux is not
a function of the traced inputs (a Python number, or a structure or
shape other than ``init_state()``'s and ``aux_zero()``'s).

The inner step (K2(e) over a traced inner model): ``trace_inner`` traces
``inner.apply(X, u, i, (), IGNORE_UNCERTAINTY)`` at (n,), (nu,), as
``ParticleDynamicsModel`` pushes each particle through it.

The cache. ``supports_fused_rollout`` runs at every evaluation and a
trace can take seconds, so traces are cached, keyed on the identity of
every object's type, the repr of the static attributes, the leaves'
shapes and dtypes, the state's and the aux's structure, the encoding,
the dtype and the device type.
"""

from __future__ import annotations

import copy
import enum
import hashlib
import math
import time
import types

import torch

from ..encoding import StateEncoding, infer_encoded_state_size
from ..utils.linalg import SMALL_N
from . import _scalar
from ._scalar import Unsupported

__all__ = ["Unsupported", "TracedRollout", "TracedInner", "trace_rollout",
           "trace_inner", "trace_inner_step", "leaves_of", "trace_step",
           "trace_cost", "check_gate", "state_structure", "is_stateful",
           "flatten", "unflatten", "SAMPLE_STEP"]

#: the step at which a trace is taken: past 0 and 1, which tracing would
#: otherwise specialize.
SAMPLE_STEP = 2

_MATRIX_CODECS = (StateEncoding.UPPER_TRIANGULAR_CHOLESKY,
                  StateEncoding.FULL_COVARIANCE_MATRIX)

#: traced rollouts (or the reason each was refused) by key.
_CACHE: dict = {}


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------


def _walkable(obj):
    """Whether ``obj`` is an instance whose attributes the trace walks."""
    return (hasattr(obj, "__dict__") and not isinstance(
        obj, (type, types.FunctionType, types.MethodType, types.ModuleType,
              torch.nn.Module, enum.Enum)))


def leaves_of(obj):
    """The tensors reachable from ``obj``'s attributes, in a fixed order,
    and a description of everything else (the cache key's part)."""
    leaves, seen = [], set()

    def walk(o):
        if isinstance(o, torch.Tensor):
            leaves.append(o)
            return ("t", tuple(o.shape), str(o.dtype))
        if isinstance(o, (tuple, list)):
            return (type(o), tuple(walk(v) for v in o))
        if isinstance(o, dict):
            return ("d", tuple((repr(k), walk(o[k])) for k in o))
        if _walkable(o):
            if id(o) in seen:
                raise Unsupported("a cycle among the attributes")
            seen.add(id(o))
            out = (type(o), tuple((k, walk(v))
                                  for k, v in sorted(vars(o).items())))
            seen.discard(id(o))
            return out
        if isinstance(o, (bool, int, float, str, type(None), complex,
                          enum.Enum)):
            return repr(o)
        try:
            hash(o)
            return ("o", o)
        except TypeError:
            return ("id", id(o))

    desc = walk(obj)
    return leaves, desc


def _substitute(obj, values):
    """A copy of ``obj`` whose tensors are the next of ``values`` (an
    iterator), in ``leaves_of``'s order; objects without tensors stay."""
    if isinstance(obj, torch.Tensor):
        return next(values)
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(_substitute(v, values) for v in obj)
    if isinstance(obj, tuple):
        return type(obj)(*(_substitute(v, values) for v in obj))
    if isinstance(obj, list):
        return [_substitute(v, values) for v in obj]
    if isinstance(obj, dict):
        return {k: _substitute(obj[k], values) for k in obj}
    if _walkable(obj):
        if not leaves_of(obj)[0]:
            return obj
        new = copy.copy(obj)
        for k, v in sorted(vars(obj).items()):
            object.__setattr__(new, k, _substitute(v, values))
        return new
    return obj


def flatten(tree, what="state"):
    """(leaves, spec) of a nest of tensors in tuples, lists and dicts (the
    nests ``control_law`` stacks); Unsupported for anything else."""
    if isinstance(tree, torch.Tensor):
        return [tree], None
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        leaves, specs = [], []
        for v in tree:
            sub, spec = flatten(v, what)
            leaves += sub
            specs.append((len(sub), spec))
        return leaves, (type(tree), tuple(specs))
    if isinstance(tree, dict):
        leaves, specs = [], []
        for k in tree:
            sub, spec = flatten(tree[k], what)
            leaves += sub
            specs.append((k, len(sub), spec))
        return leaves, ("d", tuple(specs))
    raise Unsupported("a {} of {} (tensors in tuples, lists and dicts "
                      "only)".format(what, type(tree).__name__))


def unflatten(spec, leaves):
    """The nest of ``spec`` (``flatten``'s) over ``leaves``."""
    if spec is None:
        return leaves[0]
    if spec[0] == "d":
        out, at = {}, 0
        for k, n, sub in spec[1]:
            out[k] = unflatten(sub, leaves[at:at + n])
            at += n
        return out
    kind, subs = spec
    out, at = [], 0
    for n, sub in subs:
        out.append(unflatten(sub, leaves[at:at + n]))
        at += n
    return kind(out)


def state_structure(model):
    """(state leaves, state spec, aux leaves, aux spec) of ``model``'s
    ``init_state()`` and ``aux_zero()`` (one candidate's); Unsupported
    where either is not a nest of floating tensors or raises."""
    try:
        state, aux = model.init_state(), model.aux_zero()
    except Exception:  # noqa: BLE001 - as pddp_tpu's gate
        raise Unsupported("a model whose init_state or aux_zero raises") \
            from None
    s_leaves, s_spec = flatten(state, "state")
    a_leaves, a_spec = flatten(aux, "aux")
    for t in s_leaves + a_leaves:
        if not t.is_floating_point():
            raise Unsupported("a state or aux leaf of dtype {}".format(
                t.dtype))
    return s_leaves, s_spec, a_leaves, a_spec


def is_stateful(model):
    """Whether ``model`` carries a rolling state or an aux (its
    ``init_state()`` or ``aux_zero()`` is not ``()``), as ``pddp_tpu``'s
    gate asks; a model whose either raises counts as stateful."""
    try:
        return not all(isinstance(x, tuple) and x == ()
                       for x in (model.init_state(), model.aux_zero()))
    except Exception:  # noqa: BLE001 - as pddp_tpu's gate
        return True


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


class _StepIndex(torch.overrides.TorchFunctionMode):
    """Turns ``Tensor.__getitem__`` by the step index (alone or in a tuple
    of ints, slices, None and Ellipsis) into ``torch.select``, so that the
    select keeps the symbolic index."""

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            x, idx = args
            items = idx if isinstance(idx, tuple) else (idx,)
            if any(isinstance(v, torch.SymInt) for v in items) and all(
                    isinstance(v, (int, torch.SymInt, slice, type(None)))
                    or v is Ellipsis for v in items):
                return _select_items(x, items)
        return func(*args, **kwargs)


def _select_items(x, items):
    consumed = sum(1 for v in items if v is not None and v is not Ellipsis)
    d = 0
    for v in items:
        if v is None:
            x = x.unsqueeze(d)
            d += 1
        elif v is Ellipsis:
            d += x.dim() - d - consumed
        elif isinstance(v, slice):
            x = x[(slice(None),) * d + (v,)]
            d += 1
            consumed -= 1
        else:
            x = torch.select(x, d, v)
            consumed -= 1
    return x


def _trace(fn, leaves, inputs, dtype, device):
    """(GraphModule, shape env, the index's sympy symbol or None) of
    ``fn(*leaves, *inputs)`` traced with fake leaves and inputs: each
    input "z" (nz,), "u" (nu,), "s" (a state leaf of the given shape) or
    "i" (a Python int made symbolic)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    env = ShapeEnv(duck_shape=False, specialize_zero_one=False)
    mode = FakeTensorMode(shape_env=env, static_shapes=True)
    args = [mode.from_tensor(t) for t in leaves]
    for kind, size in inputs:
        if kind == "i":
            args.append(size)
        else:
            args.append(mode.from_tensor(torch.empty(size, dtype=dtype,
                                                     device=device)))

    def wrapped(*a):
        with _StepIndex():
            return fn(*a)

    gm = make_fx(torch.func.functionalize(wrapped),
                 tracing_mode="symbolic")(*args)
    sym = None
    for n in gm.graph.nodes:
        if n.op == "placeholder" and isinstance(n.meta.get("val"),
                                                torch.SymInt):
            sym = n.meta["val"].node.expr
    return gm, env, sym


def _horizon(prog, env, sym):
    """The steps i = 0 .. H-1 at which ``prog`` may run: every run-time
    read in bounds, and every guard on the index's symbol true there (else
    Unsupported). H is None where nothing bounds the index. Each condition
    must be linear in the index (a branch on ``i % 2`` is refused)."""
    if sym is None:
        return None
    H = None
    for expr, length in prog.index_ranges:
        a, b = _linear(expr, sym)
        if not 0 <= b < length:
            raise Unsupported("a step-indexed read out of bounds at step 0")
        if a > 0:       # the first i with a i + b >= length
            h = -(-(length - b) // a)
        elif a < 0:     # the first i with a i + b < 0
            h = b // -a + 1
        else:
            continue
        H = h if H is None else min(H, h)
    guards = [g.expr for g in env.guards]
    guards += [ra.expr for ras in getattr(env, "deferred_runtime_asserts",
                                          {}).values() for ra in ras]
    for g in guards:
        if sym not in g.free_symbols:
            continue
        if len(g.free_symbols) > 1 or not _holds(g, sym, H):
            raise Unsupported("a Python branch on the step index (guard "
                              "{})".format(g))
    return H


def _linear(expr, sym):
    """(a, b) with ``expr`` = a sym + b, integers; else Unsupported."""
    import sympy
    try:
        poly = sympy.Poly(expr, sym)
    except sympy.PolynomialError:
        poly = None
    if poly is None or poly.degree() > 1 or not all(
            c.is_integer for c in poly.all_coeffs()):
        raise Unsupported("a step-index expression that is not linear: "
                          "{}".format(expr))
    coeffs = [int(c) for c in poly.all_coeffs()]
    return (coeffs[0], coeffs[1]) if len(coeffs) == 2 else (0, coeffs[0])


def _holds(guard, sym, H):
    """Whether the relation ``guard`` (linear in sym) holds at every step
    0 .. H-1 (H None: every step from 0 on). A linear inequality holds on
    an interval where it holds at both ends."""
    import sympy
    if not isinstance(guard, sympy.core.relational.Relational):
        return False
    a, b = _linear(guard.lhs - guard.rhs, sym)
    last = None if H is None else H - 1
    if last is not None and last < 0:
        return True
    if isinstance(guard, sympy.Eq):
        return a == 0 and b == 0
    if isinstance(guard, sympy.Ne):
        if a == 0:
            return b != 0
        root_in = b % a == 0 and -b // a >= 0 and (last is None
                                                   or -b // a <= last)
        return not root_in
    below = isinstance(guard, (sympy.StrictLessThan, sympy.LessThan))
    strict = isinstance(guard, (sympy.StrictLessThan,
                                sympy.StrictGreaterThan))

    def test(v):
        if below:
            return v < 0 if strict else v <= 0
        return v > 0 if strict else v >= 0
    if last is None and a != 0 and (a > 0) == below:
        return False    # unbounded steps: it fails as i grows
    return test(b) and (last is None or test(a * last + b))


def trace_step(model, encoding, dtype, device, stateful=False):
    """(Program, horizon) of ``model``'s step at one candidate: the
    lowered program and the steps at which it may run (None: any).
    ``stateful``: the step of a stateful model, its state's leaves inputs
    after z, u and i, its outputs the next z, then the next state's and
    the aux's leaves (see the module)."""
    leaves, _ = leaves_of(model)
    nz = infer_encoded_state_size(model.state_size, encoding)
    nu = model.action_size
    inputs = [("z", (nz,)), ("u", (nu,)), ("i", SAMPLE_STEP)]
    if not stateful:
        def step(*a):
            m = _substitute(model, iter(a[:len(leaves)]))
            z, u, i = a[len(leaves):]
            out = m.step(z, u, i, (), encoding)
            if not (isinstance(out, tuple) and len(out) == 3
                    and out[1] == () and out[2] == ()):
                raise Unsupported("a step with a rolling state or an aux")
            return out[0]

        return _trace_and_lower(step, leaves, inputs, dtype, device, (nz,))

    s_leaves, s_spec, a_leaves, a_spec = state_structure(model)
    want = ([(nz,)] + [tuple(t.shape) for t in s_leaves]
            + [tuple(t.shape) for t in a_leaves])

    def step(*a):
        m = _substitute(model, iter(a[:len(leaves)]))
        z, u, i = a[len(leaves):len(leaves) + 3]
        state = unflatten(s_spec, list(a[len(leaves) + 3:]))
        out = m.step(z, u, i, state, encoding)
        if not (isinstance(out, tuple) and len(out) == 3):
            raise Unsupported("a step that does not return (z, state, "
                              "aux)")
        s_next, s_next_spec = flatten(out[1], "next state")
        aux, aux_spec = flatten(out[2], "aux")
        if s_next_spec != s_spec or aux_spec != a_spec:
            raise Unsupported("a next state or aux of another structure "
                              "than init_state()'s and aux_zero()'s")
        return (out[0], *s_next, *aux)

    inputs += [("s", tuple(t.shape)) for t in s_leaves]
    return _trace_and_lower(step, leaves, inputs, dtype, device, want)


def trace_inner(inner, dtype, device):
    """(Program, horizon) of a particle model's inner step at one particle:
    ``inner.apply(X, u, i, (), IGNORE_UNCERTAINTY)`` at (n,), (nu,), as
    ``ParticleDynamicsModel._push`` calls it."""
    leaves, _ = leaves_of(inner)
    n, nu = inner.state_size, inner.action_size
    ign = StateEncoding.IGNORE_UNCERTAINTY

    def apply(*a):
        m = _substitute(inner, iter(a[:len(leaves)]))
        X, u, i = a[len(leaves):]
        return m.apply(X, u, i, (), ign)

    return _trace_and_lower(apply, leaves, [("z", (n,)), ("u", (nu,)),
                                  ("i", SAMPLE_STEP)], dtype, device, (n,))


def trace_cost(cost, model, encoding, terminal, dtype, device, opts=None):
    """(Program, horizon) of ``cost`` at one candidate (u None where
    ``terminal``, as ``control_law`` calls it), with the keyword options
    ``opts`` (static: baked into the trace)."""
    opts = dict(opts or {})
    leaves, _ = leaves_of(cost)
    nz = infer_encoded_state_size(model.state_size, encoding)
    nu = model.action_size

    def fn(*a):
        c = _substitute(cost, iter(a[:len(leaves)]))
        rest = a[len(leaves):]
        if terminal:
            z, i = rest
            return c(z, None, i, terminal=True, encoding=encoding, **opts)
        z, u, i = rest
        return c(z, u, i, terminal=False, encoding=encoding, **opts)

    inputs = [("z", (nz,))] + ([] if terminal else [("u", (nu,))]) + [
        ("i", SAMPLE_STEP)]
    return _trace_and_lower(fn, leaves, inputs, dtype, device, ())


def _trace_and_lower(fn, leaves, inputs, dtype, device, out_shape):
    """(Program, horizon) of ``fn`` traced and lowered: its output of
    ``out_shape``, or a tuple of outputs of a list of shapes."""
    for t in leaves:
        if not t.is_floating_point():
            raise Unsupported("a tensor attribute of dtype {}".format(
                t.dtype))
        if torch.promote_types(t.dtype, dtype) != dtype:
            raise Unsupported("a {} tensor attribute in a {} trace".format(
                t.dtype, dtype))
    try:
        gm, env, sym = _trace(fn, leaves, inputs, dtype, device)
    except Unsupported:
        raise
    except Exception as e:  # noqa: BLE001 - a trace that raises refuses
        raise Unsupported("the trace raised {}: {}".format(
            type(e).__name__, str(e).splitlines()[0][:200])) from None
    out = [n for n in gm.graph.nodes if n.op == "output"][0]
    vals = out.args[0]
    if isinstance(out_shape, list):
        vals, shapes = list(vals), out_shape
    else:
        vals = [vals[0] if isinstance(vals, (tuple, list)) else vals]
        shapes = [out_shape]
    if len(vals) != len(shapes):
        raise Unsupported("{} outputs, not {}".format(len(vals),
                                                      len(shapes)))
    for val, shape in zip(vals, shapes):
        meta = val.meta.get("val") if hasattr(val, "meta") else None
        if not isinstance(meta, torch.Tensor) or tuple(meta.shape) != shape:
            raise Unsupported("an output of shape {}, not {}".format(
                None if meta is None else tuple(meta.shape), shape))
    prog = _scalar.lower(gm, [t.dtype for t in leaves], dtype,
                         [k for k, _ in inputs])
    return prog, _horizon(prog, env, sym)


# ---------------------------------------------------------------------------
# A traced rollout
# ---------------------------------------------------------------------------


def _layout(programs, leaves):
    """(static leaves, dynamic leaves, layout, n_static, n_dynamic) of the
    leaves the programs read: a leaf that any program reads by the step
    index goes into the dynamic buffer ``w``, every other read leaf into
    the static buffer ``p``; ``layout[leaf]`` is (buffer, offset)."""
    reads = {}
    for prog in programs:
        for leaf, how in prog.leaf_reads().items():
            if reads.get(leaf) != "dynamic":
                reads[leaf] = how
    static = sorted(k for k, v in reads.items() if v == "static")
    dynamic = sorted(k for k, v in reads.items() if v == "dynamic")
    layout, size = {}, {"p": 0, "w": 0}
    for buf, group in (("p", static), ("w", dynamic)):
        for g in group:
            layout[g] = (buf, size[buf])
            size[buf] += leaves[g].numel()
    return static, dynamic, layout, size["p"], size["w"]


def _buffers(leaves, static, dynamic, dtype, device):
    """(p, w): the live leaves' values, flattened in the layout's order,
    in ``dtype`` on ``device`` (a one-element zero buffer where a buffer
    would be empty)."""
    out = []
    for group in (static, dynamic):
        parts = [leaves[g].detach().reshape(-1).to(dtype=dtype,
                                                   device=device)
                 for g in group]
        out.append(torch.cat(parts) if parts else
                   torch.zeros(1, dtype=dtype, device=device))
    return tuple(out)


class TracedRollout:
    """What K2(f) and K2(g) run for one (model, cost, encoding, dtype):
    the programs, the leaves' layout and the generated source.

    Leaves are the model's, then (where the kernel carries the cost) the
    cost's. A leaf that any program reads by the step index goes into the
    dynamic buffer ``w`` (global memory in the kernel), every other leaf
    that a program reads into the static buffer ``p`` (shared memory);
    ``layout[leaf]`` is (buffer, offset). A stateful model's (K2(g);
    ``stateful``) step also takes the rolling state's ``n_state`` flat
    elements and returns the next state's and the aux's ``n_aux``: their
    leaves' shapes and nests are ``state_shapes``/``state_spec`` and
    ``aux_shapes``/``aux_spec`` (one candidate's)."""

    def __init__(self, model, cost, encoding, dtype, cost_opts=None,
                 stateful=False):
        self.encoding = encoding
        self.dtype = dtype
        self.nz = infer_encoded_state_size(model.state_size, encoding)
        self.nu = model.action_size
        self.has_cost = cost is not None
        self.stateful = stateful
        t0 = time.perf_counter()
        model_leaves = leaves_of(model)[0]
        leaves = model_leaves + (leaves_of(cost)[0] if self.has_cost
                                 else [])
        device = leaves[0].device if leaves else torch.device("cpu")
        self.n_model = len(model_leaves)
        self.step, h_step = trace_step(model, encoding, dtype, device,
                                       stateful)
        self.state_shapes, self.aux_shapes = [], []
        self.state_spec = self.aux_spec = None
        if stateful:
            s_leaves, self.state_spec, a_leaves, self.aux_spec = \
                state_structure(model)
            self.state_shapes = [tuple(t.shape) for t in s_leaves]
            self.aux_shapes = [tuple(t.shape) for t in a_leaves]
        self.n_state = sum(math.prod(s) for s in self.state_shapes)
        self.n_aux = sum(math.prod(s) for s in self.aux_shapes)
        self.stage = self.terminal = None
        limits = [h_step]
        if self.has_cost:
            stage, h_stage = trace_cost(cost, model, encoding, False, dtype,
                                        device, cost_opts)
            terminal, h_term = trace_cost(cost, model, encoding, True,
                                          dtype, device, cost_opts)
            self.stage = _scoped(stage, self.n_model)
            self.terminal = _scoped(terminal, self.n_model)
            limits += [h_stage, None if h_term is None else h_term - 1]
        #: the longest horizon N the programs allow (None: any): steps
        #: 0 .. N-1 and, with the cost, the terminal step N.
        self.max_horizon = min((h for h in limits if h is not None),
                               default=None)
        self.trace_seconds = time.perf_counter() - t0
        (self.static_leaves, self.dynamic_leaves, self.layout,
         self.n_static, self.n_dynamic) = _layout(self.programs(), leaves)
        cyc, counts = self.chain(_F32_LATENCY)
        self.source = _scalar.print_struct(
            "Traced", dtype, self.nz, self.nu, self.step, self.stage,
            self.terminal, layout=self.layout, n_static=self.n_static,
            n_dynamic=self.n_dynamic,
            chain_note="k2f_chain_cycles at float32 latencies: {} a step "
            "({})".format(cyc, counts), n_state=self.n_state)
        # Named by its text: rollouts that trace to the same program (an
        # example and a bare subclass of it) share a library.
        self.name = "traced_" + hashlib.sha256(
            self.source.encode()).hexdigest()[:12]

    def programs(self):
        return [p for p in (self.step, self.stage, self.terminal)
                if p is not None]

    def buffers(self, model, cost, dtype, device):
        """(p, w): the live leaves' values, flattened in the layout's
        order, in ``dtype`` on ``device`` (a one-element zero buffer where
        a buffer would be empty)."""
        leaves = leaves_of(model)[0] + (leaves_of(cost)[0]
                                        if self.has_cost else [])
        return _buffers(leaves, self.static_leaves, self.dynamic_leaves,
                        dtype, device)

    def chain(self, latency, bounded=False):
        """(cycles, {kind: count}) of one step's loop-carried chain
        (``k2f_chain_cycles``) at the depth the function needs
        (``Program.chain``): the feedback law z -> u (a subtraction, then
        the sum of the nz products and two terms as a tree, and with
        bounds the clamp's two), then the traced step from z, u and the
        rolling state to the next z and state, the outputs the next step
        reads (the longer). The aux and the stage cost run off the
        chain."""
        fb = 1 + math.ceil(math.log2(self.nz + 2)) + (2 if bounded else 0)
        ready = {("u", k): fb * latency["fma"] for k in range(self.nu)}
        cyc, counts = self.step.chain(latency, ready,
                                      self.nz + self.n_state)
        if counts.pop("from", None) == "u" or cyc < fb * latency["fma"]:
            counts["fma"] = counts.get("fma", 0) + fb
        return max(cyc, fb * latency["fma"]), counts

    def op_count(self):
        """Operations of one candidate and step: the feedback law (nu
        (2 nz + 3)), the step and, with the cost, the stage cost."""
        n = self.nu * (2 * self.nz + 3) + self.step.op_count()
        if self.has_cost:
            n += self.stage.op_count()
        return n


class TracedInner:
    """What K2(e) runs for a particle model over a traced inner model
    (``trace_inner``) in ``dtype``: the inner step's program, its leaves'
    layout (``TracedRollout``'s: ``p`` staged in shared memory, ``w`` read
    by the step index) and its ``struct TracedInner``, printed with every
    product through ``pddp_tr::mul_`` (the particle kernel's own
    arithmetic builds with contraction on, the traced step's must not
    contract)."""

    def __init__(self, inner, dtype):
        self.dtype = dtype
        self.n, self.nu = inner.state_size, inner.action_size
        t0 = time.perf_counter()
        leaves = leaves_of(inner)[0]
        device = leaves[0].device if leaves else torch.device("cpu")
        self.step, self.max_horizon = trace_inner(inner, dtype, device)
        self.trace_seconds = time.perf_counter() - t0
        (self.static_leaves, self.dynamic_leaves, self.layout,
         self.n_static, self.n_dynamic) = _layout([self.step], leaves)
        cyc, counts = self.chain(_F32_LATENCY)
        self.source = _scalar.print_struct(
            "TracedInner", dtype, self.n, self.nu, self.step,
            layout=self.layout, n_static=self.n_static,
            n_dynamic=self.n_dynamic, exact_mul=True,
            what="the particle model's inner model's",
            chain_note="the inner step's chain at float32 latencies: {} "
            "({})".format(cyc, counts))

    def buffers(self, inner, dtype, device):
        """(p, w) of the live inner model (``TracedRollout.buffers``)."""
        return _buffers(leaves_of(inner)[0], self.static_leaves,
                        self.dynamic_leaves, dtype, device)

    def chain(self, latency):
        """(cycles, {kind: count}) of the inner step's longest chain from
        a particle's X and the action (``Program.chain``)."""
        cyc, counts = self.step.chain(latency)
        counts.pop("from", None)
        return cyc, counts


#: float32 latencies in SM cycles (``chip_smoke.LATENCY``'s), for the
#: chain printed into the generated source.
_F32_LATENCY = {"fma": 4, "div": 30, "sqrt": 30, "sincos": 44}


def _scoped(prog, first):
    """``prog`` with its leaf numbers shifted by ``first`` (the cost's
    leaves follow the model's)."""
    new = _scalar.Program(prog.T)
    new.outputs = list(prog.outputs)
    new.sizes = list(prog.sizes)
    new.index_ranges = list(prog.index_ranges)
    for op, dt, args in prog.ops:
        if op in ("ld", "ldi"):
            args = (args[0] + first,) + args[1:]
        new.ops.append((op, dt, args))
    return new


def _key(model, cost, encoding, dtype, device_type, cost_opts, stateful):
    parts = [leaves_of(model)[1], int(encoding), str(dtype), device_type]
    if stateful:
        s_leaves, s_spec, a_leaves, a_spec = state_structure(model)
        parts.append(("stateful", repr(s_spec), repr(a_spec),
                      tuple((tuple(t.shape), str(t.dtype))
                            for t in s_leaves + a_leaves)))
    if cost is not None:
        parts.append(leaves_of(cost)[1])
        for k in sorted(cost_opts or {}):
            v = cost_opts[k]
            if isinstance(v, torch.Tensor) or leaves_of(v)[0]:
                raise Unsupported("a tensor among the cost's options")
            parts.append((k, leaves_of(v)[1]))
    return tuple(parts)


def check_gate(model, encoding, allow_stateful=False):
    """Raises Unsupported where ``pddp_tpu``'s gate refuses (model,
    encoding) before any trace: a matrix codec past ``SMALL_N``, or a
    stateful model without ``allow_stateful``."""
    if encoding is None:
        raise Unsupported("no encoding")
    if encoding in _MATRIX_CODECS and model.state_size > SMALL_N:
        raise Unsupported("a matrix codec at state size {} > SMALL_N".format(
            model.state_size))
    if not allow_stateful and is_stateful(model):
        raise Unsupported("a stateful model")


def _cached(key, make):
    try:
        hash(key)
    except TypeError:
        raise Unsupported("an attribute that cannot be keyed") from None
    hit = _CACHE.get(key)
    if hit is None:
        try:
            hit = make()
        except Unsupported as e:
            hit = e
        _CACHE[key] = hit
    if isinstance(hit, Unsupported):
        raise hit
    return hit


def trace_rollout(model, cost, encoding, dtype, device_type,
                  cost_opts=None, allow_stateful=False):
    """The TracedRollout of (model, cost, encoding, dtype), cached; raises
    Unsupported (also from the cache) where it is refused. ``cost`` None:
    the kernel carries no cost (belief codecs, or no cost given);
    ``cost_opts`` the cost's keyword options, static; a stateful model
    only with ``allow_stateful`` (K2(g))."""
    check_gate(model, encoding, allow_stateful)
    stateful = is_stateful(model)
    try:
        key = _key(model, cost, encoding, dtype, device_type, cost_opts,
                   stateful)
    except TypeError:
        raise Unsupported("an attribute that cannot be keyed") from None
    return _cached(key, lambda: TracedRollout(model, cost, encoding, dtype,
                                              cost_opts, stateful))


def trace_inner_step(inner, dtype, device_type):
    """The TracedInner of a particle model's inner model in ``dtype``,
    cached; raises Unsupported where it is refused (a stateful inner
    model, or a trace that fails)."""
    if is_stateful(inner):
        raise Unsupported("a stateful inner model")
    key = ("inner", leaves_of(inner)[1], str(dtype), device_type)
    return _cached(key, lambda: TracedInner(inner, dtype))
