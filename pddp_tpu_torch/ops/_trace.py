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

The cache. ``supports_fused_rollout`` runs at every evaluation and a
trace can take seconds, so traces are cached, keyed on the identity of
every object's type, the repr of the static attributes, the leaves'
shapes and dtypes, the encoding, the dtype and the device type.
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

__all__ = ["Unsupported", "TracedRollout", "trace_rollout", "leaves_of",
           "trace_step", "trace_cost", "check_stateless", "SAMPLE_STEP"]

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
    input "z" (nz,), "u" (nu,) or "i" (a Python int made symbolic)."""
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


def trace_step(model, encoding, dtype, device):
    """(Program, horizon) of ``model``'s step at one candidate: the
    lowered program and the steps at which it may run (None: any)."""
    leaves, _ = leaves_of(model)
    nz = infer_encoded_state_size(model.state_size, encoding)
    nu = model.action_size

    def step(*a):
        m = _substitute(model, iter(a[:len(leaves)]))
        z, u, i = a[len(leaves):]
        out = m.step(z, u, i, (), encoding)
        if not (isinstance(out, tuple) and len(out) == 3
                and out[1] == () and out[2] == ()):
            raise Unsupported("a step with a rolling state or an aux")
        return out[0]

    return _trace_and_lower(step, leaves, [("z", (nz,)), ("u", (nu,)),
                                 ("i", SAMPLE_STEP)], dtype, device, (nz,))


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
    val = out.args[0]
    val = val[0] if isinstance(val, (tuple, list)) else val
    meta = val.meta.get("val") if hasattr(val, "meta") else None
    if not isinstance(meta, torch.Tensor) or tuple(meta.shape) != out_shape:
        raise Unsupported("an output of shape {}, not {}".format(
            None if meta is None else tuple(meta.shape), out_shape))
    prog = _scalar.lower(gm, [t.dtype for t in leaves], dtype,
                         [k for k, _ in inputs])
    return prog, _horizon(prog, env, sym)


# ---------------------------------------------------------------------------
# A traced rollout
# ---------------------------------------------------------------------------


class TracedRollout:
    """What K2(f) runs for one (model, cost, encoding, dtype): the
    programs, the leaves' layout and the generated source.

    Leaves are the model's, then (where the kernel carries the cost) the
    cost's. A leaf that any program reads by the step index goes into the
    dynamic buffer ``w`` (global memory in the kernel), every other leaf
    that a program reads into the static buffer ``p`` (shared memory);
    ``layout[leaf]`` is (buffer, offset)."""

    def __init__(self, model, cost, encoding, dtype, cost_opts=None):
        self.encoding = encoding
        self.dtype = dtype
        self.nz = infer_encoded_state_size(model.state_size, encoding)
        self.nu = model.action_size
        self.has_cost = cost is not None
        t0 = time.perf_counter()
        model_leaves = leaves_of(model)[0]
        leaves = model_leaves + (leaves_of(cost)[0] if self.has_cost
                                 else [])
        device = leaves[0].device if leaves else torch.device("cpu")
        self.n_model = len(model_leaves)
        self.step, h_step = trace_step(model, encoding, dtype, device)
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
        reads = {}
        for prog in self.programs():
            for leaf, how in prog.leaf_reads().items():
                if reads.get(leaf) != "dynamic":
                    reads[leaf] = how
        self.static_leaves = sorted(k for k, v in reads.items()
                                    if v == "static")
        self.dynamic_leaves = sorted(k for k, v in reads.items()
                                     if v == "dynamic")
        self.layout, size = {}, {"p": 0, "w": 0}
        for buf, group in (("p", self.static_leaves),
                           ("w", self.dynamic_leaves)):
            for g in group:
                self.layout[g] = (buf, size[buf])
                size[buf] += leaves[g].numel()
        self.n_static, self.n_dynamic = size["p"], size["w"]
        cyc, counts = self.chain(_F32_LATENCY)
        self.source = _scalar.print_struct(
            "Traced", dtype, self.nz, self.nu, self.step, self.stage,
            self.terminal, layout=self.layout, n_static=self.n_static,
            n_dynamic=self.n_dynamic,
            chain_note="k2f_chain_cycles at float32 latencies: {} a step "
            "({})".format(cyc, counts))
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
        out = []
        for group in (self.static_leaves, self.dynamic_leaves):
            parts = [leaves[g].detach().reshape(-1).to(dtype=dtype,
                                                       device=device)
                     for g in group]
            out.append(torch.cat(parts) if parts else
                       torch.zeros(1, dtype=dtype, device=device))
        return tuple(out)

    def chain(self, latency, bounded=False):
        """(cycles, {kind: count}) of one step's loop-carried chain
        (``k2f_chain_cycles``) at the depth the function needs
        (``Program.chain``): the feedback law z -> u (a subtraction, then
        the sum of the nz products and two terms as a tree, and with
        bounds the clamp's two), then the traced step from z and u to the
        next z. The stage cost runs off the chain."""
        fb = 1 + math.ceil(math.log2(self.nz + 2)) + (2 if bounded else 0)
        ready = {("u", k): fb * latency["fma"] for k in range(self.nu)}
        cyc, counts = self.step.chain(latency, ready)
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


#: float32 latencies in SM cycles (``chip_smoke.LATENCY``'s), for the
#: chain printed into the generated source.
_F32_LATENCY = {"fma": 4, "div": 30, "sqrt": 30, "sincos": 44}


def _scoped(prog, first):
    """``prog`` with its leaf numbers shifted by ``first`` (the cost's
    leaves follow the model's)."""
    new = _scalar.Program(prog.T)
    new.outputs = list(prog.outputs)
    new.index_ranges = list(prog.index_ranges)
    for op, dt, args in prog.ops:
        if op in ("ld", "ldi"):
            args = (args[0] + first,) + args[1:]
        new.ops.append((op, dt, args))
    return new


def _key(model, cost, encoding, dtype, device_type, cost_opts):
    parts = [leaves_of(model)[1], int(encoding), str(dtype), device_type]
    if cost is not None:
        parts.append(leaves_of(cost)[1])
        for k in sorted(cost_opts or {}):
            v = cost_opts[k]
            if isinstance(v, torch.Tensor) or leaves_of(v)[0]:
                raise Unsupported("a tensor among the cost's options")
            parts.append((k, leaves_of(v)[1]))
    return tuple(parts)


def check_stateless(model, encoding):
    """Raises Unsupported where ``pddp_tpu``'s gate refuses (model,
    encoding) before any trace: a stateful model, or a matrix codec past
    ``SMALL_N``."""
    if encoding is None:
        raise Unsupported("no encoding")
    if encoding in _MATRIX_CODECS and model.state_size > SMALL_N:
        raise Unsupported("a matrix codec at state size {} > SMALL_N".format(
            model.state_size))
    try:
        if model.init_state() != () or model.aux_zero() != ():
            raise Unsupported("a stateful model")
    except Unsupported:
        raise
    except Exception:  # noqa: BLE001 - as pddp_tpu's gate
        raise Unsupported("a model whose init_state or aux_zero raises") \
            from None


def trace_rollout(model, cost, encoding, dtype, device_type,
                  cost_opts=None):
    """The TracedRollout of (model, cost, encoding, dtype), cached; raises
    Unsupported (also from the cache) where it is refused. ``cost`` None:
    the kernel carries no cost (belief codecs, or no cost given);
    ``cost_opts`` the cost's keyword options, static."""
    check_stateless(model, encoding)
    try:
        key = _key(model, cost, encoding, dtype, device_type,
                   cost_opts)
        hash(key)
    except Unsupported:
        raise
    except TypeError:
        raise Unsupported("an attribute that cannot be keyed") from None
    hit = _CACHE.get(key)
    if hit is None:
        try:
            hit = TracedRollout(model, cost, encoding, dtype, cost_opts)
        except Unsupported as e:
            hit = e
        _CACHE[key] = hit
    if isinstance(hit, Unsupported):
        raise hit
    return hit
