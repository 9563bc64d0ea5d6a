"""K2(f)'s scalar programs: a traced aten graph lowered to straight-line
scalar code, its torch interpreter, and its C++ printer.

``ops/_trace.py`` traces a model's step or a cost at one candidate's
shapes into an aten graph (``make_fx``). ``lower`` turns that graph into
a ``Program``: numbered registers, one scalar instruction each, as
Pallas turned the jnp code of ``pddp_tpu/ops/fused_rollout.py`` into its
kernel body.

* Every view and index op (select, slice, unbind, view, expand,
  transpose, diagonal, diag_embed, stack, cat, index by constants) is
  resolved here to element positions: it costs nothing at run time.
* Tensors that depend on no input (``triu_indices``, ``arange``, ``eye``,
  constants) are computed here, on the CPU, and enter as literals.
* ``sum`` and the matrix products become add chains in index order;
  ``where``, comparisons, ``all`` and the boolean ops become selects and
  boolean instructions.
* Each instruction computes in the dtype torch computes it in: the
  result's dtype for arithmetic (a Python number becomes a literal of
  that dtype), the promoted dtype of the operands for comparisons.
  ``pow`` by 2, 3, 0.5, -0.5, -1 and -2 takes torch's own forms (x*x,
  x*x*x, sqrt, 1/sqrt, 1/x, 1/(x*x)).
* A select of a leaf (a tensor attribute of the model or cost) by the
  step index ``i`` becomes a read of that leaf's row ``i`` at run time.

What is not in the table raises ``Unsupported``, and the gate refuses the
model. ``Program.run`` is the program's torch interpreter, vectorised
over candidates (the CPU counterpart of the printed code), and
``print_struct`` prints the programs of a rollout as the C++ ``struct``
that ``csrc/traced_rollout.cuh`` runs.

A program may have several outputs (a stateful step's next state, its
next rolling state and its aux, K2(g)): ``Program.sizes`` holds the size
of each, ``outputs`` their registers one after another, and
``Program.run`` returns one tensor per output. Its inputs are then the
state (``("s", T, (k,))``, the state's leaves flattened one after another)
besides z, u and the step.
"""

from __future__ import annotations

import heapq
import math
import operator
from collections import namedtuple

import numpy as np
import torch

__all__ = ["Unsupported", "Program", "lower", "print_struct",
           "KIND_OF", "CTYPES"]


class Unsupported(Exception):
    """The graph holds what the lowering cannot express."""


#: an element of a leaf: flat offset ``off`` of leaf number ``leaf``.
LeafRef = namedtuple("LeafRef", "leaf off")
#: an element of a leaf read at run time at ``base + stride * reg``.
DynRef = namedtuple("DynRef", "leaf base stride reg")

_DT = {torch.float32: "f32", torch.float64: "f64", torch.bool: "b",
       torch.int64: "i64", torch.int32: "i64"}
_TORCH = {"f32": torch.float32, "f64": torch.float64, "b": torch.bool,
          "i64": torch.int64}
#: C++ type of each register dtype.
CTYPES = {"f32": "float", "f64": "double", "b": "bool", "i64": "long long"}

#: the latency class of each instruction (``k2f_chain``): "fma" for one
#: dependent add, multiply, compare or select, "div" for a division or a
#: reciprocal, "sqrt" for a square root, "sincos" for a sine, cosine or
#: another transcendental (exp, log, tanh, atan2, pow); reads, literals
#: and casts between integer and boolean take none.
KIND_OF = {
    "add": "fma", "sub": "fma", "mul": "fma", "neg": "fma", "abs": "fma",
    "lt": "fma", "le": "fma", "gt": "fma", "ge": "fma", "eq": "fma",
    "ne": "fma", "where": "fma", "maximum": "fma", "minimum": "fma",
    "clampmin": "fma", "clampmax": "fma", "and": "fma", "or": "fma",
    "xor": "fma", "not": "fma", "isnan": "fma", "isfinite": "fma",
    "isinf": "fma", "cast": "fma", "div": "div", "recip": "div",
    "sqrt": "sqrt", "rsqrt": "sqrt", "sin": "sincos", "cos": "sincos",
    "exp": "sincos", "log": "sincos", "tanh": "sincos", "atan2": "sincos",
    "pow": "sincos", "sigmoid": "sincos", "expm1": "sincos",
    "log1p": "sincos", "iadd": None, "isub": None, "imul": None,
    "ineg": None,
}

_UNARY = {
    "aten.neg.default": "neg", "aten.abs.default": "abs",
    "aten.sin.default": "sin", "aten.cos.default": "cos",
    "aten.exp.default": "exp", "aten.log.default": "log",
    "aten.sqrt.default": "sqrt", "aten.rsqrt.default": "rsqrt",
    "aten.reciprocal.default": "recip", "aten.tanh.default": "tanh",
    "aten.sigmoid.default": "sigmoid", "aten.expm1.default": "expm1",
    "aten.log1p.default": "log1p",
    "aten.logical_not.default": "not", "aten.bitwise_not.default": "not",
    "aten.isnan.default": "isnan", "aten.isinf.default": "isinf",
    "aten.isfinite.default": "isfinite",
}
_BINARY = {
    "aten.add.Tensor": "add", "aten.add.Scalar": "add",
    "aten.sub.Tensor": "sub", "aten.sub.Scalar": "sub",
    "aten.mul.Tensor": "mul", "aten.mul.Scalar": "mul",
    "aten.div.Tensor": "div", "aten.div.Scalar": "div",
    "aten.true_divide.Tensor": "div",
    "aten.maximum.default": "maximum", "aten.minimum.default": "minimum",
    "aten.atan2.default": "atan2",
    "aten.pow.Tensor_Tensor": "pow", "aten.pow.Scalar": "pow",
}
_COMPARE = {
    "aten.lt.Tensor": "lt", "aten.lt.Scalar": "lt",
    "aten.le.Tensor": "le", "aten.le.Scalar": "le",
    "aten.gt.Tensor": "gt", "aten.gt.Scalar": "gt",
    "aten.ge.Tensor": "ge", "aten.ge.Scalar": "ge",
    "aten.eq.Tensor": "eq", "aten.eq.Scalar": "eq",
    "aten.ne.Tensor": "ne", "aten.ne.Scalar": "ne",
}
_LOGICAL = {
    "aten.logical_and.default": "and", "aten.logical_or.default": "or",
    "aten.logical_xor.default": "xor",
    "aten.bitwise_and.Tensor": "and", "aten.bitwise_or.Tensor": "or",
    "aten.bitwise_xor.Tensor": "xor",
}
#: instructions whose result is a bool whatever their operands' dtype.
_PREDICATES = frozenset(("lt", "le", "gt", "ge", "eq", "ne", "isnan",
                         "isinf", "isfinite"))
_VIEWS = ("aten.alias.default", "aten.clone.default",
          "aten.detach.default", "aten.lift_fresh_copy.default",
          "aten.contiguous.default", "aten.view.default",
          "aten._unsafe_view.default", "aten.reshape.default",
          "aten.squeeze.dim", "aten.squeeze.dims", "aten.squeeze.default",
          "aten.flatten.using_ints")
_LIKE = {"aten.zeros_like.default": 0.0, "aten.ones_like.default": 1.0,
         "aten.empty_like.default": 0.0, "aten.new_zeros.default": 0.0,
         "aten.new_ones.default": 1.0, "aten.new_empty.default": 0.0}
_INT_OPS = {operator.add: "iadd", operator.sub: "isub",
            operator.mul: "imul", operator.neg: "ineg"}


class IVal:
    """An integer scalar that depends on the step index: its register and
    its sympy expression in the index's symbol."""

    __slots__ = ("reg", "expr")

    def __init__(self, reg, expr):
        self.reg, self.expr = reg, expr


class Sym:
    """A tensor whose elements are registers or leaf references: ``a`` an
    object array of the tensor's shape, ``dt`` its register dtype."""

    __slots__ = ("a", "dt")

    def __init__(self, a, dt):
        if not isinstance(a, np.ndarray):
            a = _from_list([a], ())
        self.a, self.dt = a, dt


def _dt(dtype):
    try:
        return _DT[dtype]
    except KeyError:
        raise Unsupported("dtype {}".format(dtype)) from None


def _objects(shape, fill=None):
    a = np.empty(shape, dtype=object)
    if fill is not None:
        a.fill(fill)
    return a


def _from_list(items, shape):
    a = np.empty(len(items), dtype=object)
    for k, v in enumerate(items):
        a[k] = v
    return a.reshape(shape)


class Program:
    """A straight-line scalar program.

    ``ops[r]`` is register r's instruction ``(op, dtype, args)``:
    ``("z", T, (k,))``, ``("u", T, (k,))`` and ``("s", T, (k,))`` the
    inputs (s the rolling state's flat elements), ``("i", "i64", ())``
    the step index, ``("ld", T, (leaf, off))`` a leaf's element,
    ``("ldi", T, (leaf, base, stride, r_i))`` a leaf's element at
    ``base + stride * r_i``, ``("const", dt, (value,))`` a literal, the
    rest an operation on registers. ``outputs`` are registers of dtype T,
    ``sizes`` the number of them of each of the program's outputs;
    ``index_ranges`` the sympy conditions under which every run-time
    read is in bounds (``_trace`` turns them into a horizon limit)."""

    def __init__(self, T):
        self.T = T
        self.ops = []
        self.outputs = []
        self.sizes = []
        self.index_ranges = []
        self._cse = {}

    # -- building ------------------------------------------------------
    def emit(self, op, dt, *args):
        key = (op, dt, args)
        r = self._cse.get(key)
        if r is None:
            r = len(self.ops)
            self.ops.append((op, dt, args))
            self._cse[key] = r
        return r

    def const(self, value, dt):
        if dt in ("f32", "f64"):
            v = float(np.float32(value) if dt == "f32" else np.float64(value))
            return self.emit("const", dt, v.hex())
        if dt == "b":
            return self.emit("const", dt, bool(value))
        return self.emit("const", dt, int(value))

    def cast(self, r, dt):
        have = self.ops[r][1]
        if have == dt:
            return r
        op, _, args = self.ops[r]
        if op == "const":
            return self.const(_const_value(self.ops[r]), dt)
        return self.emit("cast", dt, r)

    def reg(self, e, leaf_dts):
        """The register of element ``e`` (reading a leaf where it is
        one), in the leaf's own dtype."""
        if isinstance(e, (int, np.integer)):
            return int(e)
        if isinstance(e, LeafRef):
            r = self.emit("ld", self.T, e.leaf, e.off)
        elif isinstance(e, DynRef):
            r = self.emit("ldi", self.T, e.leaf, e.base, e.stride, e.reg)
        else:
            raise Unsupported("element {!r}".format(e))
        return self.cast(r, leaf_dts[e.leaf])

    # -- after lowering -------------------------------------------------
    def prune(self):
        """Drops the registers no output needs and renumbers the rest."""
        live = set()
        stack = list(self.outputs)
        while stack:
            r = stack.pop()
            if r in live:
                continue
            live.add(r)
            stack.extend(_reg_args(self.ops[r]))
        order = sorted(live)
        new = {r: k for k, r in enumerate(order)}
        ops = []
        for r in order:
            op, dt, args = self.ops[r]
            ops.append((op, dt, _renumber(op, args, new)))
        self.ops = ops
        self.outputs = [new[r] for r in self.outputs]
        self._cse = {}
        return self

    def leaf_reads(self):
        """{leaf: "static" or "dynamic"}: how this program reads each
        leaf it reads."""
        out = {}
        for op, _, args in self.ops:
            if op == "ld":
                out.setdefault(args[0], "static")
            elif op == "ldi":
                out[args[0]] = "dynamic"
        return out

    def op_count(self):
        """Arithmetic instructions (reads, literals and integer index
        arithmetic excluded): the operations of one evaluation."""
        return sum(1 for op, _, _ in self.ops if KIND_OF.get(op))

    def chain(self, latency, ready=None, n_outputs=None):
        """The longest dependent chain to the outputs at the depth the
        function needs, not the printed order's: (cycles, {kind: count})
        with ``latency[kind]`` cycles an instruction of each kind
        (``KIND_OF``); ``ready[(name, k)]`` the cycle at which input
        ``z``/``u``/``s`` element k arrives (default 0); over the first
        ``n_outputs`` outputs (default all), the longest. A sum (adds and
        subtractions, and an ``all``'s ands and ors) is a tree, combining
        its two earliest terms first, and a product that is a term fuses
        into its add (an FMA); a select takes its later branch's time and
        its condition none (the run's data fixes it: a jitter ladder
        costs its first rung, with no select or refactorization chain
        behind it). ``counts["from"]`` names the input the chain starts
        at, where it starts at one."""
        ready = ready or {}
        t = [0] * len(self.ops)
        counts = [{}] * len(self.ops)
        for r, (op, dt, args) in enumerate(self.ops):
            if op in ("z", "u", "s"):
                t[r], counts[r] = ready.get((op, args[0]), 0), {"from": op}
            elif op == "where":
                a = max(args[1:], key=lambda a: t[a])
                t[r], counts[r] = t[a], counts[a]
            elif _tree_class(op, dt) is not None:
                t[r], counts[r] = self._tree(r, t, counts, latency)
            else:
                kind = KIND_OF.get(op)
                if op == "cast" and dt in ("b", "i64"):
                    kind = None
                regs = _reg_args(self.ops[r])
                if not regs:
                    continue
                a = max(regs, key=lambda a: t[a])
                t[r], counts[r] = t[a], dict(counts[a])
                if kind:
                    t[r] += latency[kind]
                    counts[r][kind] = counts[r].get(kind, 0) + 1
        outputs = self.outputs[:n_outputs]
        if not outputs:
            return 0, {}
        r = max(outputs, key=lambda o: t[o])
        return t[r], dict(counts[r])

    def _tree(self, r, t, counts, latency):
        """(cycles, counts) of register r, a sum or an and/or, as the
        tree of its terms that ends soonest."""
        cls = _tree_class(*self.ops[r][:2])
        terms, stack = [], [r]
        while stack:
            op, dt, args = self.ops[stack.pop()]
            for a in args:
                if _tree_class(*self.ops[a][:2]) == cls:
                    stack.append(a)
                elif cls == "sum" and self.ops[a][0] == "mul":
                    f = max(self.ops[a][2], key=lambda x: t[x])
                    terms.append((t[f], len(terms), counts[f]))
                else:
                    terms.append((t[a], len(terms), counts[a]))
        heapq.heapify(terms)
        while len(terms) > 1:
            a, b = heapq.heappop(terms), heapq.heappop(terms)
            c = dict(b[2])
            c["fma"] = c.get("fma", 0) + 1
            heapq.heappush(terms, (b[0] + latency["fma"], b[1], c))
        return terms[0][0], terms[0][2]

    # -- interpreter ----------------------------------------------------
    def run(self, leaves, z=None, u=None, i=0, s=None):
        """The program in torch, vectorised over candidates: ``leaves``
        the leaf tensors (any shape; read flat), ``z`` (A, nz), ``u``
        (A, nu), ``s`` (A, n_state) the flat rolling state, ``i`` the
        step. Returns (A, n_outputs) in T; a program of several outputs
        returns one (A, size) tensor for each."""
        T = _TORCH[self.T]
        flat = [t.detach().reshape(-1).to(T) for t in leaves]
        first = next(x for x in (z, u, s) if x is not None)
        A, device = first.shape[0], first.device
        v = [None] * len(self.ops)
        for r, (op, dt, args) in enumerate(self.ops):
            if op == "z":
                v[r] = z[:, args[0]]
            elif op == "u":
                v[r] = u[:, args[0]]
            elif op == "s":
                v[r] = s[:, args[0]]
            elif op == "i":
                v[r] = torch.tensor(int(i), dtype=torch.int64, device=device)
            elif op == "ld":
                v[r] = flat[args[0]][args[1]]
            elif op == "ldi":
                leaf, base, stride, ri = args
                v[r] = flat[leaf][base + stride * int(v[ri])]
            elif op == "const":
                v[r] = torch.tensor(_const_value(self.ops[r]),
                                    dtype=_TORCH[dt], device=device)
            else:
                v[r] = _RUN[op](*(v[a] for a in args)) if op != "cast" \
                    else v[args[0]].to(_TORCH[dt])
                if op != "cast" and v[r].dtype != _TORCH[dt]:
                    v[r] = v[r].to(_TORCH[dt])
        out = torch.stack([v[o].to(T).expand(A) for o in self.outputs],
                          dim=-1)
        if len(self.sizes) > 1:
            return tuple(out.split(self.sizes, dim=-1))
        return out


def _const_value(instr):
    op, dt, args = instr
    if dt in ("f32", "f64"):
        return float.fromhex(args[0])
    return args[0]


def _reg_args(instr):
    op, _, args = instr
    if op in ("z", "u", "s", "i", "ld", "const"):
        return ()
    if op == "ldi":
        return (args[3],)
    return args


def _tree_class(op, dt):
    """"sum" for a float add or subtraction, "logic" for an and or an or,
    else None: the operations ``Program.chain`` reassociates."""
    if op in ("add", "sub") and dt in ("f32", "f64"):
        return "sum"
    if op in ("and", "or"):
        return "logic"
    return None


def _renumber(op, args, new):
    if op in ("z", "u", "s", "i", "ld", "const"):
        return args
    if op == "ldi":
        return args[:3] + (new[args[3]],)
    return tuple(new[a] for a in args)


# The interpreter's operations: each the torch function of the same IEEE
# arithmetic as the printed C++ (``_C``).
_RUN = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "neg": torch.neg, "abs": torch.abs,
    "sin": torch.sin, "cos": torch.cos, "exp": torch.exp,
    "log": torch.log, "sqrt": torch.sqrt,
    "rsqrt": lambda x: 1 / torch.sqrt(x),
    "recip": lambda x: 1 / x, "tanh": torch.tanh,
    "sigmoid": torch.sigmoid, "expm1": torch.expm1, "log1p": torch.log1p,
    "atan2": torch.atan2, "pow": torch.pow,
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    "eq": torch.eq, "ne": torch.ne,
    "and": torch.logical_and, "or": torch.logical_or,
    "xor": torch.logical_xor, "not": torch.logical_not,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "where": torch.where, "maximum": torch.maximum,
    "minimum": torch.minimum,
    "clampmin": lambda x, lo: torch.where(x < lo, lo, x),
    "clampmax": lambda x, hi: torch.where(hi < x, hi, x),
    "iadd": torch.add, "isub": torch.sub, "imul": torch.mul,
    "ineg": torch.neg,
}


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------


class _Lowering:
    def __init__(self, program, leaf_dts):
        self.p = program
        self.leaf_dts = leaf_dts

    # -- values ---------------------------------------------------------
    def sym(self, v, dt=None):
        """``v`` (a Sym, a concrete tensor, a number or an IVal) as a
        Sym; cast to ``dt`` where given."""
        if isinstance(v, Sym):
            if dt is None or dt == v.dt:
                return v
            a = _objects(v.a.shape)
            for idx, e in np.ndenumerate(v.a):
                a[idx] = self.p.cast(self.p.reg(e, self.leaf_dts), dt)
            return Sym(a, dt)
        if isinstance(v, IVal):
            a = _objects(())
            a[()] = self.p.cast(v.reg, dt or "i64")
            return Sym(a, dt or "i64")
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            have = _dt(t.dtype)
            dt = dt or have
            a = _objects(tuple(t.shape))
            vals = t.numpy() if t.dtype != torch.bfloat16 else None
            if vals is None:
                raise Unsupported("bfloat16 constant")
            for idx, x in np.ndenumerate(vals):
                a[idx] = self.p.cast(self.p.const(x.item(), have), dt)
            return Sym(a, dt)
        if isinstance(v, (bool, int, float)):
            have = ("b" if isinstance(v, bool) else
                    "i64" if isinstance(v, int) else "f64")
            a = _objects(())
            a[()] = self.p.cast(self.p.const(v, have), dt or have)
            return Sym(a, dt or have)
        raise Unsupported("value {!r}".format(type(v)))

    def regs(self, v, dt, shape):
        """``v`` broadcast to ``shape`` as an array of registers of
        ``dt``."""
        if isinstance(v, (bool, int, float)):
            r = self.p.const(v, dt)
            return np.broadcast_to(_from_list([r], ()), shape)
        s = self.sym(v)
        a = np.broadcast_to(s.a, shape)
        out = _objects(shape)
        for idx, e in np.ndenumerate(a):
            out[idx] = self.p.cast(self.p.reg(e, self.leaf_dts), dt)
        return out

    def elementwise(self, op, inputs, out_dt, compute_dt, shape):
        arrs = [self.regs(v, compute_dt, shape) for v in inputs]
        res_dt = "b" if op in _PREDICATES else compute_dt
        out = _objects(shape)
        for idx in np.ndindex(*shape):
            r = self.p.emit(op, res_dt, *(a[idx] for a in arrs))
            out[idx] = self.p.cast(r, out_dt)
        return Sym(out, out_dt)

    def reduce(self, op, v, dims, out_dt, shape):
        """``op`` folded over ``dims`` (all where None) in index order;
        ``shape`` the result's (with or without the kept dims)."""
        s = self.sym(v)
        nd = s.a.ndim
        dims = sorted({d % nd for d in dims} if dims else set(range(nd)))
        keep = [d for d in range(nd) if d not in dims]
        a = np.transpose(s.a, keep + dims)
        lead = a.shape[:len(keep)]
        a = a.reshape(lead + (-1,))
        out = _objects(lead)
        for idx in np.ndindex(*lead):
            acc = None
            for e in a[idx]:
                r = self.p.cast(self.p.reg(e, self.leaf_dts), out_dt)
                acc = r if acc is None else self.p.emit(op, out_dt, acc, r)
            if acc is None:
                acc = self.p.const({"add": 0, "mul": 1, "and": True,
                                    "or": False}[op], out_dt)
            out[idx] = acc
        return Sym(out.reshape(shape), out_dt)

    def matmul(self, a, b, out_dt, shape):
        """(..., n, k) @ (..., k, m) batched (2-D or 3-D), as add chains
        over k in order."""
        A = self.regs(a, out_dt, self.sym(a).a.shape)
        B = self.regs(b, out_dt, self.sym(b).a.shape)
        if A.ndim == 2:
            A, B = A[None], B[None]
        n, k, m = A.shape[1], A.shape[2], B.shape[2]
        out = _objects((A.shape[0], n, m))
        for bi in range(A.shape[0]):
            for r in range(n):
                for c in range(m):
                    acc = None
                    for j in range(k):
                        prod = self.p.emit("mul", out_dt, A[bi, r, j],
                                           B[bi, j, c])
                        acc = prod if acc is None else self.p.emit(
                            "add", out_dt, acc, prod)
                    out[bi, r, c] = acc if acc is not None else \
                        self.p.const(0, out_dt)
        return Sym(out.reshape(shape), out_dt)

    # -- one node -------------------------------------------------------
    def node(self, target, args, kwargs, meta):
        name = str(target)
        leaves = torch.utils._pytree.tree_leaves((args, kwargs))
        symbolic = any(isinstance(x, (Sym, IVal)) for x in leaves)
        if target in _INT_OPS:
            return self.int_op(target, args, meta)
        if target is operator.getitem:
            return args[0][args[1]]
        if not symbolic and name not in _LIKE:
            return _fold(target, args, kwargs)
        shape = tuple(meta.shape) if isinstance(meta, torch.Tensor) else None
        out_dt = _dt(meta.dtype) if isinstance(meta, torch.Tensor) else None
        x = args[0] if args else None

        if name in _LIKE:
            return _fold_like(name, meta)
        if name == "aten.full_like.default":
            return torch.full(shape, args[1], dtype=meta.dtype)
        if name == "aten.new_full.default":
            return torch.full(shape, args[2], dtype=meta.dtype)
        if name == "aten.scalar_tensor.default":
            return self.sym(x, out_dt)
        if name in _VIEWS:
            s = self.sym(x)
            return Sym(s.a.reshape(shape), s.dt)
        if name == "aten._to_copy.default":
            return self.sym(x, out_dt)
        if name == "aten.copy.default":
            src = self.sym(args[1], out_dt)
            return Sym(np.broadcast_to(src.a, shape).copy(), out_dt)
        if name == "aten.expand.default":
            s = self.sym(x)
            return Sym(np.broadcast_to(s.a, shape), s.dt)
        if name == "aten.permute.default":
            s = self.sym(x)
            return Sym(np.transpose(s.a, args[1]), s.dt)
        if name == "aten.transpose.int":
            s = self.sym(x)
            return Sym(np.swapaxes(s.a, args[1], args[2]), s.dt)
        if name in ("aten.t.default", "aten.numpy_T.default"):
            s = self.sym(x)
            return Sym(s.a.T, s.dt)
        if name == "aten.unsqueeze.default":
            s = self.sym(x)
            return Sym(np.expand_dims(s.a, args[1] % (s.a.ndim + 1)), s.dt)
        if name == "aten.select.int":
            return self.select(self.sym(x), args[1], args[2])
        if name == "aten.slice.Tensor":
            s = self.sym(x)
            dim, start, end, step = _defaults(args, (0, None, None, 1))
            if any(isinstance(v, IVal) for v in (start, end, step)):
                raise Unsupported("slice by the step index")
            idx = [slice(None)] * s.a.ndim
            idx[dim] = slice(start, end, step)
            return Sym(s.a[tuple(idx)], s.dt)
        if name == "aten.unbind.int":
            s = self.sym(x)
            dim = args[1] if len(args) > 1 else 0
            return [Sym(np.take(s.a, k, axis=dim), s.dt)
                    for k in range(s.a.shape[dim])]
        if name == "aten.diagonal.default":
            s = self.sym(x)
            off, d1, d2 = _defaults(args, (0, 0, 1))
            return Sym(np.diagonal(s.a, off, d1, d2).copy(), s.dt)
        if name == "aten.diag_embed.default":
            if len(args) > 1 and tuple(args[1:]) not in ((0,), (0, -2),
                                                         (0, -2, -1)):
                raise Unsupported("diag_embed off its default diagonal")
            s = self.sym(x)
            out = _objects(shape, self.p.const(0, s.dt))
            n = s.a.shape[-1]
            for k in range(n):
                out[..., k, k] = s.a[..., k]
            return Sym(out, s.dt)
        if name in ("aten.stack.default", "aten.cat.default"):
            parts = [self.sym(t, out_dt) for t in x]
            dim = args[1] if len(args) > 1 else 0
            if name == "aten.stack.default":
                return Sym(np.stack([p.a for p in parts],
                                    axis=dim % (parts[0].a.ndim + 1)), out_dt)
            parts = [p for p in parts if p.a.size or p.a.ndim > 1]
            return Sym(np.concatenate([p.a for p in parts], axis=dim), out_dt)
        if name == "aten.index.Tensor":
            s = self.sym(x)
            return Sym(s.a[_np_index(args[1])], s.dt)
        if name in ("aten.index_put.default", "aten.index_put_.default"):
            if len(args) > 3 and args[3]:
                raise Unsupported("index_put with accumulate")
            s = self.sym(x, out_dt)
            vals = self.sym(args[2], out_dt)
            out = s.a.copy()
            idx = _np_index(args[1])
            out[idx] = np.broadcast_to(vals.a, out[idx].shape)
            return Sym(out, out_dt)
        if name == "aten.index_select.default":
            s = self.sym(x)
            return Sym(np.take(s.a, _concrete(args[2]).numpy(),
                               axis=args[1]), s.dt)
        if name == "aten.gather.default":
            s = self.sym(x)
            return Sym(np.take_along_axis(s.a, _concrete(args[2]).numpy(),
                                          axis=args[1]), s.dt)
        if name == "aten.masked_fill.Scalar":
            return self.where(args[1], args[2], x, out_dt, shape)
        if name in ("aten.where.self", "aten.where.ScalarSelf",
                    "aten.where.ScalarOther", "aten.where.Scalar"):
            return self.where(x, args[1], args[2], out_dt, shape)
        if name in _UNARY:
            op = _UNARY[name]
            if op in ("not", "isnan", "isinf", "isfinite"):
                cdt = "b" if op == "not" else self.sym(x).dt
            else:
                cdt = out_dt
            return self.elementwise(op, [x], out_dt, cdt, shape)
        if name in ("aten.add.Tensor", "aten.sub.Tensor") and \
                kwargs.get("alpha", 1) != 1:
            b = self.elementwise("mul", [args[1], kwargs["alpha"]], out_dt,
                                 out_dt, shape)
            return self.elementwise(_BINARY[name], [x, b], out_dt, out_dt,
                                    shape)
        if name in _BINARY:
            return self.elementwise(_BINARY[name], list(args[:2]), out_dt,
                                    out_dt, shape)
        if name == "aten.rsub.Scalar":
            return self.elementwise("sub", [args[1], x], out_dt, out_dt,
                                    shape)
        if name == "aten.pow.Tensor_Scalar":
            return self.pow(x, args[1], out_dt, shape)
        if name == "aten.square.default":
            return self.elementwise("mul", [x, x], out_dt, out_dt, shape)
        if name in _COMPARE:
            cdt = _dt(_result_type(args[:2]))
            return self.elementwise(_COMPARE[name], list(args[:2]), "b",
                                    cdt, shape)
        if name in _LOGICAL:
            return self.elementwise(_LOGICAL[name], list(args[:2]), out_dt,
                                    "b", shape)
        if name in ("aten.clamp.default", "aten.clamp.Tensor",
                    "aten.clamp_min.default", "aten.clamp_max.default",
                    "aten.clamp_min.Tensor", "aten.clamp_max.Tensor"):
            lo = hi = None
            if name.startswith("aten.clamp."):
                lo = args[1] if len(args) > 1 else kwargs.get("min")
                hi = args[2] if len(args) > 2 else kwargs.get("max")
            elif "clamp_min" in name:
                lo = args[1]
            else:
                hi = args[1]
            v = x
            if lo is not None:
                v = self.elementwise("clampmin", [v, lo], out_dt, out_dt,
                                     shape)
            if hi is not None:
                v = self.elementwise("clampmax", [v, hi], out_dt, out_dt,
                                     shape)
            return self.sym(v, out_dt)
        if name in ("aten.sum.dim_IntList", "aten.sum.default"):
            dims = args[1] if len(args) > 1 else None
            return self.reduce("add", x, dims, out_dt, shape)
        if name in ("aten.mean.dim", "aten.mean.default"):
            dims = args[1] if len(args) > 1 else None
            s = self.sym(x)
            total = self.reduce("add", x, dims, out_dt, shape)
            count = s.a.size // max(1, int(np.prod(shape, dtype=np.int64)))
            return self.elementwise("div", [total, float(count)], out_dt,
                                    out_dt, shape)
        if name in ("aten.prod.dim_int", "aten.prod.default"):
            dims = [args[1]] if len(args) > 1 else None
            return self.reduce("mul", x, dims, out_dt, shape)
        if name in ("aten.all.dim", "aten.all.dims", "aten.all.default",
                    "aten.any.dim", "aten.any.dims", "aten.any.default"):
            dims = args[1] if len(args) > 1 else None
            if isinstance(dims, int):
                dims = [dims]
            b = self.sym(x, "b")
            return self.reduce("and" if ".all." in name else "or", b, dims,
                               "b", shape)
        if name in ("aten.amax.default", "aten.amin.default"):
            dims = args[1] if len(args) > 1 else None
            op = "maximum" if "amax" in name else "minimum"
            return self.reduce(op, x, dims, out_dt, shape)
        if name in ("aten.mm.default", "aten.bmm.default"):
            return self.matmul(x, args[1], out_dt, shape)
        if name == "aten.mv.default":
            b = self.sym(args[1])
            col = Sym(b.a.reshape(-1, 1), b.dt)
            return self.matmul(x, col, out_dt, shape)
        if name == "aten.dot.default":
            a, b = self.sym(x), self.sym(args[1])
            return self.matmul(Sym(a.a.reshape(1, -1), a.dt),
                               Sym(b.a.reshape(-1, 1), b.dt), out_dt, shape)
        raise Unsupported("op {}".format(name))

    def int_op(self, target, args, meta):
        vals = [a for a in args]
        if not any(isinstance(v, IVal) for v in vals):
            return target(*vals)
        regs = [v.reg if isinstance(v, IVal) else self.p.const(v, "i64")
                for v in vals]
        if not isinstance(meta, torch.SymInt):
            raise Unsupported("step-index arithmetic that specialized")
        return IVal(self.p.emit(_INT_OPS[target], "i64", *regs),
                    meta.node.expr)

    def select(self, s, dim, idx):
        dim %= s.a.ndim
        if not isinstance(idx, IVal):
            return Sym(np.take(s.a, idx, axis=dim), s.dt)
        L = s.a.shape[dim]
        a = np.moveaxis(s.a, dim, -1)
        out = _objects(a.shape[:-1])
        for pos in np.ndindex(*a.shape[:-1]):
            seq = a[pos]
            first = seq[0]
            if not all(isinstance(e, LeafRef) and e.leaf == first.leaf
                       for e in seq):
                raise Unsupported("a select by the step index of a value "
                                  "that is not a model or cost tensor")
            stride = seq[1].off - first.off if L > 1 else 0
            if any(e.off != first.off + k * stride for k, e in
                   enumerate(seq)):
                raise Unsupported("a select by the step index along "
                                  "an irregular layout")
            out[pos] = DynRef(first.leaf, first.off, stride, idx.reg)
        self.p.index_ranges.append((idx.expr, L))
        return Sym(out, s.dt)

    def where(self, c, a, b, out_dt, shape):
        cond = self.regs(self.sym(c, "b"), "b", shape)
        A = self.regs(a, out_dt, shape)
        B = self.regs(b, out_dt, shape)
        out = _objects(shape)
        for idx in np.ndindex(*shape):
            out[idx] = self.p.emit("where", out_dt, cond[idx], A[idx], B[idx])
        return Sym(out, out_dt)

    def pow(self, x, e, out_dt, shape):
        if isinstance(e, IVal):
            return self.elementwise("pow", [x, e], out_dt, out_dt, shape)
        e = float(e)
        xs = self.sym(x, out_dt)
        if e == 2.0:
            return self.elementwise("mul", [xs, xs], out_dt, out_dt, shape)
        if e == 3.0:
            sq = self.elementwise("mul", [xs, xs], out_dt, out_dt, shape)
            return self.elementwise("mul", [sq, xs], out_dt, out_dt, shape)
        if e == 0.5:
            return self.elementwise("sqrt", [xs], out_dt, out_dt, shape)
        if e == -0.5:
            return self.elementwise("rsqrt", [xs], out_dt, out_dt, shape)
        if e == 1.0:
            return xs
        if e == -1.0:
            return self.elementwise("recip", [xs], out_dt, out_dt, shape)
        if e == -2.0:
            sq = self.elementwise("mul", [xs, xs], out_dt, out_dt, shape)
            return self.elementwise("recip", [sq], out_dt, out_dt, shape)
        if e == 0.0:
            return self.sym(torch.ones(shape, dtype=_TORCH[out_dt]))
        return self.elementwise("pow", [xs, e], out_dt, out_dt, shape)


def _defaults(args, defaults):
    """``args[1:]`` completed by ``defaults``."""
    given = list(args[1:])
    return tuple(given + list(defaults[len(given):]))


def _result_type(args):
    """torch's promoted dtype of the operands (a 0-d tensor ranks below
    a tensor with dims, as in torch)."""
    probes = []
    for a in args:
        if isinstance(a, Sym):
            probes.append(torch.empty((1,) * min(1, a.a.ndim),
                                      dtype=_TORCH[a.dt]))
        elif isinstance(a, IVal):
            probes.append(1)
        elif isinstance(a, torch.Tensor):
            probes.append(torch.empty((1,) * min(1, a.dim()),
                                      dtype=a.dtype))
        else:
            probes.append(a)
    return torch.result_type(*probes)


def _concrete(t):
    if isinstance(t, (Sym, IVal)):
        raise Unsupported("an index that depends on the inputs")
    return t.detach().cpu()


def _np_index(indices):
    out = []
    for t in indices:
        if t is None:
            out.append(slice(None))
        else:
            t = _concrete(t)
            out.append(t.numpy() if t.dtype == torch.bool
                       else t.to(torch.int64).numpy())
    return tuple(out)


def _cpu_kwargs(kwargs):
    kw = dict(kwargs)
    if "device" in kw:
        kw["device"] = torch.device("cpu")
    kw.pop("pin_memory", None)
    return kw


def _fold(target, args, kwargs):
    """An op on concrete values: computed now, on the CPU."""
    args = torch.utils._pytree.tree_map(
        lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
        args)
    with torch.no_grad():
        return target(*args, **_cpu_kwargs(kwargs))


def _fold_like(name, meta):
    value = _LIKE[name]
    return torch.full(tuple(meta.shape), value, dtype=meta.dtype)


def lower(gm, leaf_dtypes, T, inputs):
    """The scalar program of the traced GraphModule ``gm``.

    ``gm``'s placeholders are the leaves, then ``inputs`` in order, each
    "z", "u", "i" or "s" (a leaf of the rolling state, of any shape: its
    elements follow those of the state's leaves before it);
    ``leaf_dtypes`` the leaves' dtypes; ``T`` the trace's dtype. The
    output is a tensor of any shape in T (flattened into ``outputs``), or
    a tuple of several (each flattened in turn; ``sizes``)."""
    T = _dt(T)
    prog = Program(T)
    low = _Lowering(prog, [_dt(d) for d in leaf_dtypes])
    env = {}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    n_leaves = len(placeholders) - len(inputs)
    n_state = 0
    for k, n in enumerate(placeholders):
        meta = n.meta.get("val")
        if k < n_leaves:
            shape = tuple(meta.shape)
            a = _from_list([LeafRef(k, off) for off in
                            range(int(np.prod(shape, dtype=np.int64)))],
                           shape)
            env[n] = Sym(a, _dt(meta.dtype))
            continue
        kind = inputs[k - n_leaves]
        if kind == "i":
            env[n] = IVal(prog.emit("i", "i64"), meta.node.expr)
        elif kind == "s":
            shape = tuple(meta.shape)
            size = int(np.prod(shape, dtype=np.int64))
            a = _from_list([prog.emit("s", T, n_state + j)
                            for j in range(size)], shape)
            n_state += size
            env[n] = Sym(a, T)
        else:
            size = int(meta.shape[0])
            a = _from_list([prog.emit(kind, T, j) for j in range(size)],
                           (size,))
            env[n] = Sym(a, T)
    result = None
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            continue
        if n.op == "get_attr":
            env[n] = getattr(gm, n.target).detach().cpu()
            continue
        if n.op == "output":
            result = torch.fx.node.map_arg(n.args[0], lambda m: env[m])
            break
        if n.op != "call_function":
            raise Unsupported("graph node {}".format(n.op))
        args = torch.fx.node.map_arg(n.args, lambda m: env[m])
        kwargs = torch.fx.node.map_arg(n.kwargs, lambda m: env[m])
        env[n] = low.node(n.target, args, kwargs, n.meta.get("val"))
    results = (list(result) if isinstance(result, (tuple, list))
               else [result])
    for res in results:
        out = low.sym(res)
        prog.outputs += [prog.cast(prog.reg(e, low.leaf_dts), T)
                         for e in out.a.reshape(-1)]
        prog.sizes.append(out.a.size)
    return prog.prune()


# ---------------------------------------------------------------------------
# Printer
# ---------------------------------------------------------------------------

_C = {
    "add": "{0} + {1}", "sub": "{0} - {1}", "mul": "{0} * {1}",
    "div": "{0} / {1}", "neg": "-{0}", "abs": "pddp_tr::abs_({0})",
    "sin": "pddp_tr::sin_({0})", "cos": "pddp_tr::cos_({0})",
    "exp": "pddp_tr::exp_({0})", "log": "pddp_tr::log_({0})",
    "sqrt": "pddp_tr::sqrt_({0})", "rsqrt": "{T}(1) / pddp_tr::sqrt_({0})",
    "recip": "{T}(1) / {0}", "tanh": "pddp_tr::tanh_({0})",
    "sigmoid": "{T}(1) / ({T}(1) + pddp_tr::exp_(-{0}))",
    "expm1": "pddp_tr::expm1_({0})", "log1p": "pddp_tr::log1p_({0})",
    "atan2": "pddp_tr::atan2_({0}, {1})", "pow": "pddp_tr::pow_({0}, {1})",
    "lt": "{0} < {1}", "le": "{0} <= {1}", "gt": "{0} > {1}",
    "ge": "{0} >= {1}", "eq": "{0} == {1}", "ne": "{0} != {1}",
    "and": "{0} && {1}", "or": "{0} || {1}", "xor": "{0} != {1}",
    "not": "!{0}", "isnan": "pddp_tr::isnan_({0})",
    "isinf": "pddp_tr::isinf_({0})", "isfinite": "pddp_tr::isfinite_({0})",
    "where": "{0} ? {1} : {2}",
    "maximum": "pddp_tr::maximum_({0}, {1})",
    "minimum": "pddp_tr::minimum_({0}, {1})",
    "clampmin": "{0} < {1} ? {1} : {0}", "clampmax": "{1} < {0} ? {1} : {0}",
    "iadd": "{0} + {1}", "isub": "{0} - {1}", "imul": "{0} * {1}",
    "ineg": "-{0}",
}


def _literal(instr):
    op, dt, args = instr
    v = _const_value(instr)
    if dt in ("f32", "f64"):
        ct = CTYPES[dt]
        if math.isnan(v):
            return "pddp_tr::nan_<{}>()".format(ct)
        if math.isinf(v):
            return "{}pddp_tr::inf_<{}>()".format("-" if v < 0 else "", ct)
        return "{}({})".format(ct, v.hex())
    if dt == "b":
        return "true" if v else "false"
    return "{}LL".format(int(v))


def _body(prog, layout, out_stmt, exact_mul=False):
    """The C++ statements of ``prog``: one const register a line, then
    ``out_stmt(k, reg_name)`` for each output. ``exact_mul``: each product
    through ``pddp_tr::mul_``, which no compiler contracts into an FMA
    (for a source built with contraction on)."""
    lines = []
    for r, instr in enumerate(prog.ops):
        op, dt, args = instr
        ct = CTYPES[dt]
        if op == "z":
            rhs = "z[{}]".format(args[0])
        elif op == "u":
            rhs = "u[{}]".format(args[0])
        elif op == "s":
            rhs = "s[{}]".format(args[0])
        elif op == "i":
            rhs = "static_cast<long long>(i)"
        elif op == "ld":
            buf, off = layout[args[0]]
            rhs = "{}[{}]".format(buf, off + args[1])
        elif op == "ldi":
            leaf, base, stride, ri = args
            buf, off = layout[leaf]
            rhs = "{}[{} + {} * r{}]".format(buf, off + base, stride, ri)
        elif op == "const":
            rhs = _literal(instr)
        elif op == "cast":
            rhs = "static_cast<{}>(r{})".format(ct, args[0])
        elif op == "mul" and exact_mul and dt in ("f32", "f64"):
            rhs = "pddp_tr::mul_(r{}, r{})".format(*args)
        else:
            rhs = _C[op].format(*("r{}".format(a) for a in args), T=ct)
        lines.append("    const {} r{} = {};".format(ct, r, rhs))
    for k, r in enumerate(prog.outputs):
        lines.append("    " + out_stmt(k, "r{}".format(r)))
    return "\n".join(lines)


def print_struct(name, T, nz, nu, step, stage=None, terminal=None,
                 layout=None, n_static=0, n_dynamic=0, chain_note="",
                 n_state=0, exact_mul=False, what=None):
    """The C++ ``struct`` of a rollout's traced programs: ``step`` (z, u,
    i -> the next z), and where the kernel carries the cost ``stage``
    (z, u, i -> cost) and ``terminal`` (z, N -> cost). ``layout[leaf]``
    is (buffer, offset): "p", the static leaves (shared memory in the
    kernel), or "w", the leaves read by the step index (global memory).
    PDDP_HD (``traced_rollout.cuh``) is __host__ __device__ under nvcc and
    empty otherwise, so the same text builds with g++.

    A stateful step (K2(g); ``step.sizes`` more than one output) is
    printed as ``step(p, w, z, u, i, s, zn, sn, an)``: s the rolling
    state's ``n_state`` flat elements, sn the next state's, an the step's
    aux (``n_aux``, the outputs after the next state's). ``what`` names
    the programs in the first comment line (default: the model's and the
    cost's); ``exact_mul`` see ``_body``."""
    ct = CTYPES[_dt(T)]
    has_cost = stage is not None
    stateful = len(step.sizes) > 1
    parts = [
        "// Traced from {} torch code "
        "(pddp_tpu_torch/ops/_trace.py).".format(
            what or "the model's and the cost's"),
    ]
    if chain_note:
        parts.append("// " + chain_note)
    parts += [
        "struct {} {{".format(name),
        "  using T = {};".format(ct),
        "  static constexpr int nz = {}, nu = {};".format(nz, nu),
        "  static constexpr long n_static = {}, n_dynamic = {};".format(
            n_static, n_dynamic),
        "  static constexpr bool has_cost = {};".format(
            "true" if has_cost else "false"),
    ]
    if stateful:
        n_aux = len(step.outputs) - nz - n_state

        def out(k, r):
            if k < nz:
                return "zn[{}] = {};".format(k, r)
            if k < nz + n_state:
                return "sn[{}] = {};".format(k - nz, r)
            return "an[{}] = {};".format(k - nz - n_state, r)
        parts += [
            "  static constexpr int n_state = {}, n_aux = {};".format(
                n_state, n_aux),
            "  static PDDP_HD void step(const T* __restrict__ p, "
            "const T* __restrict__ w, const T* z, const T* u, int i, "
            "const T* s, T* zn, T* sn, T* an) {",
            _body(step, layout, out, exact_mul),
            "  }",
        ]
    else:
        parts += [
            "  static PDDP_HD void step(const T* __restrict__ p, "
            "const T* __restrict__ w, const T* z, const T* u, int i, "
            "T* zn) {",
            _body(step, layout, lambda k, r: "zn[{}] = {};".format(k, r),
                  exact_mul),
            "  }",
        ]
    if has_cost:
        parts += [
            "  static PDDP_HD T stage_cost(const T* __restrict__ p, "
            "const T* __restrict__ w, const T* z, const T* u, int i) {",
            _body(stage, layout, lambda k, r: "return {};".format(r)),
            "  }",
            "  static PDDP_HD T terminal_cost(const T* __restrict__ p, "
            "const T* __restrict__ w, const T* z, int i) {",
            _body(terminal, layout, lambda k, r: "return {};".format(r)),
            "  }",
        ]
    parts.append("};")
    return "\n".join(parts) + "\n"
