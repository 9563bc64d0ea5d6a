"""K2(f) and K2(g): the line search of any stateless model and cost (f),
or of a stateful model (g), in one CUDA kernel, the model's step and the
cost traced from their own torch code.

Port of ``pddp_tpu/ops/fused_rollout.py:fused_control_law`` for what the
hand-written stages (a)-(e) do not carry: Pallas traced any model's and
cost's jnp code into its kernel, stateful models included; here
``ops/_trace.py`` traces their torch code (``make_fx``),
``ops/_scalar.py`` prints it as the ``struct Traced`` of a generated
``.cu``, and ``csrc/traced_rollout.cuh``, written by hand, runs it: the
rollout loop, the staging of the nominal rows, the feedback law, the
clamp, the sum of the cost and, for a stateful model, its rolling state
in registers and its aux written out. ``_build.load_library`` compiles
each (step, cost, codec, dtype) with ``nvcc`` at its first use, into
``build/`` beside the package.

The gate (``supports``) is ``pddp_tpu``'s: every stateless model (its
``init_state()`` and ``aux_zero()`` are ``()``), and with
``allow_stateful`` every stateful one (K2(g)), under the matrix codecs up
to a state size of ``SMALL_N``; and, here, only where the trace succeeds
(``ops/_trace.py`` lists what it refuses: a Python branch on a tensor's
value or on the step index, a tensor that is not an attribute, an op
outside the lowering's table, a state or aux that is not a nest of
floating tensors). Under IGNORE_UNCERTAINTY the cost is traced and summed
in the kernel; under the belief codecs the kernel returns trajectories
and the cost is a batched post-pass.

The plain version is ``controllers.ilqr.control_law``, as for (a)-(e).
On CPU tensors the wrapper runs it; on CUDA tensors it launches K2(f) or
K2(g) or raises (a failed build or launch included).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..controllers.ilqr import control_law, trajectory_cost
from ..encoding import StateEncoding, infer_encoded_state_size
from . import _trace
from ._build import load_library
from ._trace import Unsupported

__all__ = ["supports", "traced_control_law", "traced", "source_text",
           "launches"]

#: launches made by ``traced_control_law``: K2(f) ("rollout") and K2(g)
#: ("stateful").
launches = {"rollout": 0, "stateful": 0}

_LIBS: dict = {}


def _kernel_cost(cost, encoding):
    """The cost the kernel carries: the cost under IGNORE_UNCERTAINTY,
    else None (a post-pass)."""
    return cost if encoding == StateEncoding.IGNORE_UNCERTAINTY else None


def _gate_dtype(model, cost):
    dtype = None
    for obj in (model, cost):
        for t in _trace.leaves_of(obj)[0] if obj is not None else ():
            if t.is_floating_point():
                dtype = t.dtype if dtype is None else torch.promote_types(
                    dtype, t.dtype)
    return dtype or torch.float32


def _gate_device(model):
    leaves = _trace.leaves_of(model)[0]
    return leaves[0].device.type if leaves else "cpu"


def traced(model, cost, encoding, dtype=None, device_type=None,
           cost_opts=None, allow_stateful=False):
    """The ``_trace.TracedRollout`` K2(f) or, for a stateful model with
    ``allow_stateful``, K2(g) runs for (model, cost, encoding) in
    ``dtype`` (default: the promoted dtype of the model's and cost's
    tensors), the cost's keyword options ``cost_opts`` baked in; raises
    ``Unsupported`` where the gate refuses it."""
    _trace.check_gate(model, encoding, allow_stateful)
    kcost = _kernel_cost(cost, encoding)
    dtype = dtype or _gate_dtype(model, kcost)
    return _trace.trace_rollout(model, kcost, encoding, dtype,
                                device_type or _gate_device(model),
                                cost_opts if kcost is not None else None,
                                allow_stateful)


def supports(model, cost, encoding, dtype=None, cost_opts=None,
             allow_stateful=False):
    """Whether K2(f), or with ``allow_stateful`` K2(g), takes (model,
    cost, encoding), the cost called with the keyword options
    ``cost_opts`` (see the module)."""
    try:
        traced(model, cost, encoding, dtype, cost_opts=cost_opts,
               allow_stateful=allow_stateful)
    except Unsupported:
        return False
    return True


def source_text(tr):
    """The generated ``.cu`` of a traced rollout: its ``struct Traced``
    and the library's entry, around ``csrc/traced_rollout.cuh``."""
    return ("#include \"traced_rollout.cuh\"\n\nnamespace {\n\n" + tr.source
            + "\n}  // namespace\n\nPDDP_TRACED_ENTRY(Traced)\n")


def _function(tr, dtype):
    key = (tr.name, dtype)
    fn = _LIBS.get(key)
    if fn is None:
        fn = load_library(tr.name, dtype, source_text(tr)).\
            pddp_traced_rollout
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _LIBS[key] = fn
    return fn


def traced_control_law(model, Z, U, k, K, alphas,
                       encoding: StateEncoding = StateEncoding.DEFAULT,
                       cost=None, cost_opts=None, u_min=None, u_max=None,
                       with_aux=False, allow_stateful=False):
    """Batched-alpha closed-loop rollout in K2(f), or of a stateful model
    (with ``allow_stateful``) in K2(g).

    Args mirror ``controllers.ilqr.control_law``; any model that
    ``supports`` admits, the exact examples included. Inputs may carry
    one leading batch dim B of solves (a warp per 32 candidates of a
    solve); ``alphas`` and the bounds are shared by the batch.

    Returns:
        (Z_new (..., N+1, A, nz), U_new (..., N, A, nu))
        [, J (..., A) when cost is given] [, AUX when with_aux: () for a
        stateless model, else the aux's nest, each leaf (N, ..., A,
        *shape), ``control_law``'s layout].
    """
    in_kernel = (cost is not None
                 and encoding == StateEncoding.IGNORE_UNCERTAINTY)
    try:
        tr = traced(model, cost, encoding, Z.dtype, Z.device.type,
                    cost_opts, allow_stateful)
    except Unsupported as e:
        raise ValueError("K2(f)/(g) does not take this model and cost: "
                         "{}".format(e)) from None
    if Z.device.type == "cpu":
        return control_law(model, Z, U, k, K, alphas, encoding,
                           u_min=u_min, u_max=u_max, cost=cost,
                           cost_opts=cost_opts, with_aux=with_aux,
                           cost_in_scan=in_kernel)
    if Z.device.type != "cuda":
        raise ValueError("traced_control_law runs on CUDA or CPU tensors, "
                         "not {}".format(Z.device))
    ins = (Z, U, k, K)
    unbatched = Z.dim() == 2
    if unbatched:
        ins = tuple(t.unsqueeze(0) for t in ins)
    Z, U, k, K = ins
    B, N1, nz = Z.shape
    N, A, nu = N1 - 1, alphas.shape[0], model.action_size
    dtype, device = Z.dtype, Z.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("traced_control_law takes float32 or float64, not "
                        "{}".format(dtype))
    if A < 1:
        raise ValueError("at least one alpha, not {}".format(A))
    if tr.max_horizon is not None and N > tr.max_horizon:
        raise ValueError("the model or cost reads a per-step table by the "
                         "step index for {} steps at most, not {}".format(
                             tr.max_horizon, N))
    want_nz = infer_encoded_state_size(model.state_size, encoding)
    shapes = ((B, N + 1, want_nz), (B, N, nu), (B, N, nu),
              (B, N, nu, want_nz), (A,))
    for name, t, shape in zip(("Z", "U", "k", "K", "alphas"),
                              ins + (alphas,), shapes):
        if tuple(t.shape) != shape:
            raise ValueError("{} has shape {}, expected {}".format(
                name, tuple(t.shape), shape))
        if t.dtype != dtype or t.device != device:
            raise TypeError("{} is {} on {}, expected {} on {}".format(
                name, t.dtype, t.device, dtype, device))
        if not t.is_contiguous():
            raise ValueError("{} is not contiguous".format(name))
    from .fused_rollout import _bounds
    p, w = tr.buffers(model, cost if in_kernel else None, dtype, device)
    bounds = _bounds(u_min, u_max, nu, dtype, device)
    Z_out = torch.empty((B, N + 1, A, nz), dtype=dtype, device=device)
    U_out = torch.empty((B, N, A, nu), dtype=dtype, device=device)
    J_out = (torch.empty((B, A), dtype=dtype, device=device)
             if in_kernel else None)
    S0 = AUX = None
    if tr.stateful:
        S0 = _state_rows(model, (B, A), dtype, device)
        AUX = torch.empty((B, N, A, max(1, tr.n_aux)), dtype=dtype,
                          device=device)
    fn = _function(tr, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(Z.data_ptr(), U.data_ptr(), k.data_ptr(), K.data_ptr(),
                 alphas.data_ptr(), p.data_ptr(), w.data_ptr(),
                 None if bounds is None else bounds.data_ptr(),
                 Z_out.data_ptr(), U_out.data_ptr(),
                 None if J_out is None else J_out.data_ptr(), B, N, A,
                 None if S0 is None else S0.data_ptr(),
                 None if AUX is None else AUX.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("K2({}) (traced_rollout) launch failed: CUDA "
                           "error {}".format("g" if tr.stateful else "f",
                                             err))
    launches["stateful" if tr.stateful else "rollout"] += 1

    if unbatched:
        Z_out, U_out = Z_out[0], U_out[0]
        J_out = None if J_out is None else J_out[0]
    result = (Z_out, U_out)
    if cost is not None:
        result += ((J_out,) if in_kernel else
                   (trajectory_cost(cost, Z_out, U_out, encoding,
                                    cost_opts),))
    if not with_aux:
        return result
    return result + (_aux_tree(tr, AUX, unbatched) if tr.stateful
                     else (),)


def _state_rows(model, batch, dtype, device):
    """``model.init_state(batch_shape=batch)``'s leaves as one buffer
    (*batch, n_state), the leaves' elements one after another."""
    leaves, _ = _trace.flatten(model.init_state(batch_shape=batch))
    if not leaves:
        return torch.zeros(batch + (1,), dtype=dtype, device=device)
    return torch.cat([t.to(dtype=dtype, device=device).reshape(batch + (-1,))
                      for t in leaves], dim=-1).contiguous()


def _aux_tree(tr, AUX, unbatched):
    """K2(g)'s AUX (B, N, A, n_aux) as the aux's nest, each leaf (N, B,
    A, *shape) (unbatched: (N, A, *shape)), as ``control_law`` stacks
    it."""
    B, N, A = AUX.shape[:3]
    leaves, at = [], 0
    for shape in tr.aux_shapes:
        size = math.prod(shape)
        leaf = AUX[..., at:at + size].reshape((B, N, A) + shape)
        leaf = leaf.movedim(1, 0)
        leaves.append(leaf[:, 0] if unbatched else leaf)
        at += size
    return _trace.unflatten(tr.aux_spec, leaves)
