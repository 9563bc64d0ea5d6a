"""K2 stage (e): the particle model's line search as one CUDA kernel
(``csrc/fused_particle_rollout.cuh``).

Port of the stateful variant of ``pddp_tpu/ops/fused_rollout.py:
fused_control_law`` for ``ParticleDynamicsModel``
(``utils/particles.py``): the closed-loop rollout of all A step sizes
under any of the five codecs, each step pushing the model's P particles
through the inner model and moment-matching them back, with the model's
rolling state (the previous particle outputs) and the per-step noise
aux. The kernel returns trajectories and aux only; the cost, if wanted,
is the caller's batched post-pass, as in K2(d).

The inner model's step comes one of two ways:

* one of the four known-dynamics examples or its ``constrain_model``
  subclass (``ops._examples.example_of``): the hand-written steps of
  ``csrc/examples.cuh``, in ``csrc/fused_particle_rollout.cu``'s
  instances;
* any other stateless inner model whose ``apply(X, u, i, (),
  IGNORE_UNCERTAINTY)`` K2(f)'s trace takes (a bare subclass of an
  example, a user's model that reads a table by the step index): the
  trace (``_trace.trace_inner_step``) printed as ``struct TracedInner``
  into a generated source per (inner model, codec, dtype), built at first
  use by ``_build.load_library`` (contraction on: the traced products go
  through ``pddp_tr::mul_``, which none contracts).

The plain version is ``controllers.ilqr.control_law`` with the model. On
CPU tensors the wrapper runs it; on CUDA tensors it launches the kernel
or raises. ``solve`` keeps the particle model on the scan line search,
as ``pddp_tpu``'s gate does for stateful models; this is what
``fused_control_law`` runs on one.
"""

from __future__ import annotations

import ctypes
import hashlib

import torch

from ..controllers.ilqr import control_law
from ..encoding import StateEncoding, infer_encoded_state_size
from ..utils.particles import ParticleDynamicsModel
from . import _trace, traced_rollout
from ._build import load_library
from ._examples import MODELS, example_of, param_buffer
from ._trace import Unsupported

__all__ = ["supports", "fused_particle_control_law", "inner_step",
           "traced_source", "traced_name", "launches"]

#: kernel launches of ``fused_particle_control_law``: over an example's
#: hand-written step ("rollout") and over a traced inner step ("traced").
launches = {"rollout": 0, "traced": 0}

MAX_PARTICLES = 1024  # a thread each, one thread block a candidate

_SYMBOLS = {torch.float32: "pddp_particle_rollout_f32",
            torch.float64: "pddp_particle_rollout_f64"}
_FUNCTIONS: dict = {}


def supports(model, encoding=None):
    """Whether the kernel covers ``model`` under ``encoding``: a
    ``ParticleDynamicsModel`` (exact type) with 2 to 1024 particles and
    its episode noise, under any of the five codecs (the matrix codecs up
    to a state size of ``SMALL_N``), whose ``inner`` is one of the four
    examples or its ``constrain_model`` subclass, or a stateless model
    whose step the trace takes (``inner_step``)."""
    if type(model) is not ParticleDynamicsModel or encoding is None:
        return False
    if not (2 <= model.n_particles <= MAX_PARTICLES
            and model.eps is not None
            and tuple(model.eps.shape[1:]) == (model.n_particles,
                                               model.state_size)):
        return False
    if example_of(model.inner)[0] is not None:
        return True
    try:
        _trace.check_gate(model.inner, encoding)
        inner_step(model.inner)
    except Unsupported:
        return False
    return True


def inner_step(inner, dtype=None, device_type=None):
    """The ``_trace.TracedInner`` of a particle model's inner model in
    ``dtype`` (default: its tensors' promoted dtype) on ``device_type``
    (default: its tensors'); raises ``Unsupported`` where the trace
    refuses it."""
    return _trace.trace_inner_step(
        inner, dtype or traced_rollout._gate_dtype(inner, None),
        device_type or traced_rollout._gate_device(inner))


def traced_source(tr, encoding):
    """The generated ``.cu`` of K2(e) over a traced inner step under
    ``encoding``: its ``struct TracedInner`` and the library's entry,
    around ``csrc/fused_particle_rollout.cuh``."""
    return ("#include \"traced_rollout.cuh\"\n"
            "#include \"fused_particle_rollout.cuh\"\n\nnamespace {\n\n"
            + tr.source + "\n}  // namespace\n\n"
            + "PDDP_PARTICLE_TRACED_ENTRY(TracedInner, {})\n".format(
                int(encoding)))


def traced_name(text):
    """The library name of a generated K2(e) source: a hash of its text."""
    return "traced_particle_" + hashlib.sha256(text.encode()).hexdigest()[
        :12]


def _function(dtype):
    fn = _FUNCTIONS.get(dtype)
    if fn is None:
        fn = getattr(load_library("fused_particle_rollout", dtype),
                     _SYMBOLS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCTIONS[dtype] = fn
    return fn


def _traced_function(tr, encoding, dtype):
    text = traced_source(tr, encoding)
    key = (text, dtype)
    fn = _FUNCTIONS.get(key)
    if fn is None:
        fn = load_library(traced_name(text), dtype, text,
                          contract=True).pddp_particle_traced_rollout
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCTIONS[key] = fn
    return fn


def fused_particle_control_law(model, Z, U, k, K, alphas,
                               encoding: StateEncoding = StateEncoding.DEFAULT,
                               u_min=None, u_max=None):
    """Batched-alpha closed-loop rollout of the particle model.

    Args mirror ``controllers.ilqr.control_law`` (no cost); requires
    ``supports(model, encoding)``. Inputs may carry one leading batch dim
    B of solves; ``alphas`` and the bounds (scalars or (nu,)) are shared.

    Returns:
        (Z_new (..., N+1, A, nz), U_new (..., N, A, nu),
         AUX (N, ..., A, P, n)), the layout of ``control_law``.
    """
    if not supports(model, encoding):
        raise ValueError("the particle rollout kernel does not cover this "
                         "model (see supports)")
    if Z.device.type == "cpu":
        return control_law(model, Z, U, k, K, alphas, encoding,
                           u_min=u_min, u_max=u_max, with_aux=True)
    if Z.device.type != "cuda":
        raise ValueError("fused_particle_control_law runs on CUDA or CPU "
                         "tensors, not {}".format(Z.device))
    unbatched = Z.dim() == 2
    ins = tuple(t.unsqueeze(0) if unbatched else t for t in (Z, U, k, K))
    Z, U, k, K = ins
    B, N1, _ = Z.shape
    N, A = N1 - 1, alphas.shape[0]
    n, nu, P = model.state_size, model.action_size, model.n_particles
    nz = infer_encoded_state_size(n, encoding)
    dtype, device = Z.dtype, Z.device
    if dtype not in _SYMBOLS:
        raise TypeError("fused_particle_control_law takes float32 or "
                        "float64, not {}".format(dtype))
    if A < 1:
        raise ValueError("at least one alpha, not {}".format(A))
    if N > model.eps.shape[0]:
        raise ValueError("horizon {} exceeds the model's noise table of "
                         "{} steps".format(N, model.eps.shape[0]))
    for name, t, shape in zip(("Z", "U", "k", "K", "alphas"),
                              ins + (alphas,),
                              ((B, N + 1, nz), (B, N, nu), (B, N, nu),
                               (B, N, nu, nz), (A,))):
        if tuple(t.shape) != shape:
            raise ValueError("{} has shape {}, expected {}".format(
                name, tuple(t.shape), shape))
        if t.dtype != dtype or t.device != device:
            raise TypeError("{} is {} on {}, expected {} on {}".format(
                name, t.dtype, t.device, dtype, device))
        if not t.is_contiguous():
            raise ValueError("{} is not contiguous".format(name))
    base, constrained = example_of(model.inner)
    tr = None
    if base is None:
        tr = inner_step(model.inner, dtype, "cuda")
        if tr.max_horizon is not None and N > tr.max_horizon:
            raise ValueError("the inner model reads a per-step table by "
                             "the step index for {} steps at most, not "
                             "{}".format(tr.max_horizon, N))
    eps = model.eps.to(dtype=dtype, device=device).contiguous()
    bounds = None
    if u_min is not None and u_max is not None:
        bounds = torch.stack([torch.as_tensor(v).to(dtype=dtype,
                                                    device=device).expand(nu)
                              for v in (u_min, u_max)]).contiguous()
    Z_out = torch.empty((B, N + 1, A, nz), dtype=dtype, device=device)
    U_out = torch.empty((B, N, A, nu), dtype=dtype, device=device)
    AUX = torch.empty((B, N, A, P, n), dtype=dtype, device=device)
    infer = int(bool(model.infer_noise_variables))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if tr is None:
            params = param_buffer(model.inner, None, dtype, device)
            err = _function(dtype)(
                Z.data_ptr(), U.data_ptr(), k.data_ptr(), K.data_ptr(),
                alphas.data_ptr(), params.data_ptr(), eps.data_ptr(),
                None if bounds is None else bounds.data_ptr(),
                Z_out.data_ptr(), U_out.data_ptr(), AUX.data_ptr(),
                B, N, A, P, MODELS[base], int(encoding), int(constrained),
                infer, stream)
        else:
            p, w = tr.buffers(model.inner, dtype, device)
            err = _traced_function(tr, encoding, dtype)(
                Z.data_ptr(), U.data_ptr(), k.data_ptr(), K.data_ptr(),
                alphas.data_ptr(), p.data_ptr(), w.data_ptr(),
                eps.data_ptr(), None if bounds is None else bounds.data_ptr(),
                Z_out.data_ptr(), U_out.data_ptr(), AUX.data_ptr(),
                B, N, A, P, infer, stream)
    if err != 0:
        raise RuntimeError("K2(e) (fused_particle_rollout{}) launch failed: "
                           "CUDA error {}".format(
                               "" if tr is None else ", traced inner step",
                               err))
    launches["rollout" if tr is None else "traced"] += 1
    if unbatched:
        return Z_out[0], U_out[0], AUX[0]
    return Z_out, U_out, AUX.movedim(1, 0)
