"""K2 stage (e): the particle model's line search as one CUDA kernel
(``csrc/fused_particle_rollout.cu``).

Port of the stateful variant of ``pddp_tpu/ops/fused_rollout.py:
fused_control_law`` for ``ParticleDynamicsModel``
(``utils/particles.py``) over one of the four known-dynamics examples or
its ``constrain_model`` subclass: the closed-loop rollout of all A step
sizes under any of the five codecs, each step pushing the model's P
particles through the example and moment-matching them back, with the
model's rolling state (the previous particle outputs) and the per-step
noise aux. The kernel returns trajectories and aux only; the cost, if
wanted, is the caller's batched post-pass, as in K2(d).

The plain version is ``controllers.ilqr.control_law`` with the model. On
CPU tensors the wrapper runs it; on CUDA tensors it launches the kernel
or raises. ``solve`` keeps the particle model on the scan line search,
as ``pddp_tpu``'s gate does for stateful models; this is what
``fused_control_law`` runs on one.
"""

from __future__ import annotations

import ctypes

import torch

from ..controllers.ilqr import control_law
from ..encoding import StateEncoding, infer_encoded_state_size
from ..utils.particles import ParticleDynamicsModel
from ._build import load_library
from ._examples import MODELS, example_of, param_buffer

__all__ = ["supports", "fused_particle_control_law", "launches"]

#: kernel launches of ``fused_particle_control_law``.
launches = {"rollout": 0}

MAX_PARTICLES = 1024  # a thread each, one thread block a candidate

_SYMBOLS = {torch.float32: "pddp_particle_rollout_f32",
            torch.float64: "pddp_particle_rollout_f64"}
_FUNCTIONS: dict = {}


def supports(model, encoding=None):
    """Whether the kernel covers ``model`` under ``encoding``: a
    ``ParticleDynamicsModel`` (exact type) whose ``inner`` is one of the
    four examples or its ``constrain_model`` subclass
    (``ops._examples.example_of``), with 2 to 1024 particles and its
    episode noise, under any of the five codecs (every example's state
    size is within ``SMALL_N``, so the matrix codecs too)."""
    if type(model) is not ParticleDynamicsModel or encoding is None:
        return False
    return (example_of(model.inner)[0] is not None
            and 2 <= model.n_particles <= MAX_PARTICLES
            and model.eps is not None
            and tuple(model.eps.shape[1:]) == (model.n_particles,
                                               model.state_size))


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
        raise ValueError("the particle rollout kernel covers "
                         "ParticleDynamicsModel over the four examples only "
                         "(see supports)")
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
    params = param_buffer(model.inner, None, dtype, device)
    eps = model.eps.to(dtype=dtype, device=device).contiguous()
    bounds = None
    if u_min is not None and u_max is not None:
        bounds = torch.stack([torch.as_tensor(v).to(dtype=dtype,
                                                    device=device).expand(nu)
                              for v in (u_min, u_max)]).contiguous()
    Z_out = torch.empty((B, N + 1, A, nz), dtype=dtype, device=device)
    U_out = torch.empty((B, N, A, nu), dtype=dtype, device=device)
    AUX = torch.empty((B, N, A, P, n), dtype=dtype, device=device)
    fn = _function(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(Z.data_ptr(), U.data_ptr(), k.data_ptr(), K.data_ptr(),
                 alphas.data_ptr(), params.data_ptr(), eps.data_ptr(),
                 None if bounds is None else bounds.data_ptr(),
                 Z_out.data_ptr(), U_out.data_ptr(), AUX.data_ptr(),
                 B, N, A, P, MODELS[base], int(encoding), int(constrained),
                 int(bool(model.infer_noise_variables)), stream)
    if err != 0:
        raise RuntimeError("K2(e) (fused_particle_rollout) launch failed: "
                           "CUDA error {}".format(err))
    launches["rollout"] += 1
    if unbatched:
        return Z_out[0], U_out[0], AUX[0]
    return Z_out, U_out, AUX.movedim(1, 0)
