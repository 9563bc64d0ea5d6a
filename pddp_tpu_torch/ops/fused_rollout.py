"""K2: the line-search rollout as one CUDA kernel (``csrc/fused_rollout.cu``).

Port of ``pddp_tpu/ops/fused_rollout.py:fused_control_law``, stage (a):
the closed-loop rollout of all A step sizes over the N steps, with the
stage and terminal costs accumulated inside the kernel, for the cartpole
model and ``CartpoleCost`` under IGNORE_UNCERTAINTY. Pallas traced any
model's jnp code into its kernel; a CUDA kernel carries its own copy of
the model and cost, so ``supports_fused_rollout`` admits exactly that
triple, and ``solve`` takes the plain line search for anything else.

The plain version is ``controllers.ilqr.control_law`` with the cost
accumulated in the loop (the kernel's order of summation). On CPU
tensors the wrapper runs it; on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..controllers.ilqr import control_law
from ..encoding import StateEncoding
from ..examples.cartpole.cost import CartpoleCost
from ..examples.cartpole.model import PARAM_NAMES, CartpoleDynamicsModel
from ._build import load_library

__all__ = ["fused_control_law", "supports_fused_rollout", "param_buffer",
           "launches"]

#: number of kernel launches made by ``fused_control_law``.
launches = 0

#: largest candidate count (one thread per candidate, one block per solve).
MAX_ALPHAS = 1024

_SYMBOLS = {torch.float32: "pddp_fused_rollout_cartpole_f32",
            torch.float64: "pddp_fused_rollout_cartpole_f64"}


def supports_fused_rollout(model, cost, encoding=None):
    """Whether (model, cost, encoding) runs in the kernel: the cartpole
    model with ``CartpoleCost`` under IGNORE_UNCERTAINTY, exact types
    (a subclass may change the arithmetic the kernel carries)."""
    return (type(model) is CartpoleDynamicsModel
            and type(cost) is CartpoleCost
            and encoding == StateEncoding.IGNORE_UNCERTAINTY)


def param_buffer(model, cost, dtype, device):
    """The kernel's parameter buffer: the model's dt, mc, mp, l, mu, g,
    then the cost's Q (5x5), R (1x1), Q_term (5x5), x_goal (5), u_goal
    (1), 63 values."""
    parts = [getattr(model, n).reshape(1) for n in PARAM_NAMES]
    parts += [cost.Q.reshape(-1), cost.R.reshape(-1), cost.Q_term.reshape(-1),
              cost.x_goal.reshape(-1), cost.u_goal.reshape(-1).expand(1)]
    return torch.cat([p.to(dtype=dtype, device=device) for p in parts])


def _function(dtype):
    fn = getattr(load_library("fused_rollout"), _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_control_law(model, Z, U, k, K, alphas,
                      encoding: StateEncoding = StateEncoding.DEFAULT,
                      cost=None, cost_opts=None, u_min=None, u_max=None,
                      with_aux=False):
    """Batched-alpha closed-loop rollout with cost, in one kernel.

    Args mirror ``controllers.ilqr.control_law``; requires
    ``supports_fused_rollout(model, cost, encoding)``. Inputs may carry
    one leading batch dim B of solves (the kernel's grid); ``alphas`` and
    the bounds are shared by the batch. ``cost_opts`` reach the plain
    version only: ``CartpoleCost`` takes no options.

    Returns:
        (Z_new (..., N+1, A, nz), U_new (..., N, A, nu), J (..., A))
        [, AUX when with_aux: the cartpole records none, so ()].
    """
    if not supports_fused_rollout(model, cost, encoding):
        raise ValueError("the fused rollout kernel covers the cartpole model "
                         "with CartpoleCost under IGNORE_UNCERTAINTY only")
    if Z.device.type == "cpu":
        return control_law(model, Z, U, k, K, alphas, encoding,
                           u_min=u_min, u_max=u_max, cost=cost,
                           cost_opts=cost_opts, with_aux=with_aux,
                           cost_in_scan=True)
    if Z.device.type != "cuda":
        raise ValueError("fused_control_law runs on CUDA or CPU tensors, "
                         "not {}".format(Z.device))
    ins = (Z, U, k, K)
    unbatched = Z.dim() == 2
    if unbatched:
        ins = tuple(t.unsqueeze(0) for t in ins)
    Z, U, k, K = ins
    B, N1, nz = Z.shape
    N, A = N1 - 1, alphas.shape[0]
    dtype, device = Z.dtype, Z.device
    if dtype not in _SYMBOLS:
        raise TypeError("fused_control_law takes float32 or float64, not "
                        "{}".format(dtype))
    if not 1 <= A <= MAX_ALPHAS:
        raise ValueError("between 1 and {} alphas, not {}".format(
            MAX_ALPHAS, A))
    bounds = None
    if u_min is not None and u_max is not None:
        bounds = torch.stack([torch.as_tensor(b).reshape(())
                              for b in (u_min, u_max)]).to(dtype=dtype,
                                                           device=device)
    params = param_buffer(model, cost, dtype, device)
    shapes = ((B, N + 1, 4), (B, N, 1), (B, N, 1), (B, N, 1, 4), (A,))
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

    Z_out = torch.empty((B, N + 1, A, nz), dtype=dtype, device=device)
    U_out = torch.empty((B, N, A, 1), dtype=dtype, device=device)
    J_out = torch.empty((B, A), dtype=dtype, device=device)
    fn = _function(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(Z.data_ptr(), U.data_ptr(), k.data_ptr(), K.data_ptr(),
                 alphas.data_ptr(), params.data_ptr(),
                 None if bounds is None else bounds.data_ptr(),
                 Z_out.data_ptr(), U_out.data_ptr(), J_out.data_ptr(),
                 B, N, A, stream)
    if err != 0:
        raise RuntimeError("K2 (fused_rollout_cartpole) launch failed: CUDA "
                           "error {}".format(err))
    global launches
    launches += 1

    if unbatched:
        Z_out, U_out, J_out = Z_out[0], U_out[0], J_out[0]
    result = (Z_out, U_out, J_out)
    return result + ((),) if with_aux else result
