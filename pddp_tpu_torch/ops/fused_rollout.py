"""K2: the line-search rollout as one CUDA kernel.

Port of ``pddp_tpu/ops/fused_rollout.py:fused_control_law``. Pallas traced
any model's jnp code into its kernel; a CUDA kernel carries its own copy
of the model and cost, so ``supports_fused_rollout`` admits what the
port's kernels cover, and ``solve`` takes the plain line search for
anything else:

 * ``csrc/fused_rollout.cu``, one template per (model, codec, cost), for
   the exact types of the four example models (cartpole, pendulum,
   double cartpole, rendezvous):
   stage (a), the cartpole under IGNORE_UNCERTAINTY; stage (b), the other
   three under IGNORE_UNCERTAINTY (the cost, a ``QRCost`` on the state or
   on its angular augmentation, is accumulated inside the kernel); stage
   (c), every example under the four belief codecs (the matrix codecs for
   state sizes up to ``SMALL_N``, as ``pddp_tpu``'s gate has it), which
   returns trajectories only: a cost, if given, is a batched post-pass;
 * stage (d), ``csrc/fused_bnn_rollout.cu`` (``ops/fused_bnn_rollout.py``):
   the stateful belief-state BNN under the Cholesky codec, admitted only
   with ``allow_stateful=True`` as in ``pddp_tpu``; the cost, if given, is
   a batched post-pass.

The plain version is ``controllers.ilqr.control_law`` (under
IGNORE_UNCERTAINTY with the cost accumulated in the loop, the kernel's
order of summation). On CPU tensors the wrapper runs it; on CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..controllers.ilqr import control_law, trajectory_cost
from ..costs.quadratic import QRCost
from ..encoding import StateEncoding, infer_encoded_state_size
from ..examples import cartpole, double_cartpole, pendulum, rendezvous
from ..examples.cartpole import CartpoleCost, CartpoleDynamicsModel
from ..examples.double_cartpole import (DoubleCartpoleCost,
                                        DoubleCartpoleDynamicsModel)
from ..examples.pendulum import PendulumCost, PendulumDynamicsModel
from ..examples.rendezvous import RendezvousCost, RendezvousDynamicsModel
from ..utils.linalg import SMALL_N
from . import fused_bnn_rollout
from ._build import load_library

__all__ = ["fused_control_law", "supports_fused_rollout", "stage",
           "param_buffer", "launches"]

#: kernel launches made by ``fused_control_law``, per stage.
launches = {"a": 0, "b": 0, "c": 0}

_SYMBOLS = {torch.float32: "pddp_fused_rollout_f32",
            torch.float64: "pddp_fused_rollout_f64"}

#: the kernel's model index of each example, and its parameters' names.
_MODELS = {CartpoleDynamicsModel: 0, PendulumDynamicsModel: 1,
           DoubleCartpoleDynamicsModel: 2, RendezvousDynamicsModel: 3}
_PARAM_NAMES = {
    CartpoleDynamicsModel: cartpole.model.PARAM_NAMES,
    PendulumDynamicsModel: pendulum.model.PARAM_NAMES,
    DoubleCartpoleDynamicsModel: double_cartpole.model.PARAM_NAMES,
    RendezvousDynamicsModel: rendezvous.model.PARAM_NAMES,
}

#: costs the kernel carries: QRCost's own __call__, or exactly augment ->
#: QRCost (``call_is_augmented_qr``).
_COSTS = (QRCost, CartpoleCost, PendulumCost, DoubleCartpoleCost,
          RendezvousCost)
_NO_COST, _QR, _AUG_QR = 0, 1, 2

_MATRIX_CODECS = (StateEncoding.UPPER_TRIANGULAR_CHOLESKY,
                  StateEncoding.FULL_COVARIANCE_MATRIX)


def _cost_kind(model, cost, encoding):
    """The kernel's cost for (model, cost, encoding), or None where it
    carries none that matches. Under the belief codecs the cost is a
    post-pass, so any cost goes."""
    if cost is None or encoding != StateEncoding.IGNORE_UNCERTAINTY:
        return _NO_COST
    if type(cost) not in _COSTS:
        return None
    if not type(cost).call_is_augmented_qr:
        return _QR
    same = (tuple(cost.aug_angular_indices) == tuple(model.angular_indices)
            and tuple(cost.aug_non_angular_indices)
            == tuple(model.non_angular_indices))
    return _AUG_QR if same and model.angular_indices else None


def stage(model, cost, encoding):
    """K2's stage for (model, cost, encoding): "a", "b" or "c", or None
    where ``csrc/fused_rollout.cu`` does not cover it. Exact types: a
    subclass may change the arithmetic the kernel carries."""
    if type(model) not in _MODELS or encoding is None:
        return None
    if encoding in _MATRIX_CODECS and model.state_size > SMALL_N:
        return None
    if _cost_kind(model, cost, encoding) is None:
        return None
    if encoding != StateEncoding.IGNORE_UNCERTAINTY:
        return "c"
    return "a" if type(model) is CartpoleDynamicsModel else "b"


def supports_fused_rollout(model, cost, encoding=None, allow_stateful=False):
    """Whether (model, cost, encoding) runs in a kernel: stages (a)-(c)
    (see ``stage``) or, only with ``allow_stateful``, stage (d), a
    stateful ``BNNDynamicsModel`` under the Cholesky codec (any cost: it
    runs as a post-pass)."""
    if stage(model, cost, encoding) is not None:
        return True
    return allow_stateful and fused_bnn_rollout.supports(model, encoding)


def param_buffer(model, cost, dtype, device):
    """The kernel's parameter buffer: the model's parameters (in the
    order of its module's ``PARAM_NAMES``), then, where the kernel
    carries the cost, its Q (ny x ny), R (nu x nu), Q_term (ny x ny),
    x_goal (ny) and u_goal (nu), ny the state size or, for an augmented
    cost, the augmented size. Under stage (a) that is 63 values."""
    parts = [getattr(model, n).reshape(1)
             for n in _PARAM_NAMES[type(model)]]
    if cost is not None:
        nu = model.action_size
        ny = (len(model.non_angular_indices) + 2 * len(model.angular_indices)
              if type(cost).call_is_augmented_qr else model.state_size)
        parts += [cost.Q.reshape(ny * ny), cost.R.reshape(nu * nu),
                  cost.Q_term.reshape(ny * ny),
                  cost.x_goal.reshape(-1).expand(ny),
                  cost.u_goal.reshape(-1).expand(nu)]
    return torch.cat([p.to(dtype=dtype, device=device) for p in parts])


_FUNCTIONS: dict = {}


def _function(dtype):
    fn = _FUNCTIONS.get(dtype)
    if fn is None:
        fn = getattr(load_library("fused_rollout"), _SYMBOLS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCTIONS[dtype] = fn
    return fn


def _bounds(u_min, u_max, nu, dtype, device):
    """(2, nu) [u_min; u_max] broadcast per action dimension, or None."""
    if u_min is None or u_max is None:
        return None
    return torch.stack([torch.as_tensor(b, dtype=dtype, device=device)
                        .expand(nu) for b in (u_min, u_max)]).contiguous()


def fused_control_law(model, Z, U, k, K, alphas,
                      encoding: StateEncoding = StateEncoding.DEFAULT,
                      cost=None, cost_opts=None, u_min=None, u_max=None,
                      with_aux=False):
    """Batched-alpha closed-loop rollout in one kernel.

    Args mirror ``controllers.ilqr.control_law``; requires
    ``supports_fused_rollout(model, cost, encoding, allow_stateful=True)``.
    Inputs may carry one leading batch dim B of solves (stages (a)-(c):
    one warp per 32 candidates of a solve); ``alphas`` and the bounds are
    shared by the batch. Under
    IGNORE_UNCERTAINTY ``cost_opts`` reach the plain version only: the
    kernel's QR costs take no options.

    Returns:
        (Z_new (..., N+1, A, nz), U_new (..., N, A, nu))
        [, J (..., A) when cost is given]
        [, AUX when with_aux: for the examples (); for the BNN the step
        noise (N, ..., A, P, n)].
    """
    st = stage(model, cost, encoding)
    if st is None:
        if not fused_bnn_rollout.supports(model, encoding):
            raise ValueError("no fused rollout kernel covers this model, "
                             "cost and encoding (see supports_fused_rollout)")
        Z_b, U_b, AUX_b = fused_bnn_rollout.fused_bnn_control_law(
            model, Z, U, k, K, alphas, encoding, u_min=u_min, u_max=u_max)
        result = (Z_b, U_b)
        if cost is not None:
            result += (trajectory_cost(cost, Z_b, U_b, encoding, cost_opts),)
        return result + (AUX_b,) if with_aux else result
    in_kernel = encoding == StateEncoding.IGNORE_UNCERTAINTY
    if Z.device.type == "cpu":
        return control_law(model, Z, U, k, K, alphas, encoding,
                           u_min=u_min, u_max=u_max, cost=cost,
                           cost_opts=cost_opts, with_aux=with_aux,
                           cost_in_scan=in_kernel)
    if Z.device.type != "cuda":
        raise ValueError("fused_control_law runs on CUDA or CPU tensors, "
                         "not {}".format(Z.device))
    ins = (Z, U, k, K)
    unbatched = Z.dim() == 2
    if unbatched:
        ins = tuple(t.unsqueeze(0) for t in ins)
    Z, U, k, K = ins
    B, N1, nz = Z.shape
    N, A, nu = N1 - 1, alphas.shape[0], model.action_size
    dtype, device = Z.dtype, Z.device
    if dtype not in _SYMBOLS:
        raise TypeError("fused_control_law takes float32 or float64, not "
                        "{}".format(dtype))
    if A < 1:
        raise ValueError("at least one alpha, not {}".format(A))
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
    kind = _cost_kind(model, cost, encoding)
    params = param_buffer(model, cost if kind != _NO_COST else None, dtype,
                          device)
    bounds = _bounds(u_min, u_max, nu, dtype, device)

    Z_out = torch.empty((B, N + 1, A, nz), dtype=dtype, device=device)
    U_out = torch.empty((B, N, A, nu), dtype=dtype, device=device)
    J_out = (torch.empty((B, A), dtype=dtype, device=device)
             if kind != _NO_COST else None)
    fn = _function(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(Z.data_ptr(), U.data_ptr(), k.data_ptr(), K.data_ptr(),
                 alphas.data_ptr(), params.data_ptr(),
                 None if bounds is None else bounds.data_ptr(),
                 Z_out.data_ptr(), U_out.data_ptr(),
                 None if J_out is None else J_out.data_ptr(),
                 B, N, A, _MODELS[type(model)], int(encoding), kind,
                 stream)
    if err != 0:
        raise RuntimeError("K2({}) (fused_rollout) launch failed: CUDA error "
                           "{}".format(st, err))
    launches[st] += 1

    if unbatched:
        Z_out, U_out = Z_out[0], U_out[0]
        J_out = None if J_out is None else J_out[0]
    result = (Z_out, U_out)
    if cost is not None:
        result += ((J_out,) if in_kernel else
                   (trajectory_cost(cost, Z_out, U_out, encoding,
                                    cost_opts),))
    return result + ((),) if with_aux else result
