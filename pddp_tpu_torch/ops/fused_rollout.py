"""K2: the line-search rollout as one CUDA kernel.

Port of ``pddp_tpu/ops/fused_rollout.py:fused_control_law``. Pallas traced
any model's jnp code into its kernel. The port's stages (a)-(c) and (e)
carry hand-written copies of the four examples; stage (f) traces any
other stateless model's and cost's torch code into a kernel of its own,
so ``supports_fused_rollout`` admits what ``pddp_tpu``'s gate admits:

 * ``csrc/fused_rollout.cu``, one template per (model, codec, cost), for
   the four example models (cartpole, pendulum, double cartpole,
   rendezvous) and their ``constrain_model`` subclasses (instances of
   their own, the bounds in ``param_buffer``; ``ops/_examples.py``):
   stage (a), the cartpole under IGNORE_UNCERTAINTY; stage (b), the other
   three under IGNORE_UNCERTAINTY (the cost, a ``QRCost`` on the state or
   on its angular augmentation, is accumulated inside the kernel); stage
   (c), every example under the four belief codecs (the matrix codecs for
   state sizes up to ``SMALL_N``, as ``pddp_tpu``'s gate has it), which
   returns trajectories only: a cost, if given, is a batched post-pass;
 * stage (d), ``csrc/fused_bnn_rollout.cu`` (``ops/fused_bnn_rollout.py``):
   the stateful belief-state BNN under any of the five codecs, its net at
   full precision or under one bfloat16 knob (``compute_dtype`` or
   ``matmul_dtype``; in float32 the net on the tensor cores);
 * stage (e), ``csrc/fused_particle_rollout.cuh``
   (``ops/fused_particle_rollout.py``): the stateful
   ``ParticleDynamicsModel`` under any of the five codecs, over an
   example of (a)-(c) (``csrc/fused_particle_rollout.cu``'s hand-written
   instances) or over any other stateless inner model whose
   ``apply`` K2(f)'s trace takes (a generated instance);
 * stage (f), ``csrc/traced_rollout.cuh`` (``ops/traced_rollout.py``):
   every stateless model and cost that no stage above covers (a user's
   own model, any subclass of an example, ``SaturatingQRCost``,
   ``AggregateCost``, a user's cost), the step and, under
   IGNORE_UNCERTAINTY, the cost traced from their torch code; under the
   belief codecs the cost is a batched post-pass. Where a hand-written
   stage covers a call, it takes precedence;
 * stage (g), ``csrc/traced_rollout.cuh`` (``ops/traced_rollout.py``):
   every other stateful model whose step the trace takes, its rolling
   state and aux traced beside z, u and the step (a user's own stateful
   model); the cost as in stage (f).

The stateful stages (d), (e) and (g) are admitted only with
``allow_stateful=True``, as in ``pddp_tpu``; (d) and (e) never take a
cost in the kernel: a cost, if given, is a batched post-pass. Still
refused, each with the ``ValueError`` of ``fused_control_law``: a model
or cost whose trace K2(f)/(g) refuses (``ops/_trace.py``: a Python branch
on a tensor's value or on the step index, an op outside its table, a
state or aux that is not a nest of floating tensors), a BNN under a knob
of another dtype (``torch.float16``) or under both knobs, or with its
particles sharded, a particle model over the BNN (or any other inner
model whose ``apply`` the trace refuses), a particle model of more than
``fused_particle_rollout.MAX_PARTICLES`` particles.

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
from ..examples.cartpole import CartpoleCost, CartpoleDynamicsModel
from ..examples.double_cartpole import DoubleCartpoleCost
from ..examples.pendulum import PendulumCost
from ..examples.rendezvous import RendezvousCost
from ..utils.linalg import SMALL_N
from . import fused_bnn_rollout, fused_particle_rollout, traced_rollout
from . import _examples
from ._build import load_library

__all__ = ["fused_control_law", "supports_fused_rollout", "stage",
           "stateful_stage", "param_buffer", "launches"]

#: K2(a)-(c) launches made by ``fused_control_law``, per stage; (d)-(g)
#: are counted where they launch, in ``fused_bnn_rollout.launches``,
#: ``fused_particle_rollout.launches`` (the hand-written and the traced
#: inner step) and ``traced_rollout.launches`` (f and g).
launches = {"a": 0, "b": 0, "c": 0}

_SYMBOLS = {torch.float32: "pddp_fused_rollout_f32",
            torch.float64: "pddp_fused_rollout_f64"}

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


def stage(model, cost, encoding, cost_opts=None):
    """K2's stage for a stateless (model, cost, encoding): "a", "b" or
    "c" where ``csrc/fused_rollout.cu`` covers it (the four examples'
    exact types and their ``constrain_model`` subclasses,
    ``_examples.example_of``: any other subclass may change the
    arithmetic that kernel carries), else "f" where K2(f) takes its trace
    with the cost's options ``cost_opts`` (``traced_rollout.supports``),
    else None."""
    hand = _hand_written_stage(model, cost, encoding)
    if hand is not None:
        return hand
    return "f" if traced_rollout.supports(model, cost, encoding,
                                          cost_opts=cost_opts) else None


def _hand_written_stage(model, cost, encoding):
    base = _examples.example_of(model)[0]
    if base is None or encoding is None:
        return None
    if encoding in _MATRIX_CODECS and model.state_size > SMALL_N:
        return None
    if _cost_kind(model, cost, encoding) is None:
        return None
    if encoding != StateEncoding.IGNORE_UNCERTAINTY:
        return "c"
    return "a" if base is CartpoleDynamicsModel else "b"


def stateful_stage(model, encoding, cost=None, cost_opts=None):
    """The stage of a stateful model: "d" for the BNN
    (``fused_bnn_rollout.supports``: at full precision or under one
    bfloat16 knob), "e" for the particle model
    (``fused_particle_rollout.supports``: over an example or a traced
    inner model), "g" for any other stateful model whose step (and, under
    IGNORE_UNCERTAINTY, ``cost`` with ``cost_opts``) the trace takes
    (``traced_rollout.supports``), else None. Still refused: the BNN
    under a float16 knob, under both knobs or with its particles sharded,
    a particle model over the BNN or past ``MAX_PARTICLES``, a stateful
    model the trace refuses."""
    if fused_bnn_rollout.supports(model, encoding):
        return "d"
    if fused_particle_rollout.supports(model, encoding):
        return "e"
    if traced_rollout.supports(model, cost, encoding, cost_opts=cost_opts,
                               allow_stateful=True):
        return "g"
    return None


def supports_fused_rollout(model, cost, encoding=None, allow_stateful=False,
                           cost_opts=None):
    """Whether (model, cost, encoding) runs in a kernel: stages (a)-(c)
    and (f) (see ``stage``; ``cost_opts`` the options the cost will be
    called with) or, only with ``allow_stateful``, the stateful stages
    (d), the belief-state BNN, (e), the particle model, and (g), a traced
    stateful model, under any codec (``stateful_stage``)."""
    if stage(model, cost, encoding, cost_opts) is not None:
        return True
    return allow_stateful and stateful_stage(
        model, encoding, cost, cost_opts) is not None


def param_buffer(model, cost, dtype, device):
    """The kernel's parameter buffer: the model's parameters (in the
    order of its module's ``PARAM_NAMES``), then, where the kernel
    carries the cost, its Q (ny x ny), R (nu x nu), Q_term (ny x ny),
    x_goal (ny) and u_goal (nu), ny the state size or, for an augmented
    cost, the augmented size (under stage (a) 63 values in all), then a
    ``constrain_model`` subclass's lower and upper bounds (nu each)."""
    ny = None
    if cost is not None:
        ny = (len(model.non_angular_indices) + 2 * len(model.angular_indices)
              if type(cost).call_is_augmented_qr else model.state_size)
    return _examples.param_buffer(model, cost, dtype, device, ny)


_FUNCTIONS: dict = {}


def _function(dtype):
    fn = _FUNCTIONS.get(dtype)
    if fn is None:
        fn = getattr(load_library("fused_rollout", dtype), _SYMBOLS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
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
    ``supports_fused_rollout(model, cost, encoding, allow_stateful=True,
    cost_opts=cost_opts)``.
    Inputs may carry one leading batch dim B of solves (stages (a)-(c),
    (f) and (g): one warp per 32 candidates of a solve; (d) a thread-block
    cluster and (e) a thread block per candidate); ``alphas`` and the
    bounds are shared by the batch. Under
    IGNORE_UNCERTAINTY ``cost_opts`` reach the plain version only under
    stages (a)-(c), whose QR costs take no options; K2(f) bakes them into
    its trace.

    Returns:
        (Z_new (..., N+1, A, nz), U_new (..., N, A, nu))
        [, J (..., A) when cost is given]
        [, AUX when with_aux: for a stateless model (); for the BNN and
        the particle model the step noise (N, ..., A, P, n); for stage
        (g) the model's aux, each leaf (N, ..., A, *shape)].
    """
    st = stage(model, cost, encoding, cost_opts)
    if st is None:
        st = stateful_stage(model, encoding, cost, cost_opts)
        if st is None:
            raise ValueError("no fused rollout kernel covers this model, "
                             "cost and encoding (see supports_fused_rollout)")
        if st == "g":
            return traced_rollout.traced_control_law(
                model, Z, U, k, K, alphas, encoding, cost=cost,
                cost_opts=cost_opts, u_min=u_min, u_max=u_max,
                with_aux=with_aux, allow_stateful=True)
        law = (fused_bnn_rollout.fused_bnn_control_law if st == "d" else
               fused_particle_rollout.fused_particle_control_law)
        Z_b, U_b, AUX_b = law(model, Z, U, k, K, alphas, encoding,
                              u_min=u_min, u_max=u_max)
        result = (Z_b, U_b)
        if cost is not None:
            result += (trajectory_cost(cost, Z_b, U_b, encoding, cost_opts),)
        return result + (AUX_b,) if with_aux else result
    if st == "f":
        return traced_rollout.traced_control_law(
            model, Z, U, k, K, alphas, encoding, cost=cost,
            cost_opts=cost_opts, u_min=u_min, u_max=u_max, with_aux=with_aux)
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
                 B, N, A, _examples.MODELS[_examples.example_of(model)[0]],
                 int(encoding), kind, int(_examples.example_of(model)[1]),
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
