"""K1: the Riccati backward as one CUDA kernel (``csrc/backward_kernel.cu``).

Port of ``pddp_tpu/ops/backward_kernel.py:pallas_backward``. The
sequential reverse recursion of the unconstrained, Q_uu-regularized iLQR
backward runs in one launch, one warp per solve and several solves per
block, with the value function in the warp's shared memory across the N
steps and the per-step inputs staged there ahead of use
(``csrc/async_copy.cuh``; the library picks the chunk and the solves per
block itself).
The kernel is an instance per (nz, nu) of ``INSTANCES``; the eigen clamp
of Q_uu is the closed form for nu = 1 and the fixed-sweep Jacobi of
``utils.linalg.small_eigh`` for nu = 4. It also writes ``ok``.

The plain version is ``controllers.ilqr.backward``. On CPU tensors the
wrapper runs it; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..controllers.ilqr import backward
from ._build import load_library

__all__ = ["kernel_backward", "supports_kernel_backward", "INSTANCES",
           "launches"]

#: the kernel's (nz, nu) instances: the paths' shapes (pendulum 2,
#: cartpole 4, double cartpole 6, rendezvous 8 with nu=4, the BNN under the
#: Cholesky codec 14) and the examples' belief codecs up to nz = 16
#: (pendulum 4, 5, 6; cartpole 8, 14; double cartpole 12; rendezvous 16).
INSTANCES = frozenset({(2, 1), (4, 1), (5, 1), (6, 1), (8, 1), (12, 1),
                       (14, 1), (8, 4), (16, 4)})

#: number of kernel launches made by ``kernel_backward``.
launches = 0

_SYMBOLS = {torch.float32: "pddp_riccati_backward_f32",
            torch.float64: "pddp_riccati_backward_f64"}


def supports_kernel_backward(L_u, F_z):
    """Whether the kernel has an instance for these sizes (``INSTANCES``);
    ``solve`` takes the plain backward for any other."""
    return (F_z.shape[-1], L_u.shape[-1]) in INSTANCES


_FUNCTIONS: dict = {}


def _function(dtype):
    fn = _FUNCTIONS.get(dtype)
    if fn is None:
        fn = getattr(load_library("backward_kernel"), _SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_double]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FUNCTIONS[dtype] = fn
    return fn


def kernel_backward(Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu, reg=0.0):
    """Riccati backward at the (nz, nu) of ``INSTANCES``; the interface
    and returns of ``controllers.ilqr.backward`` (unconstrained).

    Inputs may carry one leading batch dim B (a batch of solves, one warp
    each). ``reg`` is a host scalar.

    Returns:
        (k (..., N, nu), K (..., N, nu, nz), ok (...) bool).
    """
    if F_z.device.type == "cpu":
        return backward(Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu, reg=reg)
    if F_z.device.type != "cuda":
        raise ValueError("kernel_backward runs on CUDA or CPU tensors, not "
                         "{}".format(F_z.device))
    ins = (F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu)
    unbatched = F_z.dim() == 3
    if unbatched:
        ins = tuple(t.unsqueeze(0) for t in ins)
    F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu = ins
    B, N, nz, _ = F_z.shape
    nu = F_u.shape[-1]
    dtype, device = F_z.dtype, F_z.device
    if dtype not in _SYMBOLS:
        raise TypeError("kernel_backward takes float32 or float64, not "
                        "{}".format(dtype))
    if not supports_kernel_backward(L_u, F_z):
        raise ValueError("kernel_backward has no instance at nz={}, nu={} "
                         "(it has {})".format(nz, nu, sorted(INSTANCES)))
    shapes = ((B, N, nz, nz), (B, N, nz, nu), (B, N + 1, nz), (B, N, nu),
              (B, N + 1, nz, nz), (B, N, nu, nz), (B, N, nu, nu))
    for name, t, shape in zip(("F_z", "F_u", "L_z", "L_u", "L_zz", "L_uz",
                               "L_uu"), ins, shapes):
        if tuple(t.shape) != shape:
            raise ValueError("{} has shape {}, expected {}".format(
                name, tuple(t.shape), shape))
        if t.dtype != dtype or t.device != device:
            raise TypeError("{} is {} on {}, expected {} on {}".format(
                name, t.dtype, t.device, dtype, device))
        if not t.is_contiguous():
            raise ValueError("{} is not contiguous".format(name))

    k = torch.empty((B, N, nu), dtype=dtype, device=device)
    K = torch.empty((B, N, nu, nz), dtype=dtype, device=device)
    ok = torch.empty((B,), dtype=torch.bool, device=device)
    fn = _function(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in ins), float(reg), k.data_ptr(),
                 K.data_ptr(), ok.data_ptr(), B, N, nz, nu, stream)
    if err != 0:
        raise RuntimeError("K1 (riccati_backward) launch failed: CUDA error "
                           "{}".format(err))
    global launches
    launches += 1

    if unbatched:
        return k[0], K[0], ok[0]
    return k, K, ok
