"""K1: the Riccati backward as one CUDA kernel (``csrc/backward_kernel.cu``).

Port of ``pddp_tpu/ops/backward_kernel.py:pallas_backward``, at every
shape that ``pddp_tpu``'s gate sends to it: any nz, nu <= 4. The
sequential reverse recursion of the unconstrained, Q_uu-regularized iLQR
backward runs in one launch, with the value function on chip across the
N steps. Two kernels share the arithmetic:

 * the warp kernel, an instance per (nz, nu) of ``INSTANCES`` (the paths'
   small shapes): one warp per solve, several solves per block, the
   per-step inputs staged in shared memory ahead of use
   (``csrc/async_copy.cuh``; the library picks the chunk and the solves
   per block itself);
 * the block kernel, for every other nz with nu <= 4: one thread block
   per solve, nz a run-time size, its workspace in shared memory or, past
   it, in a device-memory scratch buffer this wrapper allocates (the
   library says how large, ``launch_plan``).

The eigen clamp of Q_uu is the closed form for nu = 1 and the fixed-sweep
Jacobi of ``utils.linalg.small_eigh`` for nu = 2-4. Both kernels write
``ok``.

The plain version is ``controllers.ilqr.backward``. On CPU tensors the
wrapper runs it; on CUDA tensors it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..controllers.ilqr import backward
from ..utils.linalg import SMALL_EIGH_N
from ._build import load_library

__all__ = ["kernel_backward", "supports_kernel_backward", "launch_plan",
           "INSTANCES", "launches", "block_launches"]

#: the warp kernel's (nz, nu) instances: the paths' shapes (pendulum 2,
#: cartpole 4, double cartpole 6, rendezvous 8 with nu=4, the BNN under the
#: Cholesky codec 14) and the examples' belief codecs up to nz = 16
#: (pendulum 4, 5, 6; cartpole 8, 14; double cartpole 12; rendezvous 16).
INSTANCES = frozenset({(2, 1), (4, 1), (5, 1), (6, 1), (8, 1), (12, 1),
                       (14, 1), (8, 4), (16, 4)})

#: launches of the warp kernel made by ``kernel_backward``.
launches = 0
#: launches of the block kernel made by ``kernel_backward``.
block_launches = 0

_SYMBOLS = {torch.float32: "pddp_riccati_backward_f32",
            torch.float64: "pddp_riccati_backward_f64"}
_BLOCK_SYMBOLS = {torch.float32: "pddp_riccati_backward_block_f32",
                  torch.float64: "pddp_riccati_backward_block_f64"}


def supports_kernel_backward(L_u, F_z):
    """``pddp_tpu``'s gate: any nz with nu <= ``SMALL_EIGH_N`` (4). The
    (nz, nu) of ``INSTANCES`` take the warp kernel, every other the block
    kernel."""
    return L_u.shape[-1] <= SMALL_EIGH_N


_FUNCTIONS: dict = {}


def _function(dtype, block=False):
    fn = _FUNCTIONS.get((dtype, block))
    if fn is None:
        lib = load_library("backward_kernel")
        fn = getattr(lib, (_BLOCK_SYMBOLS if block else _SYMBOLS)[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_double]
                       + [ctypes.c_void_p] * (4 if block else 3)
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FUNCTIONS[(dtype, block)] = fn
    return fn


@functools.lru_cache(maxsize=None)
def launch_plan(nz, nu, dtype):
    """The launch the library plans at (nz, nu): {"kernel": "warp" or
    "block"}, and for the block kernel its threads a block and the
    scratch elements a solve needs (0: the workspace is in shared
    memory)."""
    if (nz, nu) in INSTANCES:
        return {"kernel": "warp"}
    lib = load_library("backward_kernel")
    lib.pddp_riccati_block_threads.argtypes = [ctypes.c_int] * 2
    lib.pddp_riccati_block_threads.restype = ctypes.c_int
    lib.pddp_riccati_block_scratch_elems.argtypes = [ctypes.c_int] * 3
    lib.pddp_riccati_block_scratch_elems.restype = ctypes.c_long
    itemsize = torch.empty((), dtype=dtype).element_size()
    return {"kernel": "block",
            "threads": lib.pddp_riccati_block_threads(nz, nu),
            "scratch_elems": lib.pddp_riccati_block_scratch_elems(
                nz, nu, itemsize)}


def kernel_backward(Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu, reg=0.0):
    """Riccati backward at any nz with nu <= 4; the interface and returns
    of ``controllers.ilqr.backward`` (unconstrained).

    Inputs may carry one leading batch dim B (a batch of solves: a warp
    each at the shapes of ``INSTANCES``, else a block each). ``reg`` is a
    host scalar.

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
        raise ValueError("kernel_backward takes nu <= {}, not nu={}".format(
            SMALL_EIGH_N, nu))
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
    block = (nz, nu) not in INSTANCES
    outs = [k.data_ptr(), K.data_ptr(), ok.data_ptr()]
    if block:
        # Freed on return: the caching allocator hands it out again only
        # on this stream, after the kernel.
        elems = launch_plan(nz, nu, dtype)["scratch_elems"]
        scratch = (torch.empty((B, elems), dtype=dtype, device=device)
                   if elems else None)
        outs.append(None if scratch is None else scratch.data_ptr())
    fn = _function(dtype, block)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in ins), float(reg), *outs, B, N, nz,
                 nu, stream)
    if err != 0:
        raise RuntimeError("K1 ({} kernel) launch failed: CUDA error "
                           "{}".format("block" if block else "warp", err))
    global launches, block_launches
    if block:
        block_launches += 1
    else:
        launches += 1

    if unbatched:
        return k[0], K[0], ok[0]
    return k, K, ok
