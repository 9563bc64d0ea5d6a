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
 * the block kernel, for every other nz with nu <= 4: one thread block,
   or at the widest shapes a thread-block cluster, per solve, nz a
   run-time size, its workspace in shared memory or, past it, in a
   device-memory scratch buffer this wrapper allocates (the library plans
   the cluster, the tile and the scratch, ``launch_plan``).

The eigen clamp of Q_uu is the closed form for nu = 1 and, for nu = 2-4,
the fixed-sweep Jacobi of ``utils.linalg.small_eigh``: as it is in the
warp kernel, with a shorter chain in the block kernel (round-robin pairs,
one square root and one reciprocal a rotation, an early exit once
converged; ``csrc/backward_kernel.cu:clamped_inverse``). Both kernels
write ``ok``.

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
        lib = load_library("backward_kernel", dtype)
        fn = getattr(lib, (_BLOCK_SYMBOLS if block else _SYMBOLS)[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_double]
                       + [ctypes.c_void_p] * (5 if block else 4)
                       + [ctypes.c_int] * (5 if block else 4)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FUNCTIONS[(dtype, block)] = fn
    return fn


@functools.lru_cache(maxsize=None)
def launch_plan(nz, nu, dtype, B=1, *, _cluster=None):
    """The launch the library plans for B solves at (nz, nu): {"kernel":
    "warp" or "block"}, and for the block kernel its CTAs a solve
    ("cluster", 1 without a cluster), its tile (a thread's "tile" x "tile"
    outputs), "threads" a CTA, "smem_bytes" a CTA and the "scratch_elems"
    a solve needs (0: the workspace is in shared memory), and "stage_l",
    whether a step's L terms are staged in shared memory. Asks the card
    (the cluster's occupancy). ``_cluster`` is for the checks only (the card tests, chip_smoke.py): it
    asks for another cluster than the library's (the library refuses one
    that does not fit)."""
    if (nz, nu) in INSTANCES:
        return {"kernel": "warp"}
    lib = load_library("backward_kernel", dtype)
    lib.pddp_riccati_block_plan.argtypes = [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.pddp_riccati_block_plan.restype = ctypes.c_int
    out = (ctypes.c_long * 6)()
    itemsize = torch.empty((), dtype=dtype).element_size()
    err = lib.pddp_riccati_block_plan(nz, nu, itemsize, B, _cluster or 0,
                                      out)
    if err != 0:
        raise RuntimeError("K1 block kernel: no plan for nz={}, nu={}, "
                           "B={}, cluster={}: CUDA error {}".format(
                               nz, nu, B, _cluster, err))
    return {"kernel": "block", "cluster": out[0], "tile": out[1],
            "threads": out[2], "smem_bytes": out[3],
            "scratch_elems": out[4], "stage_l": bool(out[5])}


def kernel_backward(Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu, reg=0.0, *,
                    _cluster=None):
    """Riccati backward at any nz with nu <= 4; the interface and returns
    of ``controllers.ilqr.backward`` (unconstrained).

    Inputs may carry one leading batch dim B (a batch of solves: a warp
    each at the shapes of ``INSTANCES``, else a block or a cluster each).
    ``reg`` is a host scalar for every solve, or a tensor of the batch's
    shape (B,) on the inputs' device, each solve's own (the batched
    solve's per-lane regularization); the kernel reads a solve's entry
    once, before its recursion. ``_cluster`` is for the checks only (the
    card tests, chip_smoke.py): it overrides the block kernel's plan
    (``launch_plan``).

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
    regs = reg if isinstance(reg, torch.Tensor) else None
    if unbatched:
        ins = tuple(t.unsqueeze(0) for t in ins)
        regs = None if regs is None else regs.reshape(1)
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
    if regs is not None:
        if tuple(regs.shape) != (B,):
            raise ValueError("reg has shape {}, expected a float or "
                             "({},)".format(tuple(regs.shape), B))
        if regs.dtype != dtype or regs.device != device:
            raise TypeError("reg is {} on {}, expected {} on {}".format(
                regs.dtype, regs.device, dtype, device))
        regs = regs.contiguous()

    k = torch.empty((B, N, nu), dtype=dtype, device=device)
    K = torch.empty((B, N, nu, nz), dtype=dtype, device=device)
    ok = torch.empty((B,), dtype=torch.bool, device=device)
    block = (nz, nu) not in INSTANCES
    outs = [k.data_ptr(), K.data_ptr(), ok.data_ptr()]
    if block:
        # Freed on return: the caching allocator hands it out again only
        # on this stream, after the kernel.
        with torch.cuda.device(device):
            elems = launch_plan(nz, nu, dtype, B,
                                _cluster=_cluster)["scratch_elems"]
        scratch = (torch.empty((B, elems), dtype=dtype, device=device)
                   if elems else None)
        outs.append(None if scratch is None else scratch.data_ptr())
    fn = _function(dtype, block)
    plan = (B, N, nz, nu) + ((_cluster or 0,) if block else ())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in ins),
                 0.0 if regs is not None else float(reg),
                 None if regs is None else regs.data_ptr(), *outs, *plan,
                 stream)
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
