"""Small-matrix linear algebra (port of ``pddp_tpu/utils/linalg.py``).

Only what the known-dynamics path and the encodings need: ``mm``, the
fixed-sweep Jacobi ``small_eigh`` that K1's plain version uses for
nu > 1, and ``safe_cholesky`` with its jitter ladder. The TPU package's
unrolled ``small_mm`` and in-kernel masked-sum forms are compiler
workarounds and are not carried over.
"""

from __future__ import annotations

import torch

__all__ = ["mm", "small_eigh", "safe_cholesky", "JITTER_LEVELS",
           "SMALL_EIGH_N", "SMALL_N"]

#: largest action size for which the Jacobi eigen-clamp (and so K1) is used.
SMALL_EIGH_N = 4

#: largest size ``small_eigh`` handles by Jacobi sweeps; past it, eigh.
SMALL_N = 8

#: Cholesky jitter ladder, smallest rung first (reference x10 ladder).
JITTER_LEVELS = (1e-12, 1e-9, 1e-6, 1e-3, 1e-1)

#: matrix product; float32 products stay in full float32 (no TF32) because
#: the package never enables ``torch.backends.cuda.matmul.allow_tf32``.
mm = torch.matmul


def _sym(C):
    return 0.5 * (C + C.transpose(-1, -2))


def small_eigh(A, sweeps=None, sort=True):
    """Symmetric eigendecomposition by fixed-sweep cyclic Jacobi.

    Same rotation sequence as ``pddp_tpu.utils.linalg.small_eigh``: each
    of ``sweeps`` sweeps (default 8 in f64, 5 otherwise) annihilates every
    upper off-diagonal entry once. Broadcasts over leading batch dims.

    Returns (eigenvalues (..., n), eigenvectors (..., n, n)), ascending
    unless ``sort=False``.
    """
    n = A.shape[-1]
    if n > SMALL_N:
        return torch.linalg.eigh(_sym(A))
    if n == 1:
        return A[..., 0], torch.ones_like(A)
    if sweeps is None:
        sweeps = 8 if A.dtype == torch.float64 else 5
    A = _sym(A)
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    one = torch.ones_like(a[0][0])
    zero = torch.zeros_like(one)
    v = [[one if i == j else zero for j in range(n)] for i in range(n)]
    big = torch.finfo(A.dtype).max ** 0.5 * 0.25

    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = a[p][p], a[q][q], a[p][q]
                nz_mask = apq != 0
                apq_safe = torch.where(nz_mask, apq, one)
                tau = ((aqq - app) / (2.0 * apq_safe)).clamp(-big, big)
                sgn = torch.where(tau >= 0, one, -one)
                t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = t * c
                t = torch.where(nz_mask, t, zero)
                c = torch.where(nz_mask, c, one)
                s = torch.where(nz_mask, s, zero)
                for k in range(n):
                    if k != p and k != q:
                        akp, akq = a[k][p], a[k][q]
                        a[k][p] = a[p][k] = c * akp - s * akq
                        a[k][q] = a[q][k] = s * akp + c * akq
                a[p][p] = app - t * apq
                a[q][q] = aqq + t * apq
                a[p][q] = a[q][p] = zero
                for k in range(n):
                    vkp, vkq = v[k][p], v[k][q]
                    v[k][p] = c * vkp - s * vkq
                    v[k][q] = s * vkp + c * vkq

    evals = torch.stack([a[i][i] for i in range(n)], dim=-1)
    evecs = torch.stack([torch.stack(row, dim=-1) for row in v], dim=-2)
    if sort:
        evals, order = torch.sort(evals, dim=-1, stable=True)
        evecs = torch.gather(
            evecs, -1, order.unsqueeze(-2).expand(evecs.shape))
    return evals, evecs


def safe_cholesky(C, jitter_levels=JITTER_LEVELS):
    """Upper Cholesky factor U with C = U^T U, with the jitter ladder.

    The smallest jitter whose factorization succeeds wins; where every
    rung fails, the diagonal square root of the clamped variances is
    returned, so the result is never NaN.
    """
    C = _sym(C)
    n = C.shape[-1]
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    diag = torch.diagonal(C, dim1=-2, dim2=-1).clamp(min=1e-12)
    result = torch.sqrt(diag)[..., :, None] * eye
    for j in reversed(jitter_levels):
        L, info = torch.linalg.cholesky_ex(C + j * eye)
        U = L.transpose(-1, -2)
        ok = (info == 0) & torch.isfinite(U).all(dim=(-2, -1))
        result = torch.where(ok[..., None, None], U, result)
    return result
