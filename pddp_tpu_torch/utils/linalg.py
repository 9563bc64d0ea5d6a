"""Small-matrix linear algebra (port of ``pddp_tpu/utils/linalg.py``).

What the solver, the encodings, the examples and the belief-state BNN
need: ``mm``, the adjugate ``small_inv``/``small_solve`` of the double
cartpole's 3x3 mass matrix, the fixed-sweep Jacobi ``small_eigh`` that
K1's plain version uses for nu > 1, the unrolled ``small_cholesky`` behind ``safe_cholesky`` and its
jitter ladder, the triangular solves ``tria_solve``/``tria_solve_right``
and ``psd_clamp``. The TPU package's unrolled ``small_mm`` and in-kernel
masked-sum forms are compiler workarounds and are not carried over.
"""

from __future__ import annotations

import torch

__all__ = ["mm", "small_det", "small_inv", "small_solve", "small_eigh",
           "small_cholesky", "safe_cholesky", "psd_clamp",
           "psd_inverse_clamped", "tria_solve", "tria_solve_right",
           "JITTER_LEVELS", "SMALL_EIGH_N", "SMALL_N"]

#: largest action size for which the Jacobi eigen-clamp (and so K1) is used.
SMALL_EIGH_N = 4

#: largest size the unrolled forms (Jacobi ``small_eigh``, ``small_cholesky``,
#: the triangular solves) handle; past it, ``torch.linalg``.
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


def _minor(A, i, j):
    n = A.shape[-1]
    rows = [r for r in range(n) if r != i]
    cols = [c for c in range(n) if c != j]
    return torch.stack([torch.stack([A[..., r, c] for c in cols], dim=-1)
                        for r in rows], dim=-2)


def small_det(A):
    """Determinant by Laplace expansion along the first row, unrolled for
    n <= 4, in ``pddp_tpu``'s order of operations."""
    n = A.shape[-1]
    if n == 1:
        return A[..., 0, 0]
    out = 0.0
    for j in range(n):
        term = A[..., 0, j] * small_det(_minor(A, 0, j))
        out = out + term if j % 2 == 0 else out - term
    return out


def small_inv(A):
    """Inverse through the adjugate, adj / det, unrolled for n <= 4 (the
    rounding of ``pddp_tpu.utils.linalg.small_inv``; K2 carries the same
    3x3 solve for the double cartpole)."""
    n = A.shape[-1]
    if n == 1:
        return 1.0 / A
    d = small_det(A)
    cof_T = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            m = small_det(_minor(A, i, j))
            cof_T[j][i] = m if (i + j) % 2 == 0 else -m
    adj = torch.stack([torch.stack(row, dim=-1) for row in cof_T], dim=-2)
    return adj / d[..., None, None]


def small_solve(A, b):
    """(adj(A) / det(A)) @ b for n <= 4; b is (..., n) or (..., n, k).

    The vector case is an elementwise product and sum, not a matmul:
    under ``torch.func.jacfwd`` a float32 model's tangents can be float64
    (see ``utils.evaluation.eval_dynamics``), which matmul refuses."""
    inv = small_inv(A)
    if b.dim() == A.dim() - 1:
        return (inv * b[..., None, :]).sum(-1)
    return inv @ b


def small_cholesky(C):
    """Unrolled Cholesky-Crout for n <= SMALL_N: the upper factor U with
    C = U^T U, NaN where C is not positive definite (a negative pivot's
    square root). A zero last pivot gives a finite factor, as in
    ``pddp_tpu``; LAPACK's ``cholesky_ex`` would report it as a failure."""
    n = C.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = C[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(C[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)],
                        dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2).transpose(-1, -2)


def _cholesky_upper(C):
    if C.shape[-1] <= SMALL_N:
        return small_cholesky(C)
    L, info = torch.linalg.cholesky_ex(C)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    return L.transpose(-1, -2)


def safe_cholesky(C, jitter_levels=JITTER_LEVELS):
    """Upper Cholesky factor U with C = U^T U, with the jitter ladder.

    Every rung is factorized and the smallest jitter whose factor is
    finite wins; where every rung fails, the diagonal square root of the
    variances clamped at 1e-12 is returned, so the result is never NaN
    unless C holds a NaN. Differentiable under ``torch.func``.
    """
    C = _sym(C)
    n = C.shape[-1]
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    diag = torch.diagonal(C, dim1=-2, dim2=-1).clamp(min=1e-12)
    result = torch.sqrt(diag)[..., :, None] * eye
    for j in reversed(jitter_levels):
        U = _cholesky_upper(C + j * eye)
        ok = torch.isfinite(U).all(dim=-1).all(dim=-1)
        result = torch.where(ok[..., None, None], U, result)
    return result


def psd_clamp(Q, floor=1e-12, extra=0.0):
    """Eigenvalue-clamped PSD projection: eigenvalues below 0 become
    ``floor``, then ``extra`` is added.

    Returns:
        (Q_clamped, eigenvalues_clamped, eigenvectors).
    """
    e, E = torch.linalg.eigh(_sym(Q))
    e = torch.where(e < 0, torch.as_tensor(floor, dtype=e.dtype,
                                           device=e.device), e) + extra
    Qc = (E * e[..., None, :]) @ E.transpose(-1, -2)
    return _sym(Qc), e, E


def psd_inverse_clamped(Q, floor=1e-12, extra=0.0):
    """Inverse of the eigenvalue-clamped matrix, E diag(1/e) E^T with
    eigenvalues below 0 set to ``floor``, plus ``extra``; the 1x1 case
    without an eigendecomposition."""
    if Q.shape[-1] == 1:
        e = torch.where(Q < 0, torch.as_tensor(floor, dtype=Q.dtype,
                                               device=Q.device), Q) + extra
        return 1.0 / e
    e, E = torch.linalg.eigh(_sym(Q))
    e = torch.where(e < 0, torch.as_tensor(floor, dtype=e.dtype,
                                           device=e.device), e) + extra
    return (E / e[..., None, :]) @ E.transpose(-1, -2)


def tria_solve(U, B, trans=False):
    """Solve with an upper-triangular factor U (C = U^T U): U x = b, or
    U^T x = b when ``trans``. B is (..., n) or (..., n, m). Unrolled
    substitution for n <= SMALL_N."""
    n = U.shape[-1]
    was_vec = B.dim() == U.dim() - 1
    Bm = B[..., :, None] if was_vec else B
    if n > SMALL_N:
        X = torch.linalg.solve_triangular(
            U.transpose(-1, -2) if trans else U, Bm, upper=not trans)
        return X[..., 0] if was_vec else X
    xs = [None] * n
    order = range(n) if trans else range(n - 1, -1, -1)
    for i in order:
        s = Bm[..., i, :]
        others = range(i) if trans else range(i + 1, n)
        for k in others:
            u = U[..., k, i, None] if trans else U[..., i, k, None]
            s = s - u * xs[k]
        xs[i] = s / U[..., i, i, None]
    X = torch.stack(xs, dim=-2)
    return X[..., 0] if was_vec else X


def tria_solve_right(U, D):
    """Solve X U = D for upper-triangular U; D is (..., m, n).

    The column sweep X[:, j] = (D[:, j] - sum_{k<j} X[:, k] U[k, j]) /
    U[j, j], in this order of operations (K2(d)'s noise inference does
    the same per particle).
    """
    n = U.shape[-1]
    if n > SMALL_N:
        return torch.linalg.solve_triangular(U, D, upper=True, left=False)
    xs = [None] * n
    for j in range(n):
        s = D[..., :, j]
        for k in range(j):
            s = s - xs[k] * U[..., k, j, None]
        xs[j] = s / U[..., j, j, None]
    return torch.stack(xs, dim=-1)
