"""The port's Cholesky jitter ladder (``utils.linalg.safe_cholesky``): its
values are the where-walk over every rung that it was before, bit for bit;
its derivative comes through the selected rung alone.

Where the first rung fails (a matrix singular to rounding, as the cost's
augmented 5 x 5 covariance of the float32 particle cartpole becomes on an
H100), a where over every rung gives the failed rung a zero cotangent,
which the backward of its NaN square root turns into NaN; the repaired
ladder's ``jacrev`` and ``hessian`` are those of the selected rung's
factorization. Where every rung succeeds, the derivatives are
``pddp_tpu``'s, stored in ``tests/golden/cholesky_ladder.npz`` (with the
matrices and the seeded search that found them: ``python -m
tests.golden.cholesky_ladder``), not compiled live.
"""

import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd, jacrev, vmap

from pddp_tpu_torch.utils.linalg import (JITTER_LEVELS, _cholesky_upper,
                                         _sym, safe_cholesky)
from tests.golden import cholesky_ladder as g

DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.fixture(scope="module")
def data():
    with np.load(g.PATH) as npz:
        return dict(npz)


def where_walk(C, jitter_levels=JITTER_LEVELS):
    """The ladder as a where over every rung, walked from the largest
    jitter down (``pddp_tpu``'s form, and the port's before the repair)."""
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


def selected_rung(C, rung):
    n = C.shape[-1]
    return _cholesky_upper(_sym(C) + JITTER_LEVELS[rung] * torch.eye(
        n, dtype=C.dtype))


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_first_rung_fails_and_where_walk_leaks_nan(data, name):
    """The stored matrix fails the first rung here and the ladder takes
    the stored later one; the where-walk's derivative there is NaN (the
    fault), the repaired ladder's is finite."""
    C = torch.as_tensor(data["fail_" + name])
    assert C.dtype == DTYPES[name]
    rung = int(data["fail_rung_" + name])
    eye = torch.eye(C.shape[-1], dtype=C.dtype)
    ok = [bool(torch.isfinite(_cholesky_upper(_sym(C) + j * eye)).all())
          for j in JITTER_LEVELS]
    assert not ok[0] and ok.index(True) == rung
    assert not bool(torch.isfinite(jacrev(where_walk)(C)).all())
    assert bool(torch.isfinite(jacrev(safe_cholesky)(C)).all())


@pytest.mark.parametrize("name", ["f32", "f64"])
@pytest.mark.parametrize("transform", ["jacrev", "hessian", "jacfwd",
                                       "autograd"])
def test_derivative_is_the_selected_rungs(data, name, transform):
    """Where the first rung fails, the derivative is finite and equal to
    that of the selected rung's factorization: bit for bit under the same
    transform, and under autograd (a sum of the factor's entries)."""
    C = torch.as_tensor(data["fail_" + name])
    rung = int(data["fail_rung_" + name])
    torch.testing.assert_close(safe_cholesky(C), selected_rung(C, rung),
                               rtol=0, atol=0)
    if transform == "autograd":
        got, want = (C.clone().requires_grad_(True) for _ in range(2))
        safe_cholesky(got).sum().backward()
        selected_rung(want, rung).sum().backward()
        got, want = got.grad, want.grad
    else:
        t = {"jacrev": jacrev, "hessian": hessian, "jacfwd": jacfwd}[
            transform]
        got = t(safe_cholesky)(C)
        want = t(lambda c: selected_rung(c, rung))(C)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_vmap_of_jacrev_per_matrix(data):
    """Under ``vmap``, each matrix of a batch takes its own rung: the
    failing f64 matrix beside SPD ones whose first rung holds, each
    Jacobian that of its own rung's factorization."""
    fail = torch.as_tensor(data["fail_f64"])
    spd = torch.as_tensor(g.spd(5))
    batch = torch.stack([fail, spd, 2.0 * spd])
    got = vmap(jacrev(safe_cholesky))(batch)
    rungs = (int(data["fail_rung_f64"]), 0, 0)
    for b, rung in enumerate(rungs):
        want = jacrev(lambda c: selected_rung(c, rung))(batch[b])
        assert torch.equal(got[b], want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 4, 5, 8, 9])
def test_values_are_the_where_walks_bit_for_bit(dtype, n):
    """Random SPD matrices, rank-deficient ones (some rungs fail), an
    indefinite one (every rung fails: the diagonal fallback), one holding
    a NaN, and n = 9 past the unrolled size (LAPACK's factor): the values
    of the where-walk, bit for bit, NaN where it is NaN."""
    rng = np.random.default_rng(n)
    full = rng.standard_normal((32, n + 3, n))
    low = rng.standard_normal((32, n - 1, n))
    C = torch.as_tensor(np.concatenate([
        np.einsum("bpi,bpj->bij", full, full),
        np.einsum("bpi,bpj->bij", low, low)]), dtype=dtype)
    C[0] = -torch.eye(n, dtype=dtype)
    C[1, 0, 0] = torch.nan
    got, want = safe_cholesky(C), where_walk(C)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got, nan=7.0),
                       torch.nan_to_num(want, nan=7.0))


@pytest.mark.parametrize("n", g.SPD_SIZES)
def test_derivatives_are_pddp_tpus_where_every_rung_succeeds(data, n):
    """jacrev and hessian at float64 SPD matrices against ``pddp_tpu``'s
    (stored): within 1e-12 of the largest entry (the same factorization
    in another order of rounding)."""
    C = torch.as_tensor(data["spd_{}".format(n)])
    for t, key in ((jacrev, "jac"), (hessian, "hess")):
        got = t(safe_cholesky)(C)
        want = torch.as_tensor(data["{}_{}".format(key, n)])
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())
