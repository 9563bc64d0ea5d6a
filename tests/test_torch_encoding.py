"""The port's state encodings (pddp_tpu_torch.encoding) against pddp_tpu's.

The same numpy-seeded mean and covariance go through both packages'
encode and every decode, for all five codecs, in float64 on the CPU.
Tolerance 1e-12: the two compute the same closed forms, and only the
Cholesky factorization (LAPACK in both, through different bindings) and
the order of sums differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddp_tpu import encoding as jenc
from pddp_tpu_torch import encoding as tenc

torch.set_num_threads(1)

ENCODINGS = list(tenc.StateEncoding)[:5]
TOL = dict(rtol=1e-12, atol=1e-12)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((3, n))
    L = rng.standard_normal((3, n, n))
    C = L @ np.swapaxes(L, -1, -2) + 0.1 * np.eye(n)
    return M, C


def test_integer_values_match():
    assert [int(e) for e in tenc.StateEncoding] == [
        int(e) for e in jenc.StateEncoding]
    assert int(tenc.StateEncoding.DEFAULT) == int(jenc.StateEncoding.DEFAULT)


@pytest.mark.parametrize("encoding", ENCODINGS, ids=lambda e: e.name)
def test_size_inference_matches(encoding):
    for n in (1, 2, 4, 8):
        m = tenc.infer_encoded_state_size(n, encoding)
        assert m == jenc.infer_encoded_state_size(n, encoding)
        assert tenc.infer_state_size(m, encoding) == n


@pytest.mark.parametrize("encoding", ENCODINGS, ids=lambda e: e.name)
@pytest.mark.parametrize("n", [1, 3])
def test_encode_and_decodes_match_jax(encoding, n):
    M, C = _inputs(n)
    z_j = np.array(jenc.encode(jnp.asarray(M), C=jnp.asarray(C),
                               encoding=encoding))
    z_t = tenc.encode(torch.as_tensor(M), C=torch.as_tensor(C),
                      encoding=encoding)
    np.testing.assert_allclose(z_t.numpy(), z_j, **TOL)

    zj = jnp.asarray(z_j)
    zt = torch.as_tensor(z_j)
    for name in ("decode_mean", "decode_covar", "decode_var", "decode_std",
                 "decode_covar_sqrt"):
        want = np.asarray(getattr(jenc, name)(zj, encoding))
        got = getattr(tenc, name)(zt, encoding).numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("encoding", ENCODINGS[:4], ids=lambda e: e.name)
def test_round_trip_from_variances(encoding):
    """encode(M, V=v) decodes back to the same mean and variances."""
    rng = np.random.default_rng(1)
    M = torch.as_tensor(rng.standard_normal(4))
    V = torch.as_tensor(rng.uniform(0.1, 2.0, 4))
    z = tenc.encode(M, V=V, encoding=encoding)
    np.testing.assert_allclose(tenc.decode_mean(z, encoding), M, **TOL)
    np.testing.assert_allclose(tenc.decode_var(z, encoding), V, **TOL)
