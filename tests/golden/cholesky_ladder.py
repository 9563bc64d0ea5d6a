"""Matrices and ``pddp_tpu``'s derivatives for the port's test of the
Cholesky jitter ladder (``tests/test_torch_ladder.py``), stored in
``cholesky_ladder.npz``.

- ``fail_f32``, ``fail_f64``: a 5 x 5 symmetric matrix (the size of the
  cartpole cost's augmented covariance) whose first rung (jitter 1e-12)
  fails on the CPU under the port's unrolled Cholesky and whose ladder
  takes a later rung. Found by a seeded numpy search: X the standard
  normal draws (4, 5) of numpy seed s, scaled by ``FAIL_SCALE`` of the
  type, C = X^T X (rank 4, so the last pivot is rounding), the first seed
  from 0 that fails so; ``fail_seed_f32``/``_f64`` and ``fail_rung_*``
  (the rung the ladder takes) beside them.
- ``spd_<n>``: float64 symmetric positive definite matrices, X^T X / m +
  0.1 I from numpy seed 100 + n (X (m, n), m = n + 2), at n = 3 and 5,
  where every rung succeeds; ``jac_<n>`` and ``hess_<n>`` are
  ``jax.jacrev`` and ``jax.hessian`` of ``pddp_tpu.utils.linalg.
  safe_cholesky`` there, in float64.

JAX compiles derivatives through the ladder slowly, so they are stored.
Regenerate with

    JAX_PLATFORMS=cpu python -m tests.golden.cholesky_ladder
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "cholesky_ladder.npz")

FAIL_N = 5
FAIL_SCALE = {"f32": 1.0, "f64": 100.0}
SPD_SIZES = (3, 5)


def spd(n):
    rng = np.random.default_rng(100 + n)
    X = rng.standard_normal((n + 2, n))
    return X.T @ X / (n + 2) + 0.1 * np.eye(n)


def failing(dtype_name):
    """(seed, C, the rung the ladder takes) of the first seed whose
    matrix fails the first rung and passes a later one, on the port's
    unrolled Cholesky on the CPU."""
    import torch

    from pddp_tpu_torch.utils.linalg import JITTER_LEVELS, small_cholesky
    dtype = {"f32": torch.float32, "f64": torch.float64}[dtype_name]
    eye = torch.eye(FAIL_N, dtype=dtype)
    for seed in range(1000):
        X = FAIL_SCALE[dtype_name] * np.random.default_rng(
            seed).standard_normal((FAIL_N - 1, FAIL_N))
        C = torch.as_tensor(X.T @ X, dtype=dtype)
        C = 0.5 * (C + C.T)
        ok = [bool(torch.isfinite(small_cholesky(C + j * eye)).all())
              for j in JITTER_LEVELS]
        if not ok[0] and any(ok):
            return seed, C.numpy(), ok.index(True)
    raise RuntimeError("no seed fails the first rung alone")


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pddp_tpu.utils.linalg import safe_cholesky
    out = {}
    for name in ("f32", "f64"):
        seed, C, rung = failing(name)
        out["fail_" + name] = C
        out["fail_seed_" + name] = np.asarray(seed)
        out["fail_rung_" + name] = np.asarray(rung)
    for n in SPD_SIZES:
        C = jnp.asarray(spd(n), jnp.float64)
        out["spd_{}".format(n)] = np.asarray(C)
        out["jac_{}".format(n)] = np.asarray(jax.jacrev(safe_cholesky)(C))
        out["hess_{}".format(n)] = np.asarray(jax.hessian(safe_cholesky)(C))
    print({k: v for k, v in out.items() if v.size < 2})
    np.savez(PATH, **out)
    print("wrote", PATH)


if __name__ == "__main__":
    main()
