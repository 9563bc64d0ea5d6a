// The Cholesky codec's device functions, shared by the line-search kernels
// (fused_rollout.cu, fused_bnn_rollout.cu): the row-major upper-triangle
// layout of encoding.UPPER_TRIANGULAR_CHOLESKY and utils.linalg's
// safe_cholesky ladder, in the plain versions' order of operations.
//
// All functions run on one thread; n (N) is the state size (n <= 8).

#pragma once

#include <cuda_runtime.h>

namespace pddp {

// Offset of (r, c), c >= r, in the row-major upper triangle of an n x n
// (encoding._flatten_triu).
__host__ __device__ __forceinline__ int tri(int r, int c, int n) {
  return r * n - r * (r - 1) / 2 + (c - r);
}

// Upper factor U (row-major n x n, zeros below the diagonal) from its
// flattened triangle.
template <typename T>
__device__ __forceinline__ void triu_unflatten(const T* flat, int n, T* U) {
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c) U[r * n + c] = c >= r ? flat[tri(r, c, n)]
                                                     : T(0);
}

// The flattened triangle of U = L^T, L lower (row-major n x n).
template <typename T>
__device__ __forceinline__ void triu_flatten_lower_t(const T* L, int n,
                                                     T* flat) {
  for (int r = 0; r < n; ++r)
    for (int c = r; c < n; ++c) flat[tri(r, c, n)] = L[c * n + r];
}

// Lower Cholesky factor L (row-major N x N, the lower triangle written) of
// the symmetric C through a jitter ladder: the first rung jitter[q] whose
// Cholesky-Crout factor of C + jitter[q] I is finite wins; where every
// rung fails, L is diag(sqrt(max(diag C, 1e-12))), which keeps a NaN
// (utils.linalg.safe_cholesky). N is a constant of the compiler, so the
// factor stays in registers. A failed rung's later entries are computed
// and then overwritten by the next rung, which reads only the entries it
// computed itself: the same result as stopping at the first non-finite
// entry.
template <int N, typename T>
__device__ __forceinline__ void safe_cholesky_lower(const T* C,
                                                    const T* jitter,
                                                    int n_jitter, T* L) {
  bool found = false;
  for (int q = 0; q < n_jitter && !found; ++q) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T s = C[i * N + j] + (i == j ? jitter[q] : T(0));
#pragma unroll
        for (int k = 0; k < j; ++k) s = s - L[i * N + k] * L[j * N + k];
        L[i * N + j] = i == j ? sqrt(s) : s / L[j * N + j];
        ok = ok && isfinite(L[i * N + j]);
      }
    }
    found = ok;
  }
  if (!found) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < i; ++j) L[i * N + j] = T(0);
      const T d = C[i * N + i];
      L[i * N + i] = sqrt(d < T(1e-12) ? T(1e-12) : d);  // keeps a NaN
    }
  }
}

}  // namespace pddp
