// The five state codecs' device functions, shared by the line-search
// kernels K2(a)-(c) (fused_rollout.cu), K2(d) (fused_bnn_rollout.cu) and
// K2(e) (fused_particle_rollout.cu): the row-major upper-triangle layout of
// encoding.UPPER_TRIANGULAR_CHOLESKY, utils.linalg's safe_cholesky ladder,
// the decode and re-encode of encoding.py that K2(c) applies to a mean
// state (codec a constant of the compiler), and, with the codec a value
// known at run time, the factor of decode_covar_sqrt and the encode of a
// moment match (utils/particles.moment_match), in the plain versions'
// order of operations.
//
// All functions run on one thread; n (N) is the state size (n <= 8).

#pragma once

#include <cuda_runtime.h>

namespace pddp {

// StateEncoding's values (encoding.py).
constexpr int kFull = 0, kChol = 1, kVar = 2, kStd = 3, kIgnore = 4;

// Elements of an encoded state of n means under codec.
__host__ __device__ constexpr int encoded_size(int codec, int n) {
  return codec == kFull ? n + n * n
         : codec == kChol ? n + n * (n + 1) / 2
         : codec == kIgnore ? n
                            : 2 * n;
}

// encoding._IGNORE_STD: the standard deviation IGNORE_UNCERTAINTY decodes.
constexpr double kIgnoreStd = 1e-3;

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

// decode_var of the belief part of z (n values).
template <typename T, int n, int codec>
__device__ __forceinline__ void decode_var(const T* z, T* v) {
  const T* o = z + n;
  for (int j = 0; j < n; ++j) {
    if constexpr (codec == kVar) {
      v[j] = o[j];
    } else if constexpr (codec == kStd) {
      v[j] = o[j] * o[j];
    } else if constexpr (codec == kFull) {
      v[j] = o[j * n + j];
    } else {  // the squared columns of the upper factor, summed
      T s = T(0);
      for (int i = 0; i <= j; ++i) s += o[tri(i, j, n)] * o[tri(i, j, n)];
      v[j] = s;
    }
  }
}

// encode(mean, V=v): the belief part of z.
template <typename T, int n, int codec>
__device__ __forceinline__ void encode_var(const T* v, T* z) {
  T* o = z + n;
  if constexpr (codec == kVar) {
    for (int j = 0; j < n; ++j) o[j] = v[j];
  } else if constexpr (codec == kStd) {
    for (int j = 0; j < n; ++j) o[j] = sqrt(v[j]);
  } else if constexpr (codec == kFull) {
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c) o[r * n + c] = r == c ? v[r] : T(0);
  } else {  // diag(sqrt(max(v, 0))), keeping a NaN
    for (int r = 0; r < n; ++r)
      for (int c = r; c < n; ++c)
        o[tri(r, c, n)] = r == c ? sqrt(v[r] < T(0) ? T(0) : v[r]) : T(0);
  }
}

// decode_covar of the belief part of z (n x n, row-major).
template <typename T, int n, int codec>
__device__ __forceinline__ void decode_covar(const T* z, T* C) {
  const T* o = z + n;
  if constexpr (codec == kFull) {
    for (int e = 0; e < n * n; ++e) C[e] = o[e];
  } else if constexpr (codec == kChol) {  // U^T U
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c) {
        T s = T(0);
        for (int k = 0; k <= (r < c ? r : c); ++k)
          s += o[tri(k, r, n)] * o[tri(k, c, n)];
        C[r * n + c] = s;
      }
  } else {
    T v[n];
    decode_var<T, n, codec>(z, v);
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c) C[r * n + c] = r == c ? v[r] : T(0);
  }
}

// encode(mean, C=C): the belief part of z.
template <typename T, int n, int codec>
__device__ __forceinline__ void encode_covar(const T* C, T* z) {
  T* o = z + n;
  if constexpr (codec == kFull) {
    for (int e = 0; e < n * n; ++e) o[e] = C[e];
  } else if constexpr (codec == kChol) {
    // safe_cholesky's default ladder (utils.linalg.JITTER_LEVELS); C is
    // symmetric as decoded, so its symmetrization is exact.
    const T jitter[5] = {T(1e-12), T(1e-9), T(1e-6), T(1e-3), T(1e-1)};
    T L[n * n];
    pddp::safe_cholesky_lower<n>(C, jitter, 5, L);
    pddp::triu_flatten_lower_t(L, n, o);
  } else {
    T v[n];
    for (int j = 0; j < n; ++j) v[j] = C[j * n + j];
    encode_var<T, n, codec>(v, z);
  }
}


// The upper factor Uc (row-major N x N, C = Uc^T Uc) of the belief part of
// z under codec, as encoding.decode_covar_sqrt: FULL safe_cholesky of
// 0.5 (C + C^T) through the default ladder, CHOL the flat triangle, VAR
// diag(sqrt(max(v, 0))) (keeping a NaN), STD diag(s), IGNORE 1e-3 I.
template <int N, typename T>
__device__ __forceinline__ void decode_covar_sqrt(const T* z, int codec,
                                                  T* Uc) {
  const T* o = z + N;
  if (codec == kFull) {
    const T jitter[5] = {T(1e-12), T(1e-9), T(1e-6), T(1e-3), T(1e-1)};
    T C[N * N], L[N * N];
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c)
        C[r * N + c] = T(0.5) * (o[r * N + c] + o[c * N + r]);
    safe_cholesky_lower<N>(C, jitter, 5, L);
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c) Uc[r * N + c] = c >= r ? L[c * N + r] : T(0);
  } else if (codec == kChol) {
    triu_unflatten(o, N, Uc);
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c) Uc[r * N + c] = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T d;
      if (codec == kVar) {
        d = sqrt(o[j] < T(0) ? T(0) : o[j]);
      } else if (codec == kStd) {
        d = o[j];
      } else {
        d = T(kIgnoreStd);
      }
      Uc[j * N + j] = d;
    }
  }
}

// The encoded state of a moment match (utils/particles.moment_match with
// the jitter ladder `jitter`): z = [M, belief] with the belief part from
// S2, which the matrix codecs take as the ddof=1 covariance (row-major
// N x N, symmetric), FULL as it is and CHOL as the flat upper triangle of
// safe_cholesky(S2), and the diagonal codecs as the ddof=0 variances (N):
// S = sqrt(S2), VAR stores S^2 and STD stores S. IGNORE stores M alone.
template <int N, typename T>
__device__ __forceinline__ void encode_moments(const T* M, const T* S2,
                                               int codec, const T* jitter,
                                               int n_jitter, T* z) {
#pragma unroll
  for (int j = 0; j < N; ++j) z[j] = M[j];
  T* o = z + N;
  if (codec == kFull) {
    for (int e = 0; e < N * N; ++e) o[e] = S2[e];
  } else if (codec == kChol) {
    T C[N * N], L[N * N];
#pragma unroll
    for (int e = 0; e < N * N; ++e) C[e] = S2[e];
    safe_cholesky_lower<N>(C, jitter, n_jitter, L);
    triu_flatten_lower_t(L, N, o);
  } else if (codec != kIgnore) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T s = sqrt(S2[j]);
      o[j] = codec == kVar ? s * s : s;
    }
  }
}

}  // namespace pddp
