// K2 stage (e): the iLQR line search of ParticleDynamicsModel over one of
// the four known-dynamics examples (utils/particles.py), under every state
// codec: a closed-loop rollout of A step sizes alpha over N steps, each
// step pushing P particles through the example's dynamics and
// moment-matching them back into an encoded Gaussian. The model is
// stateful: each step's particle outputs are the next step's rolling
// state, and each step's noise is its aux.
//
// Replaces the stateful variant of the Pallas kernel
// pddp_tpu/ops/fused_rollout.py:114 (fused_control_law with
// allow_stateful on a particle model, pallas_call at :261).
//
// Per step i and candidate a:
//   u   = U_i + (alpha_a k_i + K_i (z - Z_i)), clamped to the bounds if
//         given (U_out stores this u)
//   mean, Uc = decode_mean(z), decode_covar_sqrt(z) under the codec
//   eps = solve eps Uc = prev - mean per particle; eps_table[i] for all
//         particles where i == 0, noise inference is off, or any element
//         of any particle's solve is not finite
//   X   = mean + eps Uc; out = the example's step of each particle under
//         IGNORE_UNCERTAINTY, after constrain(u) for a constrain_model
//         subclass
//   z   = moment_match(out): the mean, and the ddof=1 covariance (FULL;
//         CHOL through safe_cholesky's default 5-rung ladder) or the
//         ddof=0 std (VAR stores its square, STD itself; IGNORE the mean)
//   prev = out, aux[i] = eps
// which is ParticleDynamicsModel.step in the same order of operations, but
// for the sums over particles (below).
//
// What bounds it on an H100. The dynamics are a few dozen flops a
// particle, so at phase 19's shapes (P=100, A=10, N=50) the work is a few
// MFLOP and the bytes are the AUX output (N A P n values, 1.6 MB at n=4
// in f64): microseconds. Each step is a latency chain instead: the feedback
// law (an nz-long dot product), the noise solve, the step, two rounds of
// sums over P (the mean, then the second moments), and the encode and
// decode (under the matrix codecs a Cholesky ladder of up to five rungs)
// on one thread, with five block barriers between them.
//
// The first design: one thread block per (solve, candidate), one thread
// per particle (P <= 1024), each particle's state, noise and previous
// output in registers, the example's step in registers (its state size a
// constant of the compiler), the codec and the constrained flag values
// known at run time (they size no register array). The sums over P go
// over each warp by a butterfly of shuffles, then over the warps in
// ascending order by one thread per entry: a fixed order, other than the
// plain version's. The noise solve's fallback is a block-wide OR
// (__syncthreads_or), so it sees every particle. Thread 0 encodes the
// state, stores its row and decodes the next step's mean and factor.

#include <cuda_runtime.h>

#include "belief_codec.cuh"
#include "examples.cuh"

namespace {

using pddp::kChol;
using pddp::kFull;
using pddp::kIgnore;
using pddp::kStd;
using pddp::kVar;

constexpr int kMaxN = 8;
constexpr int kMaxNu = 4;
constexpr int kMaxNz = kMaxN + kMaxN * kMaxN;      // the full covariance
constexpr int kMaxThreads = 1024;                  // so P <= 1024
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxEntries = kMaxN * (kMaxN + 1) / 2;
constexpr int kMaxParams = 8 + 2 * kMaxNu;         // model, then bounds

template <typename T>
struct Args {
  const T *Z, *U, *k, *K, *alphas, *params, *eps, *bounds;
  T *Z_out, *U_out, *AUX;
  int B, N, A, P;
  int codec, constrained, infer;
};

// The sum over a warp's 32 lanes, in every lane (a butterfly: the same
// order in every lane and every call).
template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T, class M>
__global__ void __launch_bounds__(kMaxThreads)
    particle_rollout_kernel(const Args<T> g) {
  constexpr int n = M::n, nu = M::nu;
  __shared__ T prm[kMaxParams];
  __shared__ T z[kMaxNz], mean[n], Uc[n * n], uc[nu];
  __shared__ T Ms[n], S2[n * n];
  __shared__ T part[kMaxWarps][kMaxEntries];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int N = g.N, A = g.A, P = g.P, codec = g.codec;
  const int nz = pddp::encoded_size(codec, n);
  const size_t b = blockIdx.x / A;
  const int a = static_cast<int>(blockIdx.x % A);
  const bool active = tid < P;
  const bool matrix = codec == kFull || codec == kChol;
  const int n_prm = M::n_params + (g.constrained ? 2 * nu : 0);
  const T* Z = g.Z + b * (N + 1) * nz;
  const T* U = g.U + b * N * nu;
  const T* k = g.k + b * N * nu;
  const T* K = g.K + b * N * nu * nz;
  T* Z_out = g.Z_out + b * (N + 1) * A * nz;
  T* U_out = g.U_out + b * N * A * nu;
  T* AUX = g.AUX + b * N * A * P * n;
  const T alpha = g.alphas[a];

  for (int e = tid; e < n_prm; e += blockDim.x) prm[e] = g.params[e];
  if (tid == 0) {
    for (int e = 0; e < nz; ++e) {
      z[e] = Z[e];
      Z_out[a * nz + e] = Z[e];
    }
#pragma unroll
    for (int j = 0; j < n; ++j) mean[j] = z[j];
    pddp::decode_covar_sqrt<n>(z, codec, Uc);
  }
  __syncthreads();

  T prev[n];  // this particle's previous output: its rolling state
#pragma unroll
  for (int j = 0; j < n; ++j) prev[j] = T(0);

  for (int i = 0; i < N; ++i) {
    // The feedback law, one thread an action dimension; the barrier of
    // the noise's fallback publishes uc.
    if (tid < nu) {
      const T* Zi = Z + (size_t)i * nz;
      const T* Ki = K + ((size_t)i * nu + tid) * nz;
      T du = T(0);
      for (int l = 0; l < nz; ++l) du += (z[l] - Zi[l]) * Ki[l];
      T u = U[(size_t)i * nu + tid] + (alpha * k[(size_t)i * nu + tid] + du);
      if (g.bounds != nullptr) {
        const T lo = g.bounds[tid], hi = g.bounds[nu + tid];
        u = u < lo ? lo : u;  // a NaN stays, as in torch.clamp
        u = u > hi ? hi : u;
      }
      U_out[((size_t)i * A + a) * nu + tid] = u;
      uc[tid] = g.constrained
                    ? pddp::constrain(u, prm[M::n_params + tid],
                                      prm[M::n_params + nu + tid])
                    : u;
    }

    // The step's noise: eps Uc = prev - mean solved by column sweep (as
    // utils.linalg.tria_solve_right), or the drawn rows.
    const bool solve = g.infer && i > 0;
    T e[n];
    int bad = 0;
    if (solve && active) {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        T s = prev[j] - mean[j];
#pragma unroll
        for (int q = 0; q < j; ++q) s = s - e[q] * Uc[q * n + j];
        e[j] = s / Uc[j * n + j];
        bad |= !isfinite(e[j]);
      }
    }
    bad = __syncthreads_or(bad);
    if (active) {
      if (!solve || bad) {
        const T* e0 = g.eps + ((size_t)i * P + tid) * n;
#pragma unroll
        for (int j = 0; j < n; ++j) e[j] = e0[j];
      }
      T* aux = AUX + (((size_t)i * A + a) * P + tid) * n;
      T X[n], u[nu];
#pragma unroll
      for (int j = 0; j < n; ++j) {
        aux[j] = e[j];
        T s = T(0);
#pragma unroll
        for (int r = 0; r < n; ++r) s += e[r] * Uc[r * n + j];
        X[j] = mean[j] + s;
      }
#pragma unroll
      for (int m = 0; m < nu; ++m) u[m] = uc[m];
      M::step(prm, X, u, prev);
    }

    // The moment match: the mean ...
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const T s = warp_sum(active ? prev[j] : T(0));
      if (lane == 0) part[warp][j] = s;
    }
    __syncthreads();
    if (tid < n) {
      T s = T(0);
      for (int w = 0; w < warps; ++w) s += part[w][tid];
      Ms[tid] = s / T(P);
    }
    __syncthreads();
    // ... then the second moments about it: the upper triangle of the
    // covariance, or the variances.
    if (codec != kIgnore) {
      T d[n];
#pragma unroll
      for (int j = 0; j < n; ++j) d[j] = active ? prev[j] - Ms[j] : T(0);
      if (matrix) {
        int ent = 0;
#pragma unroll
        for (int r = 0; r < n; ++r)
#pragma unroll
          for (int c = r; c < n; ++c, ++ent) {
            const T s = warp_sum(d[r] * d[c]);
            if (lane == 0) part[warp][ent] = s;
          }
      } else {
#pragma unroll
        for (int j = 0; j < n; ++j) {
          const T s = warp_sum(d[j] * d[j]);
          if (lane == 0) part[warp][j] = s;
        }
      }
    }
    __syncthreads();
    const int entries = codec == kIgnore ? 0 : matrix ? n * (n + 1) / 2 : n;
    for (int t = tid; t < entries; t += blockDim.x) {  // 36 > 32 at n = 8
      T s = T(0);
      for (int w = 0; w < warps; ++w) s += part[w][t];
      if (matrix) {
        int r = 0, rem = t;
        while (rem >= n - r) rem -= n - r++;
        const int c = r + rem;
        s = s / T(P - 1);
        S2[r * n + c] = s;
        S2[c * n + r] = s;
      } else {
        S2[t] = s / T(P);
      }
    }
    __syncthreads();
    if (tid == 0) {
      const T jitter[5] = {T(1e-12), T(1e-9), T(1e-6), T(1e-3), T(1e-1)};
      pddp::encode_moments<n>(Ms, S2, codec, jitter, 5, z);
      T* row = Z_out + ((size_t)(i + 1) * A + a) * nz;
      for (int e2 = 0; e2 < nz; ++e2) row[e2] = z[e2];
#pragma unroll
      for (int j = 0; j < n; ++j) mean[j] = z[j];
      pddp::decode_covar_sqrt<n>(z, codec, Uc);
    }
    __syncthreads();
  }
}

template <typename T, class M>
int launch_one(const Args<T>& g, cudaStream_t stream) {
  const int threads = (g.P + 31) / 32 * 32;
  const long blocks = long(g.B) * g.A;
  if (threads > kMaxThreads || blocks > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  particle_rollout_kernel<T, M><<<unsigned(blocks), threads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args<T>& g, int model, void* stream_ptr) {
  if (g.B < 1 || g.N < 1 || g.A < 1 || g.P < 2 || g.codec < kFull ||
      g.codec > kIgnore)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (model) {
    case 0: return launch_one<T, pddp::Cartpole>(g, stream);
    case 1: return launch_one<T, pddp::Pendulum>(g, stream);
    case 2: return launch_one<T, pddp::DoubleCartpole>(g, stream);
    case 3: return launch_one<T, pddp::Rendezvous>(g, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// model: 0 cartpole, 1 pendulum, 2 double cartpole, 3 rendezvous (the
// inner model); codec: StateEncoding's value; constrained: the inner model
// is constrain_model's subclass, its bounds (lower, then upper, nu each)
// after its parameters in params; infer: noise inference on.
// Z (B, N+1, nz), U and k (B, N, nu), K (B, N, nu, nz), alphas (A), eps
// (>= N, P, n) the episode noise, bounds (2, nu) or null; Z_out
// (B, N+1, A, nz), U_out (B, N, A, nu), AUX (B, N, A, P, n).
#define PDDP_PARTICLE_ENTRY(T, S)                                            \
  int pddp_particle_rollout_##S(                                             \
      const T* Z, const T* U, const T* k, const T* K, const T* alphas,       \
      const T* params, const T* eps, const T* bounds, T* Z_out, T* U_out,    \
      T* AUX, int B, int N, int A, int P, int model, int codec,              \
      int constrained, int infer, void* stream) {                            \
    const Args<T> g{Z,     U,     k,   K, alphas, params, eps,   bounds,     \
                    Z_out, U_out, AUX, B, N,      A,      P,     codec,      \
                    constrained,  infer};                                    \
    return launch<T>(g, model, stream);                                      \
  }

#ifndef PDDP_F64_ONLY
PDDP_PARTICLE_ENTRY(float, f32)
#endif
#ifndef PDDP_F32_ONLY
PDDP_PARTICLE_ENTRY(double, f64)
#endif

}  // extern "C"
