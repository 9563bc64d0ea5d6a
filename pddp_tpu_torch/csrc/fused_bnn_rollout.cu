// K2 stage (d): the iLQR line search of the belief-state BNN dynamics
// (BNNDynamicsModel under UPPER_TRIANGULAR_CHOLESKY): a closed-loop rollout
// of A step sizes alpha over N steps, each step pushing P particles through
// the MC-dropout MLP and moment-matching them back into a Cholesky-encoded
// Gaussian. Three fragment entries run its device functions alone.
//
// Replaces the stateful variant of the Pallas kernel
// pddp_tpu/ops/fused_rollout.py:114 (fused_control_law with the particle
// BNN, pallas_call at :261), and the Mosaic probes of its fragments:
//   F1 = scripts/probe_micro.py:57, probe_micro2.py:46, probe_micro3.py:47
//        (noise inference: triangular solve and the finite fallback);
//   F2 = scripts/probe_micro4.py:83, probe_micro5.py:90 (moment match,
//        Cholesky ladder, triangle flatten and unflatten);
//   F3 = scripts/probe_kernel_mlp_batch.py:86 (the candidate MLP);
//   P7 = scripts/probe_fused_stateful.py:66/:91 is the rollout entry itself.
//
// Per step i and candidate a (one block each):
//   u   = U_i + (alpha k_i + K_i (z - Z_i)), clamped to the bounds if given
//   eps = solve eps Uc = prev - mean per particle, or eps_in[i] for all
//         particles when any element is not finite or i == 0
//   X   = mean + eps Uc; x = normalize([augment(X), constrain(u)])
//   out = MLP(x) with each particle's dropout masks; output = X + delta(out)
//   z   = [mean(output), triu(safe_cholesky(cov(output, ddof=1)))]
// which is BNNDynamicsModel.step (models/bnn/model.py) in the same order of
// operations. The rolling state (the previous outputs) stays in shared
// memory for the whole horizon.
//
// What bounds it on an H100: the MLP. At the main-path shape (net
// 6-200-200-8, P=100, A=10, N=25, f32) it does 2.1 GFLOP, which is 0.03 ms
// at the 67 TFLOP/s of plain f32 arithmetic, and it moves under 1 MB. With
// one block per candidate only A blocks run, so the time is N times one
// step of one SM: about 4.3 M multiply-adds per step.
//
// What the design does about that: the MLP runs from shared memory, with
// the activations stored transposed (feature-major) so a thread loads eight
// particles of one feature with vector loads and keeps eight accumulators
// per output column; weights are read through the read-only cache,
// coalesced across the column index. Particles run in chunks sized to the
// shared memory (all 100 at once in f32, two chunks in f64). Tensor cores,
// TMA, clusters (spreading one candidate over several SMs) and packing the
// batch of solves are later work.

#include <cuda_runtime.h>

#include <cstring>

#include "belief_codec.cuh"

namespace {

using pddp::tri;

constexpr int kMaxN = 8;
constexpr int kMaxNu = 4;
constexpr int kMaxNz = kMaxN + kMaxN * (kMaxN + 1) / 2;
constexpr int kMaxLayers = 6;
constexpr int kTile = 8;
// Defaults measured by scripts/bnn_kernel_variants.py on an H100 (PERF.md):
// 1024 threads and a 4-deep unroll keep the most weight loads in flight.
#ifndef PDDP_BNN_THREADS
#define PDDP_BNN_THREADS 1024
#endif
#ifndef PDDP_BNN_UNROLL
#define PDDP_BNN_UNROLL 4
#endif
constexpr int kThreads = PDDP_BNN_THREADS;  // threads per block
constexpr int kUnroll = PDDP_BNN_UNROLL;    // MLP inner-loop unroll
constexpr int kMaxSmem = 227 * 1024;

// Mirrored field by field by ops/fused_bnn_rollout.py:_CONFIG_FIELDS.
struct Config {
  int n, nu, P, n_layers;
  int width[kMaxLayers + 1];
  int w_off[kMaxLayers], b_off[kMaxLayers], m_off[kMaxLayers];
  int n_ang, n_nonang;
  int ang[kMaxN], nonang[kMaxN];
  int x_mean_off, x_std_off, dx_mean_off, dx_std_off, u_min_off, u_max_off;
  int jitter_off, n_jitter;
  int predicted_std, sample_input, infer_noise, constrained;
  int chunk, max_width;
};

constexpr int kConfigInts = sizeof(Config) / sizeof(int);

__host__ __device__ inline int pad8(int x) { return (x + 7) / 8 * 8; }

template <typename T>
__device__ __forceinline__ void load8(const T* a, T (&v)[kTile]) {
#pragma unroll
  for (int t = 0; t < kTile; ++t) v[t] = a[t];
}

template <>
__device__ __forceinline__ void load8<float>(const float* a,
                                              float (&v)[kTile]) {
  const float4 x = reinterpret_cast<const float4*>(a)[0];
  const float4 y = reinterpret_cast<const float4*>(a)[1];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

template <>
__device__ __forceinline__ void load8<double>(const double* a,
                                               double (&v)[kTile]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const double2 x = reinterpret_cast<const double2*>(a)[h];
    v[2 * h] = x.x;
    v[2 * h + 1] = x.y;
  }
}

// mean (n) and upper factor Uc (n x n) of an encoded state z.
template <typename T>
__device__ void decode(const T* z, int n, T* mean, T* Uc) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int r = e / n, c = e % n;
    Uc[e] = c >= r ? z[n + tri(r, c, n)] : T(0);
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) mean[j] = z[j];
  __syncthreads();
}

// F1: eps (P x n) with eps Uc = prev - mean per particle; eps0 for every
// particle when any element is not finite, or when ``first``.
template <typename T>
__device__ void infer_eps(const T* Uc, const T* mean, const T* prev,
                          const T* eps0, bool first, T* eps, int P, int n) {
  int bad = 0;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    T x[kMaxN];
    for (int j = 0; j < n; ++j) {
      T s = prev[p * n + j] - mean[j];
      for (int k = 0; k < j; ++k) s = s - x[k] * Uc[k * n + j];
      x[j] = s / Uc[j * n + j];
      bad |= !isfinite(x[j]);
    }
    for (int j = 0; j < n; ++j) eps[p * n + j] = x[j];
  }
  bad = __syncthreads_or(bad);
  if (bad || first)
    for (int e = threadIdx.x; e < P * n; e += blockDim.x) eps[e] = eps0[e];
  __syncthreads();
}

// F2: output particles (P x n) -> z = [mean, triu(U)], U the upper Cholesky
// factor of the ddof=1 covariance through the jitter ladder (the first rung
// whose factor is finite; else the square root of the diagonal clamped at
// 1e-12). M and C are scratch of n and n x n.
template <typename T>
__device__ void moment_match(const T* out, int P, int n, const T* jitter,
                             int n_jitter, T* M, T* C, T* z) {
  const int tid = threadIdx.x;
  if (tid < n) {
    T s = T(0);
    for (int p = 0; p < P; ++p) s += out[p * n + tid];
    M[tid] = s / T(P);
  }
  __syncthreads();
  if (tid < n * (n + 1) / 2) {
    int r = 0, rem = tid;
    while (rem >= n - r) rem -= n - r++;
    const int c = r + rem;
    T s = T(0);
    for (int p = 0; p < P; ++p)
      s += (out[p * n + r] - M[r]) * (out[p * n + c] - M[c]);
    s = s / T(P - 1);
    C[r * n + c] = s;
    C[c * n + r] = s;
  }
  __syncthreads();
  if (tid == 0) {
    T L[kMaxN * kMaxN];
    pddp::safe_cholesky_lower(C, n, jitter, n_jitter, L);
    for (int j = 0; j < n; ++j) z[j] = M[j];
    pddp::triu_flatten_lower_t(L, n, z + n);
  }
  __syncthreads();
}

// F3 on one chunk of cp particles starting at p0: in holds the chunk's net
// input feature-major (in[f * chunk + q]); the last layer writes the rows of
// out (P x width[n_layers]). Hidden layers: (x W + b) * mask, then ReLU.
template <typename T>
__device__ void mlp_chunk(const Config& cfg, const T* __restrict__ params,
                          T* in, T* nxt, T* out, int p0, int cp) {
  const int ntiles = (cp + kTile - 1) / kTile;
  const int chunk = cfg.chunk;
  for (int l = 0; l < cfg.n_layers; ++l) {
    const int K = cfg.width[l], O = cfg.width[l + 1];
    const T* __restrict__ W = params + cfg.w_off[l];
    const T* __restrict__ bias = params + cfg.b_off[l];
    const bool last = l == cfg.n_layers - 1;
    const T* mask = (!last && cfg.m_off[l] >= 0) ? params + cfg.m_off[l]
                                                 : nullptr;
    for (int item = threadIdx.x; item < ntiles * O; item += blockDim.x) {
      const int tile = item / O, o = item % O;
      T acc[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) acc[t] = T(0);
      const T* src = in + tile * kTile;
#pragma unroll kUnroll
      for (int kk = 0; kk < K; ++kk) {
        const T w = __ldg(W + kk * O + o);
        T a[kTile];
        load8(src + kk * chunk, a);
#pragma unroll
        for (int t = 0; t < kTile; ++t) acc[t] += a[t] * w;
      }
      const T b = __ldg(bias + o);
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int q = tile * kTile + t;
        T v = acc[t] + b;
        if (last) {
          if (q < cp) out[(p0 + q) * O + o] = v;
        } else {
          if (mask != nullptr) v = v * (q < cp ? mask[(p0 + q) * O + o]
                                               : T(0));
          nxt[o * chunk + q] = v < T(0) ? T(0) : v;  // ReLU that keeps a NaN
        }
      }
    }
    __syncthreads();
    T* s = in;
    in = nxt;
    nxt = s;
  }
}

// The net input of particles [p0, p0 + cp) from particles X (P x n) and the
// constrained action uc, feature-major into act.
template <typename T>
__device__ void net_input(const Config& cfg, const T* __restrict__ params,
                          const T* X, const T* uc, T* act, int p0, int cp) {
  const int n = cfg.n, naug = cfg.n_nonang + 2 * cfg.n_ang;
  const int F = cfg.width[0], chunk = cfg.chunk;
  const T* xm = params + cfg.x_mean_off;
  const T* xs = params + cfg.x_std_off;
  for (int e = threadIdx.x; e < F * chunk; e += blockDim.x) {
    const int f = e / chunk, q = e % chunk;
    T v = T(0);
    if (q < cp) {
      const T* x = X + (p0 + q) * n;
      if (f < cfg.n_nonang) {
        v = x[cfg.nonang[f]];
      } else if (f < naug) {
        const int g = f - cfg.n_nonang;
        const T th = x[cfg.ang[g / 2]];
        v = (g & 1) ? cos(th) : sin(th);
      } else {
        v = uc[f - naug];
      }
      v = (v - xm[f]) / xs[f];
    }
    act[f * chunk + q] = v;
  }
  __syncthreads();
}

template <typename T>
struct Smem {
  T *prev, *eps, *X, *out, *act0, *act1;
};

template <typename T>
__device__ Smem<T> carve(const Config& cfg, unsigned char* raw) {
  T* base = reinterpret_cast<T*>(raw);
  const int pn = pad8(cfg.P * cfg.n);
  Smem<T> s;
  s.prev = base;
  s.eps = s.prev + pn;
  s.X = s.eps + pn;
  s.out = s.X + pn;
  s.act0 = s.out + pad8(cfg.P * cfg.width[cfg.n_layers]);
  s.act1 = s.act0 + cfg.max_width * cfg.chunk;
  return s;
}

size_t smem_bytes(const Config& cfg, size_t itemsize) {
  const size_t pn = pad8(cfg.P * cfg.n);
  return (3 * pn + pad8(cfg.P * cfg.width[cfg.n_layers])
          + 2 * (size_t)cfg.max_width * cfg.chunk) * itemsize;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bnn_rollout_kernel(
    const T* __restrict__ Z, const T* __restrict__ U,
    const T* __restrict__ k, const T* __restrict__ K,
    const T* __restrict__ alphas, const T* __restrict__ params,
    const T* __restrict__ eps_in, const T* __restrict__ eps_out,
    const T* __restrict__ bounds, T* __restrict__ Z_out,
    T* __restrict__ U_out, T* __restrict__ AUX, int N, int A, Config cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(cfg, smem_raw);
  __shared__ T zc[kMaxNz], uc[kMaxNu], mean[kMaxN], Uc[kMaxN * kMaxN];
  __shared__ T M[kMaxN], C[kMaxN * kMaxN];
  const int n = cfg.n, nu = cfg.nu, P = cfg.P;
  const int nz = n + n * (n + 1) / 2, O = 2 * n, tid = threadIdx.x;
  const size_t b = blockIdx.x / A;
  const int a = blockIdx.x % A;
  Z += b * (N + 1) * nz;
  U += b * N * nu;
  k += b * N * nu;
  K += b * N * nu * nz;
  Z_out += b * (N + 1) * A * nz;
  U_out += b * N * A * nu;
  AUX += b * N * A * P * n;
  const T alpha = alphas[a];
  const T* dxm = params + cfg.dx_mean_off;
  const T* dxs = params + cfg.dx_std_off;

  for (int e = tid; e < nz; e += blockDim.x) {
    zc[e] = Z[e];
    Z_out[a * nz + e] = Z[e];
  }
  for (int e = tid; e < P * n; e += blockDim.x) sm.prev[e] = T(0);
  __syncthreads();

  for (int i = 0; i < N; ++i) {
    // The feedback law.
    if (tid < nu) {
      const T* Ki = K + ((size_t)i * nu + tid) * nz;
      T du = T(0);
      for (int j = 0; j < nz; ++j) du += (zc[j] - Z[(size_t)i * nz + j]) * Ki[j];
      T u = U[(size_t)i * nu + tid] + (alpha * k[(size_t)i * nu + tid] + du);
      if (bounds != nullptr) {
        const T lo = bounds[tid], hi = bounds[nu + tid];
        u = u < lo ? lo : u;  // a NaN stays, as in torch.clamp
        u = u > hi ? hi : u;
      }
      U_out[((size_t)i * A + a) * nu + tid] = u;
      if (cfg.constrained) {
        const T lo = params[cfg.u_min_off + tid];
        const T hi = params[cfg.u_max_off + tid];
        u = (hi - lo) / T(2) * tanh(u) + (hi + lo) / T(2);
      }
      uc[tid] = u;
    }
    decode(zc, n, mean, Uc);

    // The step's noise and particles.
    const T* e0 = eps_in + (size_t)i * P * n;
    if (!cfg.sample_input) {
      for (int e = tid; e < P * n; e += blockDim.x) sm.eps[e] = T(0);
      __syncthreads();
    } else if (!cfg.infer_noise) {
      for (int e = tid; e < P * n; e += blockDim.x) sm.eps[e] = e0[e];
      __syncthreads();
    } else {
      infer_eps(Uc, mean, sm.prev, e0, i == 0, sm.eps, P, n);
    }
    T* aux = AUX + ((size_t)i * A + a) * P * n;
    for (int e = tid; e < P * n; e += blockDim.x) {
      const int p = e / n, j = e % n;
      if (cfg.sample_input) {
        T s = T(0);
        for (int q = 0; q < n; ++q) s += sm.eps[p * n + q] * Uc[q * n + j];
        sm.X[e] = mean[j] + s;
      } else {
        sm.X[e] = mean[j];
      }
      aux[e] = sm.eps[e];
    }
    __syncthreads();

    // The MLP, chunk by chunk.
    for (int p0 = 0; p0 < P; p0 += cfg.chunk) {
      const int cp = min(cfg.chunk, P - p0);
      net_input(cfg, params, sm.X, uc, sm.act0, p0, cp);
      mlp_chunk(cfg, params, sm.act0, sm.act1, sm.out, p0, cp);
    }

    // Next-state particles: the rolling state of the next step.
    const T* eo = cfg.predicted_std ? eps_out + (size_t)i * P * n : nullptr;
    for (int e = tid; e < P * n; e += blockDim.x) {
      const int p = e / n, j = e % n;
      T dx = sm.out[p * O + j] * dxs[j] + dxm[j];
      if (cfg.predicted_std) {
        const T log_std = sm.out[p * O + n + j] + log(dxs[j]);
        dx = dx + exp(log_std) * eo[e];
      }
      sm.prev[e] = sm.X[e] + dx;
    }
    __syncthreads();

    moment_match(sm.prev, P, n, params + cfg.jitter_off, cfg.n_jitter, M, C,
                 zc);
    for (int e = tid; e < nz; e += blockDim.x)
      Z_out[((size_t)(i + 1) * A + a) * nz + e] = zc[e];
    __syncthreads();
  }
}

// F1 entry: one block per group g of U_chol (G, n, n), deltas (G, P, n).
template <typename T>
__global__ void __launch_bounds__(kThreads) bnn_infer_eps_kernel(
    const T* __restrict__ U_chol, const T* __restrict__ deltas,
    const T* __restrict__ eps0, int first, T* __restrict__ eps, Config cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = cfg.n, P = cfg.P;
  T* D = reinterpret_cast<T*>(smem_raw);
  T* E = D + pad8(P * n);
  __shared__ T Uc[kMaxN * kMaxN], zero[kMaxN];
  const size_t g = blockIdx.x;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    Uc[e] = U_chol[g * n * n + e];
  for (int e = threadIdx.x; e < n; e += blockDim.x) zero[e] = T(0);
  for (int e = threadIdx.x; e < P * n; e += blockDim.x)
    D[e] = deltas[g * P * n + e];
  __syncthreads();
  infer_eps(Uc, zero, D, eps0, first != 0, E, P, n);
  for (int e = threadIdx.x; e < P * n; e += blockDim.x)
    eps[g * P * n + e] = E[e];
}

// F2 entry: particles (G, P, n) -> z (G, nz) and its decoded factor
// (G, n, n).
template <typename T>
__global__ void __launch_bounds__(kThreads) bnn_moment_match_kernel(
    const T* __restrict__ particles, const T* __restrict__ params,
    T* __restrict__ z_out, T* __restrict__ U_out, Config cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = cfg.n, P = cfg.P, nz = n + n * (n + 1) / 2;
  T* out = reinterpret_cast<T*>(smem_raw);
  __shared__ T z[kMaxNz], M[kMaxN], C[kMaxN * kMaxN], Uc[kMaxN * kMaxN];
  const size_t g = blockIdx.x;
  for (int e = threadIdx.x; e < P * n; e += blockDim.x)
    out[e] = particles[g * P * n + e];
  __syncthreads();
  moment_match(out, P, n, params + cfg.jitter_off, cfg.n_jitter, M, C, z);
  decode(z, n, M, Uc);
  for (int e = threadIdx.x; e < nz; e += blockDim.x) z_out[g * nz + e] = z[e];
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    U_out[g * n * n + e] = Uc[e];
}

// F3 entry: net inputs x (G, P, F) -> outputs (G, P, O).
template <typename T>
__global__ void __launch_bounds__(kThreads) bnn_mlp_kernel(
    const T* __restrict__ x, const T* __restrict__ params,
    T* __restrict__ y, Config cfg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(cfg, smem_raw);
  const int P = cfg.P, F = cfg.width[0], O = cfg.width[cfg.n_layers];
  const size_t g = blockIdx.x;
  for (int p0 = 0; p0 < P; p0 += cfg.chunk) {
    const int cp = min(cfg.chunk, P - p0);
    for (int e = threadIdx.x; e < F * cfg.chunk; e += blockDim.x) {
      const int f = e / cfg.chunk, q = e % cfg.chunk;
      sm.act0[e] = q < cp ? x[(g * P + p0 + q) * F + f] : T(0);
    }
    __syncthreads();
    mlp_chunk(cfg, params, sm.act0, sm.act1, sm.out, p0, cp);
  }
  for (int e = threadIdx.x; e < P * O; e += blockDim.x)
    y[g * P * O + e] = sm.out[e];
}

bool valid(const Config& cfg) {
  if (cfg.n < 1 || cfg.n > kMaxN || cfg.P < 2 || cfg.n_layers < 1 || cfg.n_layers > kMaxLayers ||
      cfg.chunk < kTile || cfg.chunk % kTile != 0 ||
      cfg.width[cfg.n_layers] != 2 * cfg.n)
    return false;
  return true;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmem) - 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T>
int launch_rollout(const T* Z, const T* U, const T* k, const T* K,
                   const T* alphas, const T* params, const T* eps_in,
                   const T* eps_out, const T* bounds, T* Z_out, T* U_out,
                   T* AUX, int B, int N, int A, const int* cfg_ints,
                   void* stream) {
  Config cfg;
  memcpy(&cfg, cfg_ints, sizeof(cfg));
  if (B < 1 || N < 1 || A < 1 || cfg.nu < 1 || cfg.nu > kMaxNu ||
      !valid(cfg))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(cfg, sizeof(T));
  int err = set_smem(bnn_rollout_kernel<T>, bytes);
  if (err != 0) return err;
  bnn_rollout_kernel<T><<<B * A, kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      Z, U, k, K, alphas, params, eps_in, eps_out, bounds, Z_out, U_out, AUX,
      N, A, cfg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_infer_eps(const T* U_chol, const T* deltas, const T* eps0,
                     int first, T* eps, int G, const int* cfg_ints,
                     void* stream) {
  Config cfg;
  memcpy(&cfg, cfg_ints, sizeof(cfg));
  if (G < 1 || cfg.n < 1 || cfg.n > kMaxN || cfg.P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = 2 * pad8(cfg.P * cfg.n) * sizeof(T);
  int err = set_smem(bnn_infer_eps_kernel<T>, bytes);
  if (err != 0) return err;
  bnn_infer_eps_kernel<T><<<G, kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      U_chol, deltas, eps0, first, eps, cfg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_moment_match(const T* particles, const T* params, T* z_out,
                        T* U_out, int G, const int* cfg_ints, void* stream) {
  Config cfg;
  memcpy(&cfg, cfg_ints, sizeof(cfg));
  if (G < 1 || cfg.n < 1 || cfg.n > kMaxN || cfg.P < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = pad8(cfg.P * cfg.n) * sizeof(T);
  int err = set_smem(bnn_moment_match_kernel<T>, bytes);
  if (err != 0) return err;
  bnn_moment_match_kernel<T><<<G, kThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      particles, params, z_out, U_out, cfg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mlp(const T* x, const T* params, T* y, int G, const int* cfg_ints,
               void* stream) {
  Config cfg;
  memcpy(&cfg, cfg_ints, sizeof(cfg));
  if (G < 1 || !valid(cfg)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(cfg, sizeof(T));
  int err = set_smem(bnn_mlp_kernel<T>, bytes);
  if (err != 0) return err;
  bnn_mlp_kernel<T><<<G, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(x, params, y, cfg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pddp_bnn_config_ints() { return kConfigInts; }

#define PDDP_BNN_ENTRIES(T, S)                                                \
  int pddp_bnn_rollout_##S(const T* Z, const T* U, const T* k, const T* K,   \
                           const T* alphas, const T* params,                 \
                           const T* eps_in, const T* eps_out,                \
                           const T* bounds, T* Z_out, T* U_out, T* AUX,      \
                           int B, int N, int A, const int* cfg,              \
                           void* stream) {                                   \
    return launch_rollout<T>(Z, U, k, K, alphas, params, eps_in, eps_out,    \
                             bounds, Z_out, U_out, AUX, B, N, A, cfg,        \
                             stream);                                        \
  }                                                                           \
  int pddp_bnn_infer_eps_##S(const T* U_chol, const T* deltas,               \
                             const T* eps0, int first, T* eps, int G,        \
                             const int* cfg, void* stream) {                 \
    return launch_infer_eps<T>(U_chol, deltas, eps0, first, eps, G, cfg,     \
                               stream);                                      \
  }                                                                           \
  int pddp_bnn_moment_match_##S(const T* particles, const T* params,         \
                                T* z_out, T* U_out, int G, const int* cfg,   \
                                void* stream) {                              \
    return launch_moment_match<T>(particles, params, z_out, U_out, G, cfg,   \
                                  stream);                                   \
  }                                                                           \
  int pddp_bnn_mlp_##S(const T* x, const T* params, T* y, int G,             \
                       const int* cfg, void* stream) {                       \
    return launch_mlp<T>(x, params, y, G, cfg, stream);                      \
  }

PDDP_BNN_ENTRIES(float, f32)
PDDP_BNN_ENTRIES(double, f64)

#undef PDDP_BNN_ENTRIES

}  // extern "C"
