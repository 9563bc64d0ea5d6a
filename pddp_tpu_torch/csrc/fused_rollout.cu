// K2 stages (a)-(c): the iLQR line search of the known-dynamics examples
// (cartpole, pendulum, double cartpole, rendezvous) under every state
// codec: a closed-loop rollout of A step sizes alpha over N steps, with
// the cost accumulated on the way under IGNORE_UNCERTAINTY.
//
// Replaces the Pallas kernel pddp_tpu/ops/fused_rollout.py:114
// (fused_control_law; its pallas_call is at :261) for stateless models.
// Pallas traced the model's and cost's jnp code into the kernel; CUDA
// cannot, so this kernel carries its own copy of each example's step
// (examples.cuh, shared with K2(e)) and of the QR cost, as templates on
// (model, codec, cost), each also instantiated for constrain_model's
// subclass of the example (constrain(u) before the step, the bounds after
// the parameters; U_out and the cost keep the unsquashed u), so that the
// other instances keep their code:
//   stage (a) cartpole under IGNORE_UNCERTAINTY (examples/cartpole);
//   stage (b) pendulum, double cartpole (a 3x3 adjugate solve) and
//             rendezvous under IGNORE_UNCERTAINTY, with the clamp;
//   stage (c) every example under VARIANCE_ONLY, STANDARD_DEVIATION_ONLY,
//             UPPER_TRIANGULAR_CHOLESKY and FULL_COVARIANCE_MATRIX, which
//             return trajectories only (the cost is the caller's batched
//             post-pass).
// Per step i and candidate a:
//   du = alpha_a k_i + K_i (z - z_i),  u = clamp(u_i + du, u_min, u_max)
//   J += d^T Q d + (u - u*)^T R (u - u*),  d = y(z) - x*, y = z or its
//        angular augmentation [non-angular, sin, cos, ...]
//   z  = decode -> the model's mean step -> encode, as the model's apply
// and at the end J += d_T^T Q_term d_T. The belief part of z goes through
// the decode and re-encode arithmetic of encoding.py (the round trip is
// not the identity in floating point): the variance models re-encode
// decode_var(z), rendezvous re-encodes decode_covar(z), under the Cholesky
// codec through safe_cholesky's 5-rung ladder (belief_codec.cuh, which
// holds the five codecs' decode and encode). Every
// expression keeps the plain version's order of operations. The model's
// and cost's parameters arrive in a small device buffer (layout in
// ops/fused_rollout.py), so the values a caller set reach the kernel.
//
// What bounds it on an H100: at the main-path shapes (N=200, A=10, f32) it
// reads a few KB and writes under 100 KB, so the roofline says
// nanoseconds. Its real limit is the chain of N dependent model steps on
// each candidate: the time is N times the latency of one step (tens to a
// few hundred dependent flops, sin/cos, divisions; under the Cholesky
// codec at n=8 a factorization of up to five rungs).
//
// What the design does about that: one lane per candidate, each keeping
// its state in registers for the whole horizon (the n=8 belief matrices of
// rendezvous spill to local memory), and one warp per group of up to 32 of
// a solve's candidates (a solve of A candidates takes ceil(A / 32) warps,
// each staging the same nominal rows for itself, so no warp waits on
// another); several warps per block, the batch. Nothing but the chain is
// left in a step: the nominal rows z_i, u_i, k_i, K_i arrive in shared memory ahead
// of use, a ring of chunks of steps (async_copy.cuh), the bounds sit in
// registers, the parameters in shared memory, and no step has a barrier.
// A chunk's states and actions gather in shared memory; when it ends, all
// 32 lanes take its stage costs (independent once the states are known;
// each candidate then adds its own in step order) and store its rows to
// Z_out and U_out contiguously.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "belief_codec.cuh"
#include "examples.cuh"

namespace {

using pddp::tri;

using pddp::Cartpole;
using pddp::DoubleCartpole;
using pddp::Pendulum;
using pddp::Rendezvous;
using pddp::kChol;
using pddp::kFull;
using pddp::kIgnore;
using pddp::kStd;
using pddp::kVar;
using pddp::decode_covar;
using pddp::decode_var;
using pddp::encode_covar;
using pddp::encode_var;

// The cost carried in the kernel: none, QRCost on z, QRCost on augment(z).
constexpr int kNoCost = 0, kQR = 1, kAugQR = 2;
constexpr int kMaxParams = 176;  // 8 model + 2 * 8^2 + 4^2 + 8 + 4 + 2 * 4

// One model step of the encoded state z, in place.
template <typename T, class M, int codec>
__device__ __forceinline__ void model_step(const T* p, T* z, const T* u) {
  constexpr int n = M::n;
  T xn[n];
  M::step(p, z, u, xn);
  if constexpr (codec != kIgnore) {
    if constexpr (M::full_cov) {
      T C[n * n];
      decode_covar<T, n, codec>(z, C);
      encode_covar<T, n, codec>(C, z);
    } else {
      T v[n];
      decode_var<T, n, codec>(z, v);
      encode_var<T, n, codec>(v, z);
    }
  }
  for (int j = 0; j < n; ++j) z[j] = xn[j];
}

// d^T W d, d = y - goal, as ((d @ W) * d).sum(-1).
template <typename T, int m>
__device__ __forceinline__ T quad_form(const T* y, const T* W,
                                       const T* goal) {
  T d[m];
  for (int j = 0; j < m; ++j) d[j] = y[j] - goal[j];
  T acc = T(0);
  for (int j = 0; j < m; ++j) {
    T dq = T(0);
    for (int r = 0; r < m; ++r) dq += d[r] * W[r * m + j];
    acc += dq * d[j];
  }
  return acc;
}

// The QR cost's state term of the mean state x under W (Q or Q_term).
template <typename T, class M, int cost>
__device__ __forceinline__ T state_cost(const T* x, const T* W,
                                        const T* x_goal) {
  constexpr int ny = cost == kAugQR ? M::n_aug : M::n;
  if constexpr (cost == kAugQR) {
    T y[ny];
    M::augment(x, y);
    return quad_form<T, ny>(y, W, x_goal);
  } else {
    return quad_form<T, ny>(x, W, x_goal);
  }
}

// Stores n rows of `len` elements from src (contiguous) to dst, row r at
// dst + r * ld, by all 32 lanes: one run where the rows abut (a warp that
// holds all of a solve's candidates), else row by row. No division: one
// per element costs as much as the stores themselves.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const T* src, int n,
                                           int len, int ld, int lane) {
  if (len == ld) {
    for (int e = lane; e < n * len; e += 32) dst[e] = src[e];
  } else {
    for (int r = 0; r < n; ++r)
      for (int e = lane; e < len; e += 32)
        dst[long(r) * ld + e] = src[r * len + e];
  }
}

template <typename T>
struct Args {
  const T *Z, *U, *k, *K, *alphas, *params, *bounds;
  T *Z_out, *U_out, *J_out;
  int B, N, A, C;  // solves, steps, candidates, steps per chunk
  int G, W;        // warps per solve, candidates per warp (min(A, 32))
};

// Layout of one instance: its parameters (block-wide) and, per warp of W
// candidates, the ring of nominal rows (z_i, u_i, k_i, K_i as four arrays
// of C steps), the chunk's states (W a step, and the W states before its
// first step), its actions (W a step) and its stage costs (W a step).
template <class M, int codec, int cost>
struct K2Shape {
  static constexpr int n = M::n, nu = M::nu, nz = pddp::encoded_size(codec, n);
  static constexpr int ny = cost == kAugQR ? M::n_aug : n;
  // Parameter layout: the model's, then Q, R, Q_term, x_goal, u_goal.
  static constexpr int kQ = M::n_params, kR = kQ + ny * ny;
  static constexpr int kQterm = kR + nu * nu, kXgoal = kQterm + ny * ny;
  static constexpr int kUgoal = kXgoal + ny;
  static constexpr int n_params = cost == kNoCost ? M::n_params : kUgoal + nu;
  static constexpr int n_nominal = nz + 2 * nu + nu * nz;
  __host__ __device__ static constexpr long warp_elems(int chunk, int W) {
    return long(pddp::kStages) * chunk * n_nominal +
           long(chunk) * W * (nz + nu + 1) + long(W) * nz;
  }
};

// Constrained: constrain_model's subclass, its bounds after the parameters
// (an instance of its own, so that the others keep their code).
template <typename T, class M, int codec, int cost, bool Constrained>
__global__ void __launch_bounds__(32 * pddp::kMaxSolvesPerBlock)
    fused_rollout_kernel(const Args<T> g) {
  using S = K2Shape<M, codec, cost>;
  constexpr int nz = S::nz, nu = S::nu;
  constexpr int n_params = S::n_params;
  constexpr int n_all = n_params + (Constrained ? 2 * nu : 0);
  static_assert(n_all <= kMaxParams, "parameter buffer");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // The parameters, once per block: the only block barrier. A constrained
  // model's bounds follow them (its lower, then its upper bounds).
  T* const p = reinterpret_cast<T*>(smem_raw);
  for (int e = threadIdx.x; e < n_all; e += blockDim.x) p[e] = g.params[e];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long w = long(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (w >= long(g.B) * g.G) return;  // the ragged last block
  // This warp's candidates: a0 .. a0 + Aw - 1 of solve b.
  const int b = int(w / g.G), a0 = int(w % g.G) * 32;
  const int N = g.N, A = g.A, C = g.C, W = g.W;
  const int Aw = A - a0 < 32 ? A - a0 : 32;
  const long warp_elems = pddp::round16(S::warp_elems(C, W) * long(sizeof(T))) /
                          long(sizeof(T));
  T* const ring = p + pddp::round16(long(n_all) * long(sizeof(T))) /
                          long(sizeof(T)) +
                  warp * warp_elems;
  T* const outZ = ring + long(pddp::kStages) * C * S::n_nominal;
  T* const outU = outZ + long(C + 1) * W * nz;
  T* const costs = outU + long(C) * W * nu;

  const size_t bb = b;
  const T* Z = g.Z + bb * (N + 1) * nz;
  const T* U = g.U + bb * N * nu;
  const T* k = g.k + bb * N * nu;
  const T* K = g.K + bb * N * nu * nz;
  T* Z_out = g.Z_out + (bb * (N + 1) * A + a0) * nz;
  T* U_out = g.U_out + (bb * N * A + a0) * nu;

  // The ring: chunk c holds steps [c C, min(N, (c+1) C)) in slot c % kStages.
  const int n_chunks = (N + C - 1) / C;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int lo = c * C, n_steps = (N - lo < C ? N - lo : C);
      T* s = ring + long(c % pddp::kStages) * C * S::n_nominal;
      pddp::stage_rows<1, nz>(s, nz, 0, Z + lo * nz, n_steps, lane);
      pddp::stage_rows<1, nu>(s + C * nz, nu, 0, U + lo * nu, n_steps, lane);
      pddp::stage_rows<1, nu>(s + C * (nz + nu), nu, 0, k + lo * nu, n_steps,
                              lane);
      pddp::stage_rows<1, nu * nz>(s + C * (nz + 2 * nu), nu * nz, 0,
                                   K + lo * nu * nz, n_steps, lane);
    }
    pddp::cp_async_commit();  // empty past the end: the count stays even
  };
  for (int c = 0; c < pddp::kStages - 1; ++c) issue(c);

  // Lanes past the warp's Aw candidates help to stage and to store.
  const bool active = lane < Aw;
  const T alpha = active ? g.alphas[a0 + lane] : T(0);
  const bool bounded = g.bounds != nullptr;
  T lo_b[nu], hi_b[nu];
#pragma unroll
  for (int j = 0; j < nu; ++j) {
    lo_b[j] = bounded ? g.bounds[j] : T(0);
    hi_b[j] = bounded ? g.bounds[nu + j] : T(0);
  }
  T z[nz];
#pragma unroll
  for (int j = 0; j < nz; ++j) z[j] = Z[j];
  if (active)
#pragma unroll
    for (int j = 0; j < nz; ++j) Z_out[lane * nz + j] = z[j];
  T J = T(0);

  for (int c = 0; c < n_chunks; ++c) {
    issue(c + pddp::kStages - 1);
    pddp::cp_async_wait_oldest();
    __syncwarp();
    const int lo = c * C, n_steps = (N - lo < C ? N - lo : C);
    const T* s = ring + long(c % pddp::kStages) * C * S::n_nominal;
    if (active) {
      // Row 0: the candidates' states before the chunk's first step.
#pragma unroll
      for (int e = 0; e < nz; ++e) outZ[lane * nz + e] = z[e];
      for (int j = 0; j < n_steps; ++j) {
        const T* zi = s + j * nz;
        const T* ui = s + C * nz + j * nu;
        const T* ki = s + C * (nz + nu) + j * nu;
        const T* Ki = s + C * (nz + 2 * nu) + j * nu * nz;
        T u[nu];
#pragma unroll
        for (int m = 0; m < nu; ++m) {
          T du = T(0);
#pragma unroll
          for (int l = 0; l < nz; ++l) du += (z[l] - zi[l]) * Ki[m * nz + l];
          T um = ui[m] + (alpha * ki[m] + du);
          // min(max(u, u_min), u_max) that keeps a NaN, as torch.clamp does.
          if (bounded) {
            um = um < lo_b[m] ? lo_b[m] : um;
            um = um > hi_b[m] ? hi_b[m] : um;
          }
          u[m] = um;
        }
        if constexpr (Constrained) {
          T uc[nu];
#pragma unroll
          for (int m = 0; m < nu; ++m)
            uc[m] = pddp::constrain(u[m], p[n_params + m],
                                    p[n_params + nu + m]);
          model_step<T, M, codec>(p, z, uc);
        } else {
          model_step<T, M, codec>(p, z, u);
        }
#pragma unroll
        for (int e = 0; e < nz; ++e)
          outZ[((j + 1) * Aw + lane) * nz + e] = z[e];
#pragma unroll
        for (int e = 0; e < nu; ++e) outU[(j * Aw + lane) * nu + e] = u[e];
      }
    }
    __syncwarp();
    if constexpr (cost != kNoCost) {
      // The chunk's stage costs, off the chain: once its states are known
      // the (step, candidate) pairs are independent, so all 32 lanes take
      // them; then each candidate adds its own in step order, as the
      // plain version's scan does.
      for (int e = lane; e < n_steps * Aw; e += 32)
        costs[e] = state_cost<T, M, cost>(outZ + e * nz, p + S::kQ,
                                          p + S::kXgoal) +
                   quad_form<T, nu>(outU + e * nu, p + S::kR, p + S::kUgoal);
      __syncwarp();
      if (active)
        for (int j = 0; j < n_steps; ++j) J += costs[j * Aw + lane];
    }
    // The chunk's rows: each step's Aw candidates are contiguous in Z_out
    // (steps lo+1 ..) and U_out, the whole chunk when the warp has them all.
    store_rows(Z_out + (size_t)(lo + 1) * A * nz, outZ + Aw * nz, n_steps,
               Aw * nz, A * nz, lane);
    store_rows(U_out + (size_t)lo * A * nu, outU, n_steps, Aw * nu, A * nu,
               lane);
    __syncwarp();
  }
  if constexpr (cost != kNoCost) {
    if (active)
      g.J_out[bb * A + a0 + lane] =
          J + state_cost<T, M, cost>(z, p + S::kQterm, p + S::kXgoal);
  }
}

template <typename T, class M, int codec, int cost, bool Constrained>
int launch_one(Args<T> g, cudaStream_t stream) {
  using S = K2Shape<M, codec, cost>;
  const long warps = long(g.B) * g.G;
  const pddp::Plan p = pddp::plan<T>(
      warps, g.N, S::n_params + (Constrained ? 2 * S::nu : 0),
      [W = g.W](int chunk) { return S::warp_elems(chunk, W); });
  if (p.bytes > pddp::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static long allowed = 48 * 1024;  // per instance
  const cudaError_t err = pddp::allow_smem(
      fused_rollout_kernel<T, M, codec, cost, Constrained>, p.bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  g.C = p.chunk;
  const long blocks = (warps + p.warps - 1) / p.warps;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  fused_rollout_kernel<T, M, codec, cost, Constrained>
      <<<unsigned(blocks), 32 * p.warps, p.bytes, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// The (model, codec, cost) instances: f(Inst<M, codec, cost>{}) for the
// one asked for, or `missing` where there is none.
template <class M_, int codec_, int cost_>
struct Inst {
  using M = M_;
  static constexpr int codec = codec_, cost = cost_;
};

template <class M, class F>
long visit_model(int codec, int cost, long missing, F&& f) {
  switch (codec) {
    case kIgnore:
      if (cost == kNoCost) return f(Inst<M, kIgnore, kNoCost>{});
      if (cost == kQR) return f(Inst<M, kIgnore, kQR>{});
      if constexpr (M::n_aug != M::n)
        if (cost == kAugQR) return f(Inst<M, kIgnore, kAugQR>{});
      break;
    case kVar:
      if (cost == kNoCost) return f(Inst<M, kVar, kNoCost>{});
      break;
    case kStd:
      if (cost == kNoCost) return f(Inst<M, kStd, kNoCost>{});
      break;
    case kChol:
      if (cost == kNoCost) return f(Inst<M, kChol, kNoCost>{});
      break;
    case kFull:
      if (cost == kNoCost) return f(Inst<M, kFull, kNoCost>{});
      break;
  }
  return missing;
}

template <class F>
long visit(int model, int codec, int cost, long missing, F&& f) {
  switch (model) {
    case 0: return visit_model<Cartpole>(codec, cost, missing, f);
    case 1: return visit_model<Pendulum>(codec, cost, missing, f);
    case 2: return visit_model<DoubleCartpole>(codec, cost, missing, f);
    case 3: return visit_model<Rendezvous>(codec, cost, missing, f);
  }
  return missing;
}

template <typename T>
int launch(const T* Z, const T* U, const T* k, const T* K, const T* alphas,
           const T* params, const T* bounds, T* Z_out, T* U_out, T* J_out,
           int B, int N, int A, int model, int codec, int cost,
           int constrained, void* stream_ptr) {
  if (B < 1 || N < 1 || A < 1 || (cost != kNoCost && !J_out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> g{Z, U, k, K, alphas, params, bounds, Z_out, U_out, J_out,
                  B, N, A, 0, (A + 31) / 32, A < 32 ? A : 32};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(visit(
      model, codec, cost, cudaErrorInvalidValue, [&](auto inst) -> long {
        using I = decltype(inst);
        if (constrained)
          return launch_one<T, typename I::M, I::codec, I::cost, true>(
              g, stream);
        return launch_one<T, typename I::M, I::codec, I::cost, false>(
            g, stream);
      }));
}

}  // namespace

extern "C" {

// model: 0 cartpole, 1 pendulum, 2 double cartpole, 3 rendezvous; codec:
// StateEncoding's value; cost: 0 none, 1 QRCost, 2 augmented QRCost;
// constrained: constrain_model's subclass, its bounds (lower, then upper,
// nu each) after the parameters and the cost in params.
// Z (B, N+1, nz), U and k (B, N, nu), K (B, N, nu, nz), alphas (A);
// bounds (2, nu) or null; Z_out (B, N+1, A, nz), U_out (B, N, A, nu),
// J_out (B, A) or null without a cost. The launch picks its warps a block
// and its chunk (pddp::plan).
#ifndef PDDP_F64_ONLY
int pddp_fused_rollout_f32(const float* Z, const float* U, const float* k,
                           const float* K, const float* alphas,
                           const float* params, const float* bounds,
                           float* Z_out, float* U_out, float* J_out, int B,
                           int N, int A, int model, int codec, int cost,
                           int constrained, void* stream) {
  return launch<float>(Z, U, k, K, alphas, params, bounds, Z_out, U_out,
                       J_out, B, N, A, model, codec, cost, constrained,
                       stream);
}
#endif

#ifndef PDDP_F32_ONLY
int pddp_fused_rollout_f64(const double* Z, const double* U, const double* k,
                           const double* K, const double* alphas,
                           const double* params, const double* bounds,
                           double* Z_out, double* U_out, double* J_out, int B,
                           int N, int A, int model, int codec, int cost,
                           int constrained, void* stream) {
  return launch<double>(Z, U, k, K, alphas, params, bounds, Z_out, U_out,
                        J_out, B, N, A, model, codec, cost, constrained,
                        stream);
}
#endif

}  // extern "C"
