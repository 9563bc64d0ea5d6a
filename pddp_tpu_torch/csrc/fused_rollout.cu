// K2 stages (a)-(c): the iLQR line search of the known-dynamics examples
// (cartpole, pendulum, double cartpole, rendezvous) under every state
// codec: a closed-loop rollout of A step sizes alpha over N steps, with
// the cost accumulated on the way under IGNORE_UNCERTAINTY.
//
// Replaces the Pallas kernel pddp_tpu/ops/fused_rollout.py:114
// (fused_control_law; its pallas_call is at :261) for stateless models.
// Pallas traced the model's and cost's jnp code into the kernel; CUDA
// cannot, so this kernel carries its own copy of each example's step and
// of the QR cost, as templates on (model, codec, cost):
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
// codec through safe_cholesky's 5-rung ladder (belief_codec.cuh). Every
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

namespace {

using pddp::tri;

// StateEncoding's values (encoding.py).
constexpr int kFull = 0, kChol = 1, kVar = 2, kStd = 3, kIgnore = 4;
// The cost carried in the kernel: none, QRCost on z, QRCost on augment(z).
constexpr int kNoCost = 0, kQR = 1, kAugQR = 2;
constexpr int kMaxParams = 176;  // 8 model + 2 * 8^2 + 4^2 + 8 + 4 < 176

__host__ __device__ constexpr int encoded_size(int codec, int n) {
  return codec == kFull ? n + n * n
         : codec == kChol ? n + n * (n + 1) / 2
         : codec == kIgnore ? n
                            : 2 * n;
}

// The examples' mean steps: x (n), u (nu) -> x_next (n), parameters p in
// the order of each model's PARAM_NAMES. augment() is the cost's
// utils.angular.augment_state with the model's indices (rendezvous has no
// angles, and its cost takes the state as it is).

struct Cartpole {  // examples/cartpole/model.py
  static constexpr int n = 4, nu = 1, n_params = 6, n_aug = 5;
  static constexpr bool full_cov = false;
  template <typename T>
  __device__ static void step(const T* p, const T* x, const T* u, T* xn) {
    const T dt = p[0], mc = p[1], mp = p[2], l = p[3], mu = p[4], g = p[5];
    const T x_dot = x[1], theta = x[2], theta_dot = x[3];
    const T sn = sin(theta), cs = cos(theta);
    const T a0 = mp * l * (theta_dot * theta_dot) * sn;
    const T a1 = g * sn;
    const T a2 = u[0] - mu * x_dot;
    const T a3 = T(4) * (mc + mp) - T(3) * mp * (cs * cs);
    const T theta_dot_dot =
        T(-3) * (a0 * cs + T(2) * ((mc + mp) * a1 + a2 * cs)) / (l * a3);
    const T x_dot_dot = (T(2) * a0 + T(3) * mp * a1 * cs + T(4) * a2) / a3;
    const T new_x_dot = x_dot + x_dot_dot * dt;
    const T new_theta_dot = theta_dot + theta_dot_dot * dt;
    xn[0] = x[0] + new_x_dot * dt;
    xn[1] = new_x_dot;
    xn[2] = theta + new_theta_dot * dt;
    xn[3] = new_theta_dot;
  }
  template <typename T>
  __device__ static void augment(const T* x, T* y) {
    y[0] = x[0]; y[1] = x[1]; y[2] = x[3];
    y[3] = sin(x[2]); y[4] = cos(x[2]);
  }
};

struct Pendulum {  // examples/pendulum/model.py
  static constexpr int n = 2, nu = 1, n_params = 5, n_aug = 3;
  static constexpr bool full_cov = false;
  template <typename T>
  __device__ static void step(const T* p, const T* x, const T* u, T* xn) {
    const T dt = p[0], m = p[1], l = p[2], mu = p[3], g = p[4];
    const T theta = x[0], theta_dot = x[1];
    const T temp = m * l;
    T theta_dot_dot = u[0] - mu * theta_dot - T(0.5) * temp * g * sin(theta);
    theta_dot_dot = T(3) * theta_dot_dot / (temp * l);
    xn[0] = theta + theta_dot * dt;
    xn[1] = theta_dot + theta_dot_dot * dt;
  }
  template <typename T>
  __device__ static void augment(const T* x, T* y) {
    y[0] = x[1]; y[1] = sin(x[0]); y[2] = cos(x[0]);
  }
};

// Determinant of the 2x2 minor of the 3x3 A without row i and column j,
// as utils.linalg.small_det expands it: a d - b c.
template <typename T>
__device__ __forceinline__ T minor2(const T (&A)[3][3], int i, int j) {
  const int r0 = i == 0 ? 1 : 0, r1 = i == 2 ? 1 : 2;
  const int c0 = j == 0 ? 1 : 0, c1 = j == 2 ? 1 : 2;
  return A[r0][c0] * A[r1][c1] - A[r0][c1] * A[r1][c0];
}

struct DoubleCartpole {  // examples/double_cartpole/model.py
  static constexpr int n = 6, nu = 1, n_params = 8, n_aug = 8;
  static constexpr bool full_cov = false;
  template <typename T>
  __device__ static void step(const T* p, const T* x, const T* u, T* xn) {
    const T dt = p[0], mc = p[1], mp1 = p[2], mp2 = p[3], l1 = p[4],
            l2 = p[5], mu = p[6], g = p[7];
    const T x_dot = x[1], theta1 = x[2], theta1_dot = x[3], theta2 = x[4],
            theta2_dot = x[5];
    const T sin_theta1 = sin(theta1), cos_theta1 = cos(theta1);
    const T sin_theta2 = sin(theta2), cos_theta2 = cos(theta2);
    const T sin_dtheta = sin(theta1 - theta2);
    const T cos_dtheta = cos(theta1 - theta2);
    const T a0 = mp2 + T(2) * mc;
    const T a1 = mc * l2;
    const T a2 = l1 * (theta1_dot * theta1_dot);
    const T a3 = a1 * (theta2_dot * theta2_dot);
    const T A[3][3] = {
        {T(2) * (mp1 + mp2 + mc), -a0 * l1 * cos_theta1, -a1 * cos_theta2},
        {T(-3) * a0 * cos_theta1, (T(2) * a0 + T(2) * mc) * l1,
         T(3) * a1 * cos_dtheta},
        {T(-3) * cos_theta2, T(3) * l1 * cos_dtheta, T(2) * l2}};
    const T b[3] = {
        T(2) * u[0] - T(2) * mu * x_dot - a0 * a2 * sin_theta1 -
            a3 * sin_theta2,
        T(3) * a0 * g * sin_theta1 - T(3) * a3 * sin_dtheta,
        T(3) * a2 * sin_dtheta + T(3) * g * sin_theta2};
    // small_solve: (adj(A) / det(A)) b, the determinant expanded along the
    // first row and adj[j][i] the (i, j) cofactor.
    const T det = A[0][0] * minor2(A, 0, 0) - A[0][1] * minor2(A, 0, 1) +
                  A[0][2] * minor2(A, 0, 2);
    T sol[3];
    for (int r = 0; r < 3; ++r) {
      T s = T(0);
      for (int c = 0; c < 3; ++c) {
        const T m = minor2(A, c, r);
        s += (((r + c) % 2 == 0) ? m : -m) / det * b[c];
      }
      sol[r] = s;
    }
    const T new_x_dot = x_dot + sol[0] * dt;
    const T new_theta1_dot = theta1_dot + sol[1] * dt;
    const T new_theta2_dot = theta2_dot + sol[2] * dt;
    xn[0] = x[0] + new_x_dot * dt;
    xn[1] = new_x_dot;
    xn[2] = theta1 + new_theta1_dot * dt;
    xn[3] = new_theta1_dot;
    xn[4] = theta2 + new_theta2_dot * dt;
    xn[5] = new_theta2_dot;
  }
  template <typename T>
  __device__ static void augment(const T* x, T* y) {
    y[0] = x[0]; y[1] = x[1]; y[2] = x[3]; y[3] = x[5];
    y[4] = sin(x[2]); y[5] = cos(x[2]); y[6] = sin(x[4]); y[7] = cos(x[4]);
  }
};

struct Rendezvous {  // examples/rendezvous/model.py
  static constexpr int n = 8, nu = 4, n_params = 3, n_aug = 8;
  static constexpr bool full_cov = true;  // re-encodes decode_covar(z)
  template <typename T>
  __device__ static void step(const T* p, const T* x, const T* u, T* xn) {
    const T dt = p[0], m = p[1], alpha = p[2];
    for (int j = 0; j < 4; ++j) {
      xn[j] = x[j] + x[j + 4] * dt;
      T acc = x[j + 4] * (T(1) - alpha * dt / m);
      acc = acc + u[j] * dt / m;
      xn[j + 4] = x[j + 4] + acc * dt;
    }
  }
};

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
  static constexpr int n = M::n, nu = M::nu, nz = encoded_size(codec, n);
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

template <typename T, class M, int codec, int cost>
__global__ void __launch_bounds__(32 * pddp::kMaxSolvesPerBlock)
    fused_rollout_kernel(const Args<T> g) {
  using S = K2Shape<M, codec, cost>;
  constexpr int nz = S::nz, nu = S::nu;
  constexpr int n_params = S::n_params;
  static_assert(n_params <= kMaxParams, "parameter buffer");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // The parameters, once per block: the only block barrier.
  T* const p = reinterpret_cast<T*>(smem_raw);
  for (int e = threadIdx.x; e < n_params; e += blockDim.x) p[e] = g.params[e];
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
  T* const ring = p + pddp::round16(long(n_params) * long(sizeof(T))) /
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
        model_step<T, M, codec>(p, z, u);
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

template <typename T, class M, int codec, int cost>
int launch_one(Args<T> g, cudaStream_t stream) {
  using S = K2Shape<M, codec, cost>;
  const long warps = long(g.B) * g.G;
  const pddp::Plan p = pddp::plan<T>(
      warps, g.N, S::n_params,
      [W = g.W](int chunk) { return S::warp_elems(chunk, W); });
  if (p.bytes > pddp::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static long allowed = 48 * 1024;  // per instance
  const cudaError_t err = pddp::allow_smem(
      fused_rollout_kernel<T, M, codec, cost>, p.bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  g.C = p.chunk;
  const long blocks = (warps + p.warps - 1) / p.warps;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  fused_rollout_kernel<T, M, codec, cost>
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
           void* stream_ptr) {
  if (B < 1 || N < 1 || A < 1 || (cost != kNoCost && !J_out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> g{Z, U, k, K, alphas, params, bounds, Z_out, U_out, J_out,
                  B, N, A, 0, (A + 31) / 32, A < 32 ? A : 32};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(visit(
      model, codec, cost, cudaErrorInvalidValue, [&](auto inst) -> long {
        using I = decltype(inst);
        return launch_one<T, typename I::M, I::codec, I::cost>(g, stream);
      }));
}

}  // namespace

extern "C" {

// model: 0 cartpole, 1 pendulum, 2 double cartpole, 3 rendezvous; codec:
// StateEncoding's value; cost: 0 none, 1 QRCost, 2 augmented QRCost.
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
                           void* stream) {
  return launch<float>(Z, U, k, K, alphas, params, bounds, Z_out, U_out,
                       J_out, B, N, A, model, codec, cost, stream);
}
#endif

#ifndef PDDP_F32_ONLY
int pddp_fused_rollout_f64(const double* Z, const double* U, const double* k,
                           const double* K, const double* alphas,
                           const double* params, const double* bounds,
                           double* Z_out, double* U_out, double* J_out, int B,
                           int N, int A, int model, int codec, int cost,
                           void* stream) {
  return launch<double>(Z, U, k, K, alphas, params, bounds, Z_out, U_out,
                        J_out, B, N, A, model, codec, cost, stream);
}
#endif

}  // extern "C"
