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
// few hundred dependent flops, sin/cos, divisions, two block barriers;
// under the Cholesky codec at n=8 a factorization of up to five rungs).
//
// What the design does about that: one block per solve and one thread per
// candidate, each keeping its state in registers for the whole horizon
// (the n=8 belief matrices of rendezvous spill to local memory); the block
// shares the nominal z_i, u_i, k_i, K_i of step i through shared memory;
// the batch of solves is the grid. Prefetching several steps per barrier
// and packing several solves per block are later work.

#include <cuda_runtime.h>

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
    pddp::safe_cholesky_lower(C, n, jitter, 5, L);
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

template <typename T>
struct Args {
  const T *Z, *U, *k, *K, *alphas, *params, *bounds;
  T *Z_out, *U_out, *J_out;
  int N, A;
};

template <typename T, class M, int codec, int cost>
__global__ void fused_rollout_kernel(Args<T> g) {
  constexpr int n = M::n, nu = M::nu, nz = encoded_size(codec, n);
  constexpr int ny = cost == kAugQR ? M::n_aug : n;
  // Parameter layout: the model's, then Q, R, Q_term, x_goal, u_goal.
  constexpr int kQ = M::n_params, kR = kQ + ny * ny, kQterm = kR + nu * nu;
  constexpr int kXgoal = kQterm + ny * ny, kUgoal = kXgoal + ny;
  constexpr int n_params = cost == kNoCost ? M::n_params : kUgoal + nu;
  // The nominal row of step i: z_i, u_i, k_i, K_i.
  constexpr int kNomU = nz, kNomk = nz + nu, kNomK = nz + 2 * nu;
  constexpr int n_nominal = nz + 2 * nu + nu * nz;
  static_assert(n_params <= kMaxParams, "parameter buffer");

  const int N = g.N, A = g.A;
  const size_t b = blockIdx.x;
  const int a = threadIdx.x, nt = blockDim.x;
  const T* Z = g.Z + b * (N + 1) * nz;
  const T* U = g.U + b * N * nu;
  const T* k = g.k + b * N * nu;
  const T* K = g.K + b * N * nu * nz;
  T* Z_out = g.Z_out + b * (N + 1) * A * nz;
  T* U_out = g.U_out + b * N * A * nu;

  __shared__ T p[n_params];
  __shared__ T nominal[n_nominal];
  for (int e = a; e < n_params; e += nt) p[e] = g.params[e];
  __syncthreads();

  const bool active = a < A;
  const T alpha = active ? g.alphas[a] : T(0);
  T z[nz];
  for (int j = 0; j < nz; ++j) z[j] = Z[j];
  if (active)
    for (int j = 0; j < nz; ++j) Z_out[a * nz + j] = z[j];
  T J = T(0);

  for (int i = 0; i < N; ++i) {
    for (int e = a; e < n_nominal; e += nt) {
      nominal[e] = e < kNomU   ? Z[(size_t)i * nz + e]
                   : e < kNomk ? U[(size_t)i * nu + e - kNomU]
                   : e < kNomK ? k[(size_t)i * nu + e - kNomk]
                               : K[(size_t)i * nu * nz + e - kNomK];
    }
    __syncthreads();

    // Threads past the A candidates only help to load the nominal rows.
    if (active) {
      T u[nu];
      for (int j = 0; j < nu; ++j) {
        T du = T(0);
        for (int l = 0; l < nz; ++l)
          du += (z[l] - nominal[l]) * nominal[kNomK + j * nz + l];
        T uj = nominal[kNomU + j] + (alpha * nominal[kNomk + j] + du);
        // min(max(u, u_min), u_max) that keeps a NaN, as torch.clamp does.
        if (g.bounds != nullptr) {
          const T lo = g.bounds[j], hi = g.bounds[nu + j];
          uj = uj < lo ? lo : uj;
          uj = uj > hi ? hi : uj;
        }
        u[j] = uj;
      }
      if constexpr (cost != kNoCost)
        J += state_cost<T, M, cost>(z, p + kQ, p + kXgoal) +
             quad_form<T, nu>(u, p + kR, p + kUgoal);
      model_step<T, M, codec>(p, z, u);

      T* zo = Z_out + ((size_t)(i + 1) * A + a) * nz;
      for (int j = 0; j < nz; ++j) zo[j] = z[j];
      for (int j = 0; j < nu; ++j) U_out[((size_t)i * A + a) * nu + j] = u[j];
    }
    __syncthreads();
  }
  if constexpr (cost != kNoCost) {
    if (active)
      g.J_out[b * A + a] = J + state_cost<T, M, cost>(z, p + kQterm,
                                                      p + kXgoal);
  }
}

template <typename T, class M, int codec, int cost>
int launch_one(const Args<T>& g, int B, cudaStream_t stream) {
  constexpr int nz = encoded_size(codec, M::n);
  constexpr int n_nominal = nz + 2 * M::nu + M::nu * nz;
  // One thread per candidate, and enough to load a step's nominal row in
  // one pass (up to 256).
  int threads = ((g.A + 31) / 32) * 32;
  const int rows = ((n_nominal + 31) / 32) * 32;
  if (threads < rows) threads = rows < 256 ? rows : 256;
  if (threads < ((g.A + 31) / 32) * 32) threads = ((g.A + 31) / 32) * 32;
  fused_rollout_kernel<T, M, codec, cost><<<B, threads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class M>
int launch_model(const Args<T>& g, int B, int codec, int cost,
                 cudaStream_t stream) {
  switch (codec) {
    case kIgnore:
      if (cost == kNoCost) return launch_one<T, M, kIgnore, kNoCost>(g, B, stream);
      if (cost == kQR) return launch_one<T, M, kIgnore, kQR>(g, B, stream);
      if constexpr (M::n_aug != M::n)
        if (cost == kAugQR)
          return launch_one<T, M, kIgnore, kAugQR>(g, B, stream);
      break;
    case kVar:
      if (cost == kNoCost) return launch_one<T, M, kVar, kNoCost>(g, B, stream);
      break;
    case kStd:
      if (cost == kNoCost) return launch_one<T, M, kStd, kNoCost>(g, B, stream);
      break;
    case kChol:
      if (cost == kNoCost) return launch_one<T, M, kChol, kNoCost>(g, B, stream);
      break;
    case kFull:
      if (cost == kNoCost) return launch_one<T, M, kFull, kNoCost>(g, B, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const T* Z, const T* U, const T* k, const T* K, const T* alphas,
           const T* params, const T* bounds, T* Z_out, T* U_out, T* J_out,
           int B, int N, int A, int model, int codec, int cost,
           void* stream_ptr) {
  if (B < 1 || N < 1 || A < 1 || A > 1024 || (cost != kNoCost && !J_out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> g{Z, U, k, K, alphas, params, bounds, Z_out, U_out, J_out,
                  N, A};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (model) {
    case 0: return launch_model<T, Cartpole>(g, B, codec, cost, stream);
    case 1: return launch_model<T, Pendulum>(g, B, codec, cost, stream);
    case 2: return launch_model<T, DoubleCartpole>(g, B, codec, cost, stream);
    case 3: return launch_model<T, Rendezvous>(g, B, codec, cost, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// model: 0 cartpole, 1 pendulum, 2 double cartpole, 3 rendezvous; codec:
// StateEncoding's value; cost: 0 none, 1 QRCost, 2 augmented QRCost.
// Z (B, N+1, nz), U and k (B, N, nu), K (B, N, nu, nz), alphas (A);
// bounds (2, nu) or null; Z_out (B, N+1, A, nz), U_out (B, N, A, nu),
// J_out (B, A) or null without a cost.
int pddp_fused_rollout_f32(const float* Z, const float* U, const float* k,
                           const float* K, const float* alphas,
                           const float* params, const float* bounds,
                           float* Z_out, float* U_out, float* J_out, int B,
                           int N, int A, int model, int codec, int cost,
                           void* stream) {
  return launch<float>(Z, U, k, K, alphas, params, bounds, Z_out, U_out,
                       J_out, B, N, A, model, codec, cost, stream);
}

int pddp_fused_rollout_f64(const double* Z, const double* U, const double* k,
                           const double* K, const double* alphas,
                           const double* params, const double* bounds,
                           double* Z_out, double* U_out, double* J_out, int B,
                           int N, int A, int model, int codec, int cost,
                           void* stream) {
  return launch<double>(Z, U, k, K, alphas, params, bounds, Z_out, U_out,
                        J_out, B, N, A, model, codec, cost, stream);
}

}  // extern "C"
