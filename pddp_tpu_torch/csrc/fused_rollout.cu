// K2: the iLQR line search for (cartpole, CartpoleCost,
// IGNORE_UNCERTAINTY): a closed-loop rollout of A step sizes alpha over N
// steps, with the cost accumulated on the way.
//
// Replaces the Pallas kernel pddp_tpu/ops/fused_rollout.py:114
// (fused_control_law; its pallas_call is at :261), stage (a) of its port.
// Pallas traced the model's and cost's jnp code into the kernel; CUDA
// cannot, so this kernel carries its own copy of that code for one
// (model, cost, encoding) triple. Per step i and candidate a:
//   du = alpha_a k_i + K_i (z - z_i),  u = clamp(u_i + du, u_min, u_max)
//   J += d^T Q d + (u - u*)^T R (u - u*),  d = [x, x', theta',
//        sin theta, cos theta] - x*            (examples/cartpole/cost.py)
//   z  = symplectic-Euler cartpole step       (examples/cartpole/model.py)
// and at the end J += d_T^T Q_term d_T. The model's and cost's parameters
// arrive in a small device buffer (layout in fused_rollout.py), so the
// values a caller set reach the kernel.
//
// What bounds it on an H100: at the main-path shape (N=200, A=10, f32)
// it reads about 8 KB and writes about 40 KB and does about 0.3 MFLOP, so
// the roofline says nanoseconds. Its real limit is the chain of N
// dependent model steps on each candidate: the time is N times the latency
// of one step (about a hundred dependent flops, two sin/cos pairs, two
// divisions, two block barriers).
//
// What the design does about that: one block per solve and one thread per
// candidate, each keeping its state in registers for the whole horizon;
// the block shares the nominal z_i, u_i, k_i, K_i of step i through shared
// memory; the batch of solves is the grid. Prefetching several steps per
// barrier and packing several solves per block are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kNz = 4;      // cartpole state size
constexpr int kNy = 5;      // augmented state size
constexpr int kParams = 63; // 6 model + Q 25 + R 1 + Q_term 25 + x* 5 + u* 1
constexpr int kQ = 6, kR = 31, kQterm = 32, kXgoal = 57, kUgoal = 62;

template <typename T>
__device__ __forceinline__ T quad_state_cost(const T* z, const T* Q,
                                             const T* xg) {
  const T sn = sin(z[2]), cs = cos(z[2]);
  const T y[kNy] = {z[0], z[1], z[3], sn, cs};
  T d[kNy];
  for (int j = 0; j < kNy; ++j) d[j] = y[j] - xg[j];
  T acc = T(0);
  for (int j = 0; j < kNy; ++j) {
    T dq = T(0);
    for (int r = 0; r < kNy; ++r) dq += d[r] * Q[r * kNy + j];
    acc += dq * d[j];
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void cartpole_step(T* z, T F, const T* p) {
  const T dt = p[0], mc = p[1], mp = p[2], l = p[3], mu = p[4], g = p[5];
  const T x = z[0], x_dot = z[1], theta = z[2], theta_dot = z[3];
  const T sn = sin(theta), cs = cos(theta);
  const T a0 = mp * l * (theta_dot * theta_dot) * sn;
  const T a1 = g * sn;
  const T a2 = F - mu * x_dot;
  const T a3 = T(4) * (mc + mp) - T(3) * mp * (cs * cs);
  const T theta_dot_dot =
      T(-3) * (a0 * cs + T(2) * ((mc + mp) * a1 + a2 * cs)) / (l * a3);
  const T x_dot_dot = (T(2) * a0 + T(3) * mp * a1 * cs + T(4) * a2) / a3;
  const T new_x_dot = x_dot + x_dot_dot * dt;
  const T new_theta_dot = theta_dot + theta_dot_dot * dt;
  z[0] = x + new_x_dot * dt;
  z[1] = new_x_dot;
  z[2] = theta + new_theta_dot * dt;
  z[3] = new_theta_dot;
}

template <typename T>
__global__ void fused_rollout_cartpole_kernel(
    const T* __restrict__ Z, const T* __restrict__ U,
    const T* __restrict__ k, const T* __restrict__ K,
    const T* __restrict__ alphas, const T* __restrict__ params,
    const T* __restrict__ bounds, T* __restrict__ Z_out,
    T* __restrict__ U_out, T* __restrict__ J_out, int N, int A) {
  const size_t b = blockIdx.x;
  const int a = threadIdx.x, nt = blockDim.x;
  Z += b * (N + 1) * kNz;
  U += b * N;
  k += b * N;
  K += b * N * kNz;
  Z_out += b * (N + 1) * A * kNz;
  U_out += b * N * A;
  J_out += b * A;

  __shared__ T p[kParams];
  __shared__ T nominal[kNz + 2 + kNz];  // z_i, u_i, k_i, K_i
  for (int e = a; e < kParams; e += nt) p[e] = params[e];
  __syncthreads();

  const bool active = a < A;
  const T alpha = active ? alphas[a] : T(0);
  const bool clamped = bounds != nullptr;
  const T u_min = clamped ? bounds[0] : T(0);
  const T u_max = clamped ? bounds[1] : T(0);
  T z[kNz];
  for (int j = 0; j < kNz; ++j) z[j] = Z[j];
  if (active)
    for (int j = 0; j < kNz; ++j) Z_out[a * kNz + j] = z[j];
  T J = T(0);

  for (int i = 0; i < N; ++i) {
    if (a < kNz) nominal[a] = Z[i * kNz + a];
    else if (a == kNz) nominal[kNz] = U[i];
    else if (a == kNz + 1) nominal[kNz + 1] = k[i];
    else if (a < 2 * kNz + 2) nominal[a] = K[i * kNz + a - kNz - 2];
    __syncthreads();

    T du = T(0);
    for (int j = 0; j < kNz; ++j)
      du += (z[j] - nominal[j]) * nominal[kNz + 2 + j];
    T u = nominal[kNz] + (alpha * nominal[kNz + 1] + du);
    // min(max(u, u_min), u_max) that keeps a NaN, as torch.clamp does.
    if (clamped) {
      u = u < u_min ? u_min : u;
      u = u > u_max ? u_max : u;
    }

    const T du_goal = u - p[kUgoal];
    J += quad_state_cost(z, p + kQ, p + kXgoal) + du_goal * p[kR] * du_goal;
    cartpole_step(z, u, p);

    if (active) {
      T* zo = Z_out + ((size_t)(i + 1) * A + a) * kNz;
      for (int j = 0; j < kNz; ++j) zo[j] = z[j];
      U_out[(size_t)i * A + a] = u;
    }
    __syncthreads();
  }
  J += quad_state_cost(z, p + kQterm, p + kXgoal);
  if (active) J_out[a] = J;
}

template <typename T>
int launch(const T* Z, const T* U, const T* k, const T* K, const T* alphas,
           const T* params, const T* bounds, T* Z_out, T* U_out, T* J_out,
           int B, int N, int A, void* stream) {
  if (B < 1 || N < 1 || A < 1 || A > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((A + 31) / 32) * 32;
  if (threads < 2 * kNz + 2) threads = 2 * kNz + 2;
  fused_rollout_cartpole_kernel<T>
      <<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          Z, U, k, K, alphas, params, bounds, Z_out, U_out, J_out, N, A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pddp_fused_rollout_cartpole_f32(const float* Z, const float* U,
                                    const float* k, const float* K,
                                    const float* alphas, const float* params,
                                    const float* bounds, float* Z_out,
                                    float* U_out, float* J_out, int B, int N,
                                    int A, void* stream) {
  return launch<float>(Z, U, k, K, alphas, params, bounds, Z_out, U_out,
                       J_out, B, N, A, stream);
}

int pddp_fused_rollout_cartpole_f64(const double* Z, const double* U,
                                    const double* k, const double* K,
                                    const double* alphas,
                                    const double* params,
                                    const double* bounds, double* Z_out,
                                    double* U_out, double* J_out, int B,
                                    int N, int A, void* stream) {
  return launch<double>(Z, U, k, K, alphas, params, bounds, Z_out, U_out,
                        J_out, B, N, A, stream);
}

}  // extern "C"
