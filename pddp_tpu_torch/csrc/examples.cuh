// The four known-dynamics examples as the line-search kernels carry them:
// K2(a)-(c) (fused_rollout.cu) step one candidate's mean state with them,
// K2(e) (fused_particle_rollout.cu) each particle of a candidate.
//
// Each model is a struct with its sizes (n, nu, n_params, n_aug), its
// mean step, for the QR cost on the angular augmentation augment(), and
// full_cov: whether K2(c) re-encodes the decoded covariance (rendezvous)
// or the decoded variances (the others).
// The arithmetic is the port's examples/<name>/model.py in the same order
// of operations. constrain() is utils.constraint.constrain, which
// constrain_model's subclasses apply to u before the step.
//
// All functions run on one thread.

#pragma once

#include <cuda_runtime.h>

namespace pddp {

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

// utils.constraint.constrain: (max - min) / 2 * tanh(u) + (max + min) / 2,
// per action dimension, the bounds lo and hi of nu values each.
template <typename T>
__device__ __forceinline__ T constrain(T u, T lo, T hi) {
  return (hi - lo) / T(2) * tanh(u) + (hi + lo) / T(2);
}

}  // namespace pddp
