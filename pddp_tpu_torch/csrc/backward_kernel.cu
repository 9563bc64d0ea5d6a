// K1: the Riccati backward of the unconstrained, Q_uu-regularized iLQR
// step, as one CUDA block per solve.
//
// Replaces the Pallas kernel pddp_tpu/ops/backward_kernel.py:45
// (pallas_backward; its pallas_call is at :122). Same arithmetic as that
// kernel's body (:59-118): per step i = N-1 .. 0,
//   Q_z  = L_z + F_z^T V_z          Q_u  = L_u + F_u^T V_z
//   Q_zz = sym(L_zz + F_z^T V_zz F_z)
//   Q_uz = L_uz + F_u^T V_zz F_z    Q_uu = L_uu + F_u^T V_zz F_u (sym, nu>1)
//   e = eig(Q_uu) clamped below at 1e-12, plus reg  (closed form for nu=1,
//       fixed-sweep cyclic Jacobi for nu <= 4, as utils/linalg.small_eigh)
//   k = -Q_uu_reg^-1 Q_u            K = -Q_uu_reg^-1 Q_uz
//   V_z  = Q_z + (Q_u + Q_uu k)^T K + k^T Q_uz
//   V_zz = sym(Q_zz + K^T Q_uu K + K^T Q_uz + Q_uz^T K)
// with the unregularized Q in the V update.
//
// What bounds it on an H100: at the main-path shape (N=200, nz=4, nu=1,
// f32) it reads about 37 KB and writes 4 KB, and does about 0.1 MFLOP:
// by the roofline that is nanoseconds. Its real limit is the chain of N
// dependent steps: each step is a few dependent stages of tiny products,
// so the time is N times the latency of one step (shared-memory round
// trips and block barriers), not bandwidth or arithmetic.
//
// What the design does about that: the whole recursion runs in one
// launch, with V_z, V_zz and the step's Q blocks in shared memory (no
// device-memory round trip between steps), and the threads of the block
// each own entries of the nz x nz products, so a stage costs one product
// row (nz multiply-adds) and one barrier. The batch of solves is the grid.
// Several solves per block, warp shuffles in place of barriers and a
// prefetch of step i-1 are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxNz = 16;
constexpr int kMaxNu = 4;

template <typename T>
__device__ __forceinline__ T clamp_floor(T e, T reg) {
  return (e < T(0) ? T(1e-12) : e) + reg;
}

// Q_uu_inv = E diag(1 / (max(e, 1e-12) + reg)) E^T for a symmetric nu x nu
// Q_uu (nu <= 4), by the cyclic Jacobi of utils/linalg.small_eigh: the same
// rotation sequence, guard and tau clip. Runs on one thread.
template <typename T>
__device__ void jacobi_clamped_inverse(const T* quu, T* qinv, int nu, T reg) {
  T a[kMaxNu][kMaxNu], v[kMaxNu][kMaxNu];
  for (int r = 0; r < nu; ++r)
    for (int c = 0; c < nu; ++c) {
      a[r][c] = quu[r * nu + c];
      v[r][c] = r == c ? T(1) : T(0);
    }
  // Sweeps and the tau clip sqrt(max)/4 of small_eigh, per type.
  int sweeps;
  T big;
  if constexpr (sizeof(T) >= 8) {
    sweeps = 8;
    big = 3.3519519824856493e+153;
  } else {
    sweeps = 5;
    big = 4.611686e+18f;
  }
  for (int sw = 0; sw < sweeps; ++sw)
    for (int p = 0; p < nu - 1; ++p)
      for (int q = p + 1; q < nu; ++q) {
        const T app = a[p][p], aqq = a[q][q], apq = a[p][q];
        T t = T(0), c = T(1), s = T(0);
        if (apq != T(0)) {
          T tau = (aqq - app) / (T(2) * apq);
          tau = tau < -big ? -big : (tau > big ? big : tau);
          const T sgn = tau >= T(0) ? T(1) : T(-1);
          t = sgn / (fabs(tau) + sqrt(T(1) + tau * tau));
          c = T(1) / sqrt(T(1) + t * t);
          s = t * c;
        }
        for (int k = 0; k < nu; ++k) {
          if (k == p || k == q) continue;
          const T akp = a[k][p], akq = a[k][q];
          a[k][p] = a[p][k] = c * akp - s * akq;
          a[k][q] = a[q][k] = s * akp + c * akq;
        }
        a[p][p] = app - t * apq;
        a[q][q] = aqq + t * apq;
        a[p][q] = a[q][p] = T(0);
        for (int k = 0; k < nu; ++k) {
          const T vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
      }
  T e[kMaxNu];
  for (int j = 0; j < nu; ++j) e[j] = clamp_floor(a[j][j], reg);
  for (int r = 0; r < nu; ++r)
    for (int c = 0; c < nu; ++c) {
      T acc = T(0);
      for (int j = 0; j < nu; ++j) acc += v[r][j] / e[j] * v[c][j];
      qinv[r * nu + c] = acc;
    }
}

template <typename T>
__global__ void riccati_backward_kernel(
    const T* __restrict__ F_z, const T* __restrict__ F_u,
    const T* __restrict__ L_z, const T* __restrict__ L_u,
    const T* __restrict__ L_zz, const T* __restrict__ L_uz,
    const T* __restrict__ L_uu, T reg, T* __restrict__ k_out,
    T* __restrict__ K_out, int N, int nz, int nu) {
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int zz = nz * nz, zu = nz * nu, uu = nu * nu;
  F_z += b * N * zz;
  F_u += b * N * zu;
  L_z += b * (N + 1) * nz;
  L_u += b * N * nu;
  L_zz += b * (N + 1) * zz;
  L_uz += b * N * zu;
  L_uu += b * N * uu;
  k_out += b * N * nu;
  K_out += b * N * zu;

  __shared__ T Vz[kMaxNz], Vzz[kMaxNz * kMaxNz];
  __shared__ T Fz[kMaxNz * kMaxNz], Fu[kMaxNz * kMaxNu];
  __shared__ T VF[kMaxNz * kMaxNz], VFu[kMaxNz * kMaxNu];
  __shared__ T Qz[kMaxNz], Qu[kMaxNu], Qzz[kMaxNz * kMaxNz];
  __shared__ T Quz[kMaxNu * kMaxNz], Quu[kMaxNu * kMaxNu];
  __shared__ T QuuRaw[kMaxNu * kMaxNu], Qinv[kMaxNu * kMaxNu];
  __shared__ T kk[kMaxNu], KK[kMaxNu * kMaxNz];
  __shared__ T W[kMaxNz * kMaxNz];  // raw Q_zz, then raw V_zz

  for (int e = tid; e < zz; e += nt) Vzz[e] = L_zz[N * zz + e];
  for (int e = tid; e < nz; e += nt) Vz[e] = L_z[N * nz + e];
  for (int e = tid; e < zz; e += nt) Fz[e] = F_z[(N - 1) * zz + e];
  for (int e = tid; e < zu; e += nt) Fu[e] = F_u[(N - 1) * zu + e];
  __syncthreads();

  for (int i = N - 1; i >= 0; --i) {
    // V_zz F_z, V_zz F_u, Q_z, Q_u.
    for (int e = tid; e < zz + zu + nz + nu; e += nt) {
      if (e < zz) {
        const int r = e / nz, c = e % nz;
        T acc = T(0);
        for (int a = 0; a < nz; ++a) acc += Vzz[r * nz + a] * Fz[a * nz + c];
        VF[e] = acc;
      } else if (e < zz + zu) {
        const int f = e - zz, r = f / nu, c = f % nu;
        T acc = T(0);
        for (int a = 0; a < nz; ++a) acc += Vzz[r * nz + a] * Fu[a * nu + c];
        VFu[f] = acc;
      } else if (e < zz + zu + nz) {
        const int j = e - zz - zu;
        T acc = T(0);
        for (int a = 0; a < nz; ++a) acc += Vz[a] * Fz[a * nz + j];
        Qz[j] = L_z[i * nz + j] + acc;
      } else {
        const int j = e - zz - zu - nz;
        T acc = T(0);
        for (int a = 0; a < nz; ++a) acc += Vz[a] * Fu[a * nu + j];
        Qu[j] = L_u[i * nu + j] + acc;
      }
    }
    __syncthreads();

    // Raw Q_zz, Q_uz, raw Q_uu.
    for (int e = tid; e < zz + zu + uu; e += nt) {
      if (e < zz) {
        const int r = e / nz, c = e % nz;
        T acc = T(0);
        for (int a = 0; a < nz; ++a) acc += Fz[a * nz + r] * VF[a * nz + c];
        W[e] = L_zz[i * zz + e] + acc;
      } else if (e < zz + zu) {
        const int f = e - zz, r = f / nz, c = f % nz;
        T acc = T(0);
        for (int a = 0; a < nz; ++a) acc += Fu[a * nu + r] * VF[a * nz + c];
        Quz[f] = L_uz[i * zu + f] + acc;
      } else {
        const int f = e - zz - zu, r = f / nu, c = f % nu;
        T acc = T(0);
        for (int a = 0; a < nz; ++a) acc += Fu[a * nu + r] * VFu[a * nu + c];
        QuuRaw[f] = L_uu[i * uu + f] + acc;
      }
    }
    __syncthreads();

    // Symmetrize; one thread clamps and inverts Q_uu.
    for (int e = tid; e < zz + uu; e += nt) {
      if (e < zz) {
        const int r = e / nz, c = e % nz;
        Qzz[e] = T(0.5) * (W[e] + W[c * nz + r]);
      } else {
        const int f = e - zz, r = f / nu, c = f % nu;
        Quu[f] = nu == 1 ? QuuRaw[f]
                         : T(0.5) * (QuuRaw[f] + QuuRaw[c * nu + r]);
      }
    }
    if (tid == 0) {
      if (nu == 1) {
        Qinv[0] = T(1) / clamp_floor(QuuRaw[0], reg);
      } else {
        T sym[kMaxNu * kMaxNu];
        for (int r = 0; r < nu; ++r)
          for (int c = 0; c < nu; ++c)
            sym[r * nu + c] =
                T(0.5) * (QuuRaw[r * nu + c] + QuuRaw[c * nu + r]);
        jacobi_clamped_inverse(sym, Qinv, nu, reg);
      }
    }
    __syncthreads();

    // Gains.
    for (int e = tid; e < nu + zu; e += nt) {
      if (e < nu) {
        T acc = T(0);
        for (int c = 0; c < nu; ++c) acc += Qinv[e * nu + c] * Qu[c];
        kk[e] = -acc;
        k_out[i * nu + e] = -acc;
      } else {
        const int f = e - nu, r = f / nz, j = f % nz;
        T acc = T(0);
        for (int c = 0; c < nu; ++c) acc += Qinv[r * nu + c] * Quz[c * nz + j];
        KK[f] = -acc;
        K_out[i * zu + f] = -acc;
      }
    }
    __syncthreads();

    // V update from the unregularized Q.
    for (int e = tid; e < nz + zz; e += nt) {
      if (e < nz) {
        const int j = e;
        T acc = Qz[j];
        T s1 = T(0);
        for (int r = 0; r < nu; ++r) {
          T quuk = T(0);
          for (int c = 0; c < nu; ++c) quuk += Quu[r * nu + c] * kk[c];
          s1 += (Qu[r] + quuk) * KK[r * nz + j];
        }
        T s2 = T(0);
        for (int r = 0; r < nu; ++r) s2 += kk[r] * Quz[r * nz + j];
        Vz[j] = acc + s1 + s2;
      } else {
        const int f = e - nz, a = f / nz, c = f % nz;
        T kqk = T(0);
        for (int m = 0; m < nu; ++m) {
          T ktq = T(0);
          for (int r = 0; r < nu; ++r) ktq += KK[r * nz + a] * Quu[r * nu + m];
          kqk += ktq * KK[m * nz + c];
        }
        T ktq_ac = T(0), ktq_ca = T(0);
        for (int r = 0; r < nu; ++r) {
          ktq_ac += KK[r * nz + a] * Quz[r * nz + c];
          ktq_ca += KK[r * nz + c] * Quz[r * nz + a];
        }
        W[f] = Qzz[f] + kqk + ktq_ac + ktq_ca;
      }
    }
    __syncthreads();

    // Symmetrize V_zz; load the next step's Jacobians.
    for (int e = tid; e < zz; e += nt) {
      const int r = e / nz, c = e % nz;
      Vzz[e] = T(0.5) * (W[e] + W[c * nz + r]);
    }
    if (i > 0) {
      for (int e = tid; e < zz; e += nt) Fz[e] = F_z[(i - 1) * zz + e];
      for (int e = tid; e < zu; e += nt) Fu[e] = F_u[(i - 1) * zu + e];
    }
    __syncthreads();
  }
}

int threads_for(int nz, int nu) {
  int work = nz * nz + nz * nu + nz + nu;
  int t = ((work + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

template <typename T>
int launch(const T* F_z, const T* F_u, const T* L_z, const T* L_u,
           const T* L_zz, const T* L_uz, const T* L_uu, double reg, T* k,
           T* K, int B, int N, int nz, int nu, void* stream) {
  if (B < 1 || N < 1 || nz < 1 || nz > kMaxNz || nu < 1 || nu > kMaxNu)
    return static_cast<int>(cudaErrorInvalidValue);
  riccati_backward_kernel<T>
      <<<B, threads_for(nz, nu), 0, static_cast<cudaStream_t>(stream)>>>(
          F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, static_cast<T>(reg), k, K,
          N, nz, nu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pddp_riccati_backward_f32(const float* F_z, const float* F_u,
                              const float* L_z, const float* L_u,
                              const float* L_zz, const float* L_uz,
                              const float* L_uu, double reg, float* k,
                              float* K, int B, int N, int nz, int nu,
                              void* stream) {
  return launch<float>(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, reg, k, K, B,
                       N, nz, nu, stream);
}

int pddp_riccati_backward_f64(const double* F_z, const double* F_u,
                              const double* L_z, const double* L_u,
                              const double* L_zz, const double* L_uz,
                              const double* L_uu, double reg, double* k,
                              double* K, int B, int N, int nz, int nu,
                              void* stream) {
  return launch<double>(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, reg, k, K, B,
                        N, nz, nu, stream);
}

}  // extern "C"
