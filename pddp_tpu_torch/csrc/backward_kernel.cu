// K1: the Riccati backward of the unconstrained, Q_uu-regularized iLQR
// step, one warp per solve.
//
// Replaces the Pallas kernel pddp_tpu/ops/backward_kernel.py:45
// (pallas_backward; its pallas_call is at :122). Same arithmetic as that
// kernel's body (:59-118): per step i = N-1 .. 0,
//   Q_z  = L_z + F_z^T V_z          Q_u  = L_u + F_u^T V_z
//   Q_zz = sym(L_zz + F_z^T V_zz F_z)
//   Q_uz = L_uz + F_u^T V_zz F_z    Q_uu = sym(L_uu + F_u^T V_zz F_u)
//   e = eig(Q_uu) clamped below at 1e-12, plus reg  (closed form for nu=1,
//       fixed-sweep cyclic Jacobi for nu <= 4, as utils/linalg.small_eigh)
//   k = -Q_uu_reg^-1 Q_u            K = -Q_uu_reg^-1 Q_uz
//   V_z  = Q_z + K^T Q_uu k + K^T Q_u + Q_uz^T k
//   V_zz = sym(Q_zz + K^T Q_uu K + K^T Q_uz + Q_uz^T K)
// with the unregularized Q in the V update, and ok = all of k, K finite.
// reg is one for every solve, or each solve's own (a batch of solves, each
// lane on its own regularization schedule, as pallas_backward receives it
// per lane under vmap), read once from device memory before the recursion.
//
// What bounds it on an H100: at the main-path shape (N=200, nz=4, nu=1,
// f32) it reads about 37 KB and writes 4 KB, and does about 0.1 MFLOP:
// by the roofline that is nanoseconds. Its real limit is the chain of N
// dependent steps, each a few dependent stages of tiny products and a
// reciprocal (nu=1) or a 5-8 sweep Jacobi (nu=4): the time is N times
// the latency of one step.
//
// What the design does about that:
//  * the shapes are template parameters (a dispatch table of the paths'
//    (nz, nu)), so every product unrolls and the Jacobi's matrices live in
//    registers; each lane runs the clamp itself (no lane waits on another
//    for it: the rotations are one dependent chain whichever lane runs it);
//  * one warp per solve, several solves per block (the batch), and no
//    block barrier: a step is three lane-parallel stages in the warp's
//    shared memory with a __syncwarp between them. The stages work in the
//    joint coordinates (z, u, 1): stage A forms P = [V_zz; V_z^T] [F_z F_u]
//    plus [0; L_z L_u] (V_zz F_z, V_zz F_u, Q_z, Q_u in one product);
//    stage B the upper triangles of Q_zz and Q_uu and all of Q_uz; stage C
//    the upper triangle of [[V_zz, V_z]], each lane forming the two gain
//    columns its entry needs (K's column j, or k for the V_z column) from
//    the clamped inverse, so the gains need no stage of their own. Lanes
//    on the diagonal store K's columns, one lane k, as they are made;
//  * no device-memory load on the chain: the per-step inputs are staged
//    in shared memory in the joint layout, a ring of chunks of steps deep
//    (async_copy.cuh), the chunk ahead in flight while one is consumed;
//  * ok comes from the kernel: each storing lane keeps whether its gains
//    were finite, and one warp vote at the end writes the solve's flag.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T clamp_floor(T e, T reg) {
  return (e < T(0) ? T(1e-12) : e) + reg;
}

// The rotation's reciprocal and reciprocal square root. float32: the
// special-function unit's approximation refined by one Newton step (within
// an ulp of the rounded result, ~10 cycles against ~30 for an IEEE
// division); float64: the IEEE operations.
template <typename T>
struct Recip;
template <>
struct Recip<float> {
  static __device__ __forceinline__ float rcp(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return fmaf(r, fmaf(-x, r, 1.0f), r);
  }
  static __device__ __forceinline__ float rsqrt(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y * fmaf(-0.5f * x * y, y, 1.5f);
  }
  static __device__ __forceinline__ float sqrt(float x) {
    return x * rsqrt(x);
  }
  static constexpr float kEps = 1.1920929e-07f, kTiny = 1.17549435e-38f;
  static constexpr int kMaxExp = 120;
};
template <>
struct Recip<double> {
  static __device__ __forceinline__ double rcp(double x) { return 1.0 / x; }
  static __device__ __forceinline__ double rsqrt(double x) {
    return ::rsqrt(x);
  }
  static __device__ __forceinline__ double sqrt(double x) {
    return ::sqrt(x);
  }
  static constexpr double kEps = 2.220446049250313e-16,
                          kTiny = 2.2250738585072014e-308;
  static constexpr int kMaxExp = 1000;
};

// The Jacobi's pair order, round robin: at NU = 4 the two rotations of a
// round, (0,1)(2,3), (0,2)(1,3), (0,3)(1,2), touch disjoint rows, so the
// second's parameters do not wait on the first and both chains are in
// flight at once.
__host__ __device__ constexpr int jacobi_pair(int nu, int k, int which) {
  return nu == 4 ? (which == 0 ? (k == 0 ? 0 : k == 1 ? 2 : k == 2 ? 0
                                  : k == 3 ? 1 : k == 4 ? 0 : 1)
                               : (k == 0 ? 1 : k == 1 ? 3 : k == 2 ? 2
                                  : k == 3 ? 3 : k == 4 ? 3 : 2))
         : nu == 3 ? (which == 0 ? (k < 2 ? 0 : 1) : (k == 0 ? 1 : 2))
                   : (which == 0 ? 0 : 1);
}

// One Jacobi rotation annihilating a[p][q] (Golub & Van Loan 8.4): with
// d = a_qq - a_pp and h = 2 a_pq, tau = d / h and
//   t = sgn(tau) / (|tau| + sqrt(1 + tau^2)) = sgn(tau) |h| / (|d| + sqrt(d^2 + h^2)),
// one square root and one reciprocal where small_eigh takes three
// divisions and two square roots; a_pq = 0 is the identity rotation.
template <typename T, int NU>
__device__ __forceinline__ void jacobi_rotate(T (&a)[NU][NU], T (&v)[NU][NU],
                                              int p, int q) {
  using R = Recip<T>;
  const T app = a[p][p], aqq = a[q][q], apq = a[p][q];
  const bool live = apq != T(0);
  const T d = aqq - app, h = T(2) * (live ? apq : T(1));
  T x = d * d + h * h;
  x = x > R::kTiny ? x : R::kTiny;
  const T den = fabs(d) + R::sqrt(x);
  const bool pos = d == T(0) || ((d > T(0)) == (h > T(0)));
  T t = (pos ? fabs(h) : -fabs(h)) * R::rcp(den);
  T c = R::rsqrt(t * t + T(1));
  T s = t * c;
  t = live ? t : T(0);
  c = live ? c : T(1);
  s = live ? s : T(0);
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    if (k == p || k == q) continue;
    const T akp = a[k][p], akq = a[k][q];
    a[k][p] = a[p][k] = c * akp - s * akq;
    a[k][q] = a[q][k] = s * akp + c * akq;
  }
  a[p][p] = app - t * apq;
  a[q][q] = aqq + t * apq;
  a[p][q] = a[q][p] = T(0);
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    const T vkp = v[k][p], vkq = v[k][q];
    v[k][p] = c * vkp - s * vkq;
    v[k][q] = s * vkp + c * vkq;
  }
}

// Q_uu_inv = E diag(1 / (max(e, 1e-12) + reg)) E^T for the symmetric
// NU x NU Q_uu: the closed form for NU = 1, else utils/linalg.small_eigh's
// fixed-sweep cyclic Jacobi (5 sweeps in float32, 8 in float64), unrolled
// into registers, with three changes that shorten its chain and leave its
// function: Q_uu is scaled by a power of two (exact) so that its largest
// entry is in [0.5, 1) and the rotation cannot overflow; the pairs go in
// round-robin order; and the sweeps stop after one in which every
// |a_pq| <= eps sqrt(|a_pp a_qq|), past which a rotation changes the
// clamped inverse by rounding only.
template <typename T, int NU>
__device__ __forceinline__ void clamped_inverse(const T (&quu)[NU][NU],
                                                T reg, T (&qinv)[NU][NU]) {
  if constexpr (NU == 1) {
    qinv[0][0] = T(1) / clamp_floor(quu[0][0], reg);
  } else {
    using R = Recip<T>;
    constexpr int sweeps = sizeof(T) >= 8 ? 8 : 5;
    constexpr int pairs = NU * (NU - 1) / 2;
    T m = T(0);
#pragma unroll
    for (int r = 0; r < NU; ++r)
#pragma unroll
      for (int c = r; c < NU; ++c)
        m = fabs(quu[r][c]) > m ? fabs(quu[r][c]) : m;
    int ex = 0;
    if (m > T(0) && isfinite(m)) {
      if constexpr (sizeof(T) == 4)
        frexpf(m, &ex);
      else
        frexp(m, &ex);
    }
    ex = ex < -R::kMaxExp ? -R::kMaxExp : (ex > R::kMaxExp ? R::kMaxExp : ex);
    T down, up;
    if constexpr (sizeof(T) == 4) {
      down = ldexpf(1.0f, -ex);
      up = ldexpf(1.0f, ex);
    } else {
      down = ldexp(1.0, -ex);
      up = ldexp(1.0, ex);
    }
    T a[NU][NU], v[NU][NU];
#pragma unroll
    for (int r = 0; r < NU; ++r)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        a[r][c] = quu[r][c] * down;
        v[r][c] = r == c ? T(1) : T(0);
      }
#pragma unroll
    for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll
      for (int k = 0; k < pairs; ++k)
        jacobi_rotate<T, NU>(a, v, jacobi_pair(NU, k, 0),
                             jacobi_pair(NU, k, 1));
      bool done = true;
#pragma unroll
      for (int p = 0; p < NU - 1; ++p)
#pragma unroll
        for (int q = p + 1; q < NU; ++q)
          done = done && a[p][q] * a[p][q] <=
                             R::kEps * R::kEps * fabs(a[p][p] * a[q][q]);
      if (done) break;
    }
    T w[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) w[j] = R::rcp(clamp_floor(a[j][j] * up, reg));
#pragma unroll
    for (int r = 0; r < NU; ++r)
#pragma unroll
      for (int c = r; c < NU; ++c) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NU; ++j) acc += v[r][j] * w[j] * v[c][j];
        qinv[r][c] = qinv[c][r] = acc;
      }
  }
}

// The warp kernel's clamp: the same function as clamped_inverse above by
// the cyclic Jacobi of utils/linalg.small_eigh itself (the same rotation
// sequence, guard and tau clip, all sweeps), unrolled into registers. (The
// warp kernel's nu = 4 instances ran 2.5x (8, 4) and 1.7x (16, 4) faster
// with clamped_inverse on an H100, but the float32 rendezvous solve through
// them then fell on the other side of its ulp tie: MAX_REG after 12
// evaluations in place of CONVERGED after 3, at the same cost.)
template <typename T, int NU>
__device__ __forceinline__ void clamped_inverse_cyclic(
    const T (&quu)[NU][NU], T reg, T (&qinv)[NU][NU]) {
  if constexpr (NU == 1) {
    qinv[0][0] = T(1) / clamp_floor(quu[0][0], reg);
  } else {
    // Sweeps and the tau clip sqrt(max)/4 of small_eigh, per type.
    constexpr int sweeps = sizeof(T) >= 8 ? 8 : 5;
    T big;
    if constexpr (sizeof(T) >= 8)
      big = 3.3519519824856493e+153;
    else
      big = 4.611686e+18f;
    T a[NU][NU], v[NU][NU];
#pragma unroll
    for (int r = 0; r < NU; ++r)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        a[r][c] = quu[r][c];
        v[r][c] = r == c ? T(1) : T(0);
      }
#pragma unroll
    for (int sw = 0; sw < sweeps; ++sw)
#pragma unroll
      for (int p = 0; p < NU - 1; ++p)
#pragma unroll
        for (int q = p + 1; q < NU; ++q) {
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
#pragma unroll
          for (int k = 0; k < NU; ++k) {
            if (k == p || k == q) continue;
            const T akp = a[k][p], akq = a[k][q];
            a[k][p] = a[p][k] = c * akp - s * akq;
            a[k][q] = a[q][k] = s * akp + c * akq;
          }
          a[p][p] = app - t * apq;
          a[q][q] = aqq + t * apq;
          a[p][q] = a[q][p] = T(0);
#pragma unroll
          for (int k = 0; k < NU; ++k) {
            const T vkp = v[k][p], vkq = v[k][q];
            v[k][p] = c * vkp - s * vkq;
            v[k][q] = s * vkp + c * vkq;
          }
        }
    T e[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) e[j] = clamp_floor(a[j][j], reg);
#pragma unroll
    for (int r = 0; r < NU; ++r)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NU; ++j) acc += v[r][j] / e[j] * v[c][j];
        qinv[r][c] = acc;
      }
  }
}

// Shared-memory layout of one warp, in elements.
template <int NZ, int NU>
struct K1Shape {
  static constexpr int NX = NZ + NU;  // the joint (z, u)
  // One staged step: Fc = [F_z F_u] (NZ x NX), Lc = [L_z; L_u] (NX), and
  // Lcc (NX x NX) holding L_zz, L_uz and L_uu at their joint places.
  static constexpr int kFc = 0, kLc = NZ * NX, kLcc = kLc + NX;
  static constexpr int kStep = kLcc + NX * NX;
  // Workspace after the ring: Vt = [V_zz; V_z^T] ((NZ+1) x NZ), P (stage
  // A, (NZ+1) x NX) and Q (stage B, NX x NX, Q_zz, Q_uz and Q_uu at their
  // joint places).
  static constexpr int kP = (NZ + 1) * NZ, kQ = kP + (NZ + 1) * NX;
  static constexpr int kWork = kQ + NX * NX;
  // Entries each stage computes.
  static constexpr int kOutA = (NZ + 1) * NX;
  static constexpr int kOutB =
      NZ * (NZ + 1) / 2 + NU * NZ + NU * (NU + 1) / 2;
  static constexpr int kOutC = (NZ + 1) * (NZ + 2) / 2 - 1;
  __host__ __device__ static constexpr long warp_elems(int chunk) {
    return long(pddp::kStages) * chunk * kStep + kWork;
  }
};

template <typename T>
struct K1Args {
  const T *F_z, *F_u, *L_z, *L_u, *L_zz, *L_uz, *L_uu;
  T *k, *K;
  bool* ok;
  const T* regs;  // a reg per solve, or null: every solve takes reg
  T reg;
  int B, N, C;  // solves, steps, steps per chunk
};

template <typename T, int NZ, int NU>
__global__ void __launch_bounds__(32 * pddp::kMaxSolvesPerBlock)
    riccati_backward_kernel(const K1Args<T> g) {
  using S = K1Shape<NZ, NU>;
  constexpr int NX = S::NX, ZZ = NZ * NZ;
  constexpr int PA = (S::kOutA + 31) / 32, PB = (S::kOutB + 31) / 32,
                PC = (S::kOutC + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= g.B) return;  // the ragged last block; no block barrier follows
  const int N = g.N, C = g.C;
  const long warp_elems =
      pddp::round16(S::warp_elems(C) * long(sizeof(T))) / long(sizeof(T));
  T* const ring = reinterpret_cast<T*>(smem_raw) + warp * warp_elems;
  T* const Vt = ring + long(pddp::kStages) * C * S::kStep;
  T* const P = Vt + S::kP;
  T* const Q = Vt + S::kQ;

  const size_t bb = b;
  const T* F_z = g.F_z + bb * N * ZZ;
  const T* F_u = g.F_u + bb * N * NZ * NU;
  const T* L_z = g.L_z + bb * (N + 1) * NZ;
  const T* L_u = g.L_u + bb * N * NU;
  const T* L_zz = g.L_zz + bb * (N + 1) * ZZ;
  const T* L_uz = g.L_uz + bb * N * NU * NZ;
  const T* L_uu = g.L_uu + bb * N * NU * NU;
  T* k_out = g.k + bb * N * NU;
  T* K_out = g.K + bb * N * NU * NZ;
  // This solve's reg: one load, before the recursion starts.
  const T reg = g.regs ? g.regs[bb] : g.reg;

  // This lane's entries in stages B and C, (row << 8) | column, -1 idle.
  int codeB[PB], codeC[PC];
#pragma unroll
  for (int p = 0; p < PB; ++p) codeB[p] = -1;
#pragma unroll
  for (int p = 0; p < PC; ++p) codeC[p] = -1;
  {
    int e = 0;  // upper Q_zz, all of Q_uz, upper Q_uu
#pragma unroll
    for (int r = 0; r < NX; ++r)
#pragma unroll
      for (int c = 0; c < NX; ++c)
        if (r < NZ ? (c >= r && c < NZ) : (c < NZ || c >= r)) {
          if ((e & 31) == lane) codeB[e >> 5] = (r << 8) | c;
          ++e;
        }
    e = 0;  // upper V_zz, and V_z as column NZ
#pragma unroll
    for (int a = 0; a < NZ; ++a)
#pragma unroll
      for (int c = a; c <= NZ; ++c) {
        if ((e & 31) == lane) codeC[e >> 5] = (a << 8) | c;
        ++e;
      }
  }

  // The ring: chunk c holds steps [lo, hi), hi = N - c C, in the joint
  // layout, in slot c % kStages.
  const int n_chunks = (N + C - 1) / C;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int hi = N - c * C, lo = hi > C ? hi - C : 0, n = hi - lo;
      T* s = ring + long(c % pddp::kStages) * C * S::kStep;
      constexpr int st = S::kStep;
      pddp::stage_rows<NZ, NZ>(s + S::kFc, st, NX, F_z + lo * ZZ, n, lane);
      pddp::stage_rows<NZ, NU>(s + S::kFc + NZ, st, NX, F_u + lo * NZ * NU,
                               n, lane);
      pddp::stage_rows<1, NZ>(s + S::kLc, st, NX, L_z + lo * NZ, n, lane);
      pddp::stage_rows<1, NU>(s + S::kLc + NZ, st, NX, L_u + lo * NU, n,
                              lane);
      pddp::stage_rows<NZ, NZ>(s + S::kLcc, st, NX, L_zz + lo * ZZ, n, lane);
      pddp::stage_rows<NU, NZ>(s + S::kLcc + NZ * NX, st, NX,
                               L_uz + lo * NU * NZ, n, lane);
      pddp::stage_rows<NU, NU>(s + S::kLcc + NZ * NX + NZ, st, NX,
                               L_uu + lo * NU * NU, n, lane);
    }
    pddp::cp_async_commit();  // empty past the end: the count stays even
  };
  for (int c = 0; c < pddp::kStages - 1; ++c) issue(c);

  // The terminal value function, while the first chunks are in flight.
  for (int e = lane; e < ZZ; e += 32) Vt[e] = L_zz[(size_t)N * ZZ + e];
  for (int e = lane; e < NZ; e += 32) Vt[ZZ + e] = L_z[(size_t)N * NZ + e];

  bool finite = true;
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + pddp::kStages - 1);
    pddp::cp_async_wait_oldest();
    __syncwarp();
    const int hi = N - c * C, lo = hi > C ? hi - C : 0;
    const T* slot = ring + long(c % pddp::kStages) * C * S::kStep;
    for (int i = hi - 1; i >= lo; --i) {
      const T* Fc = slot + (i - lo) * S::kStep + S::kFc;
      const T* Lc = slot + (i - lo) * S::kStep + S::kLc;
      const T* Lcc = slot + (i - lo) * S::kStep + S::kLcc;

      // Stage A: P = Vt Fc, plus [L_z L_u] in row NZ.
#pragma unroll
      for (int p = 0; p < PA; ++p) {
        const int e = lane + 32 * p;
        if (e < S::kOutA) {
          const int row = e / NX, col = e - row * NX;
          T acc = T(0);
#pragma unroll
          for (int a = 0; a < NZ; ++a) acc += Vt[row * NZ + a] * Fc[a * NX + col];
          P[e] = row == NZ ? Lc[col] + acc : acc;
        }
      }
      __syncwarp();

      // Stage B: W = Lcc + Fc^T P; Q_zz and Q_uu symmetrized, Q_uz as is.
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        const int code = codeB[p];
        if (code >= 0) {
          const int r = code >> 8, c2 = code & 255;
          const bool sym = r < NZ || c2 >= NZ;
          const int rt = sym ? c2 : r, ct = sym ? r : c2;
          T w1 = T(0), w2 = T(0);
#pragma unroll
          for (int a = 0; a < NZ; ++a) {
            w1 += Fc[a * NX + r] * P[a * NX + c2];
            w2 += Fc[a * NX + rt] * P[a * NX + ct];
          }
          w1 = Lcc[r * NX + c2] + w1;
          w2 = Lcc[rt * NX + ct] + w2;
          const T q = sym ? T(0.5) * (w1 + w2) : w1;
          Q[r * NX + c2] = q;
          Q[c2 * NX + r] = q;
        }
      }
      __syncwarp();

      // Stage C: every lane clamps and inverts Q_uu, forms the two gain
      // columns of its entry and the entry of [V_zz V_z].
      T quu[NU][NU], qinv[NU][NU];
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int m = 0; m < NU; ++m) quu[u][m] = Q[(NZ + u) * NX + NZ + m];
      clamped_inverse_cyclic<T, NU>(quu, reg, qinv);
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        const int code = codeC[p];
        if (code >= 0) {
          const int a = code >> 8, c2 = code & 255;
          const bool vz = c2 == NZ;  // the V_z column: gain k, no sym
          // Columns a and c2 of [Q_uz Q_u], and the gains' columns.
          const T* qcol = vz ? P + NZ * NX + NZ : Q + NZ * NX + c2;
          const int qld = vz ? 1 : NX;
          T qa[NU], qc[NU], Ka[NU], Kc[NU];
#pragma unroll
          for (int r = 0; r < NU; ++r) {
            qa[r] = Q[(NZ + r) * NX + a];
            qc[r] = qcol[r * qld];
          }
#pragma unroll
          for (int r = 0; r < NU; ++r) {
            T sa = T(0), sc = T(0);
#pragma unroll
            for (int m = 0; m < NU; ++m) {
              sa += qinv[r][m] * qa[m];
              sc += qinv[r][m] * qc[m];
            }
            Ka[r] = -sa;
            Kc[r] = -sc;
          }
          // W(x, y) = Q_xy + K_x^T Q_uu K_y + K_x^T q_y + q_x^T K_y.
          T kqk1 = T(0), kqk2 = T(0), kq1 = T(0), kq2 = T(0), qk1 = T(0),
            qk2 = T(0);
#pragma unroll
          for (int r = 0; r < NU; ++r) {
            T uc = T(0), ua = T(0);
#pragma unroll
            for (int m = 0; m < NU; ++m) {
              uc += quu[r][m] * Kc[m];
              ua += quu[r][m] * Ka[m];
            }
            kqk1 += Ka[r] * uc;
            kqk2 += Kc[r] * ua;
            kq1 += Ka[r] * qc[r];
            kq2 += Kc[r] * qa[r];
            qk1 += qa[r] * Kc[r];
            qk2 += qc[r] * Ka[r];
          }
          const T x = vz ? P[NZ * NX + a] : Q[a * NX + c2];
          const T w1 = ((x + kqk1) + kq1) + qk1;
          const T w2 = ((x + kqk2) + kq2) + qk2;
          const T v = vz ? w1 : T(0.5) * (w1 + w2);
          Vt[vz ? ZZ + a : a * NZ + c2] = v;
          Vt[vz ? ZZ + a : c2 * NZ + a] = v;
          if (a == c2) {  // K's column a
#pragma unroll
            for (int r = 0; r < NU; ++r) {
              K_out[((size_t)i * NU + r) * NZ + a] = Ka[r];
              finite = finite && isfinite(Ka[r]);
            }
          } else if (vz && a == 0) {  // k
#pragma unroll
            for (int r = 0; r < NU; ++r) {
              k_out[(size_t)i * NU + r] = Kc[r];
              finite = finite && isfinite(Kc[r]);
            }
          }
        }
      }
      __syncwarp();
    }
  }
  const bool ok = __all_sync(0xffffffffu, finite);
  if (lane == 0) g.ok[b] = ok;
}

// The (nz, nu) instances: the paths' shapes (cartpole 4, pendulum 2,
// double cartpole 6, rendezvous 8 with nu=4, the BNN under the Cholesky
// codec 14) and the examples' belief codecs within nz <= 16 (pendulum 4,
// 5, 6; cartpole 8, 14; double cartpole 12; rendezvous 16 with nu=4).
// ops/backward_kernel.INSTANCES lists the same.
#define PDDP_K1_SHAPES(X) \
  X(2, 1) X(4, 1) X(5, 1) X(6, 1) X(8, 1) X(12, 1) X(14, 1) X(8, 4) X(16, 4)

template <typename T, int NZ, int NU>
int launch_shape(K1Args<T> g, cudaStream_t stream) {
  const pddp::Plan p = pddp::plan<T>(g.B, g.N, 0, [](int chunk) {
    return K1Shape<NZ, NU>::warp_elems(chunk);
  });
  if (p.bytes > pddp::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static long allowed = 48 * 1024;  // per instance
  const cudaError_t err =
      pddp::allow_smem(riccati_backward_kernel<T, NZ, NU>, p.bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  g.C = p.chunk;
  const int blocks = (g.B + p.warps - 1) / p.warps;
  riccati_backward_kernel<T, NZ, NU>
      <<<blocks, 32 * p.warps, p.bytes, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* F_z, const T* F_u, const T* L_z, const T* L_u,
           const T* L_zz, const T* L_uz, const T* L_uu, double reg,
           const T* regs, T* k, T* K, bool* ok, int B, int N, int nz, int nu,
           void* stream_ptr) {
  if (B < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const K1Args<T> g{F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, k, K, ok,
                    regs, static_cast<T>(reg), B, N, 0};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PDDP_K1_LAUNCH(NZ_, NU_) \
  if (nz == NZ_ && nu == NU_) return launch_shape<T, NZ_, NU_>(g, stream);
  PDDP_K1_SHAPES(PDDP_K1_LAUNCH)
#undef PDDP_K1_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The block kernel: one thread block, or one thread-block cluster of c CTAs,
// per solve, for every (nz, nu <= 4) without a warp instance above; nz is a
// run-time size.
//
// Same function as the warp kernel, in the same joint coordinates. With
// Vx = [V_zz V_z] (nz x (nz+1)) and Fc = [F_z F_u] (nz x nx), a step is
//   A  P = Vx^T Fc + [0; L_z L_u]           ((nz+1) x nx; row nz is Q_z, Q_u)
//   B  W = Lcc + Fc^T P[:nz]: Q_zz (its upper triangle) and Q_uz; beside it,
//      warp 0 forms Q_uu (sym) and its clamped inverse Qi
//   C  the upper triangle of [V_zz V_z]: with q_x column x of [Q_uz Q_u]
//      and K_x = -Qi q_x, (a, x) = Q(a, x) + K_a^T Q_uu K_x + K_a^T q_x +
//      q_a^T K_x, summed in both orders and averaged as the plain version's
//      sym() does (x = nz, the V_z column, in one), each thread forming the
//      gain columns its tile needs; the first tile row stores its columns'
//      gains (K, and k at x = nz). (Folding the update into the NU x NU
//      form Qi Q_uu Qi - 2 Qi was as fast but strayed past phase 1's
//      float64 tolerance at nz = 100.)
// A and B are the bulk of a step, about (nz+1) nx nz + (nz^2/2 + nu nz) nz
// multiply-adds (0.6 M at nz = 72), as products X^T Y over the nz rows of
// two row-major operands: a thread takes a KT x KT tile (KT = 1, 2 or 4)
// and reads KT contiguous elements of each operand's row at a time, as one
// vector load (rows padded to 16 bytes), so that a 4 x 4 tile does 16
// multiply-adds for two shared-memory loads. Each stage's tiles are listed
// once in shared memory (no index arithmetic per entry in the loop).
//
// What holds a step back on an H100 (clock64 stamps of a first version,
// one block a solve with the L terms read from device memory in the tiles
// and four barriers a step: 4.3-12.2 k cycles a step at nu = 1, against a
// chain floor of 0.2-0.4 k; the Jacobi 13.7-18.9 k at nu = 4), and what
// the design does:
//  * device memory on the chain: every input of the next step ([F_z F_u]
//    in its padded layout, the L terms as they lie) is staged by cp.async
//    into the second of two buffers while this step runs, in 16-byte
//    copies where nz allows; where shared memory cannot hold the L terms'
//    buffers too (float64 at the widest shapes, the scratch buffer) a tile
//    reads them from device memory before its product. (An L2 prefetch of
//    the steps after, tried first, cost ~1.3 k cycles of issue a step and
//    saved nothing.)
//  * barriers and idle threads: three barriers a step (after A, B and C);
//    the gains are formed in C by the threads that need them; warp 0's
//    clamp is handed over by the barrier that also publishes W; tiles are
//    listed once, so no entry's index is divided out in the loop;
//  * the clamp's chain (clamped_inverse): round-robin pairs, one square
//    root and one reciprocal a rotation, an exit once converged; and Q_uu's
//    sums split over warp 0's lanes;
//  * one SM's multiply-add rate at the widest shapes: the library launches
//    a cluster of c CTAs per solve (cudaLaunchKernelEx), CTA r owning
//    columns [lo, hi) of Vx and W and rows [lo, hi) of P. Each CTA stages
//    the whole of a step's inputs, stores its rows of P into every CTA's P
//    (distributed shared memory), then after a cluster barrier its tiles of
//    W, whose Q_uz it stores into every CTA too; the clamp runs in every
//    CTA's warp 0; after a second cluster barrier each CTA updates its
//    columns' upper triangle of Vx and stores each entry's mirror into the
//    CTA owning that column, so that V stays exactly symmetric (an
//    asymmetric part would grow as F_z^T A F_z, unchecked), and the step's
//    last barrier is a cluster barrier too.
// The library plans c (4 or 8 where a step's bulk is worth it and every
// cluster of the batch fits the card at once, else 1) and KT (the smallest
// whose stages take little more than one pass of a CTA's threads). Past
// shared memory (the c = 1 workspace above 227 KB: about nz = 98 in
// float64) the same code runs on a device-memory scratch buffer the caller
// allocates, with 4 x 4 tiles.

namespace cg = cooperative_groups;

constexpr int kMaxBlockThreads = 512;  // 128 registers a thread at most
constexpr int kMaxCluster = 8;         // the portable cluster size

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ constexpr long round_up(long n, long m) {
  return (n + m - 1) / m * m;
}

// The columns [lo, hi) of Vx (rows of P) that CTA `rank` of c owns, whole
// tiles of KT each.
struct K1Range {
  int lo, hi;
};

__host__ __device__ inline K1Range k1_range(int nz, int kt, int c, int rank) {
  const int nz1 = nz + 1, per = ceil_div(ceil_div(nz1, kt), c) * kt;
  const int lo = rank * per < nz1 ? rank * per : nz1;
  return {lo, lo + per < nz1 ? lo + per : nz1};
}

// Tiles of stages A, B and C of the CTA owning columns x: A its rows of P;
// B the tiles of its columns of W that meet the upper triangle of Q_zz, and
// those of every row group holding a u row (Q_uz); C the tiles of its
// columns that meet the upper triangle of [V_zz V_z].
struct K1Tiles {
  int a, b, c;
};

// The first column group of row group rg in stage B (u: it holds a u row)
// or C, within the CTA's groups [glo, ...).
__host__ __device__ constexpr int k1_first_group(int rg, int glo, bool u) {
  return u || rg < glo ? glo : rg;
}

__host__ __device__ inline K1Tiles k1_tiles(int nz, int nu, int kt,
                                            K1Range x) {
  const int nx = nz + nu, cz = ceil_div(nz, kt), rx = ceil_div(nx, kt);
  const int glo = x.lo / kt, ghi = ceil_div(x.hi, kt),
            ghz = ghi < cz ? ghi : cz;
  K1Tiles t{(ghi - glo) * ceil_div(nx, kt), 0, 0};
  for (int rg = 0; rg < rx; ++rg) {
    const int n = ghz - k1_first_group(rg, glo, (rg + 1) * kt > nz);
    t.b += n > 0 ? n : 0;
  }
  for (int rg = 0; rg < cz; ++rg) {
    const int n = ghi - k1_first_group(rg, glo, false);
    t.c += n > 0 ? n : 0;
  }
  return t;
}

// The most tiles of each stage, and in all, over the c CTAs (the last
// CTA's columns reach furthest into the upper triangles).
struct K1MaxTiles {
  K1Tiles most;
  int sum;
};

__host__ __device__ inline K1MaxTiles k1_max_tiles(int nz, int nu, int kt,
                                                   int c) {
  K1MaxTiles m{{0, 0, 0}, 0};
  for (int r = 0; r < c; ++r) {
    const K1Tiles t = k1_tiles(nz, nu, kt, k1_range(nz, kt, c, r));
    m.most.a = t.a > m.most.a ? t.a : m.most.a;
    m.most.b = t.b > m.most.b ? t.b : m.most.b;
    m.most.c = t.c > m.most.c ? t.c : m.most.c;
    m.sum = t.a + t.b + t.c > m.sum ? t.a + t.b + t.c : m.sum;
  }
  return m;
}

// A CTA's workspace, in elements, each part a multiple of 16 bytes: two
// [F_z F_u] buffers (ldx a row), Vx and W (ldw: all nz+1 columns with one
// CTA, the CTA's own in a cluster), P, [Q_uz Q_u] (ldv), Qi and Q_uu, and,
// with stage_l, two buffers of a step's L terms (L_zz, L_uz, then L_z,
// L_u, L_uu, each as in device memory); then the tile lists and the
// cluster's ok flags (ints).
struct K1Layout {
  int ldx, ldv, ldw;
  long fc0, fc1, vx, p, w, qu, qi, quu, l0, l1, total;
  long lzz, luz, lz, lu, luu;  // offsets within an L buffer
  int tiles;
  long smem;  // bytes of dynamic shared memory (scratch: the lists only)
};

__host__ __device__ inline K1Layout k1_layout(int nz, int nu, int kt, int c,
                                              long itemsize, bool scratch,
                                              bool stage_l) {
  const long vec = 16 / itemsize, al = vec > kt ? vec : kt;
  const int nx = nz + nu, nz1 = nz + 1;
  const K1Range x = k1_range(nz, kt, c, 0);
  K1Layout l;
  l.ldx = int(round_up(nx, al));
  l.ldv = int(round_up(nz1, al));
  l.ldw = c == 1 ? l.ldv : int(round_up(x.hi - x.lo, al));
  long o = 0;
  const auto take = [&](long n) {
    const long at = o;
    o += round_up(n, vec);
    return at;
  };
  l.fc0 = take(long(nz) * l.ldx);
  l.fc1 = take(long(nz) * l.ldx);
  l.vx = take(long(nz) * l.ldw);
  l.p = take(long(nz1) * l.ldx);
  l.w = take(long(nz) * l.ldw);
  l.qu = take(long(nu) * l.ldv);
  l.qi = take(long(nu) * nu);
  l.quu = take(long(nu) * nu);
  const long lo = o;
  l.lzz = take(long(nz) * nz) - lo;
  l.luz = take(long(nu) * nz) - lo;
  l.lz = take(nz) - lo;
  l.lu = take(nu) - lo;
  l.luu = take(long(nu) * nu) - lo;
  const long lsize = o - lo;
  o = lo;
  l.l0 = stage_l ? take(lsize) : 0;
  l.l1 = stage_l ? take(lsize) : 0;
  l.total = o;
  l.tiles = k1_max_tiles(nz, nu, kt, c).sum;
  l.smem = (scratch ? 0 : l.total * itemsize) +
           round_up(long(l.tiles + kMaxCluster) * 4, 16);
  return l;
}

// Threads a CTA: enough for every tile of a stage in one pass (stage B
// beside warp 0), in whole warps, at least two, at most kMaxBlockThreads.
__host__ inline int k1_block_threads(int nz, int nu, int kt, int c) {
  const K1Tiles t = k1_max_tiles(nz, nu, kt, c).most;
  int n = t.a > t.b + 32 ? t.a : t.b + 32;
  n = int(round_up(n > t.c ? n : t.c, 32));
  return n < 64 ? 64 : (n > kMaxBlockThreads ? kMaxBlockThreads : n);
}

// The smallest tile whose stages each take at most a quarter of a second
// pass of a CTA's threads (a cluster takes 2 or 4); 4 where none does.
// (Measured on an H100: at nz = 44 two passes of 2 x 2 tiles beat one of
// 4 x 4, whose 4.5 warps leave the SM idle.)
__host__ inline int k1_block_tile(int nz, int nu, int c) {
  for (int kt = c == 1 ? 1 : 2; kt <= 2; ++kt) {
    const K1Tiles t = k1_max_tiles(nz, nu, kt, c).most;
    const int most = kMaxBlockThreads + kMaxBlockThreads / 4;
    if (t.a <= most && t.b + 32 <= most && t.c <= most) return kt;
  }
  return 4;
}

template <typename T>
struct K1BlockArgs {
  const T *F_z, *F_u, *L_z, *L_u, *L_zz, *L_uz, *L_uu;
  T *k, *K;
  bool* ok;
  T* scratch;  // null: the workspace is in shared memory
  const T* regs;  // a reg per solve, or null: every solve takes reg
  T reg;
  int N, nz;
  int fv;        // elements a copy of F_z's rows (stage_fc)
  int lzv, luv;  // elements a copy of L_zz's, L_uz's step (stage_flat)
  bool stage_l;  // the L terms staged in shared memory
};

// KT contiguous elements at p (aligned to KT elements or 16 bytes).
template <int KT, typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[KT]) {
  if constexpr (KT == 4 && sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (KT == 2 && sizeof(T) == 4) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else if constexpr (KT == 4) {
    const double2 q0 = *reinterpret_cast<const double2*>(p);
    const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
    v[0] = q0.x, v[1] = q0.y, v[2] = q1.x, v[3] = q1.y;
  } else if constexpr (KT == 2) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// Stores KT contiguous elements at p (aligned as load_vec's).
template <int KT, typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[KT]) {
  if constexpr (KT == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (KT == 2 && sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else if constexpr (KT == 4) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
  } else if constexpr (KT == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// acc(i, j) = sum_{a < K} X[a ldX + i] Y[a ldY + j], i, j < KT.
template <int KT, typename T>
__device__ __forceinline__ void xty_tile(const T* X, int ldX, const T* Y,
                                         int ldY, int K, T (&acc)[KT][KT]) {
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int j = 0; j < KT; ++j) acc[i][j] = T(0);
#pragma unroll 4
  for (int a = 0; a < K; ++a) {
    T x[KT], y[KT];
    load_vec<KT>(X + a * ldX, x);
    load_vec<KT>(Y + a * ldY, y);
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) acc[i][j] += x[i] * y[j];
  }
}

// Asynchronous copy of n elements (4, 8 or 16 bytes, both addresses
// aligned to them) from device to shared memory.
template <typename T>
__device__ __forceinline__ void cp_async_n(T* dst, const T* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (n * int(sizeof(T))) {
    case 16:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                   "l"(src) : "memory");
      break;
    default:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src) : "memory");
  }
}

// n contiguous elements from src to dst, in copies of v elements (n a
// multiple of v, both addresses aligned to v elements), by cp.async into
// shared memory (the caller commits) or plain copies into the scratch
// buffer.
template <bool kScratch, typename T>
__device__ __forceinline__ void stage_flat(T* dst, const T* src, int n,
                                           int v) {
  for (int e = threadIdx.x * v; e < n; e += blockDim.x * v) {
    if constexpr (kScratch) {
      for (int j = 0; j < v; ++j) dst[e + j] = src[e + j];
    } else {
      cp_async_n(dst + e, src + e, v);
    }
  }
}

// Where a thread's share of stage_fc starts: copy unit `first` of F_z's
// rows (fv elements each, nz / fv a row), then of F_u's elements.
struct FcCursor {
  int a, c;
};

// [F_z F_u] of one step into dst (nz x nx, row stride ld), by cp.async into
// shared memory (one commit group) or by plain copies into the scratch
// buffer: F_z in units of fv elements (16 or 8 bytes where its rows allow:
// nz a multiple of 4 or 2 in float32 and aligned tensors), F_u element by
// element. The units of a thread are every blockDim-th from its own, at
// the same place each step: it walks them from cursors computed once.
template <bool kScratch, typename T>
__device__ __forceinline__ void stage_fc(T* dst, int ld, const T* F_z,
                                         const T* F_u, int nz, int nu, int fv,
                                         FcCursor z, FcCursor u) {
  const int step = blockDim.x, per_row = nz / fv;
  const int da = step / per_row, dc = (step - da * per_row) * fv;
  for (int a = z.a, c = z.c; a < nz;) {
    if constexpr (kScratch) {
      for (int j = 0; j < fv; ++j) dst[a * ld + c + j] = F_z[a * nz + c + j];
    } else {
      cp_async_n(dst + a * ld + c, F_z + a * nz + c, fv);
    }
    a += da;
    c += dc;
    if (c >= nz) {
      c -= nz;
      ++a;
    }
  }
  const int ua = step / nu, uc = step - ua * nu;
  for (int a = u.a, c = u.c; a < nz;) {
    if constexpr (kScratch)
      dst[a * ld + nz + c] = F_u[a * nu + c];
    else
      pddp::cp_async(dst + a * ld + nz + c, F_u + a * nu + c);
    a += ua;
    c += uc;
    if (c >= nu) {
      c -= nu;
      ++a;
    }
  }
  if constexpr (!kScratch) pddp::cp_async_commit();
}

// Warp 0 during stage B: Q_uu = sym(L_uu + F_u^T V_zz F_u) (its entries'
// sums split over the lanes and joined by shuffles) and its clamped
// inverse Qi, stored by lane 0.
template <typename T, int NU>
__device__ __forceinline__ void clamp_warp(int lane, const T* Fc,
                                           const T* P, int ld, int nz,
                                           const T* Luu, T reg, T* QI,
                                           T* QUU) {
  constexpr int E = NU * NU, S = NU == 1 ? 32 : (NU == 2 ? 8 : 2);
  T luu[NU][NU];  // read before the sum, to hide its latency
#pragma unroll
  for (int r = 0; r < NU; ++r)
#pragma unroll
    for (int c = 0; c < NU; ++c) luu[r][c] = Luu[r * NU + c];
  const int e = lane % E, part = lane / E;
  T s = T(0);
  if (part < S) {  // four chains of the lane's share of the sum
    const int r = e / NU, c = e - r * NU;
    const T* f = Fc + nz + r;
    const T* p = P + nz + c;
    T s1 = T(0), s2 = T(0), s3 = T(0);
    int a = part;
    for (; a + 3 * S < nz; a += 4 * S) {
      s += f[a * ld] * p[a * ld];
      s1 += f[(a + S) * ld] * p[(a + S) * ld];
      s2 += f[(a + 2 * S) * ld] * p[(a + 2 * S) * ld];
      s3 += f[(a + 3 * S) * ld] * p[(a + 3 * S) * ld];
    }
    for (; a < nz; a += S) s += f[a * ld] * p[a * ld];
    s = (s + s1) + (s2 + s3);
  }
#pragma unroll
  for (int off = E * S / 2; off >= E; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  T w[NU][NU], q[NU][NU], qi[NU][NU];
#pragma unroll
  for (int r = 0; r < NU; ++r)
#pragma unroll
    for (int c = 0; c < NU; ++c)
      w[r][c] = luu[r][c] + __shfl_sync(0xffffffffu, s, r * NU + c);
#pragma unroll
  for (int r = 0; r < NU; ++r)
#pragma unroll
    for (int c = 0; c < NU; ++c) q[r][c] = T(0.5) * (w[r][c] + w[c][r]);
  clamped_inverse<T, NU>(q, reg, qi);
  if (lane == 0) {  // constant indices keep the matrices in registers
#pragma unroll
    for (int r = 0; r < NU; ++r)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        QUU[r * NU + c] = q[r][c];
        QI[r * NU + c] = qi[r][c];
      }
  }
}

template <typename T, int NU, int KT, bool kCluster, bool kScratch>
__global__ void __launch_bounds__(kMaxBlockThreads)
    riccati_backward_block_kernel(const K1BlockArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = g.nz, nx = nz + NU, N = g.N, tid = threadIdx.x,
            nthr = blockDim.x;
  int rank = 0, c = 1;
  if constexpr (kCluster) {
    rank = int(cg::this_cluster().block_rank());
    c = int(cg::this_cluster().num_blocks());
  }
  const size_t b = blockIdx.x / c;
  const long ZZ = long(nz) * nz;
  const K1Layout l =
      k1_layout(nz, NU, KT, c, sizeof(T), kScratch, g.stage_l);
  const K1Range xr = k1_range(nz, KT, c, rank);
  const K1Tiles nt = k1_tiles(nz, NU, KT, xr);
  // Columns a CTA owns (CTA r from r per), and this CTA's first.
  const int per = ceil_div(ceil_div(nz + 1, KT), c) * KT, xo = xr.lo;
  const int ldx = l.ldx, ldv = l.ldv, ldw = l.ldw;
  // Shared memory unless the workspace is past it: the compiler then knows
  // each access's space.
  T* const base = kScratch ? g.scratch + b * l.total
                           : reinterpret_cast<T*>(smem_raw);
  int* const tblA = reinterpret_cast<int*>(
      smem_raw + (kScratch ? 0 : l.total * long(sizeof(T))));
  int* const tblB = tblA + nt.a;
  int* const tblC = tblB + nt.b;
  int* const flags = tblA + l.tiles;
  T* const Vx = base + l.vx;
  T* const P = base + l.p;
  T* const W = base + l.w;
  T* const QI = base + l.qi;
  T* const QUU = base + l.quu;
  T* const QU = base + l.qu;

  // The tile lists, (first row << 16) | first column.
  {
    const int rx = ceil_div(nx, KT), cz = ceil_div(nz, KT),
              glo = xr.lo / KT, ghi = ceil_div(xr.hi, KT),
              ghz = ghi < cz ? ghi : cz;
    for (int t = tid; t < nt.a; t += nthr) {  // A: rows by all nx columns
      const int rg = t / rx, cg_ = t - rg * rx;
      tblA[t] = ((xr.lo + rg * KT) << 16) | (cg_ * KT);
    }
    int o = 0;
    for (int rg = 0; rg < rx; ++rg) {
      const int from = k1_first_group(rg, glo, (rg + 1) * KT > nz);
      for (int j = tid; j < ghz - from; j += nthr)
        tblB[o + j] = ((rg * KT) << 16) | ((from + j) * KT);
      o += ghz > from ? ghz - from : 0;
    }
    o = 0;
    for (int rg = 0; rg < cz; ++rg) {
      const int from = k1_first_group(rg, glo, false);
      for (int j = tid; j < ghi - from; j += nthr)
        tblC[o + j] = ((rg * KT) << 16) | ((from + j) * KT);
      o += ghi > from ? ghi - from : 0;
    }
  }

  const T* F_z = g.F_z + b * N * ZZ;
  const T* F_u = g.F_u + b * N * nz * NU;
  const T* L_z = g.L_z + b * (N + 1) * nz;
  const T* L_u = g.L_u + b * N * NU;
  const T* L_zz = g.L_zz + b * (N + 1) * ZZ;
  const T* L_uz = g.L_uz + b * N * NU * nz;
  const T* L_uu = g.L_uu + b * N * NU * NU;
  T* k_out = g.k + b * N * NU;
  T* K_out = g.K + b * N * NU * nz;
  // This solve's reg: one load, before the recursion starts.
  const T reg = g.regs ? g.regs[b] : g.reg;

  // Stores the KT values v at p (aligned to KT elements) in every other
  // CTA of the cluster.
  const auto push = [&](T* p, const T (&v)[KT]) {
    if constexpr (kCluster) {
      cg::cluster_group cl = cg::this_cluster();
      for (int q = 0; q < c; ++q)
        if (q != rank) store_vec<KT>(cl.map_shared_rank(p, q), v);
    }
  };
  const auto push1 = [&](T* p, T v) {
    if constexpr (kCluster) {
      cg::cluster_group cl = cg::this_cluster();
      for (int q = 0; q < c; ++q)
        if (q != rank) *cl.map_shared_rank(p, q) = v;
    }
  };

  // A step's L terms: from its buffer in shared memory with stage_l (staged
  // a step ahead beside [F_z F_u]), else from device memory.
  struct LTerms {
    const T *zz, *uz, *z, *u, *uu;
  };
  const auto l_terms = [&](int i, int s) {
    if (g.stage_l) {
      const T* q = base + (s ? l.l1 : l.l0);
      return LTerms{q + l.lzz, q + l.luz, q + l.lz, q + l.lu, q + l.luu};
    }
    return LTerms{L_zz + i * ZZ, L_uz + size_t(i) * NU * nz,
                  L_z + size_t(i) * nz, L_u + size_t(i) * NU,
                  L_uu + size_t(i) * NU * NU};
  };
  // Copies step j's inputs: [F_z F_u] into its buffer s (padded), and with
  // stage_l the L terms into theirs, by every thread right after the
  // barrier that frees the buffers. (On an H100 a cp.async costs a warp
  // ~100 cycles of issue: left to the threads idle in stage B the copies
  // landed during stage C and slowed it, 0.43 against 0.41 ms at nz = 20,
  // 0.73 against 0.56 at nz = 27; left to a warp of their own they held
  // the first barrier, 0.47 and 0.87 ms.)
  const int fv = g.fv, per_row = nz / fv;
  const FcCursor zcur{tid / per_row, (tid % per_row) * fv},
      ucur{tid / NU, tid % NU};
  const auto stage_step = [&](int j, int s) {
    if (g.stage_l) {
      T* q = base + (s ? l.l1 : l.l0);
      stage_flat<kScratch>(q + l.lzz, L_zz + j * ZZ, nz * nz, g.lzv);
      stage_flat<kScratch>(q + l.luz, L_uz + size_t(j) * NU * nz, NU * nz,
                           g.luv);
      stage_flat<kScratch>(q + l.lz, L_z + size_t(j) * nz, nz, 1);
      stage_flat<kScratch>(q + l.lu, L_u + size_t(j) * NU, NU, 1);
      stage_flat<kScratch>(q + l.luu, L_uu + size_t(j) * NU * NU, NU * NU,
                           1);
    }
    stage_fc<kScratch>(base + (s ? l.fc1 : l.fc0), ldx, F_z + j * ZZ,
                       F_u + size_t(j) * nz * NU, nz, NU, fv, zcur, ucur);
  };

  // Stage A's tile: this CTA's rows of P = Vx^T Fc, plus [L_z L_u] in row
  // nz; row nz also gives W's column nz (Q_z) and q_nz = Q_u.
  const auto tile_a = [&](int code, const T* Fc, const LTerms& L) {
    const int r0 = code >> 16, c0 = code & 0xffff;
    T lrow[KT];
    if (r0 <= nz && nz < r0 + KT) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int cc = c0 + j < nx ? c0 + j : nx - 1;
        lrow[j] = cc < nz ? L.z[cc] : L.u[cc - nz];
      }
    }
    T acc[KT][KT];
    xty_tile<KT>(Vx + (r0 - xo), ldw, Fc + c0, ldx, nz, acc);
#pragma unroll
    for (int i2 = 0; i2 < KT; ++i2) {
      const int r = r0 + i2;
      if (r >= xr.hi) continue;
      if (r == nz) {
#pragma unroll
        for (int j = 0; j < KT; ++j) acc[i2][j] = lrow[j] + acc[i2][j];
      }
      if (c0 + KT <= nx) {  // the whole row segment, as one vector
        store_vec<KT>(P + r * ldx + c0, acc[i2]);
        push(P + r * ldx + c0, acc[i2]);
      } else {
#pragma unroll
        for (int j = 0; j < KT; ++j)
          if (c0 + j < nx) {
            P[r * ldx + c0 + j] = acc[i2][j];
            push1(P + r * ldx + c0 + j, acc[i2][j]);
          }
      }
      if (r == nz) {
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const int cc = c0 + j;
          if (cc >= nx) continue;
          if (cc < nz) {
            W[cc * ldw + nz - xo] = acc[i2][j];
          } else {
            QU[(cc - nz) * ldv + nz] = acc[i2][j];
            push1(QU + (cc - nz) * ldv + nz, acc[i2][j]);
          }
        }
      }
    }
  };
  // Stage B's tile: this CTA's columns of W = Lcc + Fc^T P (the tiles that
  // meet Q_zz's upper triangle) and of Q_uz, which goes to every CTA.
  const auto tile_b = [&](int code, const T* Fc, const LTerms& L) {
    const int r0 = code >> 16, c0 = code & 0xffff;
    T lb[KT][KT];  // read before the sum, to hide its latency
#pragma unroll
    for (int i2 = 0; i2 < KT; ++i2) {
      const int r = r0 + i2 < nx ? r0 + i2 : nx - 1;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int x = c0 + j < nz ? c0 + j : nz - 1;
        lb[i2][j] = r < nz ? L.zz[r * nz + x] : L.uz[(r - nz) * nz + x];
      }
    }
    T acc[KT][KT];
    xty_tile<KT>(Fc + r0, ldx, P + c0, ldx, nz, acc);
#pragma unroll
    for (int i2 = 0; i2 < KT; ++i2) {
      const int r = r0 + i2;
      if (r >= nx) continue;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int x = c0 + j;
        if (x >= nz || x >= xr.hi) continue;
        const T v = lb[i2][j] + acc[i2][j];
        if (r < nz) {
          W[r * ldw + x - xo] = v;
        } else {
          QU[(r - nz) * ldv + x] = v;
          push1(QU + (r - nz) * ldv + x, v);
        }
      }
    }
  };

  stage_step(N - 1, 0);
  {  // the terminal value function, in this CTA's columns
    const int w = xr.hi - xr.lo;
    for (int e = tid; e < nz * w; e += nthr) {
      const int a = e / w, x = xr.lo + (e - a * w);
      Vx[a * ldw + x - xo] =
          x < nz ? L_zz[N * ZZ + a * nz + x] : L_z[size_t(N) * nz + a];
    }
  }
  bool finite = true;
  for (int i = N - 1; i >= 0; --i) {
    const int s = (N - 1 - i) & 1;
    const T* const Fc = base + (s ? l.fc1 : l.fc0);
    if constexpr (!kScratch) pddp::cp_async_wait_all();
    // Fc of step i and V of step i+1 in place (in a cluster: the mirrored
    // entries from the other CTAs too; and every CTA running before the
    // first store into it).
    if constexpr (kCluster)
      cg::this_cluster().sync();
    else
      __syncthreads();
    // The other buffers were last read before the barrier.
    if (i > 0) stage_step(i - 1, s ^ 1);
    const LTerms L = l_terms(i, s);

    // Stage A.
    for (int t = tid; t < nt.a; t += nthr) tile_a(tblA[t], Fc, L);
    if constexpr (kCluster)
      cg::this_cluster().sync();  // every CTA's rows of P in every CTA
    else
      __syncthreads();

    // Stage B, and warp 0 the clamp.
    if (tid < 32) {
      clamp_warp<T, NU>(tid, Fc, P, ldx, nz, L.uu, reg, QI, QUU);
    } else {
      for (int t = tid - 32; t < nt.b; t += nthr - 32)
        tile_b(tblB[t], Fc, L);
    }
    if constexpr (kCluster)
      cg::this_cluster().sync();  // Q_uz in every CTA; W, Qi, M in this one
    else
      __syncthreads();

    // Stage C: this CTA's entries of the upper triangle of [V_zz V_z], each
    // mirrored into its column's CTA, and the gains of the first tile
    // row's columns.
    {
      for (int t = tid; t < nt.c; t += nthr) {
        const int code = tblC[t], a0 = code >> 16, x0 = code & 0xffff;
        // Column x of [Q_uz Q_u], its gains K_x = -Qi q_x and Q_uu K_x.
        const auto gains = [&](int x, T (&q)[NU], T (&Kc)[NU], T (&QK)[NU]) {
#pragma unroll
          for (int u = 0; u < NU; ++u) q[u] = QU[u * ldv + x];
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            T acc = T(0);
#pragma unroll
            for (int m = 0; m < NU; ++m) acc += QI[u * NU + m] * q[m];
            Kc[u] = -acc;
          }
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            T acc = T(0);
#pragma unroll
            for (int m = 0; m < NU; ++m) acc += QUU[u * NU + m] * Kc[m];
            QK[u] = acc;
          }
        };
        T qx[KT][NU], Kx[KT][NU], QKx[KT][NU];
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const int x = x0 + j < xr.hi ? x0 + j : xr.hi - 1;
          gains(x, qx[j], Kx[j], QKx[j]);
          if (a0 == 0 && x0 + j < xr.hi) {  // the gains of column x
#pragma unroll
            for (int u = 0; u < NU; ++u) {
              if (x < nz)
                K_out[(size_t(i) * NU + u) * nz + x] = Kx[j][u];
              else
                k_out[size_t(i) * NU + u] = Kx[j][u];
              finite = finite && isfinite(Kx[j][u]);
            }
          }
        }
#pragma unroll
        for (int i2 = 0; i2 < KT; ++i2) {
          const int a = a0 + i2;
          if (a >= nz) continue;
          T qa[NU], Ka[NU], QKa[NU];
          gains(a, qa, Ka, QKa);
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            const int x = x0 + j;
            if (x >= xr.hi || x < a) continue;
            T kqk1 = T(0), kqk2 = T(0), kq1 = T(0), kq2 = T(0), qk1 = T(0),
              qk2 = T(0);
#pragma unroll
            for (int u = 0; u < NU; ++u) {
              kqk1 += Ka[u] * QKx[j][u];
              kqk2 += Kx[j][u] * QKa[u];
              kq1 += Ka[u] * qx[j][u];
              kq2 += Kx[j][u] * qa[u];
              qk1 += qa[u] * Kx[j][u];
              qk2 += qx[j][u] * Ka[u];
            }
            const T base = W[a * ldw + x - xo];
            const T w1 = ((base + kqk1) + kq1) + qk1;
            const T w2 = ((base + kqk2) + kq2) + qk2;
            const T v = x == nz ? w1 : T(0.5) * (w1 + w2);
            Vx[a * ldw + x - xo] = v;
            if (x == a || x == nz) continue;  // V(x, a) into column a
            if constexpr (kCluster) {
              if (a < xr.lo) {  // a column of an earlier CTA
                const int owner = a / per;
                *cg::this_cluster().map_shared_rank(
                    Vx + x * ldw + (a - owner * per), owner) = v;
                continue;
              }
            }
            Vx[x * ldw + a - xo] = v;
          }
        }
      }
    }
  }
  finite = __syncthreads_and(finite) != 0;
  if constexpr (kCluster) {
    cg::cluster_group cl = cg::this_cluster();
    if (tid == 0) *cl.map_shared_rank(flags + rank, 0) = finite;
    cl.sync();
    if (rank == 0 && tid == 0) {
      bool all = true;
      for (int q = 0; q < c; ++q) all = all && flags[q] != 0;
      g.ok[b] = all;
    }
  } else if (tid == 0) {
    g.ok[b] = finite;
  }
}

// A launch's plan: CTAs a solve (the cluster), tile, threads a CTA, dynamic
// shared memory a CTA, scratch elements a solve (0: shared memory), and
// whether the L terms are staged in shared memory.
struct K1BlockPlan {
  int c, kt, threads;
  long smem, scratch;
  bool stage_l;
};

template <typename T, int NU, int KT, bool kCluster, bool kScratch>
cudaError_t prepare(long smem) {
  static long allowed = 48 * 1024;  // per instance
  return pddp::allow_smem(
      riccati_backward_block_kernel<T, NU, KT, kCluster, kScratch>, smem,
      allowed);
}

template <typename T, int NU, int KT, bool kCluster, bool kScratch>
int launch_instance(const K1BlockArgs<T>& g, int B, const K1BlockPlan& p,
                    cudaStream_t stream) {
  const cudaError_t err = prepare<T, NU, KT, kCluster, kScratch>(p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = riccati_backward_block_kernel<T, NU, KT, kCluster,
                                                    kScratch>;
  if constexpr (!kCluster) {
    kernel<<<B, p.threads, p.smem, stream>>>(g);
    return static_cast<int>(cudaGetLastError());
  } else {
    cudaLaunchConfig_t lc = {};
    lc.gridDim = dim3(static_cast<unsigned>(B) * p.c);
    lc.blockDim = dim3(static_cast<unsigned>(p.threads));
    lc.dynamicSmemBytes = static_cast<size_t>(p.smem);
    lc.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = static_cast<unsigned>(p.c);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    lc.attrs = &attr;
    lc.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&lc, kernel, g));
  }
}

// Clusters of plan p that run on the card at once.
template <typename T, int NU, int KT>
int active_clusters(const K1BlockPlan& p, int& n) {
  cudaError_t err = prepare<T, NU, KT, true, false>(p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(static_cast<unsigned>(p.c));
  lc.blockDim = dim3(static_cast<unsigned>(p.threads));
  lc.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(p.c);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  lc.attrs = &attr;
  lc.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(
      &n, riccati_backward_block_kernel<T, NU, KT, true, false>, &lc);
  return static_cast<int>(err);
}

// Multiply-adds of stages A and B of a step on one CTA (with the upper
// triangle). A cluster pays where a step's bulk passes kClusterMinMacs,
// and only with 4 or 8 CTAs: on an H100 (measured) a cluster
// of 2 was slower than one CTA at every width, and clusters were slower
// at nz = 42 and 44 (117 k and 146 k multiply-adds a step), faster at 72
// (609 k).
inline long k1_step_macs(int nz, int nu) {
  const long nx = nz + nu;
  return (long(nz + 1) * nx + long(nz) * (nz + 1) / 2 + long(nu) * nz) * nz;
}
constexpr long kClusterMinMacs = 300000;  // a step's bulk worth a cluster
constexpr int kClusterMinCols = 8;        // columns of Vx a CTA at least

// The plan at (nz, B), or with c_req > 0 the cluster asked for (tests). The
// library's: one CTA unless a step's bulk passes
// kClusterMinMacs, else the larger of c = 8 and 4 (each CTA keeping
// kClusterMinCols columns) whose B clusters all fit the card at once
// (cudaOccupancyMaxActiveClusters), else one CTA; the scratch buffer
// where one CTA's workspace passes shared memory.
template <typename T, int NU>
int block_plan(int nz, int B, int c_req, K1BlockPlan& p) {
  const long item = sizeof(T);
  if (nz < 1 || B < 1 || c_req < 0 || c_req > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  // The L ring where it fits shared memory (never on the scratch buffer).
  const auto make = [&](int c, int kt, bool scratch) {
    K1Layout l = k1_layout(nz, NU, kt, c, item, scratch, !scratch);
    const bool stage_l = !scratch && l.smem <= pddp::kMaxSmem;
    if (!stage_l) l = k1_layout(nz, NU, kt, c, item, scratch, false);
    return K1BlockPlan{c, kt, k1_block_threads(nz, NU, kt, c), l.smem,
                       scratch ? l.total : 0, stage_l};
  };
  const auto fits = [&](const K1BlockPlan& q) {
    return q.smem <= pddp::kMaxSmem;
  };
  const auto cluster_fits = [&](const K1BlockPlan& q, int need, bool& ok) {
    int n = 0, err;
    switch (q.kt) {
      case 2: err = active_clusters<T, NU, 2>(q, n); break;
      default: err = active_clusters<T, NU, 4>(q, n); break;
    }
    ok = err == 0 && n >= need;
    return err;
  };
  if (c_req > 1) {
    const int kt = k1_block_tile(nz, NU, c_req);
    if (ceil_div(nz + 1, kt) < c_req)
      return static_cast<int>(cudaErrorInvalidValue);
    p = make(c_req, kt, false);
    bool ok = false;
    const int err = fits(p) ? cluster_fits(p, 1, ok) : 0;
    if (err) return err;
    return ok ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
  }
  p = make(1, k1_block_tile(nz, NU, 1), false);
  if (!fits(p)) {  // the scratch buffer, 4 x 4 tiles
    p = make(1, 4, true);
    return fits(p) ? 0 : static_cast<int>(cudaErrorInvalidValue);
  }
  if (c_req == 1 || k1_step_macs(nz, NU) < kClusterMinMacs) return 0;
  for (int c = kMaxCluster; c >= 4; c /= 2) {
    if ((nz + 1) / c < kClusterMinCols) continue;
    const K1BlockPlan q = make(c, k1_block_tile(nz, NU, c), false);
    if (!fits(q)) continue;
    bool ok = false;
    const int err = cluster_fits(q, B, ok);
    if (err) return err;
    if (ok) {
      p = q;
      return 0;
    }
  }
  return 0;
}

// The last plan of each (type, nu), so that a repeated launch asks the
// runtime nothing.
struct PlanCache {
  bool ok;
  int device, nz, B, c_req;
  K1BlockPlan plan;
};

template <typename T, int NU>
int cached_plan(int nz, int B, int c_req, K1BlockPlan& p) {
  static PlanCache cache{};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cache.ok && cache.device == dev && cache.nz == nz && cache.B == B &&
      cache.c_req == c_req) {
    p = cache.plan;
    return 0;
  }
  const int err = block_plan<T, NU>(nz, B, c_req, p);
  if (err == 0) cache = PlanCache{true, dev, nz, B, c_req, p};
  return err;
}

template <typename T, int NU>
int launch_block_shape(K1BlockArgs<T> g, int B, int c_req,
                       cudaStream_t stream) {
  K1BlockPlan p;
  const int err = cached_plan<T, NU>(g.nz, B, c_req, p);
  if (err) return err;
  g.stage_l = p.stage_l;
  if (p.scratch > 0) {
    if (g.scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_instance<T, NU, 4, false, true>(g, B, p, stream);
  }
  g.scratch = nullptr;
  if (p.c > 1) {
    if (p.kt == 2) return launch_instance<T, NU, 2, true, false>(g, B, p, stream);
    return launch_instance<T, NU, 4, true, false>(g, B, p, stream);
  }
  switch (p.kt) {
    case 1: return launch_instance<T, NU, 1, false, false>(g, B, p, stream);
    case 2: return launch_instance<T, NU, 2, false, false>(g, B, p, stream);
  }
  return launch_instance<T, NU, 4, false, false>(g, B, p, stream);
}

template <typename T>
int launch_block(const T* F_z, const T* F_u, const T* L_z, const T* L_u,
                 const T* L_zz, const T* L_uz, const T* L_uu, double reg,
                 const T* regs, T* k, T* K, bool* ok, T* scratch, int B,
                 int N, int nz, int nu, int c_req, void* stream_ptr) {
  if (B < 1 || N < 1 || nz < 1) return static_cast<int>(cudaErrorInvalidValue);
  // Copies of 16 bytes where a step's rows (F_z) or slice (L_zz, L_uz) and
  // the tensor's alignment allow, else 8 or 4.
  const auto width = [](const T* p, long n) {
    int v = 16 / int(sizeof(T));
    while (v > 1 && (n % v != 0 ||
                     reinterpret_cast<size_t>(p) % (v * sizeof(T)) != 0))
      v /= 2;
    return v;
  };
  const K1BlockArgs<T> g{F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, k, K, ok,
                         scratch, regs, static_cast<T>(reg), N, nz,
                         width(F_z, nz),
                         width(L_zz, long(nz) * nz), width(L_uz, long(nu) * nz),
                         false};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (nu) {
    case 1: return launch_block_shape<T, 1>(g, B, c_req, stream);
    case 2: return launch_block_shape<T, 2>(g, B, c_req, stream);
    case 3: return launch_block_shape<T, 3>(g, B, c_req, stream);
    case 4: return launch_block_shape<T, 4>(g, B, c_req, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int report_plan(int nz, int nu, int B, int c_req, long* out) {
  K1BlockPlan p;
  int err;
  switch (nu) {
    case 1: err = cached_plan<T, 1>(nz, B, c_req, p); break;
    case 2: err = cached_plan<T, 2>(nz, B, c_req, p); break;
    case 3: err = cached_plan<T, 3>(nz, B, c_req, p); break;
    case 4: err = cached_plan<T, 4>(nz, B, c_req, p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  out[0] = p.c;
  out[1] = p.kt;
  out[2] = p.threads;
  out[3] = p.smem;
  out[4] = p.scratch;
  out[5] = p.stage_l;
  return 0;
}

}  // namespace

extern "C" {

// F_z (B, N, nz, nz), F_u (B, N, nz, nu), L_z (B, N+1, nz), L_u (B, N, nu),
// L_zz (B, N+1, nz, nz), L_uz (B, N, nu, nz), L_uu (B, N, nu, nu); regs
// (B) the reg of each solve, or null for reg in every solve; k
// (B, N, nu), K (B, N, nu, nz), ok (B) bool. The launch picks its warps a
// block and its chunk (pddp::plan); (nz, nu) without an instance returns
// cudaErrorInvalidValue.
#ifndef PDDP_F64_ONLY
int pddp_riccati_backward_f32(const float* F_z, const float* F_u,
                              const float* L_z, const float* L_u,
                              const float* L_zz, const float* L_uz,
                              const float* L_uu, double reg,
                              const float* regs, float* k,
                              float* K, bool* ok, int B, int N, int nz,
                              int nu, void* stream) {
  return launch<float>(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, reg, regs, k, K,
                       ok, B, N, nz, nu, stream);
}
#endif

#ifndef PDDP_F32_ONLY
int pddp_riccati_backward_f64(const double* F_z, const double* F_u,
                              const double* L_z, const double* L_u,
                              const double* L_zz, const double* L_uz,
                              const double* L_uu, double reg,
                              const double* regs, double* k,
                              double* K, bool* ok, int B, int N, int nz,
                              int nu, void* stream) {
  return launch<double>(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, reg, regs, k,
                        K, ok, B, N, nz, nu, stream);
}
#endif

// The block kernel, for any nz and nu <= 4: the same arguments, plus
// scratch, (B, scratch elements of the plan) of device memory where the
// workspace does not fit shared memory (else null), and the cluster (0: the
// library's plan; pddp_riccati_block_plan).
#ifndef PDDP_F64_ONLY
int pddp_riccati_backward_block_f32(const float* F_z, const float* F_u,
                                    const float* L_z, const float* L_u,
                                    const float* L_zz, const float* L_uz,
                                    const float* L_uu, double reg,
                              const float* regs, float* k,
                                    float* K, bool* ok, float* scratch, int B,
                                    int N, int nz, int nu, int cluster,
                                    void* stream) {
  return launch_block<float>(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, reg, regs,
                             k, K, ok, scratch, B, N, nz, nu, cluster,
                             stream);
}
#endif

#ifndef PDDP_F32_ONLY
int pddp_riccati_backward_block_f64(const double* F_z, const double* F_u,
                                    const double* L_z, const double* L_u,
                                    const double* L_zz, const double* L_uz,
                                    const double* L_uu, double reg,
                              const double* regs, double* k,
                                    double* K, bool* ok, double* scratch,
                                    int B, int N, int nz, int nu, int cluster,
                                    void* stream) {
  return launch_block<double>(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, reg,
                              regs, k, K, ok, scratch, B, N, nz, nu, cluster,
                              stream);
}
#endif

// The block kernel's plan for B solves at (nz, nu), elements of itemsize
// bytes, cluster as the launch takes it: out = {CTAs a solve,
// tile, threads a CTA, shared-memory bytes a CTA, scratch elements a solve
// (0: the workspace is in shared memory), 1 if the L terms are staged in
// shared memory}. Needs the device (the cluster's occupancy).
int pddp_riccati_block_plan(int nz, int nu, int itemsize, int B, int cluster,
                            long* out) {
#ifndef PDDP_F64_ONLY
  if (itemsize == 4) return report_plan<float>(nz, nu, B, cluster, out);
#endif
#ifndef PDDP_F32_ONLY
  if (itemsize == 8) return report_plan<double>(nz, nu, B, cluster, out);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
