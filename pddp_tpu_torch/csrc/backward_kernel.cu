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

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T clamp_floor(T e, T reg) {
  return (e < T(0) ? T(1e-12) : e) + reg;
}

// Q_uu_inv = E diag(1 / (max(e, 1e-12) + reg)) E^T for the symmetric
// NU x NU Q_uu: the closed form for NU = 1, else the cyclic Jacobi of
// utils/linalg.small_eigh (the same rotation sequence, guard and tau clip),
// unrolled into registers.
template <typename T, int NU>
__device__ __forceinline__ void clamped_inverse(const T (&quu)[NU][NU],
                                                T reg, T (&qinv)[NU][NU]) {
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
      clamped_inverse<T, NU>(quu, g.reg, qinv);
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
           const T* L_zz, const T* L_uz, const T* L_uu, double reg, T* k,
           T* K, bool* ok, int B, int N, int nz, int nu, void* stream_ptr) {
  if (B < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const K1Args<T> g{F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, k, K, ok,
                    static_cast<T>(reg), B, N, 0};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PDDP_K1_LAUNCH(NZ_, NU_) \
  if (nz == NZ_ && nu == NU_) return launch_shape<T, NZ_, NU_>(g, stream);
  PDDP_K1_SHAPES(PDDP_K1_LAUNCH)
#undef PDDP_K1_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The block kernel: one thread block per solve, for every (nz, nu <= 4)
// without a warp instance above, nz a run-time size.
//
// Same arithmetic as the warp kernel, in the same joint coordinates, spread
// over the block's warps with a block barrier after each stage:
//   A  P = [V_zz; V_z^T] [F_z F_u] + [0; L_z L_u]        ((nz+1) x nx)
//   B  W = [L_zz L_uz^T; L_uz L_uu] + [F_z F_u]^T P      (nx x nx), whose
//      symmetrized blocks are Q_zz and Q_uu and whose lower left is Q_uz
//   C1 each thread owning a gain column forms its column of [K k] and of
//      Q_uu [K k] from the clamped inverse of Q_uu, and stores the gain
//   C2 the upper triangle of [V_zz V_z] from those columns.
// A and B are the step's bulk, about (nz+1) nx nz + nx^2 nz multiply-adds
// (0.8 M at nz = 72): each thread takes a tile of KT x KT outputs, the
// smallest KT (1 to 4) whose tiles the block holds at once, so narrow
// shapes keep more warps in flight and wide ones read shared memory less
// often a multiply-add.
// The Jacobi of Q_uu (nu > 1) is the step's chain, ~13 k cycles in f32 on
// an H100: warp 0 forms Q_uu itself at the start of stage B and runs the
// Jacobi while the other warps form the rest of W, so the two overlap.
//
// Memory: V_zz, V_z, P, W and the gain columns live in shared memory, with
// [F_z F_u] staged one step ahead by cp.async into a second buffer; the
// L terms are read from device memory where they are added, once each, as
// the tile's first loads. Staging all of a step's inputs ahead does not
// fit at the widest bundled shape (rendezvous under the full covariance,
// nz = 72, nu = 4, in f64: two staged steps 181 KB beside a 133 KB
// workspace), and [F_z F_u] is the part read nz + 1 times a step, the L
// terms once. Past shared memory (the workspace and the two buffers above
// 227 KB: about nz = 98 in f64, 139 in f32) the same code runs on a
// device-memory scratch buffer the caller allocates, kept in L2, and
// copies [F_z F_u] with plain loads.

constexpr int kMaxBlockThreads = 512;  // 128 registers a thread at most

__host__ __device__ constexpr long round_elems(long n, long itemsize) {
  return (n * itemsize + 15) / 16 * 16 / itemsize;
}

// One solve's elements, each part rounded to 16 bytes: two [F_z F_u]
// buffers, then Vt = [V_zz; V_z^T], P, W, the gain columns G = [K k]
// (nu x (nz+1)), QG = Q_uu G, and Q_uu and its clamped inverse.
struct K1BlockLayout {
  long fc0, fc1, vt, p, w, g, qg, qu, qi, total;
};

__host__ __device__ inline K1BlockLayout k1_block_layout(int nz, int nu,
                                                        long itemsize) {
  const long nx = nz + nu;
  K1BlockLayout l;
  long o = 0;
  l.fc0 = o; o += round_elems(long(nz) * nx, itemsize);
  l.fc1 = o; o += round_elems(long(nz) * nx, itemsize);
  l.vt = o;  o += round_elems(long(nz + 1) * nz, itemsize);
  l.p = o;   o += round_elems(long(nz + 1) * nx, itemsize);
  l.w = o;   o += round_elems(nx * nx, itemsize);
  l.g = o;   o += round_elems(long(nu) * (nz + 1), itemsize);
  l.qg = o;  o += round_elems(long(nu) * (nz + 1), itemsize);
  l.qu = o;  o += round_elems(long(nu) * nu, itemsize);
  l.qi = o;  o += round_elems(long(nu) * nu, itemsize);
  l.total = o;
  return l;
}

// Threads of stage A or B (the larger) at kt x kt outputs a thread, plus
// warp 0 when it runs the Jacobi apart (nu > 1).
__host__ inline long k1_block_work(int nz, int nu, int kt) {
  const long nx = nz + nu, tr = (nz + 1 + kt - 1) / kt,
             tx = (nx + kt - 1) / kt;
  return (tr > tx ? tr : tx) * tx + (nu > 1 ? 32 : 0);
}

// A thread's tile is kt x kt outputs: the smallest kt (1 to 4) whose
// tiles a block can hold at once, so a stage is one pass over them with
// the most warps in flight; 4 where none fits (the widest shapes).
__host__ inline int k1_block_tile(int nz, int nu) {
  for (int kt = 1; kt < 4; ++kt)
    if (k1_block_work(nz, nu, kt) <= kMaxBlockThreads) return kt;
  return 4;
}

// Threads a block, in whole warps, at least two and at most
// kMaxBlockThreads.
__host__ inline int k1_block_threads(int nz, int nu) {
  long t = k1_block_work(nz, nu, k1_block_tile(nz, nu));
  t = (t + 31) / 32 * 32;
  return int(t < 64 ? 64 : (t > kMaxBlockThreads ? kMaxBlockThreads : t));
}

// Out(r, c) = add(r, c) + sum_{a < K} X[r xr + a xa] Y[a ldy + c] for
// r < R, c < C, stored by put(r, c, value), by threads t0.. of the block
// (nt of them). A thread takes KT rows (rg + i RG) by KT columns
// (cg + j CG): neighbouring threads take neighbouring columns, so Y's
// reads fall in distinct banks and X's are shared by the warp. add() is
// read before the sum, to hide its latency.
template <int KT, typename T, class Add, class Put>
__device__ __forceinline__ void tiled_product(int t0, int nt, int R, int C,
                                              int K, const T* X, int xr,
                                              int xa, const T* Y, int ldy,
                                              Add add, Put put) {
  const int RG = (R + KT - 1) / KT, CG = (C + KT - 1) / KT;
  for (int t = int(threadIdx.x) - t0; t < RG * CG; t += nt) {
    const int rg = t / CG, cg = t - rg * CG;
    int rows[KT], cols[KT];
    T acc[KT][KT], base[KT][KT];
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int r = rg + i * RG, c = cg + i * CG;
      rows[i] = r < R ? r : R - 1;  // read in bounds, stored masked
      cols[i] = c < C ? c : C - 1;
    }
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        acc[i][j] = T(0);
        base[i][j] = add(rows[i], cols[j]);
      }
#pragma unroll 4
    for (int a = 0; a < K; ++a) {
      T x[KT], y[KT];
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        x[i] = X[rows[i] * xr + a * xa];
        y[i] = Y[a * ldy + cols[i]];
      }
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int j = 0; j < KT; ++j) acc[i][j] += x[i] * y[j];
    }
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (rg + i * RG < R && cg + j * CG < C)
          put(rows[i], cols[j], base[i][j] + acc[i][j]);
  }
}

template <typename T>
struct K1BlockArgs {
  const T *F_z, *F_u, *L_z, *L_u, *L_zz, *L_uz, *L_uu;
  T *k, *K;
  bool* ok;
  T* scratch;  // null: the workspace is in shared memory
  T reg;
  int N, nz;
};

// [F_z F_u] of one step into dst (nz x nx), by cp.async into shared memory
// (one commit group) or by plain copies into the scratch buffer.
template <bool kScratch, typename T>
__device__ __forceinline__ void stage_fc(T* dst, const T* F_z, const T* F_u,
                                         int nz, int nu) {
  const int nx = nz + nu, step = blockDim.x;
  const int da = step / nx, dc = step - da * nx;
  int a = threadIdx.x / nx, c = threadIdx.x - a * nx;
  for (int e = threadIdx.x; e < nz * nx; e += step) {
    const T* src = c < nz ? F_z + a * nz + c : F_u + a * nu + (c - nz);
    if constexpr (kScratch)
      dst[e] = *src;
    else
      pddp::cp_async(dst + e, src);
    a += da;
    c += dc;
    if (c >= nx) {
      c -= nx;
      ++a;
    }
  }
  if constexpr (!kScratch) pddp::cp_async_commit();
}

template <typename T, int NU, int KT, bool kScratch>
__global__ void __launch_bounds__(kMaxBlockThreads)
    riccati_backward_block_kernel(const K1BlockArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = g.nz, nx = nz + NU, N = g.N, nz1 = nz + 1;
  const long ZZ = long(nz) * nz;
  const K1BlockLayout l = k1_block_layout(nz, NU, sizeof(T));
  const size_t b = blockIdx.x;
  // Shared memory unless the workspace is past it: the compiler then knows
  // each access's space.
  T* const base = kScratch ? g.scratch + b * l.total
                           : reinterpret_cast<T*>(smem_raw);
  T* const Vt = base + l.vt;
  T* const P = base + l.p;
  T* const W = base + l.w;
  T* const G = base + l.g;
  T* const QG = base + l.qg;
  T* const QU = base + l.qu;
  T* const QI = base + l.qi;
  // nu > 1: warp 0 forms Q_uu and runs the Jacobi during stage B.
  constexpr bool kSplit = NU > 1;
  const int b0 = kSplit ? 32 : 0, nb = int(blockDim.x) - b0;

  const T* F_z = g.F_z + b * N * ZZ;
  const T* F_u = g.F_u + b * N * nz * NU;
  const T* L_z = g.L_z + b * (N + 1) * nz;
  const T* L_u = g.L_u + b * N * NU;
  const T* L_zz = g.L_zz + b * (N + 1) * ZZ;
  const T* L_uz = g.L_uz + b * N * NU * nz;
  const T* L_uu = g.L_uu + b * N * NU * NU;
  T* k_out = g.k + b * N * NU;
  T* K_out = g.K + b * N * NU * nz;

  stage_fc<kScratch>(base + l.fc0, F_z + (N - 1) * ZZ,
                     F_u + (size_t)(N - 1) * nz * NU, nz, NU);
  for (long e = threadIdx.x; e < ZZ; e += blockDim.x)
    Vt[e] = L_zz[N * ZZ + e];
  for (int e = threadIdx.x; e < nz; e += blockDim.x)
    Vt[ZZ + e] = L_z[(size_t)N * nz + e];

  bool finite = true;
  for (int i = N - 1; i >= 0; --i) {
    T* const Fc = base + (((N - 1 - i) & 1) ? l.fc1 : l.fc0);
    if constexpr (!kScratch) pddp::cp_async_wait_all();
    __syncthreads();  // Fc of step i and the last step's V are in place
    if (i > 0)        // the other buffer was last read before the barrier
      stage_fc<kScratch>(base + (((N - 1 - i) & 1) ? l.fc0 : l.fc1),
                         F_z + (i - 1) * ZZ,
                         F_u + (size_t)(i - 1) * nz * NU, nz, NU);
    const T* Lz = L_z + (size_t)i * nz;
    const T* Lu = L_u + (size_t)i * NU;
    const T* Lzz = L_zz + i * ZZ;
    const T* Luz = L_uz + (size_t)i * NU * nz;
    const T* Luu = L_uu + (size_t)i * NU * NU;

    // Stage A: P = Vt Fc, plus [L_z L_u] in row nz.
    tiled_product<KT, T>(
        0, blockDim.x, nz1, nx, nz, Vt, nz, 1, Fc, nx,
        [&](int r, int c) {
          return r < nz ? T(0) : (c < nz ? Lz[c] : Lu[c - nz]);
        },
        [&](int r, int c, T v) { P[r * nx + c] = v; });
    __syncthreads();

    // Stage B: W = Lcc + Fc^T P over the whole joint square (threads b0..);
    // with kSplit warp 0 forms Q_uu (lane r NU + c its entry (r, c), in the
    // same order as W's), symmetrizes it and runs the clamped inverse.
    if (kSplit && threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane < NU * NU) {
        const int r = lane / NU, c = lane - r * NU;
        T acc = T(0);
        for (int a = 0; a < nz; ++a)
          acc += Fc[a * nx + nz + r] * P[a * nx + nz + c];
        QU[lane] = Luu[r * NU + c] + acc;
      }
      __syncwarp();
      T quu[NU][NU], qinv[NU][NU];
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int m = 0; m < NU; ++m)
          quu[u][m] = T(0.5) * (QU[u * NU + m] + QU[m * NU + u]);
      clamped_inverse<T, NU>(quu, g.reg, qinv);
      __syncwarp();
      if (lane == 0) {  // constant indices keep quu, qinv in registers
#pragma unroll
        for (int u = 0; u < NU; ++u)
#pragma unroll
          for (int m = 0; m < NU; ++m) {
            QU[u * NU + m] = quu[u][m];
            QI[u * NU + m] = qinv[u][m];
          }
      }
    } else {
      tiled_product<KT, T>(
          b0, nb, nx, nx, nz, Fc, 1, nx, P, nx,
          [&](int r, int c) {
            if (r < nz)
              return c < nz ? Lzz[r * nz + c] : Luz[(c - nz) * nz + r];
            return c < nz ? Luz[(r - nz) * nz + c]
                          : Luu[(r - nz) * NU + c - nz];
          },
          [&](int r, int c, T v) { W[r * nx + c] = v; });
    }
    __syncthreads();

    // Stage C1: the gain columns j of [K k], and Q_uu times them.
    if (threadIdx.x < nz1) {
      T quu[NU][NU], qinv[NU][NU];
      if constexpr (kSplit) {
#pragma unroll
        for (int u = 0; u < NU; ++u)
#pragma unroll
          for (int m = 0; m < NU; ++m) {
            quu[u][m] = QU[u * NU + m];
            qinv[u][m] = QI[u * NU + m];
          }
      } else {
        quu[0][0] = W[nz * nx + nz];
        clamped_inverse<T, NU>(quu, g.reg, qinv);
      }
      for (int j = threadIdx.x; j < nz1; j += blockDim.x) {
        T q[NU], gj[NU];
#pragma unroll
        for (int r = 0; r < NU; ++r)
          q[r] = j < nz ? W[(nz + r) * nx + j] : P[nz * nx + nz + r];
#pragma unroll
        for (int r = 0; r < NU; ++r) {
          T s = T(0);
#pragma unroll
          for (int m = 0; m < NU; ++m) s += qinv[r][m] * q[m];
          gj[r] = -s;
        }
#pragma unroll
        for (int r = 0; r < NU; ++r) {
          T s = T(0);
#pragma unroll
          for (int m = 0; m < NU; ++m) s += quu[r][m] * gj[m];
          G[r * nz1 + j] = gj[r];
          QG[r * nz1 + j] = s;
          if (j < nz)
            K_out[((size_t)i * NU + r) * nz + j] = gj[r];
          else
            k_out[(size_t)i * NU + r] = gj[r];
          finite = finite && isfinite(gj[r]);
        }
      }
    }
    __syncthreads();

    // Stage C2: the upper triangle of [V_zz V_z],
    // W(x, y) = Q_xy + K_x^T Q_uu K_y + K_x^T q_y + q_x^T K_y.
    for (int e = threadIdx.x; e < nz * nz1; e += blockDim.x) {
      const int a = e / nz1, c2 = e - a * nz1;
      if (c2 < a) continue;
      const bool vz = c2 == nz;  // the V_z column: gain k, no sym
      T kqk1 = T(0), kqk2 = T(0), kq1 = T(0), kq2 = T(0), qk1 = T(0),
        qk2 = T(0);
#pragma unroll
      for (int r = 0; r < NU; ++r) {
        const T Ka = G[r * nz1 + a], Kc = G[r * nz1 + c2];
        const T qa = W[(nz + r) * nx + a];
        const T qc = vz ? P[nz * nx + nz + r] : W[(nz + r) * nx + c2];
        kqk1 += Ka * QG[r * nz1 + c2];
        kqk2 += Kc * QG[r * nz1 + a];
        kq1 += Ka * qc;
        kq2 += Kc * qa;
        qk1 += qa * Kc;
        qk2 += qc * Ka;
      }
      const T x = vz ? P[nz * nx + a]
                     : T(0.5) * (W[a * nx + c2] + W[c2 * nx + a]);
      const T w1 = ((x + kqk1) + kq1) + qk1;
      const T w2 = ((x + kqk2) + kq2) + qk2;
      const T v = vz ? w1 : T(0.5) * (w1 + w2);
      if (vz) {
        Vt[ZZ + a] = v;
      } else {
        Vt[a * nz + c2] = v;
        Vt[c2 * nz + a] = v;
      }
    }
  }
  const int ok = __syncthreads_and(finite);
  if (threadIdx.x == 0) g.ok[b] = ok != 0;
}

template <typename T, int NU, int KT, bool kScratch>
int launch_block_kernel(const K1BlockArgs<T>& g, int B, long bytes,
                        cudaStream_t stream) {
  if constexpr (!kScratch) {
    static long allowed = 48 * 1024;  // per instance
    const cudaError_t err = pddp::allow_smem(
        riccati_backward_block_kernel<T, NU, KT, false>, bytes, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  riccati_backward_block_kernel<T, NU, KT, kScratch>
      <<<B, k1_block_threads(g.nz, NU), kScratch ? 0 : bytes, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NU>
int launch_block_shape(K1BlockArgs<T> g, int B, cudaStream_t stream) {
  const K1BlockLayout l = k1_block_layout(g.nz, NU, sizeof(T));
  const long bytes = l.total * long(sizeof(T));
  const int kt = k1_block_tile(g.nz, NU);
  if (bytes > pddp::kMaxSmem) {  // the scratch buffer; nz >= 98, kt = 4
    if (g.scratch == nullptr || kt != 4)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_block_kernel<T, NU, 4, true>(g, B, bytes, stream);
  }
  g.scratch = nullptr;
  switch (kt) {
    case 1: return launch_block_kernel<T, NU, 1, false>(g, B, bytes, stream);
    case 2: return launch_block_kernel<T, NU, 2, false>(g, B, bytes, stream);
    case 3: return launch_block_kernel<T, NU, 3, false>(g, B, bytes, stream);
  }
  return launch_block_kernel<T, NU, 4, false>(g, B, bytes, stream);
}

template <typename T>
int launch_block(const T* F_z, const T* F_u, const T* L_z, const T* L_u,
                 const T* L_zz, const T* L_uz, const T* L_uu, double reg,
                 T* k, T* K, bool* ok, T* scratch, int B, int N, int nz,
                 int nu, void* stream_ptr) {
  if (B < 1 || N < 1 || nz < 1) return static_cast<int>(cudaErrorInvalidValue);
  const K1BlockArgs<T> g{F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, k, K, ok,
                         scratch, static_cast<T>(reg), N, nz};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (nu) {
    case 1: return launch_block_shape<T, 1>(g, B, stream);
    case 2: return launch_block_shape<T, 2>(g, B, stream);
    case 3: return launch_block_shape<T, 3>(g, B, stream);
    case 4: return launch_block_shape<T, 4>(g, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// F_z (B, N, nz, nz), F_u (B, N, nz, nu), L_z (B, N+1, nz), L_u (B, N, nu),
// L_zz (B, N+1, nz, nz), L_uz (B, N, nu, nz), L_uu (B, N, nu, nu); k
// (B, N, nu), K (B, N, nu, nz), ok (B) bool. The launch picks its warps a
// block and its chunk (pddp::plan); (nz, nu) without an instance returns
// cudaErrorInvalidValue.
int pddp_riccati_backward_f32(const float* F_z, const float* F_u,
                              const float* L_z, const float* L_u,
                              const float* L_zz, const float* L_uz,
                              const float* L_uu, double reg, float* k,
                              float* K, bool* ok, int B, int N, int nz,
                              int nu, void* stream) {
  return launch<float>(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, reg, k, K, ok,
                       B, N, nz, nu, stream);
}

int pddp_riccati_backward_f64(const double* F_z, const double* F_u,
                              const double* L_z, const double* L_u,
                              const double* L_zz, const double* L_uz,
                              const double* L_uu, double reg, double* k,
                              double* K, bool* ok, int B, int N, int nz,
                              int nu, void* stream) {
  return launch<double>(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, reg, k, K, ok,
                        B, N, nz, nu, stream);
}

// The block kernel, for any nz and nu <= 4: the same arguments, plus
// scratch, (B, pddp_riccati_block_scratch_elems(...)) elements of device
// memory where the workspace does not fit shared memory (else null).
int pddp_riccati_backward_block_f32(const float* F_z, const float* F_u,
                                    const float* L_z, const float* L_u,
                                    const float* L_zz, const float* L_uz,
                                    const float* L_uu, double reg, float* k,
                                    float* K, bool* ok, float* scratch, int B,
                                    int N, int nz, int nu, void* stream) {
  return launch_block<float>(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, reg, k, K,
                             ok, scratch, B, N, nz, nu, stream);
}

int pddp_riccati_backward_block_f64(const double* F_z, const double* F_u,
                                    const double* L_z, const double* L_u,
                                    const double* L_zz, const double* L_uz,
                                    const double* L_uu, double reg, double* k,
                                    double* K, bool* ok, double* scratch,
                                    int B, int N, int nz, int nu,
                                    void* stream) {
  return launch_block<double>(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, reg, k,
                              K, ok, scratch, B, N, nz, nu, stream);
}

// The block kernel's plan at (nz, nu) for elements of itemsize bytes:
// threads a block, and the scratch elements a solve needs (0 when the
// workspace fits shared memory).
int pddp_riccati_block_threads(int nz, int nu) {
  return k1_block_threads(nz, nu);
}

long pddp_riccati_block_scratch_elems(int nz, int nu, int itemsize) {
  const K1BlockLayout l = k1_block_layout(nz, nu, itemsize);
  return l.total * itemsize <= pddp::kMaxSmem ? 0 : l.total;
}

}  // extern "C"
