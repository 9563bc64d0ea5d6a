// K2 stage (e): the iLQR line search of ParticleDynamicsModel
// (utils/particles.py) under every state codec: a closed-loop rollout of
// A step sizes alpha over N steps, each step pushing P particles through
// the inner model's dynamics and moment-matching them back into an
// encoded Gaussian. The model is
// stateful: each step's particle outputs are the next step's rolling
// state, and each step's noise is its aux.
//
// Replaces the stateful variant of the Pallas kernel
// pddp_tpu/ops/fused_rollout.py:114 (fused_control_law with
// allow_stateful on a particle model, pallas_call at :261).
//
// This header holds the kernel, a template over the inner model M:
//   M::n, M::nu, M::n_params and
//   M::step(p, w, X, u, i, out)   one particle's step X (n), u (nu) ->
//                                 out (n) at step i
// where p is the inner model's n_params parameters (staged once a block in
// shared memory where they fit in kPrmSmemBytes, else read from global
// memory) and w its leaves read by the step index (global memory). Its
// instances: fused_particle_rollout.cu, the four known-dynamics examples
// (examples.cuh, the Example adapter; w unused); and a generated source
// per (inner model, codec, dtype) whose struct TracedInner is the inner
// model's apply(X, u, i, (), IGNORE_UNCERTAINTY) traced from its torch
// code (pddp_tpu_torch/ops/_trace.py, printed by ops/_scalar.py with each
// product through pddp_tr::mul_, so that the traced step rounds as
// torch's while this kernel builds with contraction on), which ends with
// PDDP_PARTICLE_TRACED_ENTRY(TracedInner, codec).
//
// Per step i and candidate a:
//   u   = U_i + (alpha_a k_i + K_i (z - Z_i)), clamped to the bounds if
//         given (U_out stores this u)
//   mean, Uc = decode_mean(z), decode_covar_sqrt(z) under the codec
//   eps = solve eps Uc = prev - mean per particle; eps_table[i] for all
//         particles where i == 0, noise inference is off, or any element
//         of any particle's solve is not finite
//   X   = mean + eps Uc; out = the inner model's step of each particle
//         under IGNORE_UNCERTAINTY, after constrain(u) for a
//         constrain_model subclass of an example
//   z   = moment_match(out): the mean, and the ddof=1 covariance (FULL;
//         CHOL through safe_cholesky's default 5-rung ladder) or the
//         ddof=0 std (VAR stores its square, STD itself; IGNORE the mean)
//   prev = out, aux[i] = eps
// which is ParticleDynamicsModel.step in the same order of operations, but
// for the sums and the ladder's and noise solve's reciprocals (below).
//
// What bounds it on an H100. The dynamics are a few dozen flops a
// particle, so at phase 19's shapes (P=100, A=10, N=50) the work is a few
// MFLOP and the bytes are the AUX output (N A P n values, 1.6 MB at n=4
// in f64): microseconds. Each step is a latency chain instead: the feedback
// law (an nz-long dot product), the noise solve, the step, two rounds of
// sums over P (the mean, then the second moments), and the encode and
// decode (under the matrix codecs a Cholesky ladder of up to five rungs).
//
// The design. One thread block per (solve, candidate), one thread per
// particle, the block P rounded up to warps; each particle's state, noise
// and previous output in registers.
// - An instance per codec (a constant of the compiler: nz, the second
//   moments' entries and the belief work are sized and unrolled at
//   compile time) and per launch bound, 128, 256, 512 or 1024 threads, the
//   least that holds the block (registers a thread: up to 96 in float32
//   and 255 in float64 at 128 threads, so that B=64 solves of ten
//   candidates run as one wave in float32; 255, 128, 64 above). The
//   1024-thread instance sums the second moments entry by entry and reads
//   the noise rows where it uses them, which needs fewer registers. The
//   constrained flag, the bounds and noise inference stay values known at
//   run time: uniform branches.
// - The step inputs (Z_i, K_i, U_i, k_i) are staged in shared memory with
//   cp.async by the block's last warp, a ring of pddp::kStages chunks of
//   kChunk steps (async_copy.cuh), issued while warp 0 does the belief
//   work and waited for kStages - 2 chunks later; each particle's noise
//   row of the next step is loaded into registers a step ahead. No step
//   waits on device memory.
// - The sums over particles: in each warp a halving butterfly
//   (warp_scatter_sum: each lane keeps half of its entries and sends its
//   partner the other half, so the E entries take about E shuffles, not
//   5E), then over the warps in ascending order. Lane j of every warp sums
//   mean j and shuffles it to its warp, so every thread holds the same bits
//   of the mean without a barrier to publish it; the lanes of warp 0 sum
//   the second moments.
// - Warp 0, the belief warp, encodes (the ladder's five rungs side by side
//   in its lanes, each pivot through one reciprocal square root, which
//   also gives the noise solve its multipliers in place of divisions),
//   stores the Z row (a lane an entry), decodes the next step's factor and
//   computes the next step's feedback law (lanes over the nz entries, one
//   fixed shuffle tree an action) before the step's last barrier.
// - Barriers a step: the fallback's OR (only where the noise is solved),
//   the mean's partials, the second moments' partials (not under IGNORE),
//   the belief warp's results: two to four (the first design had six).
// Every order of sums is fixed (the same bits on every run), and other
// than the plain version's; the ladder's and the noise solve's products
// with reciprocals are a few ulp from the plain version's sqrt and
// divisions.

#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "belief_codec.cuh"
#include "examples.cuh"

namespace pddp_particle {

using pddp::kChol;
using pddp::kFull;
using pddp::kIgnore;
using pddp::kStd;
using pddp::kVar;

constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kMaxNu = 4;
constexpr int kMaxParams = 8 + 4 * kMaxNu;  // model, constrain's bounds,
                                            // the action bounds
constexpr int kMaxThreads = 1024;           // so P <= 1024
constexpr int kSmallBlock = 128;            // the instance for P <= 128
// An inner model's parameters past this many bytes stay in global memory.
constexpr int kPrmSmemBytes = 16 * 1024;

template <typename T>
struct Args {
  const T *Z, *U, *k, *K, *alphas, *params, *eps, *bounds;
  T *Z_out, *U_out, *AUX;
  int B, N, A, P;
  int codec, constrained, infer;
  const T* w;  // the inner model's leaves read by the step index, or null
};

// The compile-time sizes of a (model, codec) instance.
template <class M, int codec>
struct Shape {
  static constexpr int n = M::n, nu = M::nu;
  static constexpr int nz = pddp::encoded_size(codec, n);
  static constexpr bool matrix = codec == kFull || codec == kChol;
  // entries of the second moments: the covariance's upper triangle, the
  // variances, or none
  static constexpr int E = codec == kIgnore ? 0 : matrix ? n * (n + 1) / 2
                                                         : n;
  // a step's staged inputs: Z_i (nz), K_i (nu x nz), U_i (nu), k_i (nu)
  static constexpr int step = nz + nu * nz + 2 * nu;
  static constexpr int offK = nz, offU = nz + nu * nz, offk = offU + nu;
};

// Steps a chunk of the ring: 4, or 2 where the ring would pass 16 KB.
template <typename T, int step>
__host__ __device__ constexpr int chunk_steps() {
  return pddp::kStages * 4 * step * int(sizeof(T)) <= 16384 ? 4 : 2;
}

__host__ __device__ constexpr int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// Row r and column c (c >= r) of entry e of the row-major upper triangle
// of an n x n matrix, by compile-time selects (no loop that diverges).
template <int n>
__device__ __forceinline__ void tri_rc(int e, int& r, int& c) {
  r = 0;
  c = 0;
  int ent = 0;
#pragma unroll
  for (int rr = 0; rr < n; ++rr)
#pragma unroll
    for (int cc = rr; cc < n; ++cc, ++ent)
      if (ent == e) {
        r = rr;
        c = cc;
      }
}

// The sum over a warp's 32 lanes, in every lane (a butterfly: the same
// order in every lane and every call).
template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kAllLanes, s, o);
  return s;
}

// One level of warp_scatter_sum: the lane's E entries (a segment of the
// original list) become (E + 1) / 2, the half it keeps, each plus its
// partner's (lane ^ O) copy of it; base and valid follow the segment.
template <int E, int O, typename T>
__device__ __forceinline__ void scatter_level(T* v, int lane, int& base,
                                              int& valid) {
  if constexpr (O > 0) {
    constexpr int h = (E + 1) / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const T lo = v[k];
      const T hi = h + k < E ? v[h + k] : T(0);
      const T keep = up ? hi : lo;
      v[k] = keep + __shfl_xor_sync(kAllLanes, up ? lo : hi, O);
    }
    base += up ? h : 0;
    valid = up ? (valid > h ? valid - h : 0) : (valid < h ? valid : h);
    scatter_level<h, O / 2>(v, lane, base, valid);
  }
}

__host__ __device__ constexpr int scatter_size(int E, int levels) {
  return levels == 0 ? E : scatter_size((E + 1) / 2, levels - 1);
}

// Sums each of E values v[0..E) over the warp's 32 lanes and writes the
// sum of entry e to out[e], each entry by one lane: five levels that each
// halve the entries a lane holds (a lane keeps one half and sends its
// partner the other), about E shuffles in all where a butterfly an entry
// takes 5E. The order of the sums is fixed. v is overwritten.
template <int E, typename T>
__device__ __forceinline__ void warp_scatter_sum(T (&v)[E], int lane,
                                                 T* out) {
  int base = 0, valid = E;
  scatter_level<E, 16>(v, lane, base, valid);
  constexpr int R = scatter_size(E, 5);
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < valid) out[base + k] = v[k];
}

// A thread's share of the cp.async copies of steps [s0, s0 + kChunk) of
// one per-step array of W elements a step (contiguous at src, step after
// step) into ring slot dst, at offset off of each staged step.
template <int W, int step, typename T>
__device__ __forceinline__ void stage_part(T* dst, int off, const T* src,
                                           int steps, int tid, int threads) {
  for (int e = tid; e < steps * W; e += threads) {
    const int j = e / W, q = e - j * W;
    pddp::cp_async(dst + j * step + off + q, src + e);
  }
}

// Stages chunk c (steps [c kChunk, (c + 1) kChunk) of Z, K, U, k, as far
// as N) into its ring slot, spread over `threads` threads from tid, and
// commits the copies as one group (an empty one past N, so that every
// thread counts the same groups).
template <class S, int kChunk, typename T>
__device__ __forceinline__ void stage_chunk(T* ring, int c, const T* Z,
                                            const T* K, const T* U,
                                            const T* k, int N, int tid,
                                            int threads) {
  const int s0 = c * kChunk;
  const int steps = N - s0 < kChunk ? N - s0 : kChunk;
  if (steps > 0) {
    T* dst = ring + (c % pddp::kStages) * (kChunk * S::step);
    stage_part<S::nz, S::step>(dst, 0, Z + size_t(s0) * S::nz, steps, tid,
                               threads);
    stage_part<S::nu * S::nz, S::step>(dst, S::offK,
                                       K + size_t(s0) * S::nu * S::nz,
                                       steps, tid, threads);
    stage_part<S::nu, S::step>(dst, S::offU, U + size_t(s0) * S::nu, steps,
                               tid, threads);
    stage_part<S::nu, S::step>(dst, S::offk, k + size_t(s0) * S::nu, steps,
                               tid, threads);
  }
  pddp::cp_async_commit();
}

// Waits until at most kStages - 2 of the thread's copy groups are in
// flight: in the loop, the chunk of the next step's inputs has landed.
__device__ __forceinline__ void wait_for_chunk() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pddp::kStages - 2)
               : "memory");
}

// Stores a particle's row of n values, in 16- or 8-byte pieces where the
// row's size allows (its offset is a multiple of its size).
template <int n, typename T>
__device__ __forceinline__ void store_row(T* dst, const T (&v)[n]) {
  constexpr int bytes = n * int(sizeof(T));
  constexpr int piece = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8
                                                              : int(sizeof(T));
  constexpr int per = piece / int(sizeof(T));
  struct alignas(piece) Piece {
    T x[per];
  };
#pragma unroll
  for (int q = 0; q < n / per; ++q) {
    Piece p;
#pragma unroll
    for (int t = 0; t < per; ++t) p.x[t] = v[q * per + t];
    reinterpret_cast<Piece*>(dst)[q] = p;
  }
}

template <int n, typename T>
__device__ __forceinline__ void load_row(T (&v)[n], const T* src) {
#pragma unroll
  for (int j = 0; j < n; ++j) v[j] = __ldg(src + j);
}

// The upper Cholesky factor of the symmetric n x n Cs (shared memory)
// through safe_cholesky's default ladder, its five rungs side by side:
// lane q < 5 factors Cs + jitter_q I alone (Cholesky-Crout in registers,
// each entry's sum in the plain version's order; lanes past 4 repeat rung
// 4), and the first rung whose factor is finite (a warp vote) is taken,
// the value of walking the ladder; where every rung fails, lane 0 gives
// diag(sqrt(max(diag C, 1e-12))) (keeping a NaN). Each pivot s takes one
// reciprocal square root r = rsqrt(s): the diagonal is s r (0 where s is
// 0, NaN where s < 0 or NaN, as sqrt gives), the column below it s_ij r,
// in place of IEEE sqrt and division, whose slow-path branches sat on the
// chain (a few ulp apart from them). The winning lane writes U = L^T into
// Ucs (row-major, the entries above the diagonal; those below stay as
// they are), 1 / diag U into Urs (the noise solve multiplies by it) and,
// if tri_out, U's flat upper triangle into tri_out.
template <int n, typename T>
__device__ __forceinline__ void ladder_lanes(const T* Cs, int lane, T* Ucs,
                                             T* Urs, T* tri_out) {
  const int q = lane < 4 ? lane : 4;
  const T jitter = q == 0   ? T(1e-12)
                   : q == 1 ? T(1e-9)
                   : q == 2 ? T(1e-6)
                   : q == 3 ? T(1e-3)
                            : T(1e-1);
  T L[n * (n + 1) / 2];  // the lower triangle, row after row
  T R[n];                // the reciprocals of its diagonal
  bool ok = true;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T s = Cs[i * n + j] + (i == j ? jitter : T(0));
#pragma unroll
      for (int k = 0; k < j; ++k)
        s = s - L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
      T v;
      if (i == j) {
        R[i] = rsqrt(s);
        v = s > T(0) ? s * R[i] : s == T(0) ? T(0) : T(NAN);
      } else {
        v = s * R[j];
      }
      L[i * (i + 1) / 2 + j] = v;
      ok = ok && isfinite(v);
    }
  }
  const unsigned good = __ballot_sync(kAllLanes, ok) & 0x1fu;
  int win = __ffs(good) - 1;
  if (good == 0u) {  // every rung failed
    win = 0;
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < i; ++j) L[i * (i + 1) / 2 + j] = T(0);
      const T d = Cs[i * n + i];
      L[i * (i + 1) / 2 + i] = sqrt(d < T(1e-12) ? T(1e-12) : d);
      R[i] = T(1) / L[i * (i + 1) / 2 + i];
    }
  }
  if (lane == win) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) {
        const T v = L[i * (i + 1) / 2 + k];
        Ucs[k * n + i] = v;
        if (tri_out != nullptr) tri_out[pddp::tri(k, i, n)] = v;
      }
      Urs[i] = R[i];
    }
  }
}

// The belief warp's feedback law of step s from the encoded state zs and
// the step's staged inputs st: lanes over the nz entries, one fixed
// shuffle tree an action; lane m < nu stores u_m (clamped to the bounds)
// into U_out and the action the step applies into ucs.
template <class S, typename T>
__device__ __forceinline__ void feedback_law(const Args<T>& g, const T* zs,
                                             const T* st, const T* prm,
                                             T alpha, int lane, T* U_row,
                                             T* ucs, int n_params) {
  constexpr int nz = S::nz, nu = S::nu;
  constexpr int width = nz >= 32 ? 32 : pow2_at_least(nz);
  T acc[nu];
#pragma unroll
  for (int m = 0; m < nu; ++m) acc[m] = T(0);
#pragma unroll
  for (int t = 0; t < (nz + 31) / 32; ++t) {
    const int l = lane + 32 * t;
    if (l < nz) {
      const T dz = zs[l] - st[l];
#pragma unroll
      for (int m = 0; m < nu; ++m) acc[m] += dz * st[S::offK + m * nz + l];
    }
  }
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
#pragma unroll
    for (int m = 0; m < nu; ++m) acc[m] += __shfl_xor_sync(kAllLanes, acc[m], o);
  if (lane < nu) {
    T du = acc[0];
#pragma unroll
    for (int m = 1; m < nu; ++m)
      if (lane == m) du = acc[m];
    T u = st[S::offU + lane] + (alpha * st[S::offk + lane] + du);
    if (g.bounds != nullptr) {
      const T lo = prm[n_params + 2 * nu + lane];
      const T hi = prm[n_params + 3 * nu + lane];
      u = u < lo ? lo : u;  // a NaN stays, as in torch.clamp
      u = u > hi ? hi : u;
    }
    U_row[lane] = u;
    ucs[lane] = g.constrained ? pddp::constrain(u, prm[n_params + lane],
                                                prm[n_params + nu + lane])
                              : u;
  }
}

// Blocks an SM each instance keeps resident at least: the small one five
// in float32 (96 registers a thread; B=64 solves of ten candidates, 640
// blocks, then run as one wave on 132 SMs), two in float64 (255); the
// others one (255, 128 and 64 registers at 256, 512 and 1024 threads).
template <typename T, int kThreads>
__host__ __device__ constexpr int min_blocks() {
  return kThreads > kSmallBlock ? 1 : sizeof(T) == 4 ? 5 : 2;
}

template <typename T, class M, int codec, int kThreads>
__global__ void __launch_bounds__(kThreads, min_blocks<T, kThreads>())
    particle_rollout_kernel(const Args<T> g) {
  using S = Shape<M, codec>;
  constexpr int n = S::n, nu = S::nu, nz = S::nz, E = S::E;
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunk = chunk_steps<T, S::step>();
  constexpr bool kLean = kThreads == kMaxThreads;
  // prm: the inner model's parameters (where they fit), then
  // constrain_model's lower and upper bounds, then the action bounds.
  constexpr bool kPrmSmem = M::n_params * int(sizeof(T)) <= kPrmSmemBytes;
  constexpr int kOff = kPrmSmem ? M::n_params : 0;
  constexpr int kPrm = kOff + 4 * nu > kMaxParams ? kOff + 4 * nu
                                                  : kMaxParams;
  __shared__ T prm[kPrm];
  __shared__ T ring[pddp::kStages * kChunk * S::step];
  __shared__ T mpart[kWarps][n];
  __shared__ T spart[kWarps][E > 0 ? E : 1];
  __shared__ T zs[nz], Cs[n * n], Ucs[n * n], Urs[n], ucs[nu];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int stager = warps - 1;  // the warp that fills the ring
  const int N = g.N, A = g.A, P = g.P;
  const size_t b = blockIdx.x / A;
  const int a = static_cast<int>(blockIdx.x % A);
  const bool active = tid < P;
  const int n_prm = kOff + (g.constrained ? 2 * nu : 0);
  const T* const mp = kPrmSmem ? prm : g.params;  // the model's parameters
  const T* Z = g.Z + b * (N + 1) * nz;
  const T* U = g.U + b * N * nu;
  const T* k = g.k + b * N * nu;
  const T* K = g.K + b * N * nu * nz;
  T* Z_out = g.Z_out + b * (N + 1) * A * nz;
  T* U_out = g.U_out + b * N * A * nu;
  T* AUX = g.AUX + b * N * A * P * n;
  const T alpha = g.alphas[a];
  // the staged inputs of step s
  const auto staged = [&](int s) {
    return ring + ((s / kChunk) % pddp::kStages) * (kChunk * S::step) +
           (s % kChunk) * S::step;
  };

  for (int e = tid; e < n_prm; e += threads) prm[e] = g.params[e];
  if (g.bounds != nullptr)
    for (int e = tid; e < 2 * nu; e += threads)
      prm[kOff + 2 * nu + e] = g.bounds[e];
  for (int e = tid; e < n * n; e += threads)
    Ucs[e] = codec == kIgnore && e % (n + 1) == 0 ? T(pddp::kIgnoreStd)
                                                  : T(0);
  if (codec == kIgnore && tid < n) Urs[tid] = T(1) / T(pddp::kIgnoreStd);
  // The partial sums of warps past the block's stay 0, so that every sum
  // over the warps runs over all kWarps rows without a branch.
  for (int e = tid; e < kWarps * n; e += threads) (&mpart[0][0])[e] = T(0);
  for (int e = tid; e < kWarps * (E > 0 ? E : 1); e += threads)
    (&spart[0][0])[e] = T(0);
  const T inv_P = T(1) / T(P), inv_P1 = T(1) / T(P - 1);
  if (warp == stager) {
    for (int c = 0; c < pddp::kStages; ++c)
      stage_chunk<S, kChunk>(ring, c, Z, K, U, k, N, lane, 32);
    pddp::cp_async_wait_oldest();  // chunk 0
  }
  T eps_row[n];  // the drawn noise row of the coming step
#pragma unroll
  for (int j = 0; j < n; ++j) eps_row[j] = T(0);
  if (!kLean && active) load_row(eps_row, g.eps + size_t(tid) * n);
  __syncthreads();

  // The start: z = Z_0, its factor and the feedback law of step 0.
  T mean[n];  // the mean of the step's state, the same bits in every thread
#pragma unroll
  for (int j = 0; j < n; ++j) mean[j] = staged(0)[j];
  if (warp == 0) {
    const T* st = staged(0);
    for (int l = lane; l < nz; l += 32) {
      zs[l] = st[l];
      Z_out[size_t(a) * nz + l] = st[l];
    }
    __syncwarp();
    const T* o = zs + n;
    if constexpr (codec == kFull) {
      for (int e = lane; e < n * n; e += 32) {
        const int r = e / n, c = e - r * n;
        Cs[e] = T(0.5) * (o[r * n + c] + o[c * n + r]);
      }
      __syncwarp();
      ladder_lanes<n>(Cs, lane, Ucs, Urs, static_cast<T*>(nullptr));
    } else if constexpr (codec == kChol) {
      for (int e = lane; e < E; e += 32) {
        int r, c;
        tri_rc<n>(e, r, c);
        Ucs[r * n + c] = o[e];
        if (r == c) Urs[r] = T(1) / o[e];
      }
    } else if constexpr (codec == kVar || codec == kStd) {
      if (lane < n) {
        const T d = codec == kVar ? sqrt(o[lane] < T(0) ? T(0) : o[lane])
                                  : o[lane];
        Ucs[lane * (n + 1)] = d;
        Urs[lane] = T(1) / d;
      }
    }
    feedback_law<S>(g, zs, st, prm, alpha, lane, U_out + size_t(a) * nu,
                    ucs, kOff);
  }
  __syncthreads();

  T prev[n];  // this particle's previous output: its rolling state
#pragma unroll
  for (int j = 0; j < n; ++j) prev[j] = T(0);

  for (int i = 0; i < N; ++i) {
    // Step i+1's inputs start a chunk: the stager waits for it before the
    // barrier that precedes the belief work, and then refills the ring
    // slot of the chunk before it (read up to the last step's belief
    // work) with the chunk kStages - 1 ahead.
    const bool new_chunk = (i + 1) % kChunk == 0;

    // The step's noise: eps Uc = prev - mean solved by column sweep (as
    // utils.linalg.tria_solve_right, each division a product with the
    // reciprocal of Uc's diagonal), or the drawn rows.
    const bool solve = g.infer && i > 0;
    T e[n];
#pragma unroll
    for (int j = 0; j < n; ++j) e[j] = T(0);
    int bad = 0;
    if (solve && active) {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        T s = prev[j] - mean[j];
        if constexpr (S::matrix) {
#pragma unroll
          for (int q = 0; q < j; ++q) s = s - e[q] * Ucs[q * n + j];
        }
        e[j] = s * Urs[j];
        bad |= !isfinite(e[j]);
      }
    }
    if (solve) bad = __syncthreads_or(bad);
    if (!solve || bad) {
      if (kLean && active) load_row(eps_row, g.eps + (size_t(i) * P + tid) * n);
#pragma unroll
      for (int j = 0; j < n; ++j) e[j] = eps_row[j];
    }
    if (!kLean && active && i + 1 < N)
      load_row(eps_row, g.eps + (size_t(i + 1) * P + tid) * n);
    if (active) store_row<n>(AUX + ((size_t(i) * A + a) * P + tid) * n, e);
    {
      T X[n], u[nu];
#pragma unroll
      for (int j = 0; j < n; ++j) {
        T s = T(0);
        if constexpr (S::matrix) {
#pragma unroll
          for (int r = 0; r <= j; ++r) s += e[r] * Ucs[r * n + j];
        } else {
          s += e[j] * Ucs[j * n + j];
        }
        X[j] = mean[j] + s;
      }
#pragma unroll
      for (int m = 0; m < nu; ++m) u[m] = ucs[m];
      M::step(mp, g.w, X, u, i, prev);
    }

    // The moment match: the mean ...
    {
      T v[n];
#pragma unroll
      for (int j = 0; j < n; ++j) v[j] = active ? prev[j] : T(0);
      warp_scatter_sum<n>(v, lane, mpart[warp]);
    }
    if (E == 0 && new_chunk && warp == stager) wait_for_chunk();
    __syncthreads();
    T mine = T(0);  // lane j < n: mean j
    {
      const int j = lane < n ? lane : 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mine += mpart[w][j];
      mine *= inv_P;
    }
#pragma unroll
    for (int j = 0; j < n; ++j) mean[j] = __shfl_sync(kAllLanes, mine, j);
    // ... then the second moments about it: the upper triangle of the
    // covariance, or the variances.
    if constexpr (E > 0) {
      T d[n];
#pragma unroll
      for (int j = 0; j < n; ++j) d[j] = active ? prev[j] - mean[j] : T(0);
      if constexpr (kLean) {
        int ent = 0;
#pragma unroll
        for (int r = 0; r < n; ++r)
#pragma unroll
          for (int c = S::matrix ? r : 0; c < (S::matrix ? n : 1); ++c) {
            const T s = warp_sum(d[r] * d[S::matrix ? c : r]);
            if (lane == 0) spart[warp][ent] = s;
            ++ent;
          }
      } else {
        T v[E];
        int ent = 0;
#pragma unroll
        for (int r = 0; r < n; ++r)
#pragma unroll
          for (int c = S::matrix ? r : 0; c < (S::matrix ? n : 1); ++c)
            v[ent++] = d[r] * d[S::matrix ? c : r];
        warp_scatter_sum<E>(v, lane, spart[warp]);
      }
      if (new_chunk && warp == stager) wait_for_chunk();
      __syncthreads();
    }
    if (new_chunk && warp == stager)
      stage_chunk<S, kChunk>(ring, (i + 1) / kChunk + pddp::kStages - 1, Z,
                             K, U, k, N, lane, 32);

    // The belief warp: z of step i+1 (its row of Z_out), the factor and
    // the feedback law of step i+1.
    if (warp == 0) {
      T* o = zs + n;
      if (lane < n) zs[lane] = mine;
      if constexpr (S::matrix) {
#pragma unroll
        for (int t = 0; t < (E + 31) / 32; ++t) {
          const int e2 = lane + 32 * t;
          const int ec = e2 < E ? e2 : E - 1;
          T s = T(0);
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s += spart[w][ec];
          s *= inv_P1;
          int r, c;
          tri_rc<n>(ec, r, c);
          if (e2 < E) {
            Cs[r * n + c] = s;
            Cs[c * n + r] = s;
            if constexpr (codec == kFull) {
              o[r * n + c] = s;
              o[c * n + r] = s;
            }
          }
        }
        __syncwarp();
        // CHOL: the encode's factor is the next step's; FULL: the decode
        // of 0.5 (C + C^T) = C (exact), not needed after the last step.
        if (codec == kChol || i + 1 < N)
          ladder_lanes<n>(Cs, lane, Ucs, Urs, codec == kChol ? o : nullptr);
      } else if constexpr (codec == kVar || codec == kStd) {
        const int j = lane < n ? lane : 0;
        T s = T(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += spart[w][j];
        const T sd = sqrt(s * inv_P);
        const T v = codec == kVar ? sd * sd : sd;
        const T dv = codec == kVar ? sqrt(v < T(0) ? T(0) : v) : v;
        if (lane < n) {
          o[lane] = v;
          Ucs[lane * (n + 1)] = dv;
          Urs[lane] = T(1) / dv;
        }
      }
      __syncwarp();
      T* row = Z_out + (size_t(i + 1) * A + a) * nz;
      for (int l = lane; l < nz; l += 32) row[l] = zs[l];
      if (i + 1 < N)
        feedback_law<S>(g, zs, staged(i + 1), prm, alpha, lane,
                        U_out + (size_t(i + 1) * A + a) * nu, ucs,
                        kOff);
    }
    __syncthreads();
  }
}

template <typename T, class M, int codec>
int launch_codec(const Args<T>& g, cudaStream_t stream) {
  const int threads = (g.P + 31) / 32 * 32;
  const long blocks = long(g.B) * g.A;
  if (threads > kMaxThreads || blocks > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid{unsigned(blocks)}, block{unsigned(threads)};
  if (threads <= kSmallBlock)
    particle_rollout_kernel<T, M, codec, kSmallBlock>
        <<<grid, block, 0, stream>>>(g);
  else if (threads <= 256)
    particle_rollout_kernel<T, M, codec, 256><<<grid, block, 0, stream>>>(g);
  else if (threads <= 512)
    particle_rollout_kernel<T, M, codec, 512><<<grid, block, 0, stream>>>(g);
  else
    particle_rollout_kernel<T, M, codec, kMaxThreads>
        <<<grid, block, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class M>
int launch_model(const Args<T>& g, cudaStream_t stream) {
  switch (g.codec) {
    case kFull: return launch_codec<T, M, kFull>(g, stream);
    case kChol: return launch_codec<T, M, kChol>(g, stream);
    case kVar: return launch_codec<T, M, kVar>(g, stream);
    case kStd: return launch_codec<T, M, kStd>(g, stream);
    case kIgnore: return launch_codec<T, M, kIgnore>(g, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pddp_particle

// The inner model of a generated source: its struct TracedInner (T, nz =
// n, nu, n_static, n_dynamic, step(p, w, X, u, i, out)), its static leaves
// the parameters p.
namespace pddp_particle {
template <class TR>
struct TracedModel {
  using T = typename TR::T;
  static constexpr int n = TR::nz, nu = TR::nu;
  static constexpr int n_params = int(TR::n_static);
  __device__ __forceinline__ static void step(const T* p, const T* w,
                                              const T* x, const T* u, int i,
                                              T* xn) {
    TR::step(p, w, x, u, i, xn);
  }
};
}  // namespace pddp_particle

// The entry of a generated source, one (inner model, codec) and dtype: Z
// (B, N+1, nz), U and k (B, N, nu), K (B, N, nu, nz), alphas (A), p the
// inner model's static leaves, w its step-indexed leaves, eps (>= N, P, n)
// the episode noise, bounds (2, nu) or null; Z_out (B, N+1, A, nz), U_out
// (B, N, A, nu), AUX (B, N, A, P, n); infer: noise inference on. Returns
// the CUDA error of the launch (0: launched).
#define PDDP_PARTICLE_TRACED_ENTRY(TR, CODEC)                                \
  extern "C" int pddp_particle_traced_rollout(                               \
      const TR::T* Z, const TR::T* U, const TR::T* k, const TR::T* K,        \
      const TR::T* alphas, const TR::T* p, const TR::T* w,                   \
      const TR::T* eps, const TR::T* bounds, TR::T* Z_out, TR::T* U_out,     \
      TR::T* AUX, int B, int N, int A, int P, int infer, void* stream) {     \
    const pddp_particle::Args<TR::T> g{                                      \
        Z, U,     k,     K,   alphas, p, eps, bounds, Z_out, U_out,          \
        AUX, B, N, A, P, CODEC, 0, infer, w};                                \
    if (B < 1 || N < 1 || A < 1 || P < 2)                                    \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    return pddp_particle::launch_codec<TR::T, pddp_particle::TracedModel<TR>, \
                                       CODEC>(                               \
        g, static_cast<cudaStream_t>(stream));                               \
  }
