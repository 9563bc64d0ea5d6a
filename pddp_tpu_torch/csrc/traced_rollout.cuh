// K2 stages (f) and (g): the iLQR line search of any stateless model and
// cost (f) or of a stateful model (g), the model's step and the cost
// traced from their own torch code.
//
// Replaces the Pallas kernel pddp_tpu/ops/fused_rollout.py:114
// (fused_control_law; its pallas_call is at :261) for every stateless
// model and cost that pddp_tpu's gate admits and that no hand-written
// stage (a)-(c) covers: a user's own model, any subclass of an example,
// SaturatingQRCost, AggregateCost, any user cost. Pallas traced the jnp
// code of the model and the cost into its kernel; here
// pddp_tpu_torch/ops/_trace.py traces their torch code (make_fx) and
// ops/_scalar.py prints it as straight-line scalar code, the
//   struct Traced { using T; nz, nu, n_static, n_dynamic, has_cost;
//                   step(p, w, z, u, i, zn);
//                   stage_cost(p, w, z, u, i); terminal_cost(p, w, z, N); }
// of a generated .cu that includes this header and ends with
// PDDP_TRACED_ENTRY(Traced). Only the model's and the cost's arithmetic is
// generated: the rollout loop, the staging, the feedback law, the clamp
// and the sum of the cost below are written by hand, in the order of
// controllers/ilqr.py:control_law (cost_in_scan):
//   du = alpha_a k_i + K_i (z - z_i),  u = clamp(u_i + du, u_min, u_max)
//   J += stage_cost(z, u, i)   (IGNORE_UNCERTAINTY; else no cost here)
//   z  = step(z, u, i)
// and at the end J += terminal_cost(z_N, N). Under the belief codecs the
// step's program holds the codec's decode and re-encode (the model's
// apply does them), and the kernel returns trajectories only.
//
// Stage (g), a stateful model (only under allow_stateful, as pddp_tpu's
// gate): the generated struct also has n_state and n_aux, and its step is
//   step(p, w, z, u, i, s, zn, sn, an)
// the model's step(z, u, i, state) traced with the rolling state's leaves
// s as inputs and the next state's sn and the aux's an as outputs. As the
// Pallas kernel threads the state through its fori_loop carry, each lane
// holds its candidate's state in registers for the whole horizon, from
// S0 (init_state(batch_shape=(B, A)), flattened), and writes each step's
// aux to AUX (B, N, A, n_aux). A struct without n_state (K2(f)) compiles
// as it did before stage (g).
//
// The leaves (the model's and the cost's tensor attributes) arrive in two
// buffers rebuilt from their live values at every call: p, the leaves read
// at fixed offsets, staged once a block in shared memory (in global memory
// where they pass kStaticSmemBytes); w, the leaves read by the step index
// (a per-step table such as a wind profile, N rows or more), read from
// global memory through the read-only path.
//
// What bounds it on an H100: at the main-path shapes (N=200, A=10) it
// reads and writes tens of KB, so the roofline says nanoseconds; its limit
// is the chain of N dependent steps on each candidate, N times the latency
// of one traced step (its longest dependent chain, which ops/_trace.py
// reports as k2f_chain_cycles).
//
// The design is K2(a)-(c)'s (csrc/fused_rollout.cu), which PERF.md shows
// right for such chains: one lane per candidate keeping its state in
// registers for the whole horizon, one warp per group of up to 32 of a
// solve's candidates, several warps a block; the nominal rows z_i, u_i,
// k_i, K_i staged in shared memory ahead of use by async_copy.cuh's ring of
// chunks; a chunk's states and actions gathered in shared memory and, when
// it ends, its stage costs taken by all 32 lanes (independent once the
// states are known; each candidate then adds its own in step order) and
// its rows stored to Z_out and U_out contiguously.

#pragma once

#include <cmath>

#ifdef __CUDACC__
#define PDDP_HD __host__ __device__ __forceinline__
#else
#define PDDP_HD inline
#endif

// The traced programs' math: full precision (no fast-math), IEEE division;
// the generated sources build with --fmad=false (ops/_build.py), so each
// operation rounds as torch's own kernel rounds it.
namespace pddp_tr {
template <typename T> PDDP_HD T inf_() { return T(INFINITY); }
template <typename T> PDDP_HD T nan_() { return T(NAN); }
#ifdef __CUDACC__
#define PDDP_TR_F(name, fn)                                      \
  PDDP_HD float name(float x) { return fn##f(x); }               \
  PDDP_HD double name(double x) { return fn(x); }
#else
#define PDDP_TR_F(name, fn)                                      \
  PDDP_HD float name(float x) { return std::fn(x); }             \
  PDDP_HD double name(double x) { return std::fn(x); }
#endif
PDDP_TR_F(sin_, sin)
PDDP_TR_F(cos_, cos)
PDDP_TR_F(exp_, exp)
PDDP_TR_F(log_, log)
PDDP_TR_F(sqrt_, sqrt)
PDDP_TR_F(tanh_, tanh)
PDDP_TR_F(expm1_, expm1)
PDDP_TR_F(log1p_, log1p)
#undef PDDP_TR_F
#ifdef __CUDACC__
PDDP_HD float atan2_(float y, float x) { return atan2f(y, x); }
PDDP_HD double atan2_(double y, double x) { return atan2(y, x); }
PDDP_HD float pow_(float x, float y) { return powf(x, y); }
PDDP_HD double pow_(double x, double y) { return pow(x, y); }
#else
PDDP_HD float atan2_(float y, float x) { return std::atan2(y, x); }
PDDP_HD double atan2_(double y, double x) { return std::atan2(y, x); }
PDDP_HD float pow_(float x, float y) { return std::pow(x, y); }
PDDP_HD double pow_(double x, double y) { return std::pow(x, y); }
#endif
// A product that no compiler contracts into an FMA, for traced code that
// builds with contraction on (K2(e)'s traced inner step).
PDDP_HD float mul_(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
PDDP_HD double mul_(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
template <typename T> PDDP_HD T abs_(T x) { return x < T(0) ? -x : x; }
template <typename T> PDDP_HD bool isnan_(T x) { return x != x; }
template <typename T> PDDP_HD bool isinf_(T x) {
  return x == inf_<T>() || x == -inf_<T>();
}
template <typename T> PDDP_HD bool isfinite_(T x) {
  return x == x && !isinf_(x);
}
// torch.maximum / torch.minimum: NaN if either operand is NaN.
template <typename T> PDDP_HD T maximum_(T a, T b) {
  return (a != a || b != b) ? nan_<T>() : (a < b ? b : a);
}
template <typename T> PDDP_HD T minimum_(T a, T b) {
  return (a != a || b != b) ? nan_<T>() : (b < a ? b : a);
}
}  // namespace pddp_tr

#ifdef __CUDACC__

#include <cuda_runtime.h>

#include <type_traits>

#include "async_copy.cuh"

namespace pddp_traced {

// Static leaves past this many bytes stay in global memory.
constexpr long kStaticSmemBytes = 64 * 1024;

template <typename T>
struct Args {
  const T *Z, *U, *k, *K, *alphas, *p, *w, *bounds;
  T *Z_out, *U_out, *J_out;
  int B, N, A, C;  // solves, steps, candidates, steps per chunk
  int G, W;        // warps per solve, candidates per warp (min(A, 32))
  const T* S0;     // stage (g): the state at step 0, (B, A, n_state)
  T* AUX;          // stage (g): each step's aux, (B, N, A, n_aux)
};

// The rolling state's and the aux's sizes of a struct: its n_state and
// n_aux (stage (g)), or none (stage (f)).
template <class TR, class = void>
struct StateOf {
  static constexpr int n_state = 0, n_aux = 0;
  static constexpr bool stateful = false;
};
template <class TR>
struct StateOf<TR, std::void_t<decltype(TR::n_state)>> {
  static constexpr int n_state = TR::n_state, n_aux = TR::n_aux;
  static constexpr bool stateful = true;
};

// Layout of one instance: the static leaves (block-wide, where they sit in
// shared memory) and, per warp of W candidates, the ring of nominal rows
// (z_i, u_i, k_i, K_i as four arrays of C steps), the chunk's states (W a
// step, and the W states before its first step), its actions (W a step)
// and its stage costs (W a step).
template <class TR>
struct Shape {
  static constexpr int nz = TR::nz, nu = TR::nu;
  static constexpr bool static_in_smem =
      TR::n_static * long(sizeof(typename TR::T)) <= kStaticSmemBytes;
  static constexpr long block_elems = static_in_smem ? TR::n_static : 0;
  static constexpr int n_nominal = nz + 2 * nu + nu * nz;
  __host__ __device__ static constexpr long warp_elems(int chunk, int W) {
    return long(pddp::kStages) * chunk * n_nominal +
           long(chunk) * W * (nz + nu + 1) + long(W) * nz;
  }
};

// Stores n rows of `len` elements from src (contiguous) to dst, row r at
// dst + r * ld, by all 32 lanes (fused_rollout.cu's store_rows).
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

template <class TR>
__global__ void __launch_bounds__(32 * pddp::kMaxSolvesPerBlock)
    traced_rollout_kernel(const Args<typename TR::T> g) {
  using T = typename TR::T;
  using S = Shape<TR>;
  constexpr int nz = S::nz, nu = S::nu;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // The static leaves, once per block: the only block barrier.
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const T* p = g.p;
  if constexpr (S::static_in_smem) {
    for (long e = threadIdx.x; e < TR::n_static; e += blockDim.x)
      smem[e] = g.p[e];
    __syncthreads();
    p = smem;
  }
  const T* const w = g.w;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long wid = long(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (wid >= long(g.B) * g.G) return;  // the ragged last block
  // This warp's candidates: a0 .. a0 + Aw - 1 of solve b.
  const int b = int(wid / g.G), a0 = int(wid % g.G) * 32;
  const int N = g.N, A = g.A, C = g.C, W = g.W;
  const int Aw = A - a0 < 32 ? A - a0 : 32;
  const long warp_elems =
      pddp::round16(S::warp_elems(C, W) * long(sizeof(T))) / long(sizeof(T));
  T* const ring = smem +
                  pddp::round16(S::block_elems * long(sizeof(T))) /
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
  // Stage (g): this candidate's rolling state, in registers throughout.
  using SO = StateOf<TR>;
  constexpr int ns = SO::n_state > 0 ? SO::n_state : 1;
  constexpr int na = SO::n_aux > 0 ? SO::n_aux : 1;
  T st[ns];
  T* aux_out = nullptr;
  if constexpr (SO::stateful) {
    const size_t cand = bb * A + a0 + (active ? lane : 0);
#pragma unroll
    for (int e = 0; e < SO::n_state; ++e)
      st[e] = g.S0[cand * SO::n_state + e];
    aux_out = g.AUX + (bb * N * A + a0 + lane) * size_t(SO::n_aux);
  }

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
        T zn[nz];
        if constexpr (SO::stateful) {
          T sn[ns], an[na];
          TR::step(p, w, z, u, lo + j, st, zn, sn, an);
#pragma unroll
          for (int e = 0; e < SO::n_state; ++e) st[e] = sn[e];
          T* row = aux_out + size_t(lo + j) * A * SO::n_aux;
#pragma unroll
          for (int e = 0; e < SO::n_aux; ++e) row[e] = an[e];
        } else {
          TR::step(p, w, z, u, lo + j, zn);
        }
#pragma unroll
        for (int e = 0; e < nz; ++e) {
          z[e] = zn[e];
          outZ[((j + 1) * Aw + lane) * nz + e] = zn[e];
        }
#pragma unroll
        for (int e = 0; e < nu; ++e) outU[(j * Aw + lane) * nu + e] = u[e];
      }
    }
    __syncwarp();
    if constexpr (TR::has_cost) {
      // The chunk's stage costs, off the chain: all 32 lanes take the
      // (step, candidate) pairs; then each candidate adds its own in step
      // order, as the plain version's loop does.
      for (int e = lane; e < n_steps * Aw; e += 32)
        costs[e] = TR::stage_cost(p, w, outZ + e * nz, outU + e * nu,
                                  lo + e / Aw);
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
  if constexpr (TR::has_cost) {
    if (active)
      g.J_out[bb * A + a0 + lane] = J + TR::terminal_cost(p, w, z, N);
  }
}

template <class TR>
int launch(const Args<typename TR::T>& args, cudaStream_t stream) {
  using T = typename TR::T;
  using S = Shape<TR>;
  Args<T> g = args;
  if (g.B < 1 || g.N < 1 || g.A < 1 || (TR::has_cost && !g.J_out) ||
      (StateOf<TR>::n_state > 0 && !g.S0) ||
      (StateOf<TR>::n_aux > 0 && !g.AUX))
    return static_cast<int>(cudaErrorInvalidValue);
  g.G = (g.A + 31) / 32;
  g.W = g.A < 32 ? g.A : 32;
  const long warps = long(g.B) * g.G;
  const pddp::Plan plan = pddp::plan<T>(
      warps, g.N, S::block_elems,
      [W = g.W](int chunk) { return S::warp_elems(chunk, W); });
  if (plan.bytes > pddp::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  static long allowed = 48 * 1024;
  const cudaError_t err =
      pddp::allow_smem(traced_rollout_kernel<TR>, plan.bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  g.C = plan.chunk;
  const long blocks = (warps + plan.warps - 1) / plan.warps;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  traced_rollout_kernel<TR>
      <<<unsigned(blocks), 32 * plan.warps, plan.bytes, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pddp_traced

// The library's entry, one per generated source: Z (B, N+1, nz), U and k
// (B, N, nu), K (B, N, nu, nz), alphas (A), p the static leaves, w the
// step-indexed leaves, bounds (2, nu) or null; Z_out (B, N+1, A, nz), U_out
// (B, N, A, nu), J_out (B, A) or null where the kernel carries no cost;
// stage (g): S0 (B, A, n_state) the state at step 0, AUX (B, N, A, n_aux)
// each step's aux (both null for stage (f)). Returns the CUDA error of the
// launch (0: launched).
#define PDDP_TRACED_ENTRY(TR)                                                \
  extern "C" int pddp_traced_rollout(                                        \
      const TR::T* Z, const TR::T* U, const TR::T* k, const TR::T* K,        \
      const TR::T* alphas, const TR::T* p, const TR::T* w,                   \
      const TR::T* bounds, TR::T* Z_out, TR::T* U_out, TR::T* J_out, int B,  \
      int N, int A, const TR::T* S0, TR::T* AUX, void* stream) {             \
    const pddp_traced::Args<TR::T> g{Z,     U,     k,     K, alphas, p, w,   \
                                     bounds, Z_out, U_out, J_out, B, N, A,   \
                                     0,     0,     0,     S0, AUX};          \
    return pddp_traced::launch<TR>(g, static_cast<cudaStream_t>(stream));    \
  }

#endif  // __CUDACC__
