// K2 stage (d): the iLQR line search of the belief-state BNN dynamics
// (BNNDynamicsModel under any of the five state codecs): a closed-loop
// rollout of A step sizes alpha over N steps, each step pushing P particles
// through the MC-dropout MLP and moment-matching them back into an encoded
// Gaussian. Three fragment entries run its device functions alone (under
// the Cholesky codec).
//
// Replaces the stateful variant of the Pallas kernel
// pddp_tpu/ops/fused_rollout.py:114 (fused_control_law with the particle
// BNN, pallas_call at :261), and the Mosaic probes of its fragments:
//   F1 = scripts/probe_micro.py:57, probe_micro2.py:46, probe_micro3.py:47
//        (noise inference: triangular solve and the finite fallback);
//   F2 = scripts/probe_micro4.py:83, probe_micro5.py:90 (moment match,
//        Cholesky ladder, triangle flatten and unflatten);
//   F3 = scripts/probe_kernel_mlp_batch.py:86 (the candidate MLP);
//   P7 = scripts/probe_fused_stateful.py:66/:91 is the rollout entry itself.
//
// Per step i and candidate a:
//   u   = U_i + (alpha k_i + K_i (z - Z_i)), clamped to the bounds if given
//   mean, Uc = decode_mean(z), decode_covar_sqrt(z) (belief_codec.cuh)
//   eps = solve eps Uc = prev - mean per particle, or eps_in[i] for all
//         particles when any element is not finite or i == 0
//   X   = mean + eps Uc; x = normalize([augment(X), constrain(u)])
//   out = MLP(x) with each particle's dropout masks; output = X + delta(out)
//   z   = moment_match(output): [mean, triu(safe_cholesky(cov, ddof=1))]
//         under the Cholesky codec, the covariance itself under FULL, the
//         ddof=0 variances or std under VAR and STD, the mean under IGNORE
// which is BNNDynamicsModel.step (models/bnn/model.py) in the same order of
// operations, but for the sums of the moment match (below). The Cholesky
// codec runs bnn_rollout_kernel; the other four share
// bnn_rollout_codec_kernel, which takes the codec at run time (it sizes no
// register array).
//
// What bounds it on an H100. At the main-path shape (net 6-200-200-8,
// P=100, A=10, N=25, f32) the MLP is 2.1 GFLOP, 0.03 ms at the 67 TFLOP/s
// of plain f32 arithmetic, and it moves under 1 MB; each step is also a
// chain of dependent work (feedback law, noise solve, three K-long dot
// products, sums over P, a 4x4 Cholesky, a cluster barrier), about 0.03 ms
// over N=25. The first design (one block per candidate, 10 of 132 SMs; a
// thread per output column reloading 8 activations per multiply-add; W2
// re-read from L2 every step; ten block barriers around one-thread
// phases) took 2.6 ms. This one takes about 0.38 ms: per step about half
// is the 200 x 200 layer on 13 particles of a CTA (4 x 4 tiles read 2
// bytes of shared memory a multiply-add, and shared memory serves 4 bytes
// a thread a cycle; 8 x 4 tiles read less but leave one warp per SM
// quarter, and measured slower), the rest the chains above at a few
// hundred cycles each (PERF.md).
//
// What the design does about it:
//  * one thread-block cluster per (solve, candidate), the particles split
//    over its c CTAs (c <= 8, planned here from B*A, P and the widths with
//    cudaOccupancyMaxActiveClusters: the largest c whose clusters all fit
//    on the card at once, else the smallest that fits shared memory), so
//    B*A*c SMs share the MLP;
//  * the weights stay in shared memory for the whole horizon: each CTA
//    stages them once with bulk asynchronous copies (cp.async.bulk onto an
//    mbarrier), largest layer first, then its particles' dropout masks,
//    as far as 227 KB go; what does not fit is read through __ldg (all of
//    W2 at c = 1, and in f64);
//  * a register-tiled MLP: a thread owns 4 particles x 4 output columns,
//    so one shared-memory activation load serves 4 outputs and one weight
//    load 4 particles; a layer too narrow for that (the output layer) takes
//    1 x 1 tiles over more warps, each loading 8 steps of k ahead. Each
//    output keeps the first design's sum: one FMA chain over k ascending,
//    then the bias, the mask, the ReLU (keeping a NaN), so the MLP's
//    results are the same to the bit;
//  * one cluster exchange a step: each CTA stores its particles' next
//    states into every CTA's copy of the P x n array through distributed
//    shared memory, then cluster.sync(); every CTA then runs the moment
//    match on all P rows in the same order (so all hold the same z with no
//    second barrier), and the noise solve and the feedback law of the next
//    step on its own copy. The noise solve runs for all P particles in each
//    CTA, so its any-non-finite fallback sees every particle. The sums of
//    the moment match are spread over lanes: each mean entry over a warp
//    (lane l adds p = l, l + 32, ... in ascending order, then shuffles add
//    the lanes at distance 16, 8, 4, 2, 1), each covariance entry over half
//    a warp (lane l adds p = l, l + 16, ..., then distances 8, 4, 2, 1).
//    This order differs from the plain version's, within the f32
//    tolerances;
//  * the two shared-memory copies of the particle array alternate by step,
//    so a CTA that runs ahead never overwrites rows a peer still reads;
//  * nothing on a step's chain waits on device memory: the step's nominal
//    rows and noise rows are staged one step ahead by cp.async, the
//    normalization constants and the jitter ladder once, and the state
//    size is a constant of the compiler in the per-particle and Cholesky
//    code (an instance per n <= 8), so those vectors stay in registers.
// At full precision the tensor cores (3xTF32 or FP64 mma for the MLP) are
// not used: the port keeps full f32.
//
// The net's bfloat16 knobs (BayesianMLP's compute_dtype or matmul_dtype =
// torch.bfloat16, models/bnn/network.py) have instances of their own (the
// knob a template parameter; the no-knob code is as above, and the
// Cholesky codec's no-knob kernel is bnn_rollout_kernel unchanged):
//  * compute_dtype: the net input rounded to bfloat16; each layer
//    bf16(bf16(x W) + b), the product's sum at the model's precision and
//    rounded once, then the mask multiplied in bfloat16 and the ReLU; the
//    output taken back to the model's type;
//  * matmul_dtype: only the products' operands (the activations and W)
//    rounded to bfloat16, the sums, bias, mask and ReLU at full precision.
// Every rounding is to nearest even, a double through float first, as
// torch's .to(torch.bfloat16) does it. Everything outside the net (noise
// inference, moment match, codec, feedback law, bounds) is unchanged.
// float32 instances run every layer on the tensor cores: mma.sync
// m16n8k16 with bfloat16 operands and float32 sums (layer_mma), W staged
// as bfloat16, transposed and padded by the wrapper (85.6 KB for
// 6-200-200-8 where float32 takes 171 KB), the activations staged
// particle-major as bfloat16 A fragments. There is no bfloat16 product
// with float64 sums, so the float64 instances keep the FMA layer loop on
// operands rounded at the same points (the products exact, the sums
// float64); they exist to hold the card to the CPU.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "async_copy.cuh"
#include "belief_codec.cuh"

namespace cg = cooperative_groups;

extern __shared__ __align__(16) unsigned char g_smem[];

namespace {

using pddp::round16;

constexpr int kMaxN = 8;
constexpr int kMaxNu = 4;
constexpr int kMaxNz = kMaxN + kMaxN * (kMaxN + 1) / 2;
constexpr int kMaxNzFull = kMaxN + kMaxN * kMaxN;  // any codec's
constexpr int kMaxLayers = 6;
constexpr int kPad = 4;            // a CTA's particles padded to this
constexpr int kMinThreads = 128;   // threads a CTA, at least
constexpr int kMaxThreads = 512;   // and at most (128 registers a thread)
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kBulkPiece = 65536;  // bytes of one bulk copy at most
constexpr int kMaxJitter = 16;     // rungs of the Cholesky ladder
constexpr int kMaxF = 2 * kMaxN + kMaxNu;  // net input width in K2(d)

// Mirrored field by field by ops/fused_bnn_rollout.py:_CONFIG_FIELDS.
struct Config {
  int n, nu, P, n_layers;
  int width[kMaxLayers + 1];
  int w_off[kMaxLayers], b_off[kMaxLayers], m_off[kMaxLayers];
  int n_ang, n_nonang;
  int ang[kMaxN], nonang[kMaxN];
  int x_mean_off, x_std_off, dx_mean_off, dx_std_off, u_min_off, u_max_off;
  int jitter_off, n_jitter;
  int predicted_std, sample_input, infer_noise, constrained;
};

constexpr int kConfigInts = sizeof(Config) / sizeof(int);
// The ints a caller passes: Config's, then the rollout's codec
// (StateEncoding's value; F1-F3 ignore it), then the net's knob (kKnob*;
// K2(d) and F3 take it). The codec stays out of Config, and reaches the
// rollout kernel as its last argument, so that the Cholesky codec's kernel
// keeps the arguments it had as the only codec; the knob picks the
// instance on the host.
constexpr int kCallerInts = kConfigInts + 2;

// The net's precision: full, compute_dtype or matmul_dtype at bfloat16.
constexpr int kKnobNone = 0, kKnobCompute = 1, kKnobMatmul = 2;

// Row stride, in bfloat16 elements, of a bfloat16 MMA operand of K
// columns (activations particle-major, W transposed): K padded to the
// MMA's depth of 16, plus 8, so that stride / 2 words is 4 mod 8 and the 8
// rows a fragment load touches fall on distinct shared-memory banks.
// Mirrored by ops/fused_bnn_rollout.py:_bf16_stride.
__host__ __device__ constexpr int bf16_stride(int K) {
  return (K + 15) / 16 * 16 + 8;
}

// Elements of T that layer (K -> O)'s weights take in the parameter buffer
// and in shared memory: K x O, or, for the float32 MMA instances, W^T as
// bfloat16, round8(O) rows of bf16_stride(K).
template <typename T, int KNOB>
__host__ __device__ constexpr long w_elems(int K, int O) {
  return KNOB != kKnobNone && sizeof(T) == 4
             ? long((O + 7) / 8 * 8) * bf16_stride(K) / 2
             : long(K) * O;
}

// A launch's plan: the cluster, the particles and threads of a CTA, and
// the CTA's shared memory, in elements of the kernel's type from the start
// of the dynamic shared memory (-1: not in shared memory).
struct Plan {
  int c;        // CTAs a cluster
  int ppc;      // particles a CTA (the last CTA may have fewer)
  int npad;     // ppc rounded up to the tile
  int threads;  // threads a CTA
  int bytes;    // dynamic shared memory a CTA
  int tx_bytes; // bytes the bulk copies bring
  int act0, act1, full0, full1, eps, X, out;
  int stage, stage_len;  // two slots of a step's staged inputs
  int w_s[kMaxLayers], b_s[kMaxLayers], m_s[kMaxLayers];
};

// What pddp_bnn_plan_* reports: c, ppc, threads, bytes, masks resident,
// then each layer's weights resident (0/1).
constexpr int kPlanInts = 5 + kMaxLayers;

// ---------------------------------------------------------------------------
// Device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 16-byte aligned elements from shared memory (or any generic
// address), and four into shared memory.
__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void lds4(const double* p, double* v) {
  const double2 x = reinterpret_cast<const double2*>(p)[0];
  const double2 y = reinterpret_cast<const double2*>(p)[1];
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}

__device__ __forceinline__ void sts4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void sts4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Four aligned elements from device memory through the read-only cache.
__device__ __forceinline__ void ldg4(const float* p, float* v) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void ldg4(const double* p, double* v) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  const double2 y = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}

template <bool SMEM, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (SMEM) return *p;
  else return __ldg(p);
}

template <typename T>
__device__ __forceinline__ T half_warp_sum(T s) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// x rounded to bfloat16 (to nearest even) and back; a double through
// float first, as torch's .to(torch.bfloat16) rounds it.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ double bf16r(double x) {
  return static_cast<double>(bf16r(static_cast<float>(x)));
}

// lo and hi rounded to bfloat16 in one 32-bit word, lo in the low half
// (the element of the lower index in an MMA fragment).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <bool SMEM>
__device__ __forceinline__ unsigned ldw(const unsigned* p) {
  if constexpr (SMEM) return *p;
  else return __ldg(p);
}

// d += A B on the tensor cores: A 16 x 16 (row-major fragments a0-a3),
// B 16 x 8 (column-major fragments b0, b1), bfloat16; d 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The weights' bulk copies: thread 0 arms the barrier with the bytes to
// come and issues the copies; every thread waits for them in wait_weights.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar,
                                              unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

template <typename T>
__device__ void copy_part(T* dst, const T* src, long elems,
                          unsigned long long* bar) {
  const long bytes = round16(elems * long(sizeof(T)));
  for (long o = 0; o < bytes; o += kBulkPiece) {
    const long nb = bytes - o < kBulkPiece ? bytes - o : kBulkPiece;
    bulk_copy(reinterpret_cast<unsigned char*>(dst) + o,
              reinterpret_cast<const unsigned char*>(src) + o,
              static_cast<unsigned>(nb), bar);
  }
}

// Stages the plan's resident weights and biases (bulk copies) and the
// masks of the CTA's particles [p0, p0 + pc) (plain loads), and returns
// each hidden layer's mask rows of those particles (row q = particle
// p0 + q), or nullptr where the layer has none. Ends in __syncthreads.
template <typename T, int KNOB = kKnobNone>
__device__ void stage_net(const Config& cfg, const Plan& pl,
                          const T* __restrict__ params, int p0, int pc,
                          unsigned long long* bar, const T** mask) {
  T* sm = reinterpret_cast<T*>(g_smem);
  if (threadIdx.x == 0 && pl.tx_bytes > 0) {
    mbar_init(bar);
    mbar_expect(bar, static_cast<unsigned>(pl.tx_bytes));
    for (int l = 0; l < cfg.n_layers; ++l) {
      if (pl.w_s[l] < 0) continue;
      const int K = cfg.width[l], O = cfg.width[l + 1];
      copy_part(sm + pl.w_s[l], params + cfg.w_off[l], w_elems<T, KNOB>(K, O),
                bar);
      copy_part(sm + pl.b_s[l], params + cfg.b_off[l], long(O), bar);
    }
  }
  for (int l = 0; l + 1 < cfg.n_layers; ++l) {
    const int O = cfg.width[l + 1];
    mask[l] = nullptr;
    if (cfg.m_off[l] < 0) continue;
    const T* src = params + cfg.m_off[l] + long(p0) * O;
    if (pl.m_s[l] < 0) {
      mask[l] = src;
      continue;
    }
    T* dst = sm + pl.m_s[l];
    for (int e = threadIdx.x; e < pc * O; e += blockDim.x) dst[e] = src[e];
    mask[l] = dst;
  }
  __syncthreads();
}

__device__ __forceinline__ void wait_weights(const Plan& pl,
                                             unsigned long long* bar) {
  if (pl.tx_bytes > 0)
    while (!mbar_try_wait(bar, 0)) {
    }
}

// ---------------------------------------------------------------------------
// The step's device functions
// ---------------------------------------------------------------------------

// The state size n as a constant of the compiler: the per-particle and
// per-belief work (noise solve, particles, Cholesky ladder) then keeps its
// n-vectors in registers. f is called with Int<n>.
template <int V>
struct Int {
  static constexpr int value = V;
};

template <typename F>
__device__ __forceinline__ void with_n(int n, F&& f) {
  switch (n) {
    case 1: f(Int<1>{}); break;
    case 2: f(Int<2>{}); break;
    case 3: f(Int<3>{}); break;
    case 4: f(Int<4>{}); break;
    case 5: f(Int<5>{}); break;
    case 6: f(Int<6>{}); break;
    case 7: f(Int<7>{}); break;
    default: f(Int<8>{}); break;
  }
}

// mean (n) and upper factor Uc (n x n) of an encoded state z; one thread.
template <int NN, typename T>
__device__ __forceinline__ void decode(const T* z, T* mean, T* Uc) {
  pddp::triu_unflatten(z + NN, NN, Uc);
#pragma unroll
  for (int j = 0; j < NN; ++j) mean[j] = z[j];
}

// decode under codec (encoding.decode_mean and decode_covar_sqrt).
template <int NN, typename T>
__device__ __forceinline__ void decode_codec(const T* z, int codec,
                                             T* mean, T* Uc) {
  pddp::decode_covar_sqrt<NN>(z, codec, Uc);
#pragma unroll
  for (int j = 0; j < NN; ++j) mean[j] = z[j];
}

// F1: eps with eps Uc = prev - mean for every particle p < P, the rows of
// p in [p0, p0 + pc) stored in eps (row p - p0). Returns whether any
// element of any particle is not finite, for every thread of the block
// (ends in a block barrier).
template <typename T>
__device__ int solve_eps(const T* Uc, const T* mean, const T* prev, int P,
                         int n, int p0, int pc, T* eps) {
  int bad = 0;
  with_n(n, [&](auto nn) {
    constexpr int NN = decltype(nn)::value;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      T x[NN];
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        T s = prev[p * NN + j] - mean[j];
#pragma unroll
        for (int k = 0; k < j; ++k) s = s - x[k] * Uc[k * NN + j];
        x[j] = s / Uc[j * NN + j];
        bad |= !isfinite(x[j]);
      }
      const int q = p - p0;
      if (q >= 0 && q < pc)
#pragma unroll
        for (int j = 0; j < NN; ++j) eps[q * NN + j] = x[j];
    }
  });
  return __syncthreads_or(bad);
}

// The CTA's particles of the step: the noise e (zero without input
// sampling; the drawn rows e0 when `drawn`, else the solved rows eps),
// X = mean + e Uc, and e into aux; rows q < pc.
template <typename T>
__device__ void particles(int n, bool sample, bool drawn, const T* e0,
                          const T* eps, const T* mean, const T* Uc, int pc,
                          T* X, T* aux) {
  with_n(n, [&](auto nn) {
    constexpr int NN = decltype(nn)::value;
    for (int q = threadIdx.x; q < pc; q += blockDim.x) {
      T e[NN];
#pragma unroll
      for (int j = 0; j < NN; ++j)
        e[j] = !sample ? T(0) : drawn ? e0[q * NN + j] : eps[q * NN + j];
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        if (sample) {
          T s = T(0);
#pragma unroll
          for (int r = 0; r < NN; ++r) s += e[r] * Uc[r * NN + j];
          X[q * NN + j] = mean[j] + s;
        } else {
          X[q * NN + j] = mean[j];
        }
        aux[q * NN + j] = e[j];
      }
    }
  });
}

// F2: output particles (P x n) -> z = [mean, triu(U)], U the upper
// Cholesky factor of the ddof=1 covariance through the jitter ladder (the
// first rung whose factor is finite; else the square root of the diagonal
// clamped at 1e-12), with its decoded mean and Uc. The sums take a warp
// per entry (the order in the note at the top). M and C are scratch of n
// and n x n; when Zrow is given, thread 0 also stores z there. Ends in a
// block barrier.
template <typename T>
__device__ void moment_match(const T* out, int P, int n, const T* jitter,
                             int n_jitter, T* M, T* C, T* z, T* mean, T* Uc,
                             T* Zrow) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  for (int j = warp; j < n; j += warps) {
    T s = T(0);
#pragma unroll 4
    for (int p = lane; p < P; p += 32) s += out[p * n + j];
    s = warp_sum(s);
    if (lane == 0) M[j] = s / T(P);
  }
  __syncthreads();
  const int half = threadIdx.x / 16, hl = threadIdx.x % 16;
  const int entries = n * (n + 1) / 2;
  for (int e0 = 0; e0 < entries; e0 += 2 * warps) {
    const int e = e0 + half;
    int r = 0, c = 0;
    T s = T(0);
    if (e < entries) {
      int rem = e;
      while (rem >= n - r) rem -= n - r++;
      c = r + rem;
#pragma unroll 4
      for (int p = hl; p < P; p += 16)
        s += (out[p * n + r] - M[r]) * (out[p * n + c] - M[c]);
    }
    s = half_warp_sum(s);
    if (e < entries && hl == 0) {
      s = s / T(P - 1);
      C[r * n + c] = s;
      C[c * n + r] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    with_n(n, [&](auto nn) {
      constexpr int NN = decltype(nn)::value;
      T Cr[NN * NN], L[NN * NN];
#pragma unroll
      for (int e = 0; e < NN * NN; ++e) Cr[e] = C[e];
      pddp::safe_cholesky_lower<NN>(Cr, jitter, n_jitter, L);
      T zr[NN + NN * (NN + 1) / 2];
#pragma unroll
      for (int j = 0; j < NN; ++j) zr[j] = M[j];
      pddp::triu_flatten_lower_t(L, NN, zr + NN);
#pragma unroll
      for (int e = 0; e < NN + NN * (NN + 1) / 2; ++e) {
        z[e] = zr[e];
        if (Zrow != nullptr) Zrow[e] = zr[e];
      }
      decode<NN>(zr, mean, Uc);
    });
  }
  __syncthreads();
}

// moment_match under codec (utils/particles.moment_match): the mean and,
// for the matrix codecs, the ddof=1 covariance, for the diagonal codecs
// the ddof=0 variances, encoded by pddp::encode_moments; the sums in
// moment_match's order.
template <typename T>
__device__ void moment_match_codec(const T* out, int P, int n, int codec,
                                   const T* jitter, int n_jitter, T* M,
                                   T* C, T* z, T* mean, T* Uc, T* Zrow) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  for (int j = warp; j < n; j += warps) {
    T s = T(0);
#pragma unroll 4
    for (int p = lane; p < P; p += 32) s += out[p * n + j];
    s = warp_sum(s);
    if (lane == 0) M[j] = s / T(P);
  }
  __syncthreads();
  const int half = threadIdx.x / 16, hl = threadIdx.x % 16;
  const bool matrix = codec == pddp::kFull || codec == pddp::kChol;
  const int entries = codec == pddp::kIgnore ? 0
                      : matrix               ? n * (n + 1) / 2
                                             : n;
  for (int e0 = 0; e0 < entries; e0 += 2 * warps) {
    const int e = e0 + half;
    int r = 0, c = 0;
    T s = T(0);
    if (e < entries) {
      if (matrix) {
        int rem = e;
        while (rem >= n - r) rem -= n - r++;
        c = r + rem;
      } else {
        r = c = e;
      }
#pragma unroll 4
      for (int p = hl; p < P; p += 16)
        s += (out[p * n + r] - M[r]) * (out[p * n + c] - M[c]);
    }
    s = half_warp_sum(s);
    if (e < entries && hl == 0) {
      if (matrix) {
        s = s / T(P - 1);
        C[r * n + c] = s;
        C[c * n + r] = s;
      } else {
        C[r] = s / T(P);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    with_n(n, [&](auto nn) {
      constexpr int NN = decltype(nn)::value;
      const int nz = pddp::encoded_size(codec, NN);
      pddp::encode_moments<NN>(M, C, codec, jitter, n_jitter, z);
      if (Zrow != nullptr)
        for (int e = 0; e < nz; ++e) Zrow[e] = z[e];
      decode_codec<NN>(z, codec, mean, Uc);
    });
  }
  __syncthreads();
}

// One linear layer over the CTA's particles: in holds K features
// feature-major (in[k * ldp + q], ldp = npad); a thread takes a tile of TP
// particles x TO outputs (4 x 4, or 1 x 1 for a layer too narrow to give
// half the threads a 4 x 4 tile). Hidden layers write (x W + b) * mask, then
// ReLU, feature-major into nxt; the last layer writes x W + b as rows
// rows[q * O + o] of the CTA's pc particles. VEC: O is a multiple of 4,
// so a weight row's 4 columns, the bias and a mask row load as one vector.
// KNOB (float64 under a bfloat16 knob): in, W and, under compute_dtype, b
// and the mask hold bfloat16 values; the epilogue rounds as the knob says.
template <typename T, int TP, int TO, bool SMEM_W, bool VEC,
          int KNOB = kKnobNone>
__device__ __forceinline__ void layer(int in_off, int ldp, int K, int O,
                                      const T* W, const T* bias,
                                      const T* mask, int pc, bool last,
                                      int nxt_off, T* __restrict__ rows) {
  // From offsets, so that the compiler sees shared memory (LDS, not LD).
  T* const sm = reinterpret_cast<T*>(g_smem);
  const T* __restrict__ in = sm + in_off;
  T* __restrict__ nxt = sm + nxt_off;
  constexpr bool V4 = VEC && TO == 4;
  const int ptiles = ldp / TP, otiles = (O + TO - 1) / TO;
  for (int item = threadIdx.x; item < ptiles * otiles; item += blockDim.x) {
    const int q0 = (item % ptiles) * TP, o0 = (item / ptiles) * TO;
    T acc[TP][TO];
#pragma unroll
    for (int t = 0; t < TP; ++t)
#pragma unroll
      for (int j = 0; j < TO; ++j) acc[t][j] = T(0);
    const T* a_p = in + q0;
    const T* w_p = W + o0;
    const auto load = [&](int kk, T (&a)[TP], T (&w)[TO]) {
      if constexpr (TP == 1) {
        a[0] = a_p[kk * ldp];
      } else {
#pragma unroll
        for (int h = 0; h < TP; h += 4) lds4(a_p + kk * ldp + h, a + h);
      }
      if constexpr (V4) {
        if constexpr (SMEM_W) lds4(w_p + kk * O, w);
        else ldg4(w_p + kk * O, w);
      } else {
#pragma unroll
        for (int j = 0; j < TO; ++j)
          w[j] = o0 + j < O ? ld<SMEM_W>(w_p + kk * O + j) : T(0);
      }
    };
    // D steps of k at a time: their loads first, then their multiply-adds
    // in k order, so one load latency covers D steps of the chain.
    constexpr int D = TP * TO == 1 ? 8 : sizeof(T) == 8 ? 1 : 4;
    int kk = 0;
    for (; kk + D <= K; kk += D) {
      T a[D][TP], w[D][TO];
#pragma unroll
      for (int u = 0; u < D; ++u) load(kk + u, a[u], w[u]);
#pragma unroll
      for (int u = 0; u < D; ++u)
#pragma unroll
        for (int t = 0; t < TP; ++t)
#pragma unroll
          for (int j = 0; j < TO; ++j) acc[t][j] += a[u][t] * w[u][j];
    }
    for (; kk < K; ++kk) {
      T a[TP], w[TO];
      load(kk, a, w);
#pragma unroll
      for (int t = 0; t < TP; ++t)
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[t][j] += a[t] * w[j];
    }
    T b[TO];
    if constexpr (V4) {
      if constexpr (SMEM_W) lds4(bias + o0, b);
      else ldg4(bias + o0, b);
    } else {
#pragma unroll
      for (int j = 0; j < TO; ++j)
        b[j] = o0 + j < O ? ld<SMEM_W>(bias + o0 + j) : T(0);
    }
    if (last) {
#pragma unroll
      for (int t = 0; t < TP; ++t)
#pragma unroll
        for (int j = 0; j < TO; ++j)
          if (q0 + t < pc && o0 + j < O) {
            if constexpr (KNOB == kKnobCompute)
              rows[(q0 + t) * O + o0 + j] = bf16r(bf16r(acc[t][j]) + b[j]);
            else
              rows[(q0 + t) * O + o0 + j] = acc[t][j] + b[j];
          }
      continue;
    }
    T v[TO][TP];
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      const int q = q0 + t;
      T m[TO];
      if (mask != nullptr) {
        if (q >= pc) {
#pragma unroll
          for (int j = 0; j < TO; ++j) m[j] = T(0);
        } else if constexpr (V4) {
          lds4(mask + q * O + o0, m);
        } else {
#pragma unroll
          for (int j = 0; j < TO; ++j)
            m[j] = o0 + j < O ? mask[q * O + o0 + j] : T(0);
        }
      }
#pragma unroll
      for (int j = 0; j < TO; ++j) {
        if constexpr (KNOB == kKnobCompute) {
          T x = bf16r(bf16r(acc[t][j]) + b[j]);
          if (mask != nullptr) x = bf16r(x * m[j]);
          v[j][t] = x < T(0) ? T(0) : x;
        } else if constexpr (KNOB == kKnobMatmul) {
          T x = acc[t][j] + b[j];
          if (mask != nullptr) x = x * m[j];
          v[j][t] = bf16r(x < T(0) ? T(0) : x);  // the next operand
        } else {
          T x = acc[t][j] + b[j];
          if (mask != nullptr) x = x * m[j];
          v[j][t] = x < T(0) ? T(0) : x;  // ReLU that keeps a NaN
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      if (o0 + j >= O) continue;
      if constexpr (TP == 1) {
        nxt[(o0 + j) * ldp + q0] = v[j][0];
      } else {
#pragma unroll
        for (int h = 0; h < TP; h += 4)
          sts4(nxt + (o0 + j) * ldp + q0 + h, v[j] + h);
      }
    }
  }
}

template <typename T, int TP, int TO, bool SMEM_W, int KNOB = kKnobNone>
__device__ __forceinline__ void layer_vec(int in, int ldp, int K, int O,
                                          const T* W, const T* bias,
                                          const T* mask, int pc, bool last,
                                          int nxt, T* rows) {
  if (O % 4 == 0)
    layer<T, TP, TO, SMEM_W, true, KNOB>(in, ldp, K, O, W, bias, mask, pc,
                                         last, nxt, rows);
  else
    layer<T, TP, TO, SMEM_W, false, KNOB>(in, ldp, K, O, W, bias, mask, pc,
                                          last, nxt, rows);
}

// The activations' row stride (bfloat16 elements) of the MMA instances:
// the widest layer input.
__device__ __forceinline__ int act_stride(const Config& cfg) {
  int w = 0;
  for (int l = 0; l < cfg.n_layers; ++l) w = max(w, cfg.width[l]);
  return bf16_stride(w);
}

constexpr int kMmaTiles = 4;  // 8-wide output tiles a warp item carries

// One linear layer on the tensor cores (float32 instances under a
// bfloat16 knob). in holds the layer input particle-major as bfloat16
// (row q, stride s_act elements; rows and columns past the CTA's particles
// and K are zero up to Mp rows and K padded to 16), Wt the weights
// transposed (round8(O) rows of bf16_stride(K), zero past K). A warp item
// is an m-tile of 16 particles by kMmaTiles n-tiles of 8 outputs, its K
// steps of 16 one mma.sync each per n-tile, the n-tiles' sums independent.
// Hidden layers write relu(mask (x W + b)) as bfloat16 into nxt, particle-
// major, zeros in the columns O .. round16(O) that the next layer's
// padded K reads (rounded as the knob says); the last layer writes x W +
// b as rows[q * O + o] of the CTA's pc particles.
template <int KNOB, bool SMEM_W>
__device__ __forceinline__ void layer_mma(int in_off, int nxt_off, int s_act,
                                          int K, int O, const unsigned* Wt,
                                          const float* bias,
                                          const float* mask, int pc, int Mp,
                                          bool last, float* rows) {
  const unsigned* in = reinterpret_cast<const unsigned*>(g_smem) + in_off;
  unsigned* nxt = reinterpret_cast<unsigned*>(g_smem) + nxt_off;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sa = s_act / 2, sw = bf16_stride(K) / 2;  // in 32-bit words
  const int mtiles = Mp / 16, ksteps = (K + 15) / 16;
  const int ntiles = last ? (O + 7) / 8 : (O + 15) / 16 * 2;
  const int items = mtiles * ((ntiles + kMmaTiles - 1) / kMmaTiles);
  for (int item = threadIdx.x >> 5; item < items;
       item += blockDim.x >> 5) {
    const int m0 = (item % mtiles) * 16;
    const int n00 = (item / mtiles) * kMmaTiles * 8;
    float d[kMmaTiles][4];
#pragma unroll
    for (int j = 0; j < kMmaTiles; ++j)
      d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
    const unsigned* a_lo = in + (m0 + g) * sa + t;
    const unsigned* a_hi = a_lo + 8 * sa;
    for (int ks = 0; ks < ksteps; ++ks) {
      const unsigned a0 = a_lo[8 * ks], a1 = a_hi[8 * ks];
      const unsigned a2 = a_lo[8 * ks + 4], a3 = a_hi[8 * ks + 4];
#pragma unroll
      for (int j = 0; j < kMmaTiles; ++j) {
        const int n0 = n00 + 8 * j;
        if (n0 >= O) continue;  // the same for the whole warp
        const unsigned* b = Wt + (n0 + g) * sw + 8 * ks + t;
        mma_bf16(d[j], a0, a1, a2, a3, ldw<SMEM_W>(b), ldw<SMEM_W>(b + 4));
      }
    }
#pragma unroll
    for (int j = 0; j < kMmaTiles; ++j) {
      const int o = n00 + 8 * j + 2 * t;
      if (n00 + 8 * j >= ntiles * 8) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = m0 + g + 8 * h;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = d[j][2 * h + e];
          if (o + e >= O) {
            v[e] = 0.f;
            continue;
          }
          const float bo = bias[o + e];
          if (last) {
            v[e] = KNOB == kKnobCompute ? bf16r(bf16r(x) + bo) : x + bo;
            continue;
          }
          const float m =
              mask == nullptr ? 1.f : q < pc ? mask[q * O + o + e] : 0.f;
          if constexpr (KNOB == kKnobCompute) {
            x = bf16r(bf16r(x) + bo);
            if (mask != nullptr) x = bf16r(x * m);
          } else {
            x = x + bo;
            if (mask != nullptr) x = x * m;
          }
          v[e] = x < 0.f ? 0.f : x;  // ReLU that keeps a NaN
        }
        if (!last)
          nxt[q * sa + o / 2] = pack_bf16x2(v[0], v[1]);
        else if (q < pc)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (o + e < O) rows[q * O + o + e] = v[e];
      }
    }
  }
}

// F3 on the tensor cores: mlp below for the float32 instances under a
// bfloat16 knob; the input at offset act0 is particle-major bfloat16 (see
// layer_mma), pl.npad rows.
template <int KNOB>
__device__ void mlp_mma(const Config& cfg, const Plan& pl,
                        const float* __restrict__ params,
                        const float* const* mask, int act0, int act1, int pc,
                        float* rows) {
  const float* sm = reinterpret_cast<const float*>(g_smem);
  const int s_act = act_stride(cfg);
  int in = act0, nxt = act1;
  for (int l = 0; l < cfg.n_layers; ++l) {
    const int K = cfg.width[l], O = cfg.width[l + 1];
    const bool last = l == cfg.n_layers - 1;
    const float* mk = last ? nullptr : mask[l];
    if (pl.w_s[l] >= 0)
      layer_mma<KNOB, true>(in, nxt, s_act, K, O,
                            reinterpret_cast<const unsigned*>(sm + pl.w_s[l]),
                            sm + pl.b_s[l], mk, pc, pl.npad, last, rows);
    else
      layer_mma<KNOB, false>(
          in, nxt, s_act, K, O,
          reinterpret_cast<const unsigned*>(params + cfg.w_off[l]),
          params + cfg.b_off[l], mk, pc, pl.npad, last, rows);
    __syncthreads();
    const int s = in;
    in = nxt;
    nxt = s;
  }
}


// F3 over the CTA's pc particles: the shared memory at offset act0 holds
// the net input feature-major (padded to pl.npad particles); the last
// layer's rows go to rows. act0 and act1 are overwritten. Under a knob,
// float32 runs mlp_mma, float64 the layers below with the knob's rounding.
template <typename T, int KNOB = kKnobNone>
__device__ void mlp(const Config& cfg, const Plan& pl,
                    const T* __restrict__ params, const T* const* mask,
                    int act0, int act1, int pc, T* rows) {
  if constexpr (KNOB != kKnobNone && sizeof(T) == 4) {
    mlp_mma<KNOB>(cfg, pl, params, mask, act0, act1, pc, rows);
  } else {
    const T* sm = reinterpret_cast<const T*>(g_smem);
    int in = act0, nxt = act1;
    for (int l = 0; l < cfg.n_layers; ++l) {
      const int K = cfg.width[l], O = cfg.width[l + 1];
      const bool last = l == cfg.n_layers - 1;
      const T* mk = last ? nullptr : mask[l];
      const bool wide =
          2 * (pl.npad / 4) * ((O + 3) / 4) >= static_cast<int>(blockDim.x);
      if (pl.w_s[l] >= 0) {
        const T* W = sm + pl.w_s[l];
        const T* b = sm + pl.b_s[l];
        if (wide)
          layer_vec<T, 4, 4, true, KNOB>(in, pl.npad, K, O, W, b, mk, pc,
                                         last, nxt, rows);
        else
          layer_vec<T, 1, 1, true, KNOB>(in, pl.npad, K, O, W, b, mk, pc,
                                         last, nxt, rows);
      } else {
        const T* W = params + cfg.w_off[l];
        const T* b = params + cfg.b_off[l];
        if (wide)
          layer_vec<T, 4, 4, false, KNOB>(in, pl.npad, K, O, W, b, mk, pc,
                                          last, nxt, rows);
        else
          layer_vec<T, 1, 1, false, KNOB>(in, pl.npad, K, O, W, b, mk, pc,
                                          last, nxt, rows);
      }
      __syncthreads();
      const int s = in;
      in = nxt;
      nxt = s;
    }
  }
}

// The net input of the CTA's pc particles X (pc x n) and the constrained
// action uc, normalized by the input's mean xm and std xs, feature-major
// into act (padded with zeros to npad). Under a knob the input is rounded
// to bfloat16; the float32 instances store it particle-major as the MMA's
// A operand (layer_mma), zeros past pc rows and F columns.
template <typename T, int KNOB = kKnobNone>
__device__ void net_input(const Config& cfg, const T* xm, const T* xs,
                          const T* X, const T* uc, T* act, int npad,
                          int pc) {
  const int n = cfg.n, naug = cfg.n_nonang + 2 * cfg.n_ang;
  const int F = cfg.width[0];
  if constexpr (KNOB != kKnobNone && sizeof(T) == 4) {
    const auto value = [&](int f, int q) {
      float v = 0.f;
      if (q < pc && f < F) {
        const float* x = X + q * n;
        if (f < cfg.n_nonang) {
          v = x[cfg.nonang[f]];
        } else if (f < naug) {
          const int g = f - cfg.n_nonang;
          const float th = x[cfg.ang[g / 2]];
          v = (g & 1) ? cos(th) : sin(th);
        } else {
          v = uc[f - naug];
        }
        v = (v - xm[f]) / xs[f];
      }
      return v;
    };
    const int words = (F + 15) / 16 * 8, sa = act_stride(cfg) / 2;
    unsigned* a = reinterpret_cast<unsigned*>(act);
    for (int e = threadIdx.x; e < npad * words; e += blockDim.x) {
      const int q = e / words, f = 2 * (e % words);
      a[q * sa + f / 2] = pack_bf16x2(value(f, q), value(f + 1, q));
    }
  } else {
    for (int e = threadIdx.x; e < F * npad; e += blockDim.x) {
      const int f = e / npad, q = e % npad;
      T v = T(0);
      if (q < pc) {
        const T* x = X + q * n;
        if (f < cfg.n_nonang) {
          v = x[cfg.nonang[f]];
        } else if (f < naug) {
          const int g = f - cfg.n_nonang;
          const T th = x[cfg.ang[g / 2]];
          v = (g & 1) ? cos(th) : sin(th);
        } else {
          v = uc[f - naug];
        }
        v = (v - xm[f]) / xs[f];
        if constexpr (KNOB != kKnobNone) v = bf16r(v);
      }
      act[e] = v;
    }
  }
  __syncthreads();
}

// Step i's inputs staged in shared memory one step ahead by cp.async: the
// nominal state row Z_i, U_i, k_i, K_i, and the CTA's rows of the drawn
// noise eps_in[i] and (with the predicted std) eps_out[i]. One commit
// group a step; the step waits for its own with stage_wait.
template <typename T>
struct Stage {
  T *Z, *U, *k, *K, *e0, *eo;
};

template <typename T>
__device__ __forceinline__ Stage<T> stage_slot(T* base, int nz, int nu,
                                               int nrows) {
  Stage<T> s;
  s.Z = base;
  s.U = s.Z + nz;
  s.k = s.U + nu;
  s.K = s.k + nu;
  s.e0 = s.K + nu * nz;
  s.eo = s.e0 + nrows;
  return s;
}

template <typename T>
__device__ __forceinline__ void stage_step(const Stage<T>& s, const T* Zi,
                                           const T* Ui, const T* ki,
                                           const T* Ki, const T* e0,
                                           const T* eo, int nz, int nu,
                                           int nrows) {
  for (int e = threadIdx.x; e < nz; e += blockDim.x)
    pddp::cp_async(s.Z + e, Zi + e);
  for (int e = threadIdx.x; e < nu; e += blockDim.x) {
    pddp::cp_async(s.U + e, Ui + e);
    pddp::cp_async(s.k + e, ki + e);
  }
  for (int e = threadIdx.x; e < nu * nz; e += blockDim.x)
    pddp::cp_async(s.K + e, Ki + e);
  if (e0 != nullptr)
    for (int e = threadIdx.x; e < nrows; e += blockDim.x)
      pddp::cp_async(s.e0 + e, e0 + e);
  if (eo != nullptr)
    for (int e = threadIdx.x; e < nrows; e += blockDim.x)
      pddp::cp_async(s.eo + e, eo + e);
  pddp::cp_async_commit();
}

__device__ __forceinline__ void stage_wait_previous() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// K2(d): one cluster of pl.c CTAs per (solve b, candidate a); CTA rank r
// takes particles [r * ppc, r * ppc + pc).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) bnn_rollout_kernel(
    const T* __restrict__ Z, const T* __restrict__ U,
    const T* __restrict__ k, const T* __restrict__ K,
    const T* __restrict__ alphas, const T* __restrict__ params,
    const T* __restrict__ eps_in, const T* __restrict__ eps_out,
    const T* __restrict__ bounds, T* __restrict__ Z_out,
    T* __restrict__ U_out, T* __restrict__ AUX, int N, int A, Config cfg,
    Plan pl) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ T zc[kMaxNz], uc[kMaxNu], mean[kMaxN], Uc[kMaxN * kMaxN];
  __shared__ T M[kMaxN], C[kMaxN * kMaxN], jit[kMaxJitter];
  __shared__ T xm[kMaxF], xs[kMaxF], dxm[kMaxN], dxs[kMaxN];
  __shared__ T lo[kMaxNu], hi[kMaxNu], ulo[kMaxNu], uhi[kMaxNu];
  __shared__ unsigned long long bar;
  T* sm = reinterpret_cast<T*>(g_smem);
  T* const full0 = sm + pl.full0;
  T* const full1 = sm + pl.full1;
  T* eps = sm + pl.eps;
  T* X = sm + pl.X;
  T* out = sm + pl.out;
  const int n = cfg.n, nu = cfg.nu, P = cfg.P;
  const int nz = n + n * (n + 1) / 2, O = 2 * n, tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const long cl = blockIdx.x / pl.c;
  const size_t b = cl / A;
  const int a = static_cast<int>(cl % A);
  const int p0 = rank * pl.ppc;
  const int pc = max(0, min(pl.ppc, P - p0));
  const int rows_n = pc * n;
  const bool lead = rank == 0;
  Z += b * (N + 1) * nz;
  U += b * N * nu;
  k += b * N * nu;
  K += b * N * nu * nz;
  Z_out += b * (N + 1) * A * nz;
  U_out += b * N * A * nu;
  AUX += b * N * A * P * n;
  const T alpha = alphas[a];
  const bool drawn_rows = cfg.sample_input != 0;
  const bool pstd = cfg.predicted_std != 0;
  const auto slot = [&](int i) {
    return stage_slot(sm + pl.stage + (i & 1) * pl.stage_len, nz, nu,
                      pl.ppc * n);
  };
  const auto stage = [&](int i) {
    stage_step(slot(i), Z + (size_t)i * nz, U + (size_t)i * nu,
               k + (size_t)i * nu, K + (size_t)i * nu * nz,
               drawn_rows ? eps_in + ((size_t)i * P + p0) * n : nullptr,
               pstd ? eps_out + ((size_t)i * P + p0) * n : nullptr, nz, nu,
               rows_n);
  };
  stage(0);

  const T* mask[kMaxLayers];
  stage_net(cfg, pl, params, p0, pc, &bar, mask);
  // The step's constants, in shared memory for the whole horizon.
  if (tid < cfg.n_jitter) jit[tid] = params[cfg.jitter_off + tid];
  if (tid < cfg.width[0]) {
    xm[tid] = params[cfg.x_mean_off + tid];
    xs[tid] = params[cfg.x_std_off + tid];
  }
  if (tid < n) {
    dxm[tid] = params[cfg.dx_mean_off + tid];
    dxs[tid] = params[cfg.dx_std_off + tid];
  }
  if (tid < nu) {
    if (bounds != nullptr) {
      lo[tid] = bounds[tid];
      hi[tid] = bounds[nu + tid];
    }
    if (cfg.constrained) {
      ulo[tid] = params[cfg.u_min_off + tid];
      uhi[tid] = params[cfg.u_max_off + tid];
    }
  }
  if (tid == 0) {
    for (int e = 0; e < nz; ++e) {
      zc[e] = Z[e];
      if (lead) Z_out[a * nz + e] = Z[e];
    }
    with_n(n, [&](auto nn) { decode<decltype(nn)::value>(zc, mean, Uc); });
  }
  // Every CTA of the cluster runs before any stores into its peers.
  cluster.sync();
  wait_weights(pl, &bar);

  for (int i = 0; i < N; ++i) {
    const T* prev = (i & 1) ? full0 : full1;  // the outputs of step i - 1
    T* next = (i & 1) ? full1 : full0;
    const Stage<T> st = slot(i);
    if (i + 1 < N) stage(i + 1);
    else pddp::cp_async_commit();
    stage_wait_previous();

    // The step's noise: solved for all P particles (the fallback sees
    // every one), kept for the CTA's own. Its barrier also publishes the
    // staged rows.
    const bool solve = cfg.sample_input && cfg.infer_noise && i > 0;
    int bad = 0;
    if (solve) bad = solve_eps(Uc, mean, prev, P, n, p0, pc, eps);
    else __syncthreads();

    // The feedback law, beside the particles.
    if (tid < nu) {
      const T* Ki = st.K + tid * nz;
      T du = T(0);
      for (int j = 0; j < nz; ++j) du += (zc[j] - st.Z[j]) * Ki[j];
      T u = st.U[tid] + (alpha * st.k[tid] + du);
      if (bounds != nullptr) {
        u = u < lo[tid] ? lo[tid] : u;  // a NaN stays, as in torch.clamp
        u = u > hi[tid] ? hi[tid] : u;
      }
      if (lead) U_out[((size_t)i * A + a) * nu + tid] = u;
      if (cfg.constrained)
        u = (uhi[tid] - ulo[tid]) / T(2) * tanh(u) +
            (uhi[tid] + ulo[tid]) / T(2);
      uc[tid] = u;
    }
    particles(n, drawn_rows, !solve || bad, st.e0, eps, mean, Uc, pc, X,
              AUX + ((size_t)i * A + a) * P * n + (size_t)p0 * n);
    __syncthreads();

    // The MLP of the CTA's particles.
    net_input(cfg, xm, xs, X, uc, sm + pl.act0, pl.npad, pc);
    mlp(cfg, pl, params, mask, pl.act0, pl.act1, pc, out);

    // Next-state particles, into every CTA's copy: the rolling state.
    for (int e = tid; e < rows_n; e += blockDim.x) {
      const int q = e / n, j = e % n, p = p0 + q;
      T dx = out[q * O + j] * dxs[j] + dxm[j];
      if (pstd) {
        const T log_std = out[q * O + n + j] + log(dxs[j]);
        dx = dx + exp(log_std) * st.eo[e];
      }
      const T v = X[e] + dx;
      for (int r = 0; r < pl.c; ++r)
        cluster.map_shared_rank(next, r)[p * n + j] = v;
    }
    cluster.sync();

    moment_match(next, P, n, jit, cfg.n_jitter, M, C, zc, mean, Uc,
                 lead ? Z_out + ((size_t)(i + 1) * A + a) * nz : nullptr);
  }
}

// K2(d) under the other codecs, a value known at run time: the kernel
// above with decode_codec and moment_match_codec. The Cholesky codec keeps
// a kernel of its own, free of codec branches: one template for both
// compiled it to another register allocation, 1.5-2.2 % slower on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md). KNOB: the net's bfloat16 knob
// (kKnob*); under a knob this kernel takes the Cholesky codec too.
template <typename T, int KNOB>
__global__ void __launch_bounds__(kMaxThreads, 1) bnn_rollout_codec_kernel(
    const T* __restrict__ Z, const T* __restrict__ U,
    const T* __restrict__ k, const T* __restrict__ K,
    const T* __restrict__ alphas, const T* __restrict__ params,
    const T* __restrict__ eps_in, const T* __restrict__ eps_out,
    const T* __restrict__ bounds, T* __restrict__ Z_out,
    T* __restrict__ U_out, T* __restrict__ AUX, int N, int A, Config cfg,
    Plan pl, int codec) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ T zc[kMaxNzFull], uc[kMaxNu], mean[kMaxN], Uc[kMaxN * kMaxN];
  __shared__ T M[kMaxN], C[kMaxN * kMaxN], jit[kMaxJitter];
  __shared__ T xm[kMaxF], xs[kMaxF], dxm[kMaxN], dxs[kMaxN];
  __shared__ T lo[kMaxNu], hi[kMaxNu], ulo[kMaxNu], uhi[kMaxNu];
  __shared__ unsigned long long bar;
  T* sm = reinterpret_cast<T*>(g_smem);
  T* const full0 = sm + pl.full0;
  T* const full1 = sm + pl.full1;
  T* eps = sm + pl.eps;
  T* X = sm + pl.X;
  T* out = sm + pl.out;
  const int n = cfg.n, nu = cfg.nu, P = cfg.P;
  const int nz = pddp::encoded_size(codec, n), O = 2 * n;
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const long cl = blockIdx.x / pl.c;
  const size_t b = cl / A;
  const int a = static_cast<int>(cl % A);
  const int p0 = rank * pl.ppc;
  const int pc = max(0, min(pl.ppc, P - p0));
  const int rows_n = pc * n;
  const bool lead = rank == 0;
  Z += b * (N + 1) * nz;
  U += b * N * nu;
  k += b * N * nu;
  K += b * N * nu * nz;
  Z_out += b * (N + 1) * A * nz;
  U_out += b * N * A * nu;
  AUX += b * N * A * P * n;
  const T alpha = alphas[a];
  const bool drawn_rows = cfg.sample_input != 0;
  const bool pstd = cfg.predicted_std != 0;
  const auto slot = [&](int i) {
    return stage_slot(sm + pl.stage + (i & 1) * pl.stage_len, nz, nu,
                      pl.ppc * n);
  };
  const auto stage = [&](int i) {
    stage_step(slot(i), Z + (size_t)i * nz, U + (size_t)i * nu,
               k + (size_t)i * nu, K + (size_t)i * nu * nz,
               drawn_rows ? eps_in + ((size_t)i * P + p0) * n : nullptr,
               pstd ? eps_out + ((size_t)i * P + p0) * n : nullptr, nz, nu,
               rows_n);
  };
  stage(0);

  const T* mask[kMaxLayers];
  stage_net<T, KNOB>(cfg, pl, params, p0, pc, &bar, mask);
  // The step's constants, in shared memory for the whole horizon.
  if (tid < cfg.n_jitter) jit[tid] = params[cfg.jitter_off + tid];
  if (tid < cfg.width[0]) {
    xm[tid] = params[cfg.x_mean_off + tid];
    xs[tid] = params[cfg.x_std_off + tid];
  }
  if (tid < n) {
    dxm[tid] = params[cfg.dx_mean_off + tid];
    dxs[tid] = params[cfg.dx_std_off + tid];
  }
  if (tid < nu) {
    if (bounds != nullptr) {
      lo[tid] = bounds[tid];
      hi[tid] = bounds[nu + tid];
    }
    if (cfg.constrained) {
      ulo[tid] = params[cfg.u_min_off + tid];
      uhi[tid] = params[cfg.u_max_off + tid];
    }
  }
  if (tid == 0) {
    for (int e = 0; e < nz; ++e) {
      zc[e] = Z[e];
      if (lead) Z_out[a * nz + e] = Z[e];
    }
    with_n(n, [&](auto nn) {
      decode_codec<decltype(nn)::value>(zc, codec, mean, Uc);
    });
  }
  // Every CTA of the cluster runs before any stores into its peers.
  cluster.sync();
  wait_weights(pl, &bar);

  for (int i = 0; i < N; ++i) {
    const T* prev = (i & 1) ? full0 : full1;  // the outputs of step i - 1
    T* next = (i & 1) ? full1 : full0;
    const Stage<T> st = slot(i);
    if (i + 1 < N) stage(i + 1);
    else pddp::cp_async_commit();
    stage_wait_previous();

    // The step's noise: solved for all P particles (the fallback sees
    // every one), kept for the CTA's own. Its barrier also publishes the
    // staged rows.
    const bool solve = cfg.sample_input && cfg.infer_noise && i > 0;
    int bad = 0;
    if (solve) bad = solve_eps(Uc, mean, prev, P, n, p0, pc, eps);
    else __syncthreads();

    // The feedback law, beside the particles.
    if (tid < nu) {
      const T* Ki = st.K + tid * nz;
      T du = T(0);
      for (int j = 0; j < nz; ++j) du += (zc[j] - st.Z[j]) * Ki[j];
      T u = st.U[tid] + (alpha * st.k[tid] + du);
      if (bounds != nullptr) {
        u = u < lo[tid] ? lo[tid] : u;  // a NaN stays, as in torch.clamp
        u = u > hi[tid] ? hi[tid] : u;
      }
      if (lead) U_out[((size_t)i * A + a) * nu + tid] = u;
      if (cfg.constrained)
        u = (uhi[tid] - ulo[tid]) / T(2) * tanh(u) +
            (uhi[tid] + ulo[tid]) / T(2);
      uc[tid] = u;
    }
    particles(n, drawn_rows, !solve || bad, st.e0, eps, mean, Uc, pc, X,
              AUX + ((size_t)i * A + a) * P * n + (size_t)p0 * n);
    __syncthreads();

    // The MLP of the CTA's particles.
    net_input<T, KNOB>(cfg, xm, xs, X, uc, sm + pl.act0, pl.npad, pc);
    mlp<T, KNOB>(cfg, pl, params, mask, pl.act0, pl.act1, pc, out);

    // Next-state particles, into every CTA's copy: the rolling state.
    for (int e = tid; e < rows_n; e += blockDim.x) {
      const int q = e / n, j = e % n, p = p0 + q;
      T dx = out[q * O + j] * dxs[j] + dxm[j];
      if (pstd) {
        const T log_std = out[q * O + n + j] + log(dxs[j]);
        dx = dx + exp(log_std) * st.eo[e];
      }
      const T v = X[e] + dx;
      for (int r = 0; r < pl.c; ++r)
        cluster.map_shared_rank(next, r)[p * n + j] = v;
    }
    cluster.sync();

    moment_match_codec(next, P, n, codec, jit, cfg.n_jitter, M, C, zc, mean,
                       Uc,
                       lead ? Z_out + ((size_t)(i + 1) * A + a) * nz
                            : nullptr);
  }
}

// F1 entry: one block per group g of U_chol (G, n, n), deltas (G, P, n).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) bnn_infer_eps_kernel(
    const T* __restrict__ U_chol, const T* __restrict__ deltas,
    const T* __restrict__ eps0, int first, T* __restrict__ eps, Config cfg) {
  T* E = reinterpret_cast<T*>(g_smem);
  __shared__ T Uc[kMaxN * kMaxN], zero[kMaxN];
  const int n = cfg.n, P = cfg.P;
  const size_t g = blockIdx.x;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    Uc[e] = U_chol[g * n * n + e];
  for (int e = threadIdx.x; e < n; e += blockDim.x) zero[e] = T(0);
  __syncthreads();
  const int bad = solve_eps(Uc, zero, deltas + g * P * n, P, n, 0, P, E);
  const bool drawn = bad || first;
  for (int e = threadIdx.x; e < P * n; e += blockDim.x)
    eps[g * P * n + e] = drawn ? eps0[e] : E[e];
}

// F2 entry: particles (G, P, n) -> z (G, nz) and its decoded factor
// (G, n, n).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) bnn_moment_match_kernel(
    const T* __restrict__ particles, const T* __restrict__ params,
    T* __restrict__ z_out, T* __restrict__ U_out, Config cfg) {
  T* out = reinterpret_cast<T*>(g_smem);
  __shared__ T z[kMaxNz], M[kMaxN], C[kMaxN * kMaxN], mean[kMaxN];
  __shared__ T Uc[kMaxN * kMaxN], jit[kMaxJitter];
  const int n = cfg.n, P = cfg.P, nz = n + n * (n + 1) / 2;
  const size_t g = blockIdx.x;
  for (int e = threadIdx.x; e < P * n; e += blockDim.x)
    out[e] = particles[g * P * n + e];
  if (threadIdx.x < cfg.n_jitter)
    jit[threadIdx.x] = params[cfg.jitter_off + threadIdx.x];
  __syncthreads();
  moment_match(out, P, n, jit, cfg.n_jitter, M, C, z, mean, Uc,
               z_out + g * nz);
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    U_out[g * n * n + e] = Uc[e];
}

// F3 entry: net inputs x (G, P, F) -> outputs (G, P, O); one cluster of
// pl.c CTAs per group, the particles split as in K2(d). KNOB as in K2(d).
template <typename T, int KNOB>
__global__ void __launch_bounds__(kMaxThreads, 1) bnn_mlp_kernel(
    const T* __restrict__ x, const T* __restrict__ params,
    T* __restrict__ y, Config cfg, Plan pl) {
  __shared__ unsigned long long bar;
  T* sm = reinterpret_cast<T*>(g_smem);
  const int P = cfg.P, F = cfg.width[0], O = cfg.width[cfg.n_layers];
  const size_t g = blockIdx.x / pl.c;
  const int p0 = static_cast<int>(blockIdx.x % pl.c) * pl.ppc;
  const int pc = max(0, min(pl.ppc, P - p0));
  const T* mask[kMaxLayers];
  stage_net<T, KNOB>(cfg, pl, params, p0, pc, &bar, mask);
  T* act0 = sm + pl.act0;
  if constexpr (KNOB != kKnobNone && sizeof(T) == 4) {
    const int words = (F + 15) / 16 * 8, sa = act_stride(cfg) / 2;
    unsigned* a = reinterpret_cast<unsigned*>(act0);
    const auto at = [&](int q, int f) {
      return q < pc && f < F ? x[(g * P + p0 + q) * F + f] : T(0);
    };
    for (int e = threadIdx.x; e < pl.npad * words; e += blockDim.x) {
      const int q = e / words, f = 2 * (e % words);
      a[q * sa + f / 2] = pack_bf16x2(at(q, f), at(q, f + 1));
    }
  } else {
    for (int e = threadIdx.x; e < F * pl.npad; e += blockDim.x) {
      const int f = e / pl.npad, q = e % pl.npad;
      T v = q < pc ? x[(g * P + p0 + q) * F + f] : T(0);
      if constexpr (KNOB != kKnobNone) v = bf16r(v);
      act0[e] = v;
    }
  }
  __syncthreads();
  wait_weights(pl, &bar);
  mlp<T, KNOB>(cfg, pl, params, mask, pl.act0, pl.act1, pc,
               y + (g * P + p0) * O);
}

// ---------------------------------------------------------------------------
// Launch plans
// ---------------------------------------------------------------------------

bool valid(const Config& cfg) {
  if (cfg.n < 1 || cfg.n > kMaxN || cfg.P < 2 || cfg.n_layers < 1 ||
      cfg.n_layers > kMaxLayers || cfg.width[cfg.n_layers] != 2 * cfg.n ||
      cfg.n_jitter < 0 || cfg.n_jitter > kMaxJitter)
    return false;
  for (int l = 0; l <= cfg.n_layers; ++l)
    if (cfg.width[l] < 1) return false;
  return true;
}

// The shared-memory layout of c CTAs a cluster (the rollout's, or the MLP
// entry's without the particle arrays) within budget bytes: the
// activations and particle arrays first; then each layer's weights and
// bias, largest layer first, where they fit (a streamed small layer stays
// in L1 more easily than a large one); then all masks of the CTA's
// particles, if they fit (the staged step's length by the codec's state
// size). False when not even the first part fits. Under a knob in float32
// (the MMA instances) the activations are bfloat16, npad rows (the
// particles padded to the MMA's 16) of act_stride, and the weights W^T in
// bfloat16 (w_elems).
template <typename T, int KNOB>
bool layout(const Config& cfg, int codec, int c, bool rollout, long budget,
            Plan& p) {
  constexpr bool mma = KNOB != kKnobNone && sizeof(T) == 4;
  const int P = cfg.P, n = cfg.n, L = cfg.n_layers;
  p = Plan{};
  p.ppc = (P + c - 1) / c;
  p.c = (P + p.ppc - 1) / p.ppc;
  p.npad = mma ? (p.ppc + 15) / 16 * 16 : (p.ppc + kPad - 1) / kPad * kPad;
  int max_in = 0, max_out = 0;
  for (int l = 0; l < L; ++l) {
    max_in = cfg.width[l] > max_in ? cfg.width[l] : max_in;
    max_out = cfg.width[l + 1] > max_out ? cfg.width[l + 1] : max_out;
  }
  const auto r16 = [](long elems) {
    return round16(elems * long(sizeof(T))) / long(sizeof(T));
  };
  long off = 0;
  const auto take = [&](long elems) {
    const long o = off;
    off += r16(elems);
    return static_cast<int>(o);
  };
  const long act = mma ? long(p.npad) * bf16_stride(max_in) / 2
                       : long(max_in) * p.npad;
  p.act0 = take(act);
  p.act1 = take(act);
  p.full0 = p.full1 = p.eps = p.X = p.out = p.stage = -1;
  if (rollout) {
    const long nz = pddp::encoded_size(codec, n);
    p.full0 = take(long(P) * n);
    p.full1 = take(long(P) * n);
    p.eps = take(long(p.ppc) * n);
    p.X = take(long(p.ppc) * n);
    p.out = take(long(p.ppc) * cfg.width[L]);
    p.stage_len = static_cast<int>(
        r16(nz + 2 * cfg.nu + cfg.nu * nz + 2 * long(p.ppc) * n));
    p.stage = take(2L * p.stage_len);
  }
  for (int l = 0; l < kMaxLayers; ++l) p.w_s[l] = p.b_s[l] = p.m_s[l] = -1;
  const auto fits = [&](long extra) {
    return (off + extra) * long(sizeof(T)) <= budget;
  };
  if (!fits(0)) return false;
  bool placed[kMaxLayers] = {};
  for (int round = 0; round < L; ++round) {
    int best = -1;
    for (int l = 0; l < L; ++l)
      if (!placed[l] && (best < 0 || long(cfg.width[l]) * cfg.width[l + 1] >
                                         long(cfg.width[best]) *
                                             cfg.width[best + 1]))
        best = l;
    placed[best] = true;
    const long w = w_elems<T, KNOB>(cfg.width[best], cfg.width[best + 1]);
    const long bias = cfg.width[best + 1];
    if (!fits(r16(w) + r16(bias))) continue;
    p.w_s[best] = take(w);
    p.b_s[best] = take(bias);
    p.tx_bytes += static_cast<int>((r16(w) + r16(bias)) * long(sizeof(T)));
  }
  long masks = 0;
  for (int l = 0; l + 1 < L; ++l)
    if (cfg.m_off[l] >= 0) masks += r16(long(p.ppc) * cfg.width[l + 1]);
  if (masks > 0 && fits(masks))
    for (int l = 0; l + 1 < L; ++l)
      if (cfg.m_off[l] >= 0) p.m_s[l] = take(long(p.ppc) * cfg.width[l + 1]);
  p.bytes = static_cast<int>(off * long(sizeof(T)));
  const int tiles = ((p.ppc + kPad - 1) / kPad) * ((max_out + 3) / 4);
  int t = (tiles + 31) / 32 * 32;
  p.threads = t < kMinThreads ? kMinThreads : t > kMaxThreads ? kMaxThreads : t;
  return true;
}

cudaLaunchConfig_t launch_config(const Plan& p, long clusters,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(static_cast<unsigned>(clusters * p.c));
  lc.blockDim = dim3(static_cast<unsigned>(p.threads));
  lc.dynamicSmemBytes = static_cast<size_t>(p.bytes);
  lc.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(p.c);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  return lc;
}

// The plan of `clusters` clusters of a kernel: the largest c <= 8 whose
// clusters all run on the card at once (cudaOccupancyMaxActiveClusters),
// else the smallest c that fits. The last plan is kept per kernel, so a
// repeated launch of the same shape asks the runtime nothing but the
// shared-memory attribute.
struct Cached {
  bool ok;
  int device;
  long clusters;
  Config cfg;
  int codec;
  Plan plan;
};

template <typename T, int KNOB, typename Kernel>
int plan_launch(Kernel kernel, Cached& cache, const Config& cfg, int codec,
                long clusters, bool rollout, Plan& out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cache.ok && cache.device == dev && cache.clusters == clusters &&
      cache.codec == codec && memcmp(&cache.cfg, &cfg, sizeof(Config)) == 0) {
    out = cache.plan;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out.bytes));
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long budget = long(optin) - long(fa.sharedSizeBytes);
  bool found = false;
  Plan fit{};
  for (int c = cfg.P < kMaxCluster ? cfg.P : kMaxCluster; c >= 1; --c) {
    Plan p;
    if (!layout<T, KNOB>(cfg, codec, c, rollout, budget, p) || p.c != c)
      continue;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t lc = launch_config(p, 1, nullptr, &attr);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(
        &active, reinterpret_cast<const void*>(kernel), &lc);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active < 1) continue;
    fit = p;
    found = true;
    if (clusters <= active) break;
  }
  if (!found) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fit.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cache = Cached{true, dev, clusters, cfg, codec, fit};
  out = fit;
  return 0;
}

template <typename T, bool ANY_CODEC, int KNOB>
Cached& rollout_cache() {
  static Cached c{};
  return c;
}

template <typename T, int KNOB>
Cached& mlp_cache() {
  static Cached c{};
  return c;
}

template <typename T, int KNOB>
int plan_knob(int entry, long clusters, const Config& cfg, int codec,
              Plan& p) {
  if (entry == 0 && codec == pddp::kChol && KNOB == kKnobNone)
    return plan_launch<T, KNOB>(bnn_rollout_kernel<T>,
                                rollout_cache<T, false, KNOB>(), cfg, codec,
                                clusters, true, p);
  if (entry == 0)
    return plan_launch<T, KNOB>(bnn_rollout_codec_kernel<T, KNOB>,
                                rollout_cache<T, true, KNOB>(), cfg, codec,
                                clusters, true, p);
  return plan_launch<T, KNOB>(bnn_mlp_kernel<T, KNOB>, mlp_cache<T, KNOB>(),
                              cfg, codec, clusters, false, p);
}

template <typename T>
int plan_of(int entry, long clusters, const Config& cfg, int codec, int knob,
            Plan& p) {
  if (knob == kKnobCompute)
    return plan_knob<T, kKnobCompute>(entry, clusters, cfg, codec, p);
  if (knob == kKnobMatmul)
    return plan_knob<T, kKnobMatmul>(entry, clusters, cfg, codec, p);
  return plan_knob<T, kKnobNone>(entry, clusters, cfg, codec, p);
}

bool valid_knob(int knob) { return knob >= kKnobNone && knob <= kKnobMatmul; }

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

int block_threads(int P) {
  const int t = (P + 31) / 32 * 32;
  return t < kMinThreads ? kMinThreads : t > kMaxThreads ? kMaxThreads : t;
}

template <typename T>
int launch_rollout(const T* Z, const T* U, const T* k, const T* K,
                   const T* alphas, const T* params, const T* eps_in,
                   const T* eps_out, const T* bounds, T* Z_out, T* U_out,
                   T* AUX, int B, int N, int A, const int* cfg_ints,
                   void* stream) {
  Config cfg;
  memcpy(&cfg, cfg_ints, sizeof(cfg));
  const int codec = cfg_ints[kConfigInts];
  const int knob = cfg_ints[kConfigInts + 1];
  if (B < 1 || N < 1 || A < 1 || cfg.nu < 1 || cfg.nu > kMaxNu ||
      cfg.width[0] > kMaxF || !valid(cfg) || !aligned16(params) ||
      codec < pddp::kFull || codec > pddp::kIgnore || !valid_knob(knob))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const long clusters = long(B) * A;
  int err = plan_of<T>(0, clusters, cfg, codec, knob, pl);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t lc = launch_config(
      pl, clusters, static_cast<cudaStream_t>(stream), &attr);
  if (codec == pddp::kChol && knob == kKnobNone)
    err = static_cast<int>(cudaLaunchKernelEx(
        &lc, bnn_rollout_kernel<T>, Z, U, k, K, alphas, params, eps_in,
        eps_out, bounds, Z_out, U_out, AUX, N, A, cfg, pl));
  else if (knob == kKnobNone)
    err = static_cast<int>(cudaLaunchKernelEx(
        &lc, bnn_rollout_codec_kernel<T, kKnobNone>, Z, U, k, K, alphas,
        params, eps_in, eps_out, bounds, Z_out, U_out, AUX, N, A, cfg, pl,
        codec));
  else if (knob == kKnobCompute)
    err = static_cast<int>(cudaLaunchKernelEx(
        &lc, bnn_rollout_codec_kernel<T, kKnobCompute>, Z, U, k, K, alphas,
        params, eps_in, eps_out, bounds, Z_out, U_out, AUX, N, A, cfg, pl,
        codec));
  else
    err = static_cast<int>(cudaLaunchKernelEx(
        &lc, bnn_rollout_codec_kernel<T, kKnobMatmul>, Z, U, k, K, alphas,
        params, eps_in, eps_out, bounds, Z_out, U_out, AUX, N, A, cfg, pl,
        codec));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_infer_eps(const T* U_chol, const T* deltas, const T* eps0,
                     int first, T* eps, int G, const int* cfg_ints,
                     void* stream) {
  Config cfg;
  memcpy(&cfg, cfg_ints, sizeof(cfg));
  if (G < 1 || cfg.n < 1 || cfg.n > kMaxN || cfg.P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = size_t(cfg.P) * cfg.n * sizeof(T);
  int err = set_smem(bnn_infer_eps_kernel<T>, bytes);
  if (err != 0) return err;
  bnn_infer_eps_kernel<T><<<G, block_threads(cfg.P), bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      U_chol, deltas, eps0, first, eps, cfg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_moment_match(const T* particles, const T* params, T* z_out,
                        T* U_out, int G, const int* cfg_ints, void* stream) {
  Config cfg;
  memcpy(&cfg, cfg_ints, sizeof(cfg));
  if (G < 1 || cfg.n < 1 || cfg.n > kMaxN || cfg.P < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = size_t(cfg.P) * cfg.n * sizeof(T);
  int err = set_smem(bnn_moment_match_kernel<T>, bytes);
  if (err != 0) return err;
  bnn_moment_match_kernel<T><<<G, 8 * 32, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      particles, params, z_out, U_out, cfg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mlp(const T* x, const T* params, T* y, int G, const int* cfg_ints,
               void* stream) {
  Config cfg;
  memcpy(&cfg, cfg_ints, sizeof(cfg));
  const int knob = cfg_ints[kConfigInts + 1];
  if (G < 1 || !valid(cfg) || !aligned16(params) || !valid_knob(knob))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  int err = plan_of<T>(1, G, cfg, pddp::kChol, knob, pl);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t lc =
      launch_config(pl, G, static_cast<cudaStream_t>(stream), &attr);
  if (knob == kKnobNone)
    err = static_cast<int>(cudaLaunchKernelEx(
        &lc, bnn_mlp_kernel<T, kKnobNone>, x, params, y, cfg, pl));
  else if (knob == kKnobCompute)
    err = static_cast<int>(cudaLaunchKernelEx(
        &lc, bnn_mlp_kernel<T, kKnobCompute>, x, params, y, cfg, pl));
  else
    err = static_cast<int>(cudaLaunchKernelEx(
        &lc, bnn_mlp_kernel<T, kKnobMatmul>, x, params, y, cfg, pl));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int report_plan(int entry, int clusters, const int* cfg_ints, int* out) {
  Config cfg;
  memcpy(&cfg, cfg_ints, sizeof(cfg));
  const int codec = cfg_ints[kConfigInts];
  const int knob = cfg_ints[kConfigInts + 1];
  if (clusters < 1 || !valid(cfg) || (entry != 0 && entry != 1) ||
      codec < pddp::kFull || codec > pddp::kIgnore || !valid_knob(knob))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int err = plan_of<T>(entry, clusters, cfg, codec, knob, p);
  if (err != 0) return err;
  out[0] = p.c;
  out[1] = p.ppc;
  out[2] = p.threads;
  out[3] = p.bytes;
  int masks = 0;
  for (int l = 0; l < kMaxLayers; ++l) masks |= p.m_s[l] >= 0;
  out[4] = masks;
  for (int l = 0; l < kMaxLayers; ++l) out[5 + l] = p.w_s[l] >= 0;
  return 0;
}

}  // namespace

extern "C" {

int pddp_bnn_config_ints() { return kCallerInts; }

int pddp_bnn_plan_ints() { return kPlanInts; }

#define PDDP_BNN_ENTRIES(T, S)                                                \
  int pddp_bnn_rollout_##S(const T* Z, const T* U, const T* k, const T* K,   \
                           const T* alphas, const T* params,                 \
                           const T* eps_in, const T* eps_out,                \
                           const T* bounds, T* Z_out, T* U_out, T* AUX,      \
                           int B, int N, int A, const int* cfg,              \
                           void* stream) {                                   \
    return launch_rollout<T>(Z, U, k, K, alphas, params, eps_in, eps_out,    \
                             bounds, Z_out, U_out, AUX, B, N, A, cfg,        \
                             stream);                                        \
  }                                                                           \
  int pddp_bnn_infer_eps_##S(const T* U_chol, const T* deltas,               \
                             const T* eps0, int first, T* eps, int G,        \
                             const int* cfg, void* stream) {                 \
    return launch_infer_eps<T>(U_chol, deltas, eps0, first, eps, G, cfg,     \
                               stream);                                      \
  }                                                                           \
  int pddp_bnn_moment_match_##S(const T* particles, const T* params,         \
                                T* z_out, T* U_out, int G, const int* cfg,   \
                                void* stream) {                              \
    return launch_moment_match<T>(particles, params, z_out, U_out, G, cfg,   \
                                  stream);                                   \
  }                                                                           \
  int pddp_bnn_mlp_##S(const T* x, const T* params, T* y, int G,             \
                       const int* cfg, void* stream) {                       \
    return launch_mlp<T>(x, params, y, G, cfg, stream);                      \
  }                                                                           \
  int pddp_bnn_plan_##S(int entry, int clusters, const int* cfg, int* out) { \
    return report_plan<T>(entry, clusters, cfg, out);                        \
  }

#ifndef PDDP_F64_ONLY
PDDP_BNN_ENTRIES(float, f32)
#endif
#ifndef PDDP_F32_ONLY
PDDP_BNN_ENTRIES(double, f64)
#endif

#undef PDDP_BNN_ENTRIES

}  // extern "C"
