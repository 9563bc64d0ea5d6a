// K2 stage (e) over the four known-dynamics examples: the instances of
// fused_particle_rollout.cuh's kernel whose inner model is an example's
// hand-written step (examples.cuh), every codec and launch bound, for
// ParticleDynamicsModel over the cartpole, the pendulum, the double
// cartpole, rendezvous and their constrain_model subclasses.
//
// Replaces the stateful variant of the Pallas kernel
// pddp_tpu/ops/fused_rollout.py:114 (fused_control_law with
// allow_stateful on a particle model, pallas_call at :261) for those inner
// models; a generated source (ops/fused_particle_rollout.py) instantiates
// the same kernel over any other inner model whose step K2(f)'s trace
// takes. The design and its bound are in the header.

#include "fused_particle_rollout.cuh"

namespace {

using pddp_particle::Args;
using pddp_particle::launch_model;

// An example as the kernel's inner model: its parameters are p, it reads
// no step-indexed leaf and not the step.
template <class E>
struct Example {
  static constexpr int n = E::n, nu = E::nu, n_params = E::n_params;
  template <typename T>
  __device__ __forceinline__ static void step(const T* p, const T* w,
                                              const T* x, const T* u, int i,
                                              T* xn) {
    E::step(p, x, u, xn);
  }
};

template <typename T>
int launch(const Args<T>& g, int model, void* stream_ptr) {
  if (g.B < 1 || g.N < 1 || g.A < 1 || g.P < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (model) {
    case 0: return launch_model<T, Example<pddp::Cartpole>>(g, stream);
    case 1: return launch_model<T, Example<pddp::Pendulum>>(g, stream);
    case 2: return launch_model<T, Example<pddp::DoubleCartpole>>(g, stream);
    case 3: return launch_model<T, Example<pddp::Rendezvous>>(g, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// model: 0 cartpole, 1 pendulum, 2 double cartpole, 3 rendezvous (the
// inner model); codec: StateEncoding's value; constrained: the inner model
// is constrain_model's subclass, its bounds (lower, then upper, nu each)
// after its parameters in params; infer: noise inference on.
// Z (B, N+1, nz), U and k (B, N, nu), K (B, N, nu, nz), alphas (A), eps
// (>= N, P, n) the episode noise, bounds (2, nu) or null; Z_out
// (B, N+1, A, nz), U_out (B, N, A, nu), AUX (B, N, A, P, n).
#define PDDP_PARTICLE_ENTRY(T, S)                                            \
  int pddp_particle_rollout_##S(                                             \
      const T* Z, const T* U, const T* k, const T* K, const T* alphas,       \
      const T* params, const T* eps, const T* bounds, T* Z_out, T* U_out,    \
      T* AUX, int B, int N, int A, int P, int model, int codec,              \
      int constrained, int infer, void* stream) {                            \
    const Args<T> g{Z,     U,     k,   K, alphas, params, eps,   bounds,     \
                    Z_out, U_out, AUX, B, N,      A,      P,     codec,      \
                    constrained,  infer};                                    \
    return launch<T>(g, model, stream);                                      \
  }

#ifndef PDDP_F64_ONLY
PDDP_PARTICLE_ENTRY(float, f32)
#endif
#ifndef PDDP_F32_ONLY
PDDP_PARTICLE_ENTRY(double, f64)
#endif

}  // extern "C"
