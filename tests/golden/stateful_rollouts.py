"""``pddp_tpu``'s line search over the rest of its fused-rollout gate,
stored for the port's tests (``tests/test_torch_stateful_rollouts.py``).

``pddp_tpu.ops.fused_rollout.fused_control_law(..., interpret=True,
with_aux=True)`` on the CPU in float64, with a cost, for:

* ``particulate_model`` of the cartpole under all five codecs, of the
  rendezvous under the Cholesky codec, and of the cartpole squashed into
  [-U_MAX, U_MAX] by ``constrain_model`` under the Cholesky codec
  (``allow_stateful``; P particles, the rendezvous PARTICLES);
* the belief-state BNN (``bnn_dynamics_model_factory(4, 1, [8, 8])``,
  the cartpole's sizes, P particles) under VARIANCE_ONLY,
  STANDARD_DEVIATION_ONLY, FULL_COVARIANCE_MATRIX and IGNORE_UNCERTAINTY;
* ``constrain_model`` of the cartpole and of the double cartpole under
  IGNORE_UNCERTAINTY and of the pendulum under the Cholesky codec
  (stateless).

The inputs are made with numpy (seeded per case) and stored beside the
outputs: each model's parameters, the particle models' episode noise, the
BNN's leaves and buffers, the nominal Z (``rollout`` of U from z0), U, and
gains k, K of moderate size. One case of each kind is bounded: its
actions are clamped to [U_LO, U_HI] in the line search. Where interpret
mode raises on a case, the scan ``control_law`` (which
``tests/ops/test_fused_rollout.py`` holds equal to the kernel within
1e-10) is stored instead, and ``<case>_source`` says so. It raises on
the four ``constrain_model`` cases (``particle_cartpole_chol_constrained``
and the three ``constrained_*``): the decorator's subclass is not
registered as a pytree, so the kernel's ``_pack`` meets the model as one
leaf of dtype object (a TypeError); ``pddp_tpu``'s fused line search
cannot take a constrained model, on the TPU as on the CPU.

Regenerate with

    JAX_PLATFORMS=cpu python -m tests.golden.stateful_rollouts
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "stateful_rollouts.npz")

P, N = 8, 6
#: particles of a case other than P: the rendezvous (n = 8) needs more
#: than n, or the ddof=1 covariance of its particles is singular, the
#: Cholesky factor's last pivot is set by the ladder's jitter (2.4e-5 at
#: P = 8), and the noise solve scales the means' rounding by its inverse.
PARTICLES = {"particle_rendezvous_chol": 16}
ALPHAS = (1.0, 0.5, 0.1)
U_MAX = 2.0            # constrain_model's bounds, [-U_MAX, U_MAX]
U_LO, U_HI = -0.4, 0.4  # the bounded cases' clamp
BNN_HIDDEN = [8, 8]
#: example -> (dt, start mean).
EXAMPLES = {
    "cartpole": (0.05, [0.0, 0.0, 0.3, 0.0]),
    "pendulum": (0.1, [0.5, 0.0]),
    "double_cartpole": (0.05, [0.0, 0.0, 0.05, 0.0, -0.05, 0.0]),
    "rendezvous": (0.1, [-10.0, -10.0, 10.0, 10.0, 0.0, -5.0, 5.0, 0.0]),
}
#: case -> (kind, example, codec, bounded). Kinds: "particle" (the
#: example inside particulate_model), "particle_constrained",
#: "bnn" (example: the sizes), "constrained" (constrain_model's example).
CASES = {
    "particle_cartpole_ignore": ("particle", "cartpole",
                                 "IGNORE_UNCERTAINTY", False),
    "particle_cartpole_variance": ("particle", "cartpole", "VARIANCE_ONLY",
                                   True),
    "particle_cartpole_std": ("particle", "cartpole",
                              "STANDARD_DEVIATION_ONLY", False),
    "particle_cartpole_chol": ("particle", "cartpole",
                               "UPPER_TRIANGULAR_CHOLESKY", False),
    "particle_cartpole_full": ("particle", "cartpole",
                               "FULL_COVARIANCE_MATRIX", False),
    "particle_rendezvous_chol": ("particle", "rendezvous",
                                 "UPPER_TRIANGULAR_CHOLESKY", False),
    "particle_cartpole_chol_constrained": ("particle_constrained",
                                           "cartpole",
                                           "UPPER_TRIANGULAR_CHOLESKY",
                                           False),
    "bnn_variance": ("bnn", "cartpole", "VARIANCE_ONLY", False),
    "bnn_std": ("bnn", "cartpole", "STANDARD_DEVIATION_ONLY", True),
    "bnn_full": ("bnn", "cartpole", "FULL_COVARIANCE_MATRIX", False),
    "bnn_ignore": ("bnn", "cartpole", "IGNORE_UNCERTAINTY", False),
    "constrained_cartpole_ignore": ("constrained", "cartpole",
                                    "IGNORE_UNCERTAINTY", True),
    "constrained_double_cartpole_ignore": ("constrained", "double_cartpole",
                                           "IGNORE_UNCERTAINTY", False),
    "constrained_pendulum_chol": ("constrained", "pendulum",
                                  "UPPER_TRIANGULAR_CHOLESKY", False),
}
#: the stored outputs of each case.
OUTPUTS = ("Z_out", "U_out", "J_out", "AUX_out")


def inputs(case, n, nu, nz):
    """(U (N, nu), k (N, nu), K (N, nu, nz)) of ``case``: numpy draws,
    seeded by the case's place in CASES."""
    rng = np.random.default_rng(100 + list(CASES).index(case))
    U = 0.3 * rng.standard_normal((N, nu))
    k = 0.1 * rng.standard_normal((N, nu))
    K = 0.05 * rng.standard_normal((N, nu, nz))
    return U, k, K


def particle_eps(case, n):
    """Standardized episode noise (N + 1, particles, n) of a particle
    case."""
    rng = np.random.default_rng(200 + list(CASES).index(case))
    e = rng.standard_normal((N + 1, PARTICLES.get(case, P), n))
    return (e - e.mean(axis=1, keepdims=True)) / e.std(axis=1, ddof=1,
                                                       keepdims=True)


def _example(name, constrained):
    """pddp_tpu's (model, cost) of example ``name``."""
    import importlib

    from pddp_tpu.utils.constraint import constrain_model
    mod = importlib.import_module("pddp_tpu.examples." + name)
    stem = "".join(w.capitalize() for w in name.split("_"))
    cls = getattr(mod, stem + "DynamicsModel")
    if constrained:
        cls = constrain_model(-U_MAX, U_MAX)(cls)
    return cls(dt=EXAMPLES[name][0]), getattr(mod, stem + "Cost")()


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pddp_tpu.controllers.ilqr import control_law, rollout
    from pddp_tpu.encoding import (StateEncoding, encode,
                                   infer_encoded_state_size)
    from pddp_tpu.examples.cartpole import CartpoleCost
    from pddp_tpu.ops.fused_rollout import (fused_control_law,
                                            supports_fused_rollout)
    from pddp_tpu.struct import replace
    from pddp_tpu.utils.particles import particulate_model
    from tests.golden import bnn_path

    out = {}
    alphas = jnp.asarray(ALPHAS, jnp.float64)
    for c, (case, (kind, ex, codec, bounded)) in enumerate(CASES.items()):
        enc = StateEncoding[codec]
        if kind == "bnn":
            leaves, buffers = bnn_path.make_inputs(
                seed=c, n_particles=P, hidden=BNN_HIDDEN, horizon=N + 1)
            model = bnn_path.jax_model(leaves, buffers, n_particles=P,
                                       hidden=BNN_HIDDEN, horizon=N + 1)
            cost = CartpoleCost()
            for i, a in enumerate(leaves):
                out["{}_leaf{}".format(case, i)] = np.asarray(a)
            for name, a in buffers.items():
                out["{}_{}".format(case, name)] = np.asarray(a)
        else:
            inner, cost = _example(ex, kind != "particle")
            for name in type(inner).__dataclass_fields__:
                out["{}_param_{}".format(case, name)] = np.asarray(
                    getattr(inner, name))
            model = inner
            if kind.startswith("particle"):
                model = particulate_model(inner, jax.random.PRNGKey(0),
                                          n_particles=PARTICLES.get(case, P),
                                          horizon=N + 1, dtype=jnp.float64)
                eps = particle_eps(case, inner.state_size)
                model = replace(model, eps=jnp.asarray(eps))
                out[case + "_eps"] = eps
        n, nu = model.state_size, model.action_size
        nz = infer_encoded_state_size(n, enc)
        mean0 = np.asarray(EXAMPLES[ex][1], np.float64)
        z0 = encode(jnp.asarray(mean0), V=1e-2 * jnp.ones(n, jnp.float64),
                    encoding=enc)
        U, k, K = inputs(case, n, nu, nz)
        Z, _ = rollout(model, z0, jnp.asarray(U), enc)
        bounds = (U_LO, U_HI) if bounded else (None, None)
        stateful = kind in ("bnn", "particle", "particle_constrained")
        assert supports_fused_rollout(model, enc, allow_stateful=stateful)
        args = (model, Z, jnp.asarray(U), jnp.asarray(k), jnp.asarray(K),
                alphas, enc)
        kw = dict(cost=cost, u_min=bounds[0], u_max=bounds[1],
                  with_aux=True)
        try:
            res = fused_control_law(*args, interpret=True, **kw)
            source = "interpret"
        except Exception as e:  # noqa: BLE001 - recorded, then the scan
            print(case, "interpret mode raised:", repr(e)[:200])
            res = control_law(*args, **kw)
            source = "scan"
        out[case + "_source"] = np.asarray(source)
        out[case + "_z0"] = np.asarray(z0)
        out[case + "_Z"] = np.asarray(Z)
        for name, a in (("U", U), ("k", k), ("K", K)):
            out["{}_{}".format(case, name)] = a
        aux = res[3]
        for name, a in zip(OUTPUTS, res[:3] + (aux,)):
            out["{}_{}".format(case, name)] = np.asarray(
                a if not isinstance(a, tuple) else np.zeros(0))
        print(case, source, "J", out[case + "_J_out"], flush=True)
    out["alphas"] = np.asarray(ALPHAS)
    np.savez(PATH, **out)
    print("wrote", PATH)


if __name__ == "__main__":
    main()
