"""``pddp_tpu``'s fused line search of the belief-state BNN under the
net's bfloat16 knobs, stored for ``tests/test_torch_bf16_rollouts.py``.

``pddp_tpu.ops.fused_rollout.fused_control_law(..., interpret=True,
with_aux=True)`` (no cost) on the CPU, for a BNN (``bnn_path``'s
arrays at hidden [16, 16], P=8 particles, the cartpole's sizes) with
``compute_dtype`` or ``matmul_dtype`` = ``jnp.bfloat16``, under each of
the five codecs, in float64 and in float32 (the same arrays rounded to
float32). The inputs are numpy draws seeded per codec and stored beside
the outputs: the net's leaves and buffers, the nominal Z (the float64
full-precision model's ``rollout`` of U from z0), U, and gains k, K.
The float32 cases run in a process of their own without
``jax_enable_x64`` (under it the interpret-mode kernel meets a float64
value in a float32 ref). Both run with XLA's
``--xla_allow_excess_precision=false``: by default XLA on the CPU keeps a
jitted bfloat16 operation's float32 result where the next operation reads
it, skipping the rounding that ``compute_dtype`` writes after each
operation (a jitted float32 forward of the [16, 16] net then differs
from its eager one in 526 of 640 outputs, up to 3.4e-3); with the flag
the jitted forward rounds each operation as written, as the eager one
does, and as the port does.

Regenerate with

    JAX_PLATFORMS=cpu python -m tests.golden.bf16_rollouts
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "bf16_rollouts.npz")

P, N, HIDDEN = 8, 6, [16, 16]
ALPHAS = tuple(float(a) for a in 1.1 ** -(np.arange(10) ** 2))
CODECS = ("UPPER_TRIANGULAR_CHOLESKY", "VARIANCE_ONLY",
          "STANDARD_DEVIATION_ONLY", "FULL_COVARIANCE_MATRIX",
          "IGNORE_UNCERTAINTY")
KNOBS = ("compute_dtype", "matmul_dtype")
DTYPES = ("float64", "float32")
MEAN0 = (0.0, 0.0, 0.3, 0.0)   # the cartpole's start, pole at 0.3 rad
OUTPUTS = ("Z_out", "U_out", "AUX_out")


def inputs(c, nu, nz):
    """(U (N, nu), k (N, nu), K (N, nu, nz)) of codec number ``c``."""
    rng = np.random.default_rng(300 + c)
    return (0.3 * rng.standard_normal((N, nu)),
            0.1 * rng.standard_normal((N, nu)),
            0.05 * rng.standard_normal((N, nu, nz)))


def key(codec, dtype, knob, name):
    return "{}_{}_{}_{}".format(codec, dtype, knob, name)


def run(dtype):
    """The outputs of every (codec, knob) in ``dtype``, and (float64) the
    inputs."""
    os.environ["XLA_FLAGS"] = " ".join(
        [os.environ.get("XLA_FLAGS", ""),
         "--xla_allow_excess_precision=false"]).strip()
    import jax

    jax.config.update("jax_enable_x64", dtype == "float64")
    import jax.numpy as jnp

    from pddp_tpu.controllers.ilqr import rollout
    from pddp_tpu.encoding import (StateEncoding, encode,
                                   infer_encoded_state_size)
    from pddp_tpu.ops.fused_rollout import (fused_control_law,
                                            supports_fused_rollout)
    from tests.golden import bnn_path

    jd = getattr(jnp, dtype)

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda a: a.astype(jd) if isinstance(a, jax.Array)
            and jnp.issubdtype(a.dtype, jnp.floating) else a, tree)

    out = {"alphas": np.asarray(ALPHAS)} if dtype == "float64" else {}
    for c, codec in enumerate(CODECS):
        enc = StateEncoding[codec]
        leaves, buffers = bnn_path.make_inputs(
            seed=40 + c, n_particles=P, hidden=HIDDEN, horizon=N + 1)
        nz = infer_encoded_state_size(4, enc)
        U, k, K = inputs(c, 1, nz)
        if dtype == "float64":
            for i, a in enumerate(leaves):
                out["{}_leaf{}".format(codec, i)] = np.asarray(a)
            for name, a in buffers.items():
                out["{}_{}".format(codec, name)] = np.asarray(a)
            full = bnn_path.jax_model(leaves, buffers, n_particles=P,
                                      hidden=HIDDEN, horizon=N + 1)
            z0 = encode(jnp.asarray(MEAN0, jnp.float64),
                        V=1e-2 * jnp.ones(4, jnp.float64), encoding=enc)
            Z, _ = rollout(full, z0, jnp.asarray(U), enc)
            out.update({codec + "_Z": np.asarray(Z), codec + "_U": U,
                        codec + "_k": k, codec + "_K": K})
        else:
            Z = np.load(os.environ["BF16_ROLLOUTS_Z"])[codec]
        for knob in KNOBS:
            model = cast(bnn_path.jax_model(
                leaves, buffers, n_particles=P, hidden=HIDDEN,
                horizon=N + 1, factory_kwargs={knob: jnp.bfloat16}))
            assert supports_fused_rollout(model, enc, allow_stateful=True)
            res = fused_control_law(
                model, *(jnp.asarray(np.asarray(a), jd)
                         for a in (Z, U, k, K)),
                jnp.asarray(ALPHAS, jd), enc, interpret=True, with_aux=True)
            for name, a in zip(OUTPUTS, res):
                out[key(codec, dtype, knob, name)] = np.asarray(a)
            print(codec, dtype, knob, "done", flush=True)
    return out


def main():
    import subprocess
    import sys
    import tempfile

    if len(sys.argv) > 2:   # the float32 process: run(dtype) into a file
        np.savez(sys.argv[2], **run(sys.argv[1]))
        return
    out = run("float64")
    with tempfile.TemporaryDirectory() as tmp:
        zs = os.path.join(tmp, "Z.npz")
        np.savez(zs, **{c: out[c + "_Z"] for c in CODECS})
        part = os.path.join(tmp, "float32.npz")
        subprocess.run([sys.executable, "-m", "tests.golden.bf16_rollouts",
                        "float32", part], check=True,
                       env=dict(os.environ, BF16_ROLLOUTS_Z=zs))
        with np.load(part) as f:
            out.update({k: f[k] for k in f.files})
    np.savez(PATH, **out)
    print("wrote", PATH)


if __name__ == "__main__":
    main()
