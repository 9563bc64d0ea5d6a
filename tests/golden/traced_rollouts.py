"""``pddp_tpu``'s line search of the rows K2(f) covers, stored for the
port's tests (``tests/test_torch_traced_rollout.py``).

The rows (``tests/traced_models.py``'s ROWS, R1-R8) are stateless models
that no hand-written stage of the port carries: the planar quadrotor (a
user's own model, defined here in ``pddp_tpu``'s way as a
``@pytree_dataclass``, with its wind table read at the step index) under
three codecs and three costs, and bare subclasses of the cartpole, the
double cartpole, rendezvous and ``constrain_model(-1, 1)``'s cartpole.

For each, ``pddp_tpu.ops.fused_rollout.fused_control_law(...,
interpret=True)`` on the CPU in float64 at H = N, A = 10 (the default
fit alphas), with the cost (under the belief codecs a post-pass). Where
interpret mode raises, the scan ``control_law`` with the cost in the scan
(the kernel's order; ``tests/ops/test_fused_rollout.py`` holds the two
equal within 1e-12) is stored instead, and ``<row>_source`` says so: it
raises on R8, whose class ``constrain_model`` builds is not a pytree
(``ROADMAP.md`` B, "Known difference").

The inputs are made with numpy (``traced_models.row_inputs``, the wind
``traced_models.wind``) and stored beside the outputs: z0, the nominal Z
(``rollout`` of U from z0), U, k, K and the wind.

Regenerate with

    JAX_PLATFORMS=cpu python -m tests.golden.traced_rollouts
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "traced_rollouts.npz")

#: the horizon of the stored rows.
N = 25


def jax_quadrotor():
    """The planar quadrotor in ``pddp_tpu``'s way (the port's is
    ``traced_models.PlanarQuadrotorModel``)."""
    import jax.numpy as jnp

    from pddp_tpu.encoding import (StateEncoding, decode_mean, decode_var,
                                   encode)
    from pddp_tpu.models.base import DynamicsModel
    from pddp_tpu.struct import pytree_dataclass

    @pytree_dataclass
    class PlanarQuadrotorModel(DynamicsModel):
        w: jnp.ndarray
        m: jnp.ndarray = 0.486
        r: jnp.ndarray = 0.25
        I: jnp.ndarray = 0.00383
        g: jnp.ndarray = 9.81
        dt: jnp.ndarray = 0.05

        state_size = 6
        action_size = 2
        angular_indices = (2,)
        non_angular_indices = (0, 1, 3, 4, 5)

        def apply(self, z, u, i, aux,
                  encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
            return self.dynamics(z, u, self.w[i], encoding)

        def dynamics(self, z, u, gust, encoding):
            mean = decode_mean(z, encoding)
            var = decode_var(z, encoding)
            x, h, th = mean[..., 0], mean[..., 1], mean[..., 2]
            x_dot, h_dot, th_dot = mean[..., 3], mean[..., 4], mean[..., 5]
            u1, u2 = u[..., 0], u[..., 1]
            thrust = u1 + u2
            x_dd = -thrust * jnp.sin(th) / self.m + gust[..., 0]
            h_dd = thrust * jnp.cos(th) / self.m - self.g + gust[..., 1]
            th_dd = self.r * (u1 - u2) / self.I
            x_dot = x_dot + x_dd * self.dt
            h_dot = h_dot + h_dd * self.dt
            th_dot = th_dot + th_dd * self.dt
            mean_next = jnp.stack([x + x_dot * self.dt, h + h_dot * self.dt,
                                   th + th_dot * self.dt, x_dot, h_dot,
                                   th_dot], axis=-1)
            return encode(mean_next, V=var, encoding=encoding)

    return PlanarQuadrotorModel


def jax_row(row):
    """(model, cost, encoding, bounds) of ``row`` in ``pddp_tpu``."""
    import importlib

    import jax.numpy as jnp

    from pddp_tpu.costs.quadratic import QRCost, SaturatingQRCost
    from pddp_tpu.encoding import StateEncoding
    from pddp_tpu.struct import pytree_dataclass
    from pddp_tpu.utils.constraint import constrain_model
    from tests import traced_models as tm

    kind, codec, cost_kind = tm.ROWS[row]
    enc = StateEncoding[codec]
    name = tm.example_name(kind)
    if name == "quadrotor":
        model = jax_quadrotor()(w=jnp.asarray(tm.wind(N)))
        Q, R, Q_term, x_goal, u_goal = (jnp.asarray(a)
                                        for a in tm.quad_weights())
        kw = dict(Q_term=Q_term, x_goal=x_goal, u_goal=u_goal)
        if cost_kind == "saturating":
            cost = SaturatingQRCost(Q, R, **kw)
        elif cost_kind == "qr_plus_saturating":
            cost = QRCost(Q, R, **kw) + SaturatingQRCost(Q, R, **kw)
        else:
            cost = QRCost(Q, R, **kw)
    else:
        mod = importlib.import_module("pddp_tpu.examples." + name)
        stem = "".join(w.capitalize() for w in name.split("_"))
        cls = getattr(mod, stem + "DynamicsModel")
        cost = getattr(mod, stem + "Cost")()
        if kind.startswith("constrained"):
            cls = constrain_model(-1.0, 1.0)(cls)
            sub = type("User" + cls.__name__, (cls,), {})
        else:
            sub = pytree_dataclass(type("User" + cls.__name__, (cls,), {}))
        model = sub(dt=tm.STARTS[name][0])
    bounds = tm.U_BOUNDS if row in tm.BOUNDED else None
    return model, cost, enc, bounds


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pddp_tpu.controllers.ilqr import (control_law, default_fit_alphas,
                                           rollout)
    from pddp_tpu.encoding import encode, infer_encoded_state_size
    from pddp_tpu.ops.fused_rollout import (fused_control_law,
                                            supports_fused_rollout)
    from tests import traced_models as tm

    out = {"N": np.asarray(N)}
    alphas = default_fit_alphas(jnp.float64)
    out["alphas"] = np.asarray(alphas)
    out["wind"] = tm.wind(N)
    for row in tm.ROWS:
        model, cost, enc, bounds = jax_row(row)
        n, nu = model.state_size, model.action_size
        nz = infer_encoded_state_size(n, enc)
        name = tm.example_name(tm.ROWS[row][0])
        z0 = encode(jnp.asarray(tm.STARTS[name][1], jnp.float64),
                    V=1e-2 * jnp.ones(n, jnp.float64), encoding=enc)
        U, k, K = tm.row_inputs(row, N, nz, nu)
        Z, _ = rollout(model, z0, jnp.asarray(U), enc)
        lo, hi = bounds if bounds is not None else (None, None)
        assert supports_fused_rollout(model, enc)
        args = (model, Z, jnp.asarray(U), jnp.asarray(k), jnp.asarray(K),
                alphas, enc)
        kw = dict(cost=cost, u_min=lo, u_max=hi)
        try:
            res = fused_control_law(*args, interpret=True, **kw)
            source = "interpret"
        except Exception as e:  # noqa: BLE001 - recorded, then the scan
            print(row, "interpret mode raised:", repr(e)[:200])
            res = control_law(*args, cost_in_scan=True, **kw)
            source = "scan"
        print(row, source, "J", np.asarray(res[2]))
        out[row + "_source"] = np.asarray(source)
        out[row + "_z0"] = np.asarray(z0)
        out[row + "_Z"] = np.asarray(Z)
        for key, a in (("U", U), ("k", k), ("K", K)):
            out["{}_{}".format(row, key)] = a
        for key, a in zip(("Z_out", "U_out", "J_out"), res[:3]):
            out["{}_{}".format(row, key)] = np.asarray(a)
    np.savez_compressed(PATH, **out)
    print("wrote", PATH)


if __name__ == "__main__":
    main()
