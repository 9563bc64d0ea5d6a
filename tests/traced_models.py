"""The models and rows of K2(f)'s checks, in the port (no JAX here).

K2(f) runs the line search of any stateless model and cost whose torch
code it can trace (``pddp_tpu_torch/ops/traced_rollout.py``). Its rows,
shared by ``tests/test_torch_traced_rollout.py`` (CPU, against the
fixture ``tests/golden/traced_rollouts.npz``, which
``tests/golden/traced_rollouts.py`` writes from ``pddp_tpu``) and
``chip_smoke.py`` phase 21 (the card):

===  =========================================  ========  =================
Row  Model                                      Codec     Cost
===  =========================================  ========  =================
R1   the planar quadrotor                       IGNORE    saturating, bounds
R2   the planar quadrotor                       IGNORE    QR + saturating
R3   the planar quadrotor                       VARIANCE  post-pass
R4   the planar quadrotor                       CHOLESKY  post-pass
R5   a bare subclass of the cartpole            IGNORE    CartpoleCost
R6   a bare subclass of the double cartpole     IGNORE    its cost
R7   a bare subclass of rendezvous              CHOLESKY  post-pass
R8   a subclass of constrain_model(-1, 1)'s     IGNORE    CartpoleCost
     cartpole
===  =========================================  ========  =================

The planar quadrotor (Tedrake, *Underactuated Robotics*, "Acrobots,
Cart-Poles, and Quadrotors"): state [x, z, theta, x', z', theta'],
action the two rotors' thrusts [u1, u2],

    x'' = -(u1 + u2) sin(theta) / m + w_i[0]
    z'' =  (u1 + u2) cos(theta) / m - g + w_i[1]
    theta'' = r (u1 - u2) / I,

semi-implicit Euler, with a wind table w (N, 2) read at the step i: the
model reads ``self.w[i]``, a per-step table that K2(f) reads at run time.

The stateful rows (``STATEFUL_ROWS``): K2(g), a user's stateful model
traced from its torch code, and K2(e) over a traced inner model, shared
by ``tests/test_torch_stateful_traced.py`` (CPU, against
``tests/golden/stateful_traced.npz``, which
``tests/golden/stateful_traced.py`` writes from ``pddp_tpu``) and
``chip_smoke.py`` phase 22 (the card):

===  =============================================  ==========  =========
Row  Model                                          Codec       Cost
===  =============================================  ==========  =========
G1   the cartpole behind a first-order actuator lag IGNORE      CartpoleCost,
                                                                bounds
G2   the planar quadrotor in a filtered gust        IGNORE      saturating
G3   the planar quadrotor in a filtered gust        CHOLESKY    post-pass
E1   ``particulate_model`` of a bare subclass of    CHOLESKY    post-pass
     the cartpole
E2   ``particulate_model`` of the planar quadrotor  VARIANCE    post-pass
===  =============================================  ==========  =========

The lag's rolling state is the force f (1,) the cart feels, f' = f +
(dt / tau)(u - f); the gust's is g (2,), g' = g + beta (w_i - g), added
to the accelerations in place of w_i. Each step's aux is the state before
it, so that ``apply(z, u, i, aux)`` reproduces ``step(...)[0]``.
"""

from __future__ import annotations

import numpy as np
import torch

from pddp_tpu_torch.costs.quadratic import QRCost, SaturatingQRCost
from pddp_tpu_torch.encoding import (StateEncoding, decode_mean, decode_var,
                                     encode)
from pddp_tpu_torch.examples import cartpole, double_cartpole, rendezvous
from pddp_tpu_torch.models.base import DynamicsModel
from pddp_tpu_torch.utils.constraint import constrain_model

#: the quadrotor's constants (Tedrake's planar quadrotor: mass, arm,
#: inertia, gravity) and its time step.
QUAD = {"m": 0.486, "r": 0.25, "I": 0.00383, "g": 9.81, "dt": 0.05}
#: the thrust that holds it (each rotor m g / 2).
HOVER = QUAD["m"] * QUAD["g"] / 2
#: R1's action bounds.
U_BOUNDS = (0.0, 2.0 * HOVER + 1.0)
#: row -> (model, codec, cost).
ROWS = {
    "R1": ("quadrotor", "IGNORE_UNCERTAINTY", "saturating"),
    "R2": ("quadrotor", "IGNORE_UNCERTAINTY", "qr_plus_saturating"),
    "R3": ("quadrotor", "VARIANCE_ONLY", "qr"),
    "R4": ("quadrotor", "UPPER_TRIANGULAR_CHOLESKY", "qr"),
    "R5": ("cartpole_subclass", "IGNORE_UNCERTAINTY", "example"),
    "R6": ("double_cartpole_subclass", "IGNORE_UNCERTAINTY", "example"),
    "R7": ("rendezvous_subclass", "UPPER_TRIANGULAR_CHOLESKY", "example"),
    "R8": ("constrained_cartpole_subclass", "IGNORE_UNCERTAINTY",
           "example"),
}
#: the bounded rows: their actions are clamped to U_BOUNDS.
BOUNDED = ("R1",)
#: each model's time step and start mean. Rendezvous at dt = 0.01: its
#: velocity grows by 1 + dt (1 - alpha dt / m) a step whatever the action
#: (1.099 at the example's 0.1, 1.6e8 over H=200; 7.3 at 0.01).
STARTS = {
    "quadrotor": (QUAD["dt"], [0.5, -0.3, 0.1, 0.0, 0.2, 0.0]),
    "cartpole": (0.05, [0.0, 0.0, 0.3, 0.0]),
    "double_cartpole": (0.05, [0.0, 0.0, 0.05, 0.0, -0.05, 0.0]),
    "rendezvous": (0.01, [-10.0, -10.0, 10.0, 10.0, 0.0, -5.0, 5.0, 0.0]),
}


def example_name(model_kind):
    """The example a row's model is built on ("quadrotor" for its own)."""
    for name in ("double_cartpole", "cartpole", "rendezvous", "quadrotor"):
        if name in model_kind:
            return name
    raise KeyError(model_kind)


def wind(N, seed=0):
    """The quadrotor's wind table (N, 2): a seeded gust profile."""
    rng = np.random.default_rng(1000 + seed)
    return 0.3 * rng.standard_normal((N, 2))


def quad_weights():
    """(Q, R, Q_term, x_goal, u_goal) of the quadrotor's costs."""
    Q = np.diag([1.0, 1.0, 0.5, 0.1, 0.1, 0.05])
    R = 0.05 * np.eye(2)
    Q_term = 10.0 * Q
    x_goal = np.array([0.0, 0.5, 0.0, 0.0, 0.0, 0.0])
    u_goal = np.full(2, HOVER)
    return Q, R, Q_term, x_goal, u_goal


class PlanarQuadrotorModel(DynamicsModel):
    """The planar quadrotor with a wind table: state [x, z, theta, x', z',
    theta'], action [u1, u2]; ``w`` (N, 2) is added to (x'', z'') at step
    i. A user's own model: K2(f) traces it."""

    state_size = 6
    action_size = 2
    angular_indices = (2,)
    non_angular_indices = (0, 1, 3, 4, 5)

    def __init__(self, w, m=QUAD["m"], r=QUAD["r"], I=QUAD["I"],
                 g=QUAD["g"], dt=QUAD["dt"], *, device="cpu",
                 dtype=torch.float64):
        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        self.m, self.r, self.I, self.g, self.dt = t(m), t(r), t(I), t(g), \
            t(dt)
        self.w = t(w)

    def apply(self, z, u, i, aux,
              encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        return self.dynamics(z, u, self.w[i], encoding)

    def dynamics(self, z, u, gust, encoding):
        """The step with the gust ``gust`` (..., 2) added to (x'', z'')."""
        mean = decode_mean(z, encoding)
        var = decode_var(z, encoding)
        x, h, th, x_dot, h_dot, th_dot = mean.unbind(-1)
        u1, u2 = u[..., 0], u[..., 1]
        thrust = u1 + u2
        x_dd = -thrust * torch.sin(th) / self.m + gust[..., 0]
        h_dd = thrust * torch.cos(th) / self.m - self.g + gust[..., 1]
        th_dd = self.r * (u1 - u2) / self.I
        x_dot = x_dot + x_dd * self.dt
        h_dot = h_dot + h_dd * self.dt
        th_dot = th_dot + th_dd * self.dt
        mean_next = torch.stack([x + x_dot * self.dt, h + h_dot * self.dt,
                                 th + th_dot * self.dt, x_dot, h_dot,
                                 th_dot], dim=-1)
        return encode(mean_next, V=var, encoding=encoding)


def _example_classes(name):
    mod = {"cartpole": cartpole, "double_cartpole": double_cartpole,
           "rendezvous": rendezvous}[name]
    stem = "".join(w.capitalize() for w in name.split("_"))
    return getattr(mod, stem + "DynamicsModel"), getattr(mod, stem + "Cost")


#: the rows' user subclasses, made once: K2(f) keys its traces on the
#: model's type, so a class made anew at every call would be traced anew.
_SUBCLASSES = {}


def user_subclass(kind):
    """The bare subclass of a row's example (``constrain_model``'s
    subclass of it for the constrained row)."""
    cls = _SUBCLASSES.get(kind)
    if cls is None:
        base, _ = _example_classes(example_name(kind))
        if kind.startswith("constrained"):
            base = constrain_model(-1.0, 1.0)(base)
        cls = _SUBCLASSES[kind] = type("User" + base.__name__, (base,), {})
    return cls


def make_row(row, N, device="cpu", dtype=torch.float64, seed=0):
    """(model, cost, encoding, (u_min, u_max) or None) of ``row`` at
    horizon N, in the port."""
    kind, codec, cost_kind = ROWS[row]
    enc = StateEncoding[codec]
    name = example_name(kind)
    if name == "quadrotor":
        model = PlanarQuadrotorModel(wind(N, seed), device=device,
                                     dtype=dtype)
        Q, R, Q_term, x_goal, u_goal = quad_weights()
        kw = dict(Q_term=Q_term, x_goal=x_goal, u_goal=u_goal, device=device,
                  dtype=dtype)
        if cost_kind == "saturating":
            cost = SaturatingQRCost(Q, R, **kw)
        elif cost_kind == "qr_plus_saturating":
            cost = QRCost(Q, R, **kw) + SaturatingQRCost(Q, R, **kw)
        else:
            cost = QRCost(Q, R, **kw)
    else:
        cost_cls = _example_classes(name)[1]
        model = user_subclass(kind)(dt=STARTS[name][0], device=device,
                                    dtype=dtype)
        cost = cost_cls(device=device, dtype=dtype)
    bounds = U_BOUNDS if row in BOUNDED else None
    return model, cost, enc, bounds


def row_inputs(row, N, nz, nu, seed=0):
    """(U (N, nu), k (N, nu), K (N, nu, nz)) of ``row``: numpy draws,
    seeded by the row's place in ROWS."""
    rng = np.random.default_rng(300 + 10 * seed + list(ROWS).index(row))
    kind = ROWS[row][0]
    base = HOVER if example_name(kind) == "quadrotor" else 0.0
    U = base + 0.3 * rng.standard_normal((N, nu))
    k = 0.1 * rng.standard_normal((N, nu))
    K = 0.05 * rng.standard_normal((N, nu, nz))
    return U, k, K


# ---------------------------------------------------------------------------
# The stateful rows: K2(g) and K2(e) over a traced inner model
# ---------------------------------------------------------------------------

#: the lag's actuator time constant (s) and the gust filter's gain.
LAG_TAU = 0.1
GUST_BETA = 0.3
#: G1's action bounds.
LAG_BOUNDS = (-0.5, 0.5)
#: stateful row -> (model, codec, cost).
STATEFUL_ROWS = {
    "G1": ("lagged_cartpole", "IGNORE_UNCERTAINTY", "example"),
    "G2": ("gust_quadrotor", "IGNORE_UNCERTAINTY", "saturating"),
    "G3": ("gust_quadrotor", "UPPER_TRIANGULAR_CHOLESKY", "qr"),
    "E1": ("particle_cartpole_subclass", "UPPER_TRIANGULAR_CHOLESKY",
           "example"),
    "E2": ("particle_quadrotor", "VARIANCE_ONLY", "qr"),
}
#: the stateful rows whose actions are clamped (to LAG_BOUNDS).
STATEFUL_BOUNDED = ("G1",)


class LaggedCartpoleModel(cartpole.CartpoleDynamicsModel):
    """The cartpole behind a first-order actuator lag: the rolling state
    is the force f (1,) the cart feels, f' = f + (dt / tau)(u - f), and f'
    drives the cartpole; the step's aux is f. A user's stateful model:
    K2(g) traces it."""

    def __init__(self, *args, tau=LAG_TAU, **kwargs):
        super().__init__(*args, **kwargs)
        self.tau = torch.as_tensor(tau, dtype=self.dt.dtype,
                                   device=self.dt.device)

    def init_state(self, batch_shape=()):
        return self.dt.new_zeros(tuple(batch_shape) + (1,))

    def aux_zero(self):
        return self.dt.new_zeros((1,))

    def force(self, f, u):
        return f + self.dt / self.tau * (u - f)

    def step(self, z, u, i, state,
             encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        f = self.force(state, u)
        return super().apply(z, f, i, (), encoding), f, state

    def apply(self, z, u, i, aux,
              encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        return super().apply(z, self.force(aux, u), i, (), encoding)


class GustQuadrotorModel(PlanarQuadrotorModel):
    """The planar quadrotor in a filtered gust: the rolling state is the
    gust g (2,) it feels, g' = g + beta (w_i - g), added to (x'', z'') in
    place of w_i; the step's aux is g. A user's stateful model that reads
    a table by the step index: K2(g) traces it."""

    def __init__(self, w, beta=GUST_BETA, **kwargs):
        super().__init__(w, **kwargs)
        self.beta = torch.as_tensor(beta, dtype=self.w.dtype,
                                    device=self.w.device)

    def init_state(self, batch_shape=()):
        return self.w.new_zeros(tuple(batch_shape) + (2,))

    def aux_zero(self):
        return self.w.new_zeros((2,))

    def gust(self, g, i):
        return g + self.beta * (self.w[i] - g)

    def step(self, z, u, i, state,
             encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        g = self.gust(state, i)
        return self.dynamics(z, u, g, encoding), g, state

    def apply(self, z, u, i, aux,
              encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        return self.dynamics(z, u, self.gust(aux, i), encoding)


def particle_eps(row, N, P, n):
    """A particle row's standardized episode noise (N + 1, P, n): numpy
    draws seeded by the row's place in STATEFUL_ROWS, each step's
    particles at zero mean and unit std (ddof=1)."""
    rng = np.random.default_rng(500 + list(STATEFUL_ROWS).index(row))
    e = rng.standard_normal((N + 1, P, n))
    return (e - e.mean(axis=1, keepdims=True)) / e.std(axis=1, ddof=1,
                                                       keepdims=True)


def make_stateful_row(row, N, device="cpu", dtype=torch.float64, P=8):
    """(model, cost, encoding, (u_min, u_max) or None) of a stateful row
    at horizon N (the particle rows with P particles and
    ``particle_eps``'s noise), in the port."""
    from pddp_tpu_torch.convert import particle_model
    kind, codec, cost_kind = STATEFUL_ROWS[row]
    enc = StateEncoding[codec]
    name = example_name(kind)
    if name == "quadrotor":
        cls = GustQuadrotorModel if kind.startswith("gust") else \
            PlanarQuadrotorModel
        model = cls(wind(N), device=device, dtype=dtype)
        Q, R, Q_term, x_goal, u_goal = quad_weights()
        kw = dict(Q_term=Q_term, x_goal=x_goal, u_goal=u_goal, device=device,
                  dtype=dtype)
        cost = (SaturatingQRCost(Q, R, **kw) if cost_kind == "saturating"
                else QRCost(Q, R, **kw))
    else:
        cls = (LaggedCartpoleModel if kind.startswith("lagged") else
               user_subclass("cartpole_subclass"))
        model = cls(dt=STARTS[name][0], device=device, dtype=dtype)
        cost = cartpole.CartpoleCost(device=device, dtype=dtype)
    if kind.startswith("particle"):
        model = particle_model(model, particle_eps(row, N, P,
                                                   model.state_size))
    bounds = LAG_BOUNDS if row in STATEFUL_BOUNDED else None
    return model, cost, enc, bounds


def stateful_inputs(row, N, nz, nu):
    """(U (N, nu), k (N, nu), K (N, nu, nz)) of a stateful row: numpy
    draws, seeded by the row's place in STATEFUL_ROWS."""
    rng = np.random.default_rng(600 + list(STATEFUL_ROWS).index(row))
    base = HOVER if example_name(STATEFUL_ROWS[row][0]) == "quadrotor" \
        else 0.0
    U = base + 0.3 * rng.standard_normal((N, nu))
    k = 0.1 * rng.standard_normal((N, nu))
    K = 0.05 * rng.standard_normal((N, nu, nz))
    return U, k, K
