"""K2 stage (d): the belief-state BNN line search as one CUDA kernel
(``csrc/fused_bnn_rollout.cu``), and its three fragment entries.

Port of the stateful variant of ``pddp_tpu/ops/fused_rollout.py:
fused_control_law``: the closed-loop rollout of all A step sizes of a
``BNNDynamicsModel`` under any of the five codecs (the noise inference
through the codec's factor, the moment match into the codec), with the
model's rolling state (the previous particle outputs) and the per-step
noise aux.
The kernel returns trajectories and aux only; the cost is a batched
post-pass, as in ``pddp_tpu``'s belief-state line search.

The net's bfloat16 knobs (``compute_dtype`` or ``matmul_dtype`` =
``torch.bfloat16``, one at a time) have instances of their own: in
float32 the MLP runs on the tensor cores (``mma.sync`` with bfloat16
operands and float32 sums), its weights packed here transposed and padded
as bfloat16 bits in the parameter buffer; in float64 the FMA layers take
operands rounded as the knob says (see ``csrc/fused_bnn_rollout.cu``).

The fragment entries run the kernel's device functions alone, each
beside its plain version: ``infer_eps`` (F1, the noise inference),
``moment_match`` (F2, moment match and Cholesky codec) and ``mlp`` (F3,
the particle MLP). The plain versions are ``controllers.ilqr.control_law``
with the model, ``models.bnn.infer_eps``, ``models.bnn.moment_match`` with
``encoding.decode_covar_sqrt``, and the net's ``__call__``. On CPU tensors
each wrapper runs its plain version; on CUDA tensors it launches its
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..controllers.ilqr import control_law
from ..encoding import (StateEncoding, decode_covar_sqrt,
                        infer_encoded_state_size)
from ..models.bnn import BNNDynamicsModel, infer_eps as plain_infer_eps
from ..models.bnn.model import moment_match as plain_moment_match
from ..utils.linalg import JITTER_LEVELS
from ._build import load_library

__all__ = ["supports", "fused_bnn_control_law", "infer_eps", "moment_match",
           "mlp", "launch_plan", "launches"]

#: kernel launches per entry: "rollout" (K2(d)), "infer_eps" (F1),
#: "moment_match" (F2), "mlp" (F3).
launches = {"rollout": 0, "infer_eps": 0, "moment_match": 0, "mlp": 0}

MAX_N, MAX_NU, MAX_LAYERS = 8, 4, 6

#: csrc/fused_bnn_rollout.cu:Config, field by field (name, count), then
#: the rollout's codec (StateEncoding's value) and the net's knob
#: (``_knob``), which the library keeps out of Config.
_CONFIG_FIELDS = (
    ("n", 1), ("nu", 1), ("P", 1), ("n_layers", 1),
    ("width", MAX_LAYERS + 1), ("w_off", MAX_LAYERS), ("b_off", MAX_LAYERS),
    ("m_off", MAX_LAYERS), ("n_ang", 1), ("n_nonang", 1), ("ang", MAX_N),
    ("nonang", MAX_N), ("x_mean_off", 1), ("x_std_off", 1),
    ("dx_mean_off", 1), ("dx_std_off", 1), ("u_min_off", 1),
    ("u_max_off", 1), ("jitter_off", 1), ("n_jitter", 1),
    ("predicted_std", 1), ("sample_input", 1), ("infer_noise", 1),
    ("constrained", 1), ("codec", 1), ("knob", 1))

#: the library's kKnob* values of the net's precision options.
_KNOBS = {"compute_dtype": 1, "matmul_dtype": 2}


def _widths(net):
    return [net.layers[0].W.shape[0]] + [layer.W.shape[1]
                                         for layer in net.layers]


def _knob(net):
    """The kernels' knob of ``net``: 0 at full precision, 1 for
    ``compute_dtype`` and 2 for ``matmul_dtype`` = ``torch.bfloat16``;
    None for what they do not carry (another dtype, or both set)."""
    set_ = {name: getattr(net, name) for name in _KNOBS
            if getattr(net, name) is not None}
    if not set_:
        return 0
    if len(set_) > 1 or next(iter(set_.values())) != torch.bfloat16:
        return None
    return _KNOBS[next(iter(set_))]


def _bf16_stride(K):
    """csrc/fused_bnn_rollout.cu:bf16_stride: K padded to 16, plus 8."""
    return -(-K // 16) * 16 + 8


def supports(model, encoding=None):
    """Whether the kernel covers ``model`` under ``encoding``: a
    ``BNNDynamicsModel`` (exact type) under any of the five codecs with
    state size <= 8, action size <= 4, at most 6 linear layers, an
    output of width 2 n, ReLU, at least two particles and the net at full
    precision or with one of ``compute_dtype`` and ``matmul_dtype`` set to
    ``torch.bfloat16`` (``_knob``), its particles not sharded over ranks
    (the kernel sums over its own). The launch plan
    (cluster, particles and shared memory of a CTA) is the library's: a
    shape it cannot plan makes the launch raise."""
    if type(model) is not BNNDynamicsModel or encoding is None:
        return False
    net = model.net
    return (model.state_size <= MAX_N and model.action_size <= MAX_NU
            and len(net.layers) <= MAX_LAYERS and net.activation == "relu"
            and _widths(net)[-1] == 2 * model.state_size
            and model.n_particles >= 2 and model.eps_in is not None
            and model.particle_group is None and _knob(net) is not None)


class _Packer:
    """Concatenates tensors into one flat parameter buffer and records
    each one's offset in the kernel's config. Each part is padded with
    zeros to a multiple of 16 bytes, so that every part starts on a
    16-byte boundary of the buffer: the kernels stage the weights with
    bulk copies, which need that."""

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, device
        self.parts, self.starts, self.size, self.cfg = [], [], 0, {}
        self.align = 16 // torch.empty((), dtype=dtype).element_size()

    def put(self, t):
        t = torch.as_tensor(t).reshape(-1).to(dtype=self.dtype,
                                               device=self.device)
        pad = -t.numel() % self.align
        if pad:
            t = torch.cat([t, t.new_zeros(pad)])
        self.parts.append(t)
        start, self.size = self.size, self.size + t.numel()
        self.starts.append(start)
        return start

    def net(self, net, P, n):
        """The net's weights, biases and masks; under a knob rounded to
        bfloat16 as the kernels take them: W (float32: transposed, padded
        to round8(O) rows of ``_bf16_stride(K)`` and zeros, as bfloat16
        bits, the MMA's B operand; float64: its bfloat16 values), and under
        ``compute_dtype`` the biases and masks too."""
        widths = _widths(net)
        knob = _knob(net)
        bf16 = torch.bfloat16

        def rounded(t, yes=True):
            return t.to(bf16).to(self.dtype) if knob and yes else t

        def weights(W):
            if not knob:
                return self.put(W)
            if self.dtype != torch.float32:
                return self.put(rounded(W))
            K, O = W.shape
            Wt = torch.zeros((-(-O // 8) * 8, _bf16_stride(K)), dtype=bf16,
                             device=W.device)
            Wt[:O, :K] = W.T.to(bf16)
            return self.put(Wt.reshape(-1).view(self.dtype))  # raw bits

        compute = knob == _KNOBS["compute_dtype"]
        self.cfg["w_off"] = [weights(layer.W) for layer in net.layers]
        self.cfg["b_off"] = [self.put(rounded(layer.b, compute))
                             for layer in net.layers]
        self.cfg["m_off"] = [-1 if m is None else self.put(rounded(m, compute))
                             for m in net.eval_masks()]
        self.cfg.update(n=n, P=P, n_layers=len(net.layers), width=widths,
                        knob=knob)

    def jitter(self, jitter_levels):
        jitter = JITTER_LEVELS if jitter_levels is None else jitter_levels
        self.cfg["jitter_off"] = self.put(torch.tensor(jitter,
                                                       dtype=torch.float64))
        self.cfg["n_jitter"] = len(jitter)

    def done(self):
        buf = (torch.cat(self.parts) if self.parts else
               torch.zeros(1, dtype=self.dtype, device=self.device))
        return buf, _config_ints(self.cfg)


def _params(model, dtype, device, encoding):
    """(parameter buffer, config ints) of ``model`` for the rollout."""
    return _pack(model, dtype, device, encoding).done()


def _pack(model, dtype, device, encoding):
    """The packer holding ``model``'s rollout parameters and config under
    ``encoding``."""
    pk = _Packer(dtype, device)
    n, nu = model.state_size, model.action_size
    pk.net(model.net, model.n_particles, n)
    F = pk.cfg["width"][0]
    pk.cfg["x_mean_off"] = pk.put(model.X_mean.expand(F))
    pk.cfg["x_std_off"] = pk.put(model.X_std.expand(F))
    pk.cfg["dx_mean_off"] = pk.put(model.dX_mean.expand(n))
    pk.cfg["dx_std_off"] = pk.put(model.dX_std.expand(n))
    if model.constrained:
        pk.cfg["u_min_off"] = pk.put(torch.as_tensor(model.u_min).expand(nu))
        pk.cfg["u_max_off"] = pk.put(torch.as_tensor(model.u_max).expand(nu))
    pk.jitter(model.chol_jitter)
    ai, nai = model.angular_indices, model.non_angular_indices
    if not ai:
        nai = tuple(range(n))
    pk.cfg.update(
        nu=nu, n_ang=len(ai), n_nonang=len(nai), ang=list(ai),
        nonang=list(nai), predicted_std=int(model.use_predicted_std),
        sample_input=int(model.sample_input_distribution),
        infer_noise=int(model.infer_noise_variables),
        constrained=int(model.constrained), codec=int(encoding))
    return pk


def _config_ints(cfg):
    ints = []
    for name, count in _CONFIG_FIELDS:
        v = cfg.get(name, 0)
        v = list(v) if isinstance(v, (list, tuple)) else [v]
        ints += v + [0] * (count - len(v))
    return (ctypes.c_int * len(ints))(*ints)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rollout": [_PTR] * 12 + [_INT] * 3 + [_PTR, _PTR],
    "infer_eps": [_PTR] * 3 + [_INT, _PTR, _INT, _PTR, _PTR],
    "moment_match": [_PTR] * 4 + [_INT, _PTR, _PTR],
    "mlp": [_PTR] * 3 + [_INT, _PTR, _PTR],
    "plan": [_INT, _INT, _PTR, _PTR],
}


def _function(entry, dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("the BNN kernels take float32 or float64, not "
                        "{}".format(dtype))
    lib = load_library("fused_bnn_rollout", dtype)
    n_ints = lib.pddp_bnn_config_ints()
    if n_ints != sum(c for _, c in _CONFIG_FIELDS):
        raise RuntimeError("kernel Config has {} ints, the wrapper {}".format(
            n_ints, sum(c for _, c in _CONFIG_FIELDS)))
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(lib, "pddp_bnn_{}_{}".format(entry, suffix))
    fn.argtypes = _SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError("{} has shape {}, expected {}".format(
            name, tuple(t.shape), tuple(shape)))
    if t.dtype != dtype or t.device != device:
        raise TypeError("{} is {} on {}, expected {} on {}".format(
            name, t.dtype, t.device, dtype, device))
    if not t.is_contiguous():
        raise ValueError("{} is not contiguous".format(name))


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(what,
                                                                    err))


def _on_cuda(t, name):
    if t.device.type != "cuda":
        raise ValueError("{} runs on CUDA or CPU tensors, not {}".format(
            name, t.device))


def fused_bnn_control_law(model, Z, U, k, K, alphas,
                          encoding: StateEncoding = StateEncoding.DEFAULT,
                          u_min=None, u_max=None):
    """Batched-alpha closed-loop rollout of the BNN belief dynamics.

    Args mirror ``controllers.ilqr.control_law`` (no cost); requires
    ``supports(model, encoding)``. Inputs may carry one leading batch dim
    B of solves; ``alphas`` and the bounds (scalars or (nu,)) are shared.

    Returns:
        (Z_new (..., N+1, A, nz), U_new (..., N, A, nu),
         AUX (N, ..., A, P, n)), the layout of ``control_law``.
    """
    if not supports(model, encoding):
        raise ValueError("the BNN rollout kernel does not cover this "
                         "model (see supports)")
    if Z.device.type == "cpu":
        return control_law(model, Z, U, k, K, alphas, encoding,
                           u_min=u_min, u_max=u_max, with_aux=True)
    _on_cuda(Z, "fused_bnn_control_law")
    unbatched = Z.dim() == 2
    ins = tuple(t.unsqueeze(0) if unbatched else t for t in (Z, U, k, K))
    Z, U, k, K = ins
    B, N1, nz = Z.shape
    N, A = N1 - 1, alphas.shape[0]
    n, nu, P = model.state_size, model.action_size, model.n_particles
    dtype, device = Z.dtype, Z.device
    if N > model.eps_in.shape[0]:
        raise ValueError("horizon {} exceeds the model's noise table of "
                         "{} steps".format(N, model.eps_in.shape[0]))
    for name, t, shape in zip(
            ("Z", "U", "k", "K", "alphas"), ins + (alphas,),
            ((B, N + 1, infer_encoded_state_size(n, encoding)), (B, N, nu),
             (B, N, nu), (B, N, nu, nz), (A,))):
        _check(name, t, shape, dtype, device)
    fn = _function("rollout", dtype)
    params, cfg = _params(model, dtype, device, encoding)
    eps_in = model.eps_in.to(dtype=dtype, device=device).contiguous()
    eps_out = (model.eps_out.to(dtype=dtype, device=device).contiguous()
               if model.use_predicted_std else None)
    bounds = None
    if u_min is not None and u_max is not None:
        bounds = torch.stack([torch.as_tensor(v).to(dtype=dtype,
                                                    device=device).expand(nu)
                              for v in (u_min, u_max)]).contiguous()
    Z_out = torch.empty((B, N + 1, A, nz), dtype=dtype, device=device)
    U_out = torch.empty((B, N, A, nu), dtype=dtype, device=device)
    AUX = torch.empty((B, N, A, P, n), dtype=dtype, device=device)
    with torch.cuda.device(device):
        err = fn(Z.data_ptr(), U.data_ptr(), k.data_ptr(), K.data_ptr(),
                 alphas.data_ptr(), params.data_ptr(), eps_in.data_ptr(),
                 None if eps_out is None else eps_out.data_ptr(),
                 None if bounds is None else bounds.data_ptr(),
                 Z_out.data_ptr(), U_out.data_ptr(), AUX.data_ptr(),
                 B, N, A, cfg, _stream(device))
    _raise_on(err, "K2(d) (fused_bnn_rollout)")
    launches["rollout"] += 1
    if unbatched:
        return Z_out[0], U_out[0], AUX[0]
    return Z_out, U_out, AUX.movedim(1, 0)


def _groups(name, t, ndim):
    if t.dim() != ndim:
        raise ValueError("{} has {} dims, expected {}".format(name, t.dim(),
                                                              ndim))
    return t.shape[0]


def infer_eps(U_chol, deltas, eps0, first):
    """F1: the input noise of one step for G groups (e.g. the candidates).

    Args:
        U_chol (G, n, n) upper factors, deltas (G, P, n) previous outputs
        less the means, eps0 (P, n) the step's drawn noise, first: whether
        it is step 0. Returns eps (G, P, n); see ``models.bnn.infer_eps``.
    """
    if deltas.device.type == "cpu":
        return plain_infer_eps(U_chol, deltas, eps0, first)
    _on_cuda(deltas, "infer_eps")
    G = _groups("deltas", deltas, 3)
    _, P, n = deltas.shape
    dtype, device = deltas.dtype, deltas.device
    if n > MAX_N:
        raise ValueError("state size {} exceeds {}".format(n, MAX_N))
    _check("U_chol", U_chol, (G, n, n), dtype, device)
    _check("deltas", deltas, (G, P, n), dtype, device)
    _check("eps0", eps0, (P, n), dtype, device)
    fn = _function("infer_eps", dtype)
    eps = torch.empty_like(deltas)
    with torch.cuda.device(device):
        err = fn(U_chol.data_ptr(), deltas.data_ptr(), eps0.data_ptr(),
                 int(bool(first)), eps.data_ptr(), G,
                 _config_ints({"n": n, "P": P}), _stream(device))
    _raise_on(err, "F1 (bnn_infer_eps)")
    launches["infer_eps"] += 1
    return eps


def moment_match(particles, jitter_levels=None):
    """F2: particles (G, P, n) -> (z (G, nz) under the Cholesky codec,
    its decoded upper factor (G, n, n)); see ``models.bnn.moment_match``
    and ``encoding.decode_covar_sqrt``."""
    chol = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    if particles.device.type == "cpu":
        z = plain_moment_match(particles, chol, jitter_levels)
        return z, decode_covar_sqrt(z, chol, particles.shape[-1])
    _on_cuda(particles, "moment_match")
    G = _groups("particles", particles, 3)
    _, P, n = particles.shape
    dtype, device = particles.dtype, particles.device
    if n > MAX_N or P < 2:
        raise ValueError("moment_match takes n <= {} and P >= 2, not n={}, "
                         "P={}".format(MAX_N, n, P))
    _check("particles", particles, (G, P, n), dtype, device)
    pk = _Packer(dtype, device)
    pk.jitter(jitter_levels)
    pk.cfg.update(n=n, P=P)
    params, cfg = pk.done()
    fn = _function("moment_match", dtype)
    z = torch.empty((G, n + n * (n + 1) // 2), dtype=dtype, device=device)
    U = torch.empty((G, n, n), dtype=dtype, device=device)
    with torch.cuda.device(device):
        err = fn(particles.data_ptr(), params.data_ptr(), z.data_ptr(),
                 U.data_ptr(), G, cfg, _stream(device))
    _raise_on(err, "F2 (bnn_moment_match)")
    launches["moment_match"] += 1
    return z, U


def mlp(net, x):
    """F3: the particle MLP in eval mode, x (G, P, F) -> (G, P, O), each
    particle with its own dropout masks, under the net's bfloat16 knob if
    it has one (see ``supports``); see ``BayesianMLP.__call__``."""
    if x.device.type == "cpu":
        return net(x)
    _on_cuda(x, "mlp")
    G = _groups("x", x, 3)
    _, P, F = x.shape
    dtype, device = x.dtype, x.device
    widths = _widths(net)
    if (len(net.layers) > MAX_LAYERS or net.activation != "relu"
            or widths[0] != F or widths[-1] > 2 * MAX_N
            or widths[-1] % 2 or P < 2 or _knob(net) is None):
        raise ValueError("the MLP kernel does not cover this net")
    _check("x", x, (G, P, F), dtype, device)
    pk = _Packer(dtype, device)
    pk.net(net, P, widths[-1] // 2)
    params, cfg = pk.done()
    fn = _function("mlp", dtype)
    y = torch.empty((G, P, widths[-1]), dtype=dtype, device=device)
    with torch.cuda.device(device):
        err = fn(x.data_ptr(), params.data_ptr(), y.data_ptr(), G, cfg,
                 _stream(device))
    _raise_on(err, "F3 (bnn_mlp)")
    launches["mlp"] += 1
    return y


def launch_plan(model, clusters, dtype, encoding, entry="rollout"):
    """The library's launch plan of K2(d) (``entry="rollout"`` under
    ``encoding``, one cluster per (solve, candidate): ``clusters`` = B * A)
    or of F3 (``"mlp"``, one per group of its P particles; ``encoding``
    unused) for the ``BNNDynamicsModel`` ``model``
    on the current CUDA device: {"cluster": CTAs a cluster,
    "particles_per_cta", "threads": threads a CTA, "smem_bytes": dynamic
    shared memory a CTA, "masks_resident", "weights_resident": one flag a
    layer}. Raises where the library cannot plan the shape."""
    if entry == "rollout":
        cfg = _pack(model, dtype, "cpu", encoding).cfg
    else:
        pk = _Packer(dtype, "cpu")
        pk.net(model.net, model.n_particles, model.state_size)
        cfg = pk.cfg
    fn = _function("plan", dtype)
    lib = load_library("fused_bnn_rollout", dtype)
    out = (ctypes.c_int * lib.pddp_bnn_plan_ints())()
    err = fn(0 if entry == "rollout" else 1, int(clusters),
             _config_ints(cfg), out)
    _raise_on(err, "the K2(d)/F3 launch plan")
    n_layers = cfg["n_layers"]
    return {"cluster": out[0], "particles_per_cta": out[1],
            "threads": out[2], "smem_bytes": out[3],
            "masks_resident": bool(out[4]),
            "weights_resident": [bool(v) for v in out[5:5 + n_layers]]}
