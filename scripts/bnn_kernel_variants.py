"""Times K2(d) (pddp_tpu_torch/csrc/fused_bnn_rollout.cu) built with
several block sizes and unroll depths of its MLP loop, at the BNN path's
shape (trained cartpole net 6-200-200-8, P=100, N=25, ten alphas), in
float32 and float64, and checks that every build gives the same bits.

Run from the root of a checkout on a machine with one H100:

    python3 scripts/bnn_kernel_variants.py
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from pddp_tpu_torch.controllers.ilqr import default_fit_alphas  # noqa: E402
from pddp_tpu_torch.ops import _build  # noqa: E402
from pddp_tpu_torch.ops import fused_bnn_rollout as fb  # noqa: E402

VARIANTS = [(256, 1), (256, 4), (512, 1), (512, 4), (1024, 1), (1024, 4)]


def build(src, out_dir):
    """One nvcc per variant, all started together."""
    procs = {}
    for threads, unroll in VARIANTS:
        out = os.path.join(out_dir, "bnn_{}_{}.so".format(threads, unroll))
        cmd = [_build._nvcc(), *_build._FLAGS,
               "-DPDDP_BNN_THREADS={}".format(threads),
               "-DPDDP_BNN_UNROLL={}".format(unroll), "-o", out, src]
        procs[(threads, unroll)] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out)
    libs = {}
    for v, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError("nvcc failed for {}:\n{}".format(v, log))
        libs[v] = ctypes.CDLL(out)
    return libs


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(ROOT, "pddp_tpu_torch", "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    libs = build(os.path.join(ROOT, "pddp_tpu_torch", "csrc",
                              "fused_bnn_rollout.cu"), out_dir)
    print(cs.card_line(), flush=True)
    N, A = 25, 10
    for dtype in (torch.float32, torch.float64):
        model, _, ins = cs.bnn_inputs(torch, dtype, N, True, 1, None)
        alphas = default_fit_alphas(dtype, "cuda")
        params, cfg = fb._params(model, dtype, "cuda")
        ins = [t.unsqueeze(0).contiguous() for t in ins]
        eps_in = model.eps_in.contiguous()
        suffix = "f32" if dtype == torch.float32 else "f64"
        ref = None
        for v, lib in libs.items():
            fn = getattr(lib, "pddp_bnn_rollout_" + suffix)
            fn.argtypes = fb._SIGNATURES["rollout"]
            fn.restype = ctypes.c_int
            outs = [torch.empty(s, dtype=dtype, device="cuda") for s in
                    ((1, N + 1, A, 14), (1, N, A, 1), (1, N, A, 100, 4))]
            args = ([t.data_ptr() for t in ins + [alphas, params, eps_in]]
                    + [None, None] + [o.data_ptr() for o in outs]
                    + [1, N, A, cfg, torch.cuda.current_stream().cuda_stream])

            def launch():
                cs.check(fn(*args) == 0, "launch {}".format(v))
            ms = cs.events_ms(launch, 20)
            torch.cuda.synchronize()
            ref = ref or [o.clone() for o in outs]
            same = all(bool(torch.equal(a, b)) for a, b in zip(outs, ref))
            print(str(dtype), "threads", v[0], "unroll", v[1], "ms", ms,
                  "same_bits", same, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
