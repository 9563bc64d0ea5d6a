#!/usr/bin/env python3
"""How close K2 stages (b)/(c) in float32 come to ``chip_smoke.py``
phase 10's tolerance across input seeds, on one NVIDIA H100.

    python3 scripts/torch_k2c_seeds.py [--models double_cartpole]
        [--codecs VARIANCE_ONLY,...] [--seeds 0:64] [--B 3] [--N 37]
        [--unbounded] [--out FILE]

For each example, codec and seed it makes phase 10's inputs
(``chip_smoke.k2bc_inputs`` with ``numpy.random.default_rng(seed)``, in
float64 then cast, as phase 10 casts its BATCHES' inputs; the bounded
case clamps actions to +-0.12, as phase 10's), runs
``fused_control_law`` and the plain ``control_law`` in float32 on the
card, and the plain version in float64 on the float64 inputs they were
cast from. It prints one JSON line a case: the kernel's Z, U and J error
against the float32 plain version (``rel_err``: max abs error over max
|plain|, phase 10's measure), the float32 plain version's own error
against float64, and the share of actions at a bound; then a summary
line with, per example and codec, the seeds whose kernel error passes
phase 10's float32 tolerance (``chip_smoke.K2BC_TOL``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="double_cartpole")
    ap.add_argument("--codecs", default="VARIANCE_ONLY,"
                    "UPPER_TRIANGULAR_CHOLESKY,FULL_COVARIANCE_MATRIX")
    ap.add_argument("--seeds", default="0:64")
    ap.add_argument("--B", type=int, default=3)
    ap.add_argument("--N", type=int, default=37)
    ap.add_argument("--unbounded", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_k2c_seeds: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from pddp_tpu_torch.controllers.ilqr import control_law, default_fit_alphas
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import _build
    from pddp_tpu_torch.ops import fused_rollout as fr

    _build.build_all()
    lo, hi = (int(s) for s in args.seeds.split(":"))
    bounded = not args.unbounded
    tol = cs.K2BC_TOL["float32"]
    f32, f64 = torch.float32, torch.float64
    alphas = {d: default_fit_alphas(d, "cuda") for d in (f32, f64)}
    out = open(args.out, "w") if args.out else None
    summary = {}
    t0 = time.perf_counter()
    for name in args.models.split(","):
        for codec in args.codecs.split(","):
            enc = StateEncoding[codec]
            over, worst = [], {"U": 0.0, "Z": 0.0, "J": 0.0}
            for seed in range(lo, hi):
                rng = np.random.default_rng(seed)
                model64, cost64, ins64 = cs.k2bc_inputs(
                    rng, name, enc, args.B, args.N, f64,
                    first_reg=0.1 if (args.B, args.N) in cs.BATCHES
                    else 10.0)
                model, cost, _ = cs.example(name, f32)
                ins = tuple(a.to(f32).contiguous() for a in ins64)
                nu = model.action_size
                b32, b64 = ((torch.full((nu,), -0.12, dtype=d,
                                        device="cuda"),
                             torch.full((nu,), 0.12, dtype=d,
                                        device="cuda"))
                            if bounded else (None, None)
                            for d in (f32, f64))
                ign = enc == StateEncoding.IGNORE_UNCERTAINTY
                kern = fr.fused_control_law(model, *ins, alphas[f32], enc,
                                            cost=cost, u_min=b32[0],
                                            u_max=b32[1])
                plain = control_law(model, *ins, alphas[f32], enc,
                                    u_min=b32[0], u_max=b32[1], cost=cost,
                                    cost_in_scan=ign)
                plain64 = control_law(model64, *ins64, alphas[f64], enc,
                                      u_min=b64[0], u_max=b64[1],
                                      cost=cost64, cost_in_scan=ign)
                torch.cuda.synchronize()
                row = {"model": name, "codec": codec, "seed": seed,
                       "B": args.B, "N": args.N, "bounds": bounded,
                       "tol": tol}
                for key, a, p, p64 in zip("ZUJ", kern, plain, plain64):
                    row[key + "_rel"] = cs.rel_err(a, p)[1]
                    row[key + "_f32_vs_f64_rel"] = cs.rel_err(
                        p.to(f64), p64)[1]
                    worst[key] = max(worst[key], row[key + "_rel"])
                if bounded:
                    row["at_bound_share"] = float(
                        (plain[1].abs() == 0.12).to(f64).mean())
                if any(row[k + "_rel"] > tol for k in "ZUJ"):
                    over.append(seed)
                print(json.dumps(row), flush=True)
                if out:
                    out.write(json.dumps(row) + "\n")
            summary["{}/{}".format(name, codec)] = {
                "seeds": [lo, hi], "over_tol": over, "worst": worst}
    line = {"summary": summary, "tol": tol,
            "seconds": time.perf_counter() - t0,
            "card": cs.card_line()}
    print(json.dumps(line), flush=True)
    if out:
        out.write(json.dumps(line) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
