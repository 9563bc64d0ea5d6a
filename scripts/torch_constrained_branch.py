#!/usr/bin/env python3
"""How far the float64 solve of chip_smoke.py's constrained double
cartpole (phase 19c: ``constrain_model(-PDDP_UMAX, PDDP_UMAX)`` of the
double cartpole, U0 = 0.1, IGNORE_UNCERTAINTY) is a function of its
inputs to rounding.

    python3 scripts/torch_constrained_branch.py [--settings 200:1,200:10,25:25]
    python3 scripts/torch_constrained_branch.py --card 2

Without ``--card``, on the CPU through the plain versions: for each
setting H:n_iterations, the solve from the start x0 and from x0 with its
first element moved by each of SHIFTS; one JSON line a setting with each
solve's ends (state, iterations, evaluations, J) and the largest relative
spread of J. With ``--card R``, on a CUDA device through K1 and K2(b)
(``riccati_mode="kernel"``, ``fused_rollout=True``, phase 19c's options):
the solve at H=200 run R times; one JSON line with each run's ends and
whether every run gave the first's Z, U and J to the bit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

SHIFTS = (1e-15, -1e-15, 1e-14)
ROW = ("double_cartpole", "IGNORE_UNCERTAINTY")


def cpu_spread(H, n_iterations):
    import torch
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.encoding import StateEncoding
    opts = ILQROptions(n_iterations=n_iterations, cost_in_scan=True)
    ends = []
    for shift in (0.0,) + SHIFTS:
        model, cost, z0, U0 = cs.constrained_problem(*ROW, "cpu",
                                                     torch.float64, H)
        z0 = z0.clone()
        z0[0] += shift
        r = solve(model, cost, z0, U0, opts,
                  encoding=StateEncoding.IGNORE_UNCERTAINTY)
        ends.append({"shift": shift, **cs._ends(r)})
    J0 = ends[0]["J"]
    return {"device": "cpu", "H": H, "n_iterations": n_iterations,
            "ends": ends,
            "J_rel_spread": max(abs(e["J"] - J0) for e in ends) / abs(J0)}


def card_repeats(repeats):
    import torch
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.encoding import StateEncoding
    opts = ILQROptions(**cs.CONSTRAINED_OPTS, riccati_mode="kernel",
                       fused_rollout=True)
    runs = []
    for _ in range(repeats):
        model, cost, z0, U0 = cs.constrained_problem(*ROW, "cuda",
                                                     torch.float64)
        runs.append(solve(model, cost, z0, U0, opts,
                          encoding=StateEncoding.IGNORE_UNCERTAINTY))
    torch.cuda.synchronize()
    first = runs[0]
    return {"device": torch.cuda.get_device_name(0), "card": cs.card_line(),
            "H": cs.CONSTRAINED_H, **cs.CONSTRAINED_OPTS,
            "ends": [cs._ends(r) for r in runs],
            "same_bits": all(torch.equal(r.Z, first.Z)
                             and torch.equal(r.U, first.U)
                             and r.J_opt == first.J_opt for r in runs)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--settings", default="200:1,200:10,25:25",
                    help="H:n_iterations, comma separated (CPU)")
    ap.add_argument("--card", type=int, default=0, metavar="R",
                    help="run the H=200 solve R times on the card instead")
    args = ap.parse_args()
    if args.card:
        print(json.dumps(card_repeats(args.card)), flush=True)
        return
    import torch
    torch.set_num_threads(2)
    for item in args.settings.split(","):
        H, n = (int(v) for v in item.split(":"))
        print(json.dumps(cpu_spread(H, n)), flush=True)


if __name__ == "__main__":
    main()
